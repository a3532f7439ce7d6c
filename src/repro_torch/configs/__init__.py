"""Model configurations of the port (its own copies: nothing is read from
``repro``), and their registry.

``get_config(name)`` / ``get_smoke_config(name)`` over ``ARCHS`` (the
configurations the port runs) and ``EXTRA_ARCHS`` (bert-base, the paper's
own model); ``reduced_depth`` cuts a configuration's depth (and width).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

#: architecture id -> module; the reference's ids, in its order
ARCHS: Dict[str, str] = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "grok-1-314b": "grok_1_314b",
    "granite-3-8b": "granite_3_8b",
    "qwen2.5-32b": "qwen2_5_32b",
    "granite-20b": "granite_20b",
    "qwen2.5-14b": "qwen2_5_14b",
    "musicgen-large": "musicgen_large",
    "internvl2-2b": "internvl2_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

#: the paper's own model
EXTRA_ARCHS: Dict[str, str] = {
    "bert-base": "bert_base",
}


def _module(name: str):
    mod = ARCHS.get(name) or EXTRA_ARCHS.get(name)
    if mod is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS) + sorted(EXTRA_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def list_archs() -> List[str]:
    return list(ARCHS)


def reduced_depth(cfg: ModelConfig, *, n_layers: int, width_divisor: int = 1,
                  **overrides) -> ModelConfig:
    """Depth- (and optionally width-) reduced variant of a config; the
    reference's ``configs/shapes.py`` rule.

    Keeps the architecture's identity (family, MQA/GQA layout, head_dim,
    MLP type, d_ff/d_model ratio): ``n_layers`` replaces the depth, and
    ``width_divisor`` divides d_model / d_ff / n_heads / vocab_size
    (head_dim is kept, so the attention geometry survives). ``overrides``
    pass through to ``dataclasses.replace``.
    """
    if n_layers < 1:
        raise ValueError(f"n_layers must be >= 1, got {n_layers}")
    if width_divisor < 1:
        raise ValueError(f"width_divisor must be >= 1, got {width_divisor}")
    wd = int(width_divisor)
    changes = dict(
        name=f"{cfg.name}-L{n_layers}" + (f"-w{wd}" if wd > 1 else ""),
        n_layers=int(n_layers),
        d_model=max(1, cfg.d_model // wd),
        d_ff=max(1, cfg.d_ff // wd),
        n_heads=max(1, cfg.n_heads // wd),
        n_kv_heads=max(1, min(cfg.n_kv_heads, cfg.n_heads // wd)),
        vocab_size=max(2, cfg.vocab_size // wd),
        head_dim=cfg.head_dim,
    )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)


__all__ = ["ARCHS", "EXTRA_ARCHS", "get_config", "get_smoke_config", "list_archs",
           "reduced_depth"]

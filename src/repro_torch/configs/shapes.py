"""The reference's input-shape set (LM shapes) and ``input_specs``; port of
``repro/configs/shapes.py``.

  train_4k     seq_len=4096    global_batch=256   (training      -> train step)
  prefill_32k  seq_len=32768   global_batch=32    (inference     -> prefill step)
  decode_32k   seq_len=32768   global_batch=128   (decode        -> decode step,
                                                   one token, KV cache of 32768)
  long_500k    seq_len=524288  global_batch=1     (long-context decode; only
                                                   sub-quadratic archs)

``input_specs`` returns tensors on the meta device (shapes and dtypes, no
storage) matching the batch dicts the step functions consume: the
counterpart of the reference's ``ShapeDtypeStruct``s. Modality frontends
are stubs, as in the reference: "frames" provides precomputed frame
embeddings, "patch" precomputed patch embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple:
    """long_500k requires sub-quadratic attention (SSM/hybrid); pure
    full-attention archs skip it (recorded, with the reference's reason)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k dense KV decode is out of the sub-quadratic regime"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Model-input stand-ins (meta tensors) for one (arch x shape) cell:
    int32 tokens and labels, embeddings in the compute dtype."""
    b, t = shape.global_batch, shape.seq_len
    i32, cdt = torch.int32, cfg.compute_dtype
    d = cfg.d_model

    if shape.kind == "decode":
        if cfg.frontend == "frames":
            return {"embeds": _meta((b, 1, d), cdt)}
        return {"tokens": _meta((b, 1), i32)}

    if cfg.frontend == "frames":
        batch = {"embeds": _meta((b, t, d), cdt)}
        labels = _meta((b, t, cfg.n_codebooks), i32)
    elif cfg.frontend == "patch":
        p = cfg.n_frontend_tokens
        batch = {"patch_embeds": _meta((b, p, d), cdt), "tokens": _meta((b, t - p), i32)}
        labels = _meta((b, t), i32)
    else:
        batch = {"tokens": _meta((b, t), i32)}
        labels = _meta((b, t), i32)

    if shape.kind == "train":
        batch["labels"] = labels
    return batch

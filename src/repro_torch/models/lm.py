"""Dense transformer LM; port of the dense branch of ``repro/models/lm.py``.

Parameters are a nested dict of tensors with the reference's structure and
layer-stacked leaves (``params["blocks"]["attn0"]["wq"]`` is (L, d, H*hd)),
so a reference tree carries over leaf by leaf (``repro_torch.bridge``).
The layer stack is a Python loop that passes the global layer index to
every hook, as the reference's scan does with ``arange(L)``.

Every attention and MLP matmul routes through a hook: digital by default,
or an ``AnalogHook`` carrying the layer's energies and its row of the
forward's seed table (``core.analog.site_seed_table``: the whole
(layers, sites, requests) key chain is folded on the host and copied to
the card once per forward). The ``lm_head`` stays a digital matmul.

Decode updates the KV cache in place (one slot per row) and returns it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig, site_seed_table
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.hooks import MatmulHook, hook_for_layer
from repro_torch.models.layers import (
    apply_rope,
    causal_attention,
    decode_attention,
    mlp,
    rms_norm,
    rope_tables,
)

F32 = torch.float32


@dataclasses.dataclass
class AnalogSpec:
    """Analog execution request for a forward pass.

    ``energies``: an ``init_energy_tree``-shaped tree. ``key``: one raw
    (2,) uint32 key or a stacked (B, 2) array, one stream per batch row.
    ``n_repeats``: the K-repeat dynamic-precision knob for every site.
    """

    cfg: AnalogConfig
    energies: Dict[str, Any]
    key: np.ndarray
    n_repeats: int = 1


# ===========================================================================
# parameters and energies
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    scale: float = 1.0


def param_leaves(cfg: ModelConfig) -> Dict[str, Any]:
    """Shapes and init scales of every parameter (``lm.py`` reference)."""
    d, v, ff, hd = cfg.d_model, cfg.padded_vocab, cfg.d_ff, cfg.head_dim
    qh, kh, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    s = d**-0.5
    return {
        "final_ln": Leaf((d,), 0.0),
        "lm_head": Leaf((d, v), s),
        "embed": Leaf((v, d), 0.02),
        "blocks": {
            "ln1_0": Leaf((n, d), 0.0),
            "ln2_0": Leaf((n, d), 0.0),
            "attn0": {
                "wq": Leaf((n, d, qh * hd), s),
                "wk": Leaf((n, d, kh * hd), s),
                "wv": Leaf((n, d, kh * hd), s),
                "wo": Leaf((n, qh * hd, d), (qh * hd) ** -0.5),
            },
            "mlp0": {
                "w_gate": Leaf((n, d, ff), s),
                "w_up": Leaf((n, d, ff), s),
                "w_down": Leaf((n, ff, d), ff**-0.5),
            },
        },
    }


def map_leaves(fn, tree, *rest, path=()):
    """Apply ``fn(path, leaf, *other_leaves)`` over a nested dict."""
    if isinstance(tree, dict):
        return {
            k: map_leaves(fn, v, *(r[k] for r in rest), path=path + (k,))
            for k, v in tree.items()
        }
    return fn(path, tree, *rest)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random weights at the reference's shapes and scales, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``. Stacked
    leaves are drawn one layer at a time (bounded float32 scratch)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = cfg.compute_dtype

    def make(path, leaf: Leaf):
        out = torch.zeros(leaf.shape, dtype=dtype, device=dev)
        if leaf.scale == 0.0:
            return out
        parts = out if path[0] == "blocks" else out[None]
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=gen, device=dev, dtype=F32) * leaf.scale)
        return out

    return map_leaves(make, param_leaves(cfg))


def group_sites(cfg: ModelConfig) -> Dict[str, tuple]:
    """Analog matmul sites of one layer -> energy leaf suffix."""
    return {
        "attn0_q": (), "attn0_k": (), "attn0_v": (), "attn0_o": (),
        "mlp0_gate": (), "mlp0_up": (), "mlp0_out": (),
    }


def init_energy_tree(cfg: ModelConfig, e0: float, device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    return {
        "groups": {
            s: torch.full((cfg.n_layers,) + suf, float(e0), dtype=F32, device=dev)
            for s, suf in group_sites(cfg).items()
        },
        "lm_head": torch.tensor(float(e0), dtype=F32, device=dev),
    }


# ===========================================================================
# forward
# ===========================================================================


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device="cuda", dtype=None):
    """KV cache {"groups": {"k", "v"}}, each (L, 1, B, S, KH, hd)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, 1, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.compute_dtype
    return {"groups": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}}


def _cache_store(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """Write each row's one-token KV slab (B, 1, KH, hd) at its own slot, in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot] = new[:, 0].to(cache.dtype)


def _attn_sublayer(x, p, cfg: ModelConfig, hook: MatmulHook, prefix: str, *, rope, mode,
                   cache=None, pos=None):
    b, t, _ = x.shape
    hd, qh, kh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cos, sin = rope
    q = hook(f"{prefix}_q", x, p["wq"]).reshape(b, t, qh, hd)
    k = hook(f"{prefix}_k", x, p["wk"]).reshape(b, t, kh, hd)
    v = hook(f"{prefix}_v", x, p["wv"]).reshape(b, t, kh, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k_cache, v_cache = cache
    if mode == "decode":
        _cache_store(k_cache, k, pos)
        _cache_store(v_cache, v, pos)
        out = decode_attention(q, k_cache, v_cache, pos)
    else:
        k_cache[:, :t] = k.to(k_cache.dtype)
        v_cache[:, :t] = v.to(v_cache.dtype)
        g = qh // kh
        out = causal_attention(q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2))
    return hook(f"{prefix}_o", out.reshape(b, t, qh * hd), p["wo"])


def _transformer_layer(x, lp, cfg: ModelConfig, hook, *, rope, mode, cache, pos):
    h = rms_norm(x, lp["ln1_0"], cfg.norm_eps)
    x = x + _attn_sublayer(h, lp["attn0"], cfg, hook, "attn0", rope=rope, mode=mode,
                           cache=cache, pos=pos)
    h = rms_norm(x, lp["ln2_0"], cfg.norm_eps)
    return x + mlp(h, lp["mlp0"], hook, prefix="mlp0")


def _run_stack(params, h, cfg: ModelConfig, *, mode, cache, pos, positions,
               analog: Optional[AnalogSpec]):
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    blocks = params["blocks"]
    sites = list(group_sites(cfg))
    table = None
    if analog is not None:
        table = site_seed_table(analog.key, cfg.n_layers, sites, h.device)
        energies = analog.energies["groups"]
    for l in range(cfg.n_layers):
        lp = map_leaves(lambda _p, a: a[l], blocks)
        hook = MatmulHook()
        if analog is not None:
            hook = hook_for_layer(
                analog.cfg, {s: energies[s][l] for s in sites},
                {s: table[l, i] for i, s in enumerate(sites)}, n_repeats=analog.n_repeats,
            )
        layer_cache = (cache["groups"]["k"][l, 0], cache["groups"]["v"][l, 0])
        h = _transformer_layer(h, lp, cfg, hook, rope=rope, mode=mode, cache=layer_cache, pos=pos)
    return h


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.compute_dtype)


def forward_hidden(params, tokens, cfg: ModelConfig, *, cache, analog=None):
    """Prefill trunk: (B, T) tokens -> normed hidden (B, T, d); fills the
    first T slots of ``cache``."""
    h = _embed(params, tokens, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    h = _run_stack(params, h, cfg, mode="prefill", cache=cache, pos=None,
                   positions=positions, analog=analog)
    return rms_norm(h, params["final_ln"], cfg.norm_eps)


def logits_last(params, h_last: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, 1, d) -> (B, 1, 1, V): a digital matmul, vocab padding sliced off."""
    b = h_last.shape[0]
    logits = torch.matmul(h_last, params["lm_head"].to(h_last.dtype))
    return logits.reshape(b, 1, 1, cfg.padded_vocab)[..., : cfg.vocab_size]


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, analog=None, cache_len=None,
            lengths: Optional[torch.Tensor] = None):
    """Run the prompt; returns (cache, last hidden (B, 1, d)).

    ``lengths`` (B,): per-row true prompt lengths of a right-padded bucket
    batch; the last hidden is gathered at each row's final real token
    (causal attention keeps pad positions out of real rows). Length 0 marks
    a batch-padding row.
    """
    b, t = tokens.shape
    cache = init_cache(cfg, b, cache_len or t, device=tokens.device)
    h = forward_hidden(params, tokens, cfg, cache=cache, analog=analog)
    if lengths is None:
        return cache, h[:, -1:]
    idx = torch.clamp(lengths.to(h.device).long() - 1, 0, t - 1)
    return cache, h[torch.arange(b, device=h.device), idx][:, None]


def decode_step(params, cache, tokens: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                analog=None):
    """One token step: tokens (B, 1) at per-row positions ``pos`` (B,).
    Returns (logits (B, 1, 1, V), cache), the cache updated in place."""
    h = _embed(params, tokens, cfg)
    pos = pos.to(h.device).long().reshape(-1).expand(h.shape[0])
    h = _run_stack(params, h, cfg, mode="decode", cache=cache, pos=pos,
                   positions=pos[:, None], analog=analog)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return logits_last(params, h, cfg), cache

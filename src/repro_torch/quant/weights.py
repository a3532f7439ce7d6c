"""Int8 weight storage for serving; port of ``repro/quant/weights.py``.

Decode streams the weights; storing the matmul weights as int8 with
per-output-channel scales keeps about half the bytes of bf16 resident.
``quantize_params`` maps a parameter tree (nested dicts, ``tree.py``)
to one whose matmul leaves are ``Int8Weight`` (int8 codes and an f32
scale a (layer, output channel)); embeddings, norms and biases stay as
they are. The model dequantizes one layer slice at a time
(``models/lm.py`` ``_run_stack``), so the int8 tree is what stays
resident and the bf16 copy of a layer is transient.

Codes are bit-equal to the reference's: the scale is the f32 ``amax /
127`` over the contracting axis, and ``torch.round`` rounds half to even
as ``jnp.round`` does. Dequantization is f32 ``q * scale`` rounded once to
bf16, the reference's default.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import leaves, map_leaves


@dataclasses.dataclass
class Int8Weight:
    """int8 codes ``q`` (the weight's shape) and f32 per-output-channel
    ``scale`` (the shape with the contracting axis -2 of size 1).
    Indexing slices both along the leading (layer) axes, as the model's
    per-layer loop slices a float leaf."""

    q: torch.Tensor
    scale: torch.Tensor

    def __getitem__(self, idx) -> "Int8Weight":
        return Int8Weight(q=self.q[idx], scale=self.scale[idx])


def quantize_weight(w: torch.Tensor) -> Int8Weight:
    """Symmetric per-output-channel int8 over the contracting axis (-2)
    only, so stacked leading axes keep a scale per (layer, channel)."""
    w32 = w.to(torch.float32)
    amax = torch.amax(torch.abs(w32), dim=-2, keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return Int8Weight(q=q, scale=scale)


def dequantize_weight(iw: Int8Weight, dtype=torch.bfloat16) -> torch.Tensor:
    """f32 ``q * scale`` (int8 times f32 promotes in one op), then one cast."""
    return (iw.q * iw.scale).to(dtype)


def _is_matmul_leaf(path: tuple, leaf) -> bool:
    """The reference's rule: float leaves of 3 or more dims (layer-stacked
    matmul weights (L, ..., K, N)) and the top-level ``lm_head``; nothing
    whose name holds ``embed`` or ``norm`` or ends in ``ln``."""
    name = "/".join(str(p) for p in path)
    if not torch.is_tensor(leaf) or not leaf.is_floating_point():
        return False
    if "embed" in name or "norm" in name or name.endswith("ln"):
        return False
    return leaf.dim() >= 3 or name.endswith("lm_head")


class Int8Params(dict):
    """A parameter tree made by ``quantize_params``: the model reads its type
    once a forward and dequantizes its layer slices."""


def quantize_params(params) -> Int8Params:
    """A parameter tree -> the same tree with ``Int8Weight`` matmul leaves."""
    return Int8Params(map_leaves(
        lambda p, a: quantize_weight(a) if _is_matmul_leaf(p, a) else a, params))


def dequantize_params(qparams, dtype=torch.bfloat16):
    """The whole tree back to ``dtype`` matmul leaves. Serving dequantizes
    a layer slice at a time instead (``lm._run_stack``)."""
    return map_leaves(
        lambda _p, a: dequantize_weight(a, dtype) if isinstance(a, Int8Weight) else a, qparams)


def param_bytes(params) -> int:
    """Bytes of every leaf (an ``Int8Weight``: its codes and scales)."""
    total = 0
    for a in leaves(params):
        for t in (a.q, a.scale) if isinstance(a, Int8Weight) else (a,):
            total += t.numel() * t.element_size()
    return total

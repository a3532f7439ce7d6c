"""Gradient compression: int8 quantization with error feedback; port of
``repro/optim/compress.py``.

A gradient is quantized to int8 with one float32 scale a tensor (``max|x|
/ 127``, codes rounded half to even and clipped to [-127, 127]) and
dequantized: ``ef_int8_roundtrip`` is the stateless roundtrip the train
step applies (the numerics of a compressed data-parallel all-reduce);
``ef_compress`` carries the quantization residual into the next step's
gradient (error feedback). ``compressed_psum`` is the collective itself
over a ``torch.distributed`` group; the train step does not call it (the
reference's step applies the roundtrip to the reduced gradient).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import map_leaves

F32 = torch.float32
Tree = Any


def int8_quantize(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes, scale); ``amax``: the tensor's max|x| where ``x`` is a shard
    of it (default: ``x``'s own)."""
    x32 = x.to(F32)
    amax = torch.amax(torch.abs(x32)) if amax is None else amax
    scale = torch.clamp(amax / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


@torch.no_grad()
def ef_int8_roundtrip(grads: Tree, amax: Optional[dict] = None) -> Tree:
    """Per-tensor int8 quantize -> dequantize of every leaf, in its dtype.
    ``amax``: path -> the whole tensor's max|g| for a leaf that is a
    tensor shard of it."""

    def one(path, g):
        q, s = int8_quantize(g, None if amax is None else amax.get(path))
        return int8_dequantize(q, s).to(g.dtype)

    return map_leaves(one, grads)


@torch.no_grad()
def ef_compress(grads: Tree, err: Optional[Tree]) -> Tuple[Tree, Tree]:
    """Error-feedback compression: (decompressed grads, new error), with
    ``new_err = (g + err) - Q(g + err)`` in float32 and the returned
    gradient ``Q(g + err)`` in the gradient's dtype."""
    if err is None:
        err = map_leaves(lambda _p, g: torch.zeros(g.shape, dtype=F32, device=g.device), grads)

    def one(_path, g, e):
        corrected = g.to(F32) + e
        q, s = int8_quantize(corrected)
        deq = int8_dequantize(q, s)
        return deq.to(g.dtype), corrected - deq

    out = map_leaves(one, grads, err)
    return (map_leaves(lambda _p, o: o[0], out), map_leaves(lambda _p, o: o[1], out))


@torch.no_grad()
def compressed_psum(x: torch.Tensor, group) -> torch.Tensor:
    """int8-compressed all-reduce over ``group``, the reference's two phases:
    an all-reduce MAX of max|x| gives the shared scale (gmax / 127, at
    least 1e-30); each rank's codes (rounded half to even, clipped to
    [-127, 127]) are summed as int32, and the sum times the scale is
    returned in float32. Exact up to one rounding a rank; the payload is a
    quarter of float32's (carried as int32 here)."""
    import torch.distributed as dist

    from repro_torch.launch.collectives import all_reduce

    x32 = x.to(F32)
    gmax = all_reduce(torch.amax(torch.abs(x32)).reshape(1), dist.ReduceOp.MAX, group)
    scale = torch.clamp(gmax[0] / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int32)
    return all_reduce(q, dist.ReduceOp.SUM, group).to(F32) * scale

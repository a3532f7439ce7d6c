"""Gradient compression: int8 quantization with error feedback; port of
``repro/optim/compress.py``.

A gradient is quantized to int8 with one float32 scale a tensor (``max|x|
/ 127``, codes rounded half to even and clipped to [-127, 127]) and
dequantized: ``ef_int8_roundtrip`` is the stateless roundtrip the train
step applies (the numerics of a compressed data-parallel all-reduce);
``ef_compress`` carries the quantization residual into the next step's
gradient (error feedback). The reference's ``compressed_psum``, the
collective itself, needs a data-parallel group and comes with sharded
training.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import map_leaves

F32 = torch.float32
Tree = Any


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x32 = x.to(F32)
    scale = torch.clamp(torch.amax(torch.abs(x32)) / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


@torch.no_grad()
def ef_int8_roundtrip(grads: Tree) -> Tree:
    """Per-tensor int8 quantize -> dequantize of every leaf, in its dtype."""

    def one(_path, g):
        q, s = int8_quantize(g)
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

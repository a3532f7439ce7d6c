"""Sums whose bits do not depend on how many rows are summed at once.

PyTorch's CUDA reduction gives a row as many threads as its length allows
within a block, and fewer when the call has more rows to fill the block
with: a row summed alone and the same row summed in a batch can then be
added up in another order and differ in the last bit, and a request's
tokens would depend on its batch. A row of at most ``BLOCK`` (one warp's
width) elements gets one thread an element whatever the call, so these
functions sum the last dim in stages of ``BLOCK`` (zero-padded) elements,
each stage's partial results the next stage's row.
"""
from __future__ import annotations

import torch

from repro_torch import tally

BLOCK = 32
F32 = torch.float32


def _blocks(x: torch.Tensor) -> torch.Tensor:
    pad = (-x.shape[-1]) % BLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, BLOCK)


def row_sum(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Sum over the last dim, in stages."""
    while x.shape[-1] > BLOCK:
        x = _blocks(x).sum(dim=-1)
    return x.sum(dim=-1, keepdim=keepdim)


def row_norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Float32 L2 norm over the last dim, in stages: each stage takes the
    norms of blocks of the last one's."""
    while x.shape[-1] > BLOCK:
        x = torch.linalg.vector_norm(_blocks(x), dim=-1, dtype=F32)
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim, dtype=F32)


def contraction(p: torch.Tensor) -> torch.Tensor:
    """``p``, an elementwise product about to be summed by ``row_sum`` (a
    contraction that is not a matmul), its 2 x numel FLOPs added to the
    open tally (``repro_torch.tally``)."""
    tally.add("contraction_flops", 2.0 * p.numel())
    return p

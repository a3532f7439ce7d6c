"""The collectives of data-parallel training over a ``torch.distributed``
group, with bits that do not depend on the reduction's algorithm.

``sum_in_rank_order_`` adds each rank's tensor in rank order in the
tensor's own dtype (each add one rounding, as the one-device step's
gradient accumulation over microbatches), so the sum has the same bits on
every rank and equals the one-device step's: it gathers every rank's
bytes and adds them locally. ``gather_regions_`` gives every rank the
regions the others updated (ZeRO-1's parameter all-gather).

On gloo a CUDA tensor is staged through pinned host memory explicitly
(gloo reduces on the host; NCCL refuses two ranks on one card, so several
ranks sharing a card run over gloo). Every collective goes in slices of
at most ``adam.SLICE_ELEMS`` elements (``leading_slices``): the staging
buffers stay bounded whatever a leaf's size.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adam import leading_slices


def _staged(t: torch.Tensor, group) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view (any dtype)."""
    return t.reshape(-1).view(torch.uint8)


def _gather(t: torch.Tensor, group) -> list:
    """Every rank's copy of ``t`` (same shape and dtype on every rank), in
    rank order; staged ones in pinned host memory, this rank's entry
    ``t`` itself."""
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    src = t.contiguous()
    staged = _staged(src, group)
    if staged:
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        src = host
    outs = [torch.empty(src.shape, dtype=src.dtype, pin_memory=staged) for _ in range(n)]
    dist.all_gather([_bytes(o) for o in outs], _bytes(src), group=group)
    outs[me] = t
    return outs


def all_gather(t: torch.Tensor, group) -> list:
    """Every rank's copy of ``t`` (same shape and dtype on every rank), in
    rank order, on ``t``'s device."""
    return [o.to(t.device, non_blocking=True) for o in _gather(t, group)]


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place (through the host on gloo)."""
    import torch.distributed as dist

    if not _staged(t, group):
        dist.all_reduce(t, op=op, group=group)
        return t
    host = t.to("cpu")
    dist.all_reduce(host, op=op, group=group)
    return t.copy_(host)


@torch.no_grad()
def sum_in_rank_order_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` overwritten with ``((t_0 + t_1) + t_2) + ...`` over the ranks'
    tensors in rank order, in ``t``'s dtype, slice by slice."""
    import torch.distributed as dist

    me = dist.get_rank(group)
    for sl in leading_slices(t):
        parts = _gather(t[sl], group)
        acc = parts[0].to(t.device, non_blocking=True)
        acc = acc.clone() if me == 0 else acc
        for p in parts[1:]:
            acc.add_(p.to(t.device, non_blocking=True))
        t[sl] = acc
    return t


@torch.no_grad()
def gather_regions_(t: torch.Tensor, regions: list, group) -> torch.Tensor:
    """Rank r holds ``t[regions[r]]`` up to date (equal shapes); afterwards
    every rank holds all of them."""
    import torch.distributed as dist

    me = dist.get_rank(group)
    mine = t[regions[me]]
    for sl in leading_slices(mine):
        parts = _gather(mine[sl], group)
        for r, (reg, p) in enumerate(zip(regions, parts)):
            if r != me:
                t[reg][sl].copy_(p, non_blocking=True)
    return t

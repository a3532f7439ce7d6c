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
buffers stay bounded whatever a leaf's size. ``all_gather`` and
``all_reduce`` are the other collectives of the port (the tensor shards'
gather, thermal noise's range on a data mesh, ``compressed_psum``): every
collective passes this module.

A ``DryGroup`` (a dry mesh's group, ``launch/mesh.py``
``make_production_mesh``) communicates nothing: each collective on it
writes its kind, the bytes of its result and the group's size to the
group's ``Recorder`` and returns what this rank would hold, shaped and
typed (its own data in every rank's place). The recorder reckons link
bytes with the reference's ring factors (``_link_bytes``, copied from
``repro/launch/hlo_analysis.py``).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict

import torch

from repro_torch.optim.adam import leading_slices


def _link_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Per-device link bytes (ring algorithms) given the HLO *result* size.

    all-reduce: in==out==S, ring = 2S(g-1)/g.
    all-gather: out=S is the gathered tensor; ring receives S(g-1)/g.
    reduce-scatter: out=S is the scattered shard; input is S*g; ring moves
      S*(g-1) per device.
    all-to-all: out=S; each device exchanges S(g-1)/g.
    collective-permute: S.
    """
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return result_bytes


@dataclasses.dataclass
class Recorder:
    """The collectives a dry mesh's shard would run: each ``(kind,
    result_bytes, group_size)`` in call order, and per kind the count,
    the result bytes and the ring link bytes (``_link_bytes``)."""

    calls: list = dataclasses.field(default_factory=list)

    def record(self, kind: str, result_bytes: int, g: int) -> None:
        self.calls.append((kind, int(result_bytes), int(g)))

    def _by_kind(self, value) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for kind, nbytes, g in self.calls:
            if g > 1:
                out[kind] += value(kind, nbytes, g)
        return dict(out)

    def counts(self) -> Dict[str, int]:
        return {k: int(v) for k, v in self._by_kind(lambda *_: 1).items()}

    def result_bytes(self) -> Dict[str, float]:
        return self._by_kind(lambda _k, nbytes, _g: nbytes)

    def link_bytes(self) -> Dict[str, float]:
        return self._by_kind(_link_bytes)

    def total_link_bytes(self) -> float:
        return sum(self.link_bytes().values())

    def grouped(self) -> list:
        """[(kind, result bytes, group size, calls)], the most link bytes
        first."""
        seen: Dict[tuple, int] = defaultdict(int)
        for call in self.calls:
            seen[call] += 1
        return sorted(((k, b, g, n) for (k, b, g), n in seen.items()),
                      key=lambda c: -c[3] * _link_bytes(c[0], c[1], c[2]))


@dataclasses.dataclass(frozen=True, eq=False)
class DryGroup:
    """A group of ``size`` ranks that exists only on paper: this process is
    its rank 0, and its collectives are recorded in ``recorder``."""

    size: int
    recorder: Recorder


def _dry(group) -> bool:
    return isinstance(group, DryGroup)


def world_size(group) -> int:
    import torch.distributed as dist

    return group.size if _dry(group) else dist.get_world_size(group)


def rank(group) -> int:
    import torch.distributed as dist

    return 0 if _dry(group) else dist.get_rank(group)


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
    if _dry(group):
        group.recorder.record("all-gather", t.numel() * t.element_size() * group.size,
                              group.size)
        return [t] + [torch.empty_like(t) for _ in range(group.size - 1)]
    return [o.to(t.device, non_blocking=True) for o in _gather(t, group)]


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place (through the host on gloo)."""
    import torch.distributed as dist

    if _dry(group):
        group.recorder.record("all-reduce", t.numel() * t.element_size(), group.size)
        return t
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

    if _dry(group):  # one gather of every rank's bytes, added locally
        group.recorder.record("all-gather", t.numel() * t.element_size() * group.size,
                              group.size)
        return t
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

    if _dry(group):
        mine = t[regions[0]]
        group.recorder.record("all-gather", mine.numel() * mine.element_size() * group.size,
                              group.size)
        return t
    me = dist.get_rank(group)
    mine = t[regions[me]]
    for sl in leading_slices(mine):
        parts = _gather(mine[sl], group)
        for r, (reg, p) in enumerate(zip(regions, parts)):
            if r != me:
                t[reg][sl].copy_(p, non_blocking=True)
    return t

"""The collectives of data- and tensor-parallel training over a
``torch.distributed`` group, with bits that do not depend on the
reduction's algorithm.

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

The tensor shards' collectives (``copy_to_tp``, ``reduce_from_tp``,
``reduce_scatter_tp``, ``max_over_tp``, ``sum_over_tp_``) take the tensor
shards this process computes (``models.sharding.TensorShard``s, in shard
order): every shard of the local form, which runs them in turn inside
each sharded block (group None), or the one shard of a rank (its tp
group). They are Megatron's *f* and *g* and their kin, as autograd
functions where a gradient flows; the local form adds the shards' tensors
in shard order, a rank adds the ranks' in rank order
(``sum_in_rank_order_``), so the two forms give the same bits.
``mesh_subgroups`` makes a mesh's tp and data subgroups.

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


def mesh_subgroups(group, data: int, tp: int) -> tuple:
    """(tp group, data group) of this rank in a mesh of ``data`` x ``tp``
    ranks over ``group`` (rank ``d * tp + t`` holds data shard d and
    tensor shard t): ``dist.new_group`` of every tp row and every data
    column, made by every rank in the same order (``new_group`` is a
    collective of the default group)."""
    import torch.distributed as dist

    glob = [dist.get_global_rank(group, r) for r in range(data * tp)]
    me = dist.get_rank(group)
    rows = [dist.new_group([glob[d * tp + t] for t in range(tp)]) for d in range(data)]
    cols = [dist.new_group([glob[d * tp + t] for d in range(data)]) for t in range(tp)]
    return rows[me // tp], cols[me % tp]


# ---------------------------------------------------------------------------
# the tensor shards' collectives
# ---------------------------------------------------------------------------


def _in_order(parts: list) -> torch.Tensor:
    """``((p_0 + p_1) + p_2) + ...`` (a new tensor; one rounding an add)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _rank_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``t`` summed over ``group`` in rank order."""
    return sum_in_rank_order_(t.detach().contiguous().clone(), group)


class _CopyLocal(torch.autograd.Function):
    """*f* of the local form: one view of x a shard; the backward adds the
    shards' gradients in shard order."""

    @staticmethod
    def forward(ctx, x, n: int):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        zero = next(g for g in grads if g is not None)
        return _in_order([torch.zeros_like(zero) if g is None else g for g in grads]), None


class _CopyRank(torch.autograd.Function):
    """*f* of a rank: identity; the backward sums over its group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _rank_sum(grad, ctx.group), None


class _ReduceLocal(torch.autograd.Function):
    """*g* of the local form: the partials added in shard order; the
    backward hands each its gradient."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.n = len(parts)
        return _in_order(list(parts))

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + tuple(grad.clone() for _ in range(ctx.n - 1))


class _ReduceRank(torch.autograd.Function):
    """*g* of a rank: its partial summed over the tp group; the backward
    is the identity."""

    @staticmethod
    def forward(ctx, part, group):
        return _rank_sum(part, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScatterLocal(torch.autograd.Function):
    """The partials added in shard order and cut along ``dim``, chunk t
    shard t's; the backward joins the chunks' gradients, each partial's."""

    @staticmethod
    def forward(ctx, dim: int, *parts):
        ctx.dim, ctx.n = dim, len(parts)
        return tuple(c.contiguous() for c in _in_order(list(parts)).chunk(ctx.n, dim))

    @staticmethod
    def backward(ctx, *grads):
        whole = torch.cat(grads, dim=ctx.dim)
        return (None, whole) + tuple(whole.clone() for _ in range(ctx.n - 1))


class _ScatterRank(torch.autograd.Function):
    """A rank's partial summed over the tp group, its own chunk along
    ``dim`` kept; the backward gathers the chunks' gradients."""

    @staticmethod
    def forward(ctx, part, dim: int, shard):
        ctx.dim, ctx.group = dim, shard.group
        return _rank_sum(part, shard.group).chunk(shard.tp, dim)[shard.t].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(all_gather(grad.contiguous(), ctx.group), dim=ctx.dim), None, None


def _local_form(shards) -> bool:
    return shards[0].group is None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """*f* over any process group: ``x`` itself, its gradient summed over
    ``group`` in rank order (a value every rank's different rows read)."""
    return _CopyRank.apply(x, group)


def copy_to_tp(x: torch.Tensor, shards) -> list:
    """Megatron's *f* at the input of a column-parallel block: ``x`` for
    each shard (identity), the shards' input gradients summed over tp."""
    if _local_form(shards):
        return list(_CopyLocal.apply(x, len(shards)))
    return [copy_to_group(x, shards[0].group)]


def reduce_from_tp(parts: list, shards) -> torch.Tensor:
    """Megatron's *g* at the output of a row-parallel block: the shards'
    partials summed over tp; the gradient passes to each unchanged."""
    if _local_form(shards):
        return _ReduceLocal.apply(*parts)
    return _ReduceRank.apply(parts[0], shards[0].group)


def reduce_scatter_tp(parts: list, shards, dim: int = -1) -> list:
    """The shards' partial products summed over tp, each shard keeping its
    own 1/tp along ``dim`` (a product over sharded input rows that feeds
    sharded channels); the backward gathers the chunks' gradients."""
    if _local_form(shards):
        return list(_ScatterLocal.apply(dim, *parts))
    return [_ScatterRank.apply(parts[0], dim, shards[0])]


@torch.no_grad()
def max_over_tp(parts: list, shards) -> torch.Tensor:
    """The elementwise max of the shards' tensors (exact in any order; no
    gradient): the vocab-parallel loss's shared max."""
    if _local_form(shards):
        outs = parts
    else:
        outs = all_gather(parts[0].contiguous(), shards[0].group)
    acc = outs[0]
    for o in outs[1:]:
        acc = torch.maximum(acc, o)
    return acc


@torch.no_grad()
def sum_over_tp_(parts: list, shards) -> None:
    """Each shard's tensor overwritten with their sum over tp, in shard (or
    rank) order: a whole leaf's partial gradients."""
    if _local_form(shards):
        for p in parts[1:]:
            parts[0].add_(p)
        for p in parts[1:]:
            p.copy_(parts[0])
    else:
        sum_in_rank_order_(parts[0], shards[0].group)

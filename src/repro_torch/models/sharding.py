"""Logical-axis sharding and the ambient tensor-parallel mesh; port of
``repro/models/sharding.py``.

Parameters carry logical axis names (``lm.param_axes``); a rule table
maps each name onto mesh axes. ``spec`` resolves one tensor's names to a
placement: a plain tuple with, for each dim, a mesh-axis name, a tuple of
them, or None (whole), read from the port's ``launch.mesh.Mesh`` as the
reference's ("data", "model") mesh with sizes (``data``, ``tp``). There
is no ``NamedSharding``: the training step (``launch/steps.py``) reads a
placement to cut each leaf's Adam moments among the data shards (ZeRO-1,
``zero1_axes``).

``use_mesh`` makes a ``Mesh`` the ambient mesh of the calls inside it
(per thread); ``kernels.dispatch.active_mesh`` reads it, and
``core.analog.analog_dot`` runs column-parallel under it. Serving places
nothing else: as under ``SERVING_RULES``, every tensor outside
``analog_dot`` (activations, caches, tokens, keys) is whole on every
shard.

``use_data_shard`` carries a data shard's place (``DataShard``: shard r
of ``data``, and the data group of the distributed form) to the calls
inside it, as ``use_mesh`` carries the mesh: ``analog_dot`` then draws
its noise at the shard's global rows (``kernels.dispatch
.active_data_shard``).

Tensor-parallel training (Megatron's column and row shards) places the
weights by ``tensor_plan``: for every leaf the dim that ``spec`` gives
"model" under ``PROFILES[cfg.sharding_profile]``, cut in tp, or whole.
The port's own exceptions to ``spec``:

  * attention stays whole on every shard where tp does not divide
    ``n_heads`` (``spec`` would cut wq's ``heads * head_dim`` columns
    through a head); its gradients are then the same on every shard;
  * wk, wv, bk, bv stay whole where tp does not divide ``n_kv_heads``
    (each shard's query heads read the kv heads they need); their
    gradients are partial on each shard and summed over tp (``summed``);
  * griffin's ``b_a``, ``b_i`` and ``lambda`` are whole, as ``spec``
    places them, but act on each shard's channels: each shard slices its
    channels, and their gradients are summed over tp;
  * the MoE experts are whole across data shards (``spec``'s "experts" /
    "expert_embed" on "data" are expert parallelism, ROADMAP A.4, A.5):
    only "expert_mlp" is cut.

The train step hands the model each leaf cut or summed over the tensor
shards it computes as ``Shards``: its tensor on each shard, with each
shard's place (``TensorShard``: shard t of tp, and the tp group of the
distributed form; the local form's every shard, which runs in turn inside
each sharded block); the model runs a sharded block through
``tensor_parallel``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Sequence, Tuple

from repro_torch.tree import leaves, map_leaves

#: logical axis -> mesh axis (or a tuple of mesh axes, or None: whole).
#: Tensor parallelism on "model" (heads, MLP, vocabulary, experts' FF),
#: the batch and the ZeRO-1 moments on ("pod", "data"); see the
#: reference's table for each entry's reason
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": "model",
    "tokens": ("pod", "data", "model"),
    "tokens_pm": ("pod", "model"),
    "pod_tokens": ("pod",),
    "kv_seq": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "data",
    "expert_mlp": "model",
    "expert_embed": "data",
    "capacity": None,
    "layers": None,
    "rnn": "model",
    "conv": None,
    "window": None,
    "stack": None,
    "zero": ("pod", "data"),
    None: None,
}

#: pure data parallelism: weights whole, the whole mesh behind the batch
#: and the ZeRO-1 moments
DP_RULES = {
    **{k: None for k in DEFAULT_RULES},
    "batch": ("pod", "data", "model"),
    "zero": ("pod", "data", "model"),
}

#: serving: every logical axis whole (tensor parallelism lives only in
#: ``analog_dot``'s column shards)
SERVING_RULES = {k: None for k in DEFAULT_RULES}

PROFILES = {"tp": DEFAULT_RULES, "dp": DP_RULES, "serving": SERVING_RULES}

_state = threading.local()


def set_mesh(mesh) -> None:
    _state.mesh = mesh


def get_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` (a ``Mesh`` or None) as the ambient mesh inside the block."""
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


@dataclasses.dataclass(frozen=True)
class DataShard:
    """Data shard ``r`` of ``data``: its rows of every analog call are the
    r-th 1/data of the whole call's flattened rows. ``group``: the data
    shards' process group (or a dry one) in the distributed form, None in
    the local form, where the shards run one after another."""

    r: int
    data: int
    group: Optional[Any] = None


def get_data_shard() -> Optional[DataShard]:
    return getattr(_state, "data_shard", None)


@contextlib.contextmanager
def use_data_shard(shard: Optional[DataShard]):
    """``shard`` (a ``DataShard`` or None) as the ambient data shard."""
    prev = get_data_shard()
    _state.data_shard = shard
    try:
        yield shard
    finally:
        _state.data_shard = prev


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """Tensor shard ``t`` of ``tp``: its slice of every cut leaf is the
    t-th 1/tp along the leaf's dim (``tensor_plan``). ``group``: the tp
    group (or a dry one) of the distributed form, None in the local form,
    where the shards run in turn inside each sharded block."""

    t: int
    tp: int
    group: Optional[Any] = None


class Shards(tuple):
    """A leaf on the tensor shards a process computes: its tensor on each
    (a cut leaf's slice, or a summed whole leaf's view; one autograd leaf a
    shard) and, in ``shards``, the ``TensorShard`` of each, in shard order.
    A leaf carries its shards itself: a remat group's recompute in the
    backward may run on the card's autograd thread, which sees no
    thread-local state of the caller's."""

    def __new__(cls, parts, shards):
        obj = super().__new__(cls, parts)
        obj.shards = tuple(shards)
        return obj


def shards_of(tree) -> tuple:
    """The tensor shards of the first ``Shards`` leaf of a (dict / list)
    tree; ``()`` where it holds none (the block is whole on every shard)."""
    if isinstance(tree, Shards):
        return tree.shards
    for v in tree.values() if isinstance(tree, dict) else tree if isinstance(tree, list) else ():
        found = shards_of(v)
        if found:
            return found
    return ()


def shard_part(tree, i: int):
    """Part ``i`` of a (dict / list) tree: each ``Shards``' i-th tensor,
    every other leaf as it is."""
    if isinstance(tree, Shards):
        return tree[i]
    if isinstance(tree, dict):
        return {k: shard_part(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shard_part(v, i) for v in tree]
    return tree


def tensor_parallel(fn, x, p):
    """``fn(x, p, shard)`` as a Megatron block: where ``p`` holds
    ``Shards``, ``x`` enters each shard through *f* (``copy_to_tp``),
    ``fn`` runs on each shard's part of ``p`` in shard order, and the
    partials leave through *g* (``reduce_from_tp``); otherwise ``fn(x, p,
    None)``, the whole block, on every shard."""
    shards = shards_of(p)
    if not shards:
        return fn(x, p, None)
    from repro_torch.launch import collectives

    xs = collectives.copy_to_tp(x, shards)
    return collectives.reduce_from_tp(
        [fn(xi, shard_part(p, i), s) for i, (xi, s) in enumerate(zip(xs, shards))], shards)


@dataclasses.dataclass(frozen=True)
class TPLeaf:
    """A parameter's place among tp tensor shards: ``dim`` cut in tp (None:
    whole on every shard); ``summed``: a whole leaf whose gradient is a
    partial on each shard, summed over tp."""

    dim: Optional[int] = None
    summed: bool = False

    @property
    def per_shard(self) -> bool:
        """Whether each shard holds the leaf as a tensor of its own."""
        return self.dim is not None or self.summed


@dataclasses.dataclass(frozen=True)
class _Axes:
    data: int
    tp: int


_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_KV = ("wk", "wv", "bk", "bv")
_RNN_CHANNEL = ("b_a", "b_i", "lambda")


def tensor_plan(cfg, tp: int) -> dict:
    """Every parameter's ``TPLeaf`` at ``tp`` tensor shards under
    ``cfg.sharding_profile`` (the module docstring: ``spec``'s "model"
    dim, and the port's exceptions); every leaf whole at tp 1 and under
    ``"dp"``."""
    from repro_torch.models import lm

    rules = PROFILES[cfg.sharding_profile]
    heads = tp > 1 and cfg.n_heads % tp == 0
    kv = heads and cfg.n_kv_heads % tp == 0

    def place(path, leaf):
        if tp == 1:
            return TPLeaf()
        s = spec(leaf.axes, rules, _Axes(1, tp), shape=leaf.shape)
        dim = next((i for i, a in enumerate(s) if "model" in (a if isinstance(a, tuple) else (a,))),
                   None)
        name, block = path[-1], path[-2] if len(path) > 1 else ""
        if block.startswith("attn") and name in _ATTN:
            if not heads:
                return TPLeaf()
            if name in _KV and not kv:
                return TPLeaf(summed=True)
        if block.startswith("rec") and name in _RNN_CHANNEL:
            return TPLeaf(summed=cfg.rnn_width % tp == 0)
        return TPLeaf(dim)

    plan = map_leaves(place, lm.param_leaves(cfg))
    if cfg.family == "xlstm" and any(t.dim is not None for t in leaves(plan)):
        raise NotImplementedError(
            f"{cfg.name} under the {cfg.sharding_profile!r} profile at tp={tp}: the xlstm "
            "family's tensor shards are not ported; it trains under its \"dp\" profile")
    return plan


def shard_shape(shape, place: TPLeaf, tp: int) -> tuple:
    """A leaf's shape on one tensor shard."""
    if place.dim is None:
        return tuple(shape)
    out = list(shape)
    out[place.dim] //= tp
    return tuple(out)


def _cut(a, place: TPLeaf, tp: int, t: int):
    """Shard t's slice of a whole leaf ``a`` (a tensor or a numpy array),
    contiguous: a rank's layout; a whole leaf as it is."""
    if place.dim is None:
        return a
    n = a.shape[place.dim] // tp
    part = a[(slice(None),) * place.dim + (slice(t * n, (t + 1) * n),)]
    return part.contiguous() if hasattr(part, "contiguous") else part.copy()


def take_tensor_shard(tree, plan: dict, tp: int, t: int):
    """Shard t of a whole parameter tree (tensors or numpy arrays): each
    cut leaf's slice as a contiguous copy, every whole leaf as it is."""
    return map_leaves(lambda _p, a, place: _cut(a, place, tp, t), tree, plan)


def join_tensor_shards(trees: Sequence, plan: dict):
    """The whole tree from its tp shards' trees (``take_tensor_shard``'s
    inverse): cut leaves joined along their dim, whole leaves shard 0's."""
    import numpy as np
    import torch

    def join(_p, place, *parts):
        if place.dim is None:
            return parts[0]
        if isinstance(parts[0], np.ndarray):
            return np.concatenate(parts, axis=place.dim)
        return torch.cat(parts, dim=place.dim)

    return map_leaves(join, plan, *trees)


def set_rules(rules: Optional[dict]) -> None:
    _state.rules = rules


def get_rules() -> dict:
    return getattr(_state, "rules", None) or DEFAULT_RULES


@contextlib.contextmanager
def use_rules(rules: Optional[dict]):
    """``rules`` as the ambient rule table inside the block."""
    prev = getattr(_state, "rules", None)
    set_rules(rules)
    try:
        yield
    finally:
        set_rules(prev)


def spec(names: Sequence[Optional[str]], rules: Optional[dict] = None, mesh=None,
         shape: Optional[Sequence[int]] = None) -> tuple:
    """Logical axis names -> a placement under ``mesh`` (default: the
    ambient one; ``()`` without a mesh).

    Shape-aware, as the reference's: a mesh axis is given to a dim only if
    the dim divides by the (product of the) axis sizes, which is more than
    1, and no earlier dim of the tensor took it (first dim wins); a tuple
    of mesh axes degrades to its longest feasible prefix. Without a shape,
    no divisibility filter.
    """
    mesh = mesh if mesh is not None else get_mesh()
    rules = rules or get_rules()
    if mesh is None:
        return ()
    sizes = {"data": mesh.data, "model": mesh.tp}
    used: set = set()
    out = []
    for i, n in enumerate(names):
        phys = rules.get(n, None)
        phys = (phys,) if isinstance(phys, str) else (phys or ())
        cand = tuple(a for a in phys if a in sizes and a not in used)
        chosen = None
        if cand:
            if shape is None:
                chosen = cand
            else:
                for k in range(len(cand), 0, -1):
                    prod = 1
                    for a in cand[:k]:
                        prod *= sizes[a]
                    if prod > 1 and shape[i] % prod == 0:
                        chosen = cand[:k]
                        break
        if chosen:
            used.update(chosen)
            out.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            out.append(None)
    return tuple(out)


def tree_shardings(axes_tree, shapes_tree=None, mesh=None, rules=None):
    """A tree of logical-axis tuples (and a matching tree of shapes, or of
    tensors) -> the tree of their placements (``spec``)."""
    if shapes_tree is None:
        return map_leaves(lambda _p, names: spec(names, rules, mesh), axes_tree)
    return map_leaves(lambda _p, names, sh: spec(names, rules, mesh,
                                                 shape=tuple(getattr(sh, "shape", sh))),
                      axes_tree, shapes_tree)


def zero1_axes(axes: Tuple[Optional[str], ...]) -> Tuple[Optional[str], ...]:
    """Optimizer-state axes of a parameter: ``"zero"`` on its first dim
    with no logical name (ZeRO-1); a parameter with none gains nothing."""
    out = list(axes)
    for i, a in enumerate(out):
        if a is None:
            out[i] = "zero"
            return tuple(out)
    return tuple(out)

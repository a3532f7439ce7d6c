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
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Sequence, Tuple

from repro_torch.tree import map_leaves

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

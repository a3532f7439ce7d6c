"""Tensor-parallel meshes; the port's counterpart of ``repro/launch/mesh.py``
``make_mesh_for_devices``.

A ``Mesh`` is ``tp`` tensor-parallel shards. In serving only the analog
matmul is sharded: it runs as ``tp`` column shards, shard r computing
columns ``[r N / tp, (r + 1) N / tp)`` with its noise drawn at that
global column offset (``core.analog._maybe_sharded_analog_dot``), and
everything else stays replicated. Two forms:

  * local (``group`` None): the ``tp`` shards run one after another on
    the caller's device and are concatenated. The counterpart of the
    reference's forced host-device mesh: what one card and the CPU tests
    run.
  * distributed: one shard for each rank of a ``torch.distributed``
    process group of ``tp`` ranks, each rank holding the whole
    (replicated) model on its own device; rank r computes shard r and the
    shards are ``all_gather``-ed. The caller initialises the group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``tp`` tensor-parallel shards; ``group`` is the process group of the
    distributed form (one shard a rank), None for the local form."""

    tp: int
    group: Optional[Any] = None

    def __post_init__(self):
        if self.tp < 1:
            raise ValueError(f"a mesh needs tp >= 1, got {self.tp}")
        if self.group is not None:
            import torch.distributed as dist

            size = dist.get_world_size(self.group)
            if size != self.tp:
                raise ValueError(f"a distributed mesh runs one shard a rank: the group has "
                                 f"{size} ranks for tp={self.tp}")

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def shards(self) -> range:
        """The shard indices this process computes: all of them locally,
        its own rank's in the distributed form."""
        if self.group is None:
            return range(self.tp)
        import torch.distributed as dist

        r = dist.get_rank(self.group)
        return range(r, r + 1)


def make_mesh_for_devices(tp: int, *, group=None) -> Mesh:
    """A mesh of ``tp`` tensor-parallel shards, local unless ``group`` (a
    process group of ``tp`` ranks) is given."""
    return Mesh(tp=tp, group=group)

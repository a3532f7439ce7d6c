"""Meshes of data-parallel and tensor-parallel shards; the port's
counterpart of ``repro/launch/mesh.py`` ``make_mesh_for_devices``.

A ``Mesh`` is ``data`` x ``tp`` shards: the reference's ("data", "model")
mesh. Two forms:

  * local (``group`` None): the shards run one after another on the
    caller's device. The counterpart of the reference's forced
    host-device mesh: what one card and the CPU tests run.
  * distributed: one shard for each rank of a ``torch.distributed``
    process group of ``data * tp`` ranks, rank ``d * tp + t`` holding
    data shard d and tensor shard t, each on its own device (or several
    ranks on one card over gloo). The caller initialises the group.

Serving reads only ``tp``: the analog matmul runs as ``tp`` column
shards, shard r computing columns ``[r N / tp, (r + 1) N / tp)`` with its
noise drawn at that global column offset
(``core.analog._maybe_sharded_analog_dot``), and everything else stays
replicated. Training reads only ``data`` (``launch/steps.py``: each data
shard takes its rows of the batch; the gradients are summed over the
shards and the Adam moments cut among them, ZeRO-1); tensor-parallel
training and a distributed mesh of both axes are not ported (ROADMAP A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``data`` x ``tp`` shards; ``group`` is the process group of the
    distributed form (one shard a rank), None for the local form."""

    tp: int
    group: Optional[Any] = None
    data: int = 1

    def __post_init__(self):
        if self.tp < 1 or self.data < 1:
            raise ValueError(f"a mesh needs tp >= 1 and data >= 1, got {self.tp}, {self.data}")
        if self.group is not None:
            import torch.distributed as dist

            if self.tp > 1 and self.data > 1:
                raise NotImplementedError(
                    "a distributed mesh of both data and tensor shards is not ported "
                    "(tensor-parallel training, ROADMAP A)")
            size = dist.get_world_size(self.group)
            if size != self.size:
                raise ValueError(f"a distributed mesh runs one shard a rank: the group has "
                                 f"{size} ranks for data={self.data} x tp={self.tp}")

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def size(self) -> int:
        return self.data * self.tp

    def _rank(self) -> int:
        import torch.distributed as dist

        return dist.get_rank(self.group)

    def shards(self) -> range:
        """The tensor shards this process computes: all of them locally,
        its own rank's in the distributed form."""
        if self.group is None:
            return range(self.tp)
        r = self._rank() % self.tp
        return range(r, r + 1)

    def data_shards(self) -> range:
        """The data shards this process computes: all of them locally, its
        own rank's in the distributed form."""
        if self.group is None:
            return range(self.data)
        r = self._rank() // self.tp
        return range(r, r + 1)


def make_mesh_for_devices(tp: int, *, group=None, data: int = 1) -> Mesh:
    """A mesh of ``data`` x ``tp`` shards, local unless ``group`` (a
    process group of ``data * tp`` ranks) is given."""
    return Mesh(tp=tp, group=group, data=data)

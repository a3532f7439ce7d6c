"""Meshes of data-parallel and tensor-parallel shards; the port's
counterpart of ``repro/launch/mesh.py`` (``make_mesh_for_devices``,
``make_production_mesh``, ``make_local_mesh``).

A ``Mesh`` is ``data`` x ``tp`` shards: the reference's ("data", "model")
mesh. Three forms:

  * local (``group`` None): the shards run one after another on the
    caller's device. The counterpart of the reference's forced
    host-device mesh: what one card and the CPU tests run.
  * distributed: one shard for each rank of a ``torch.distributed``
    process group of ``data * tp`` ranks, rank ``d * tp + t`` holding
    data shard d and tensor shard t, each on its own device (or several
    ranks on one card over gloo). The caller initialises the group.
  * dry (``group`` a ``collectives.DryGroup``): shard 0 of data x tp of a
    mesh that exists only on paper, the dry run's production meshes. It
    computes shard (0, 0) alone; its collectives record their kind, bytes
    and group size (``collectives.Recorder``) and communicate nothing.

A distributed mesh of both axes makes its tp rows and data columns as
subgroups (``tp_group``, ``data_group``; every rank makes every subgroup,
in the same order, when it builds the mesh); a mesh of one axis uses its
group for that axis.

Serving reads ``tp``: the analog matmul runs as ``tp`` column shards,
shard r computing columns ``[r N / tp, (r + 1) N / tp)`` with its noise
drawn at that global column offset
(``core.analog._maybe_sharded_analog_dot``), and everything else stays
replicated; the serving steps (``launch/steps.py``) also cut the batch's
rows by ``data``. Training reads both: under the ``"tp"`` profile each
rank holds its tensor shard of the weights (Megatron's column and row
shards, ``models/sharding.py``) and its data shard's rows, the gradients
are summed over ``data`` and the Adam moments cut among the data shards
(ZeRO-1); under ``"dp"`` the weights are whole and the batch and the
moments go over ``data * tp`` shards. The LM calibration reads only
``data``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.launch import collectives


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``data`` x ``tp`` shards; ``group`` is the process group of the
    distributed form (one shard a rank), a ``collectives.DryGroup`` of a
    dry mesh, or None for the local form."""

    tp: int
    group: Optional[Any] = None
    data: int = 1

    def __post_init__(self):
        if self.tp < 1 or self.data < 1:
            raise ValueError(f"a mesh needs tp >= 1 and data >= 1, got {self.tp}, {self.data}")
        groups = (self.group, self.group)
        if self.group is not None and not self.dry:
            size = collectives.world_size(self.group)
            if size != self.size:
                raise ValueError(f"a distributed mesh runs one shard a rank: the group has "
                                 f"{size} ranks for data={self.data} x tp={self.tp}")
            if self.tp > 1 and self.data > 1:
                groups = collectives.mesh_subgroups(self.group, self.data, self.tp)
        object.__setattr__(self, "_groups", groups)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def dry(self) -> bool:
        return isinstance(self.group, collectives.DryGroup)

    @property
    def size(self) -> int:
        return self.data * self.tp

    @property
    def recorder(self) -> Optional[collectives.Recorder]:
        """A dry mesh's record of its collectives (None otherwise)."""
        return self.group.recorder if self.dry else None

    @property
    def tp_group(self):
        """The group of the tensor shards' collectives: a dry mesh's group
        of ``tp`` ranks; this rank's tp row of a distributed mesh of both
        axes; else the mesh's group."""
        if self.dry:
            return collectives.DryGroup(self.tp, self.group.recorder)
        return self._groups[0]

    @property
    def data_group(self):
        """The group of the data shards' collectives (as ``tp_group``: the
        data column)."""
        if self.dry:
            return collectives.DryGroup(self.data, self.group.recorder)
        return self._groups[1]

    def _rank(self) -> int:
        return collectives.rank(self.group)

    def shards(self) -> range:
        """The tensor shards this process computes: all of them locally,
        its own rank's in the distributed form (shard 0 on a dry mesh)."""
        if self.group is None:
            return range(self.tp)
        r = self._rank() % self.tp
        return range(r, r + 1)

    def data_shards(self) -> range:
        """The data shards this process computes: all of them locally, its
        own rank's in the distributed form (shard 0 on a dry mesh)."""
        if self.group is None:
            return range(self.data)
        r = self._rank() // self.tp
        return range(r, r + 1)


def make_mesh_for_devices(tp: int, *, group=None, data: int = 1) -> Mesh:
    """A mesh of ``data`` x ``tp`` shards, local unless ``group`` (a
    process group of ``data * tp`` ranks) is given."""
    return Mesh(tp=tp, group=group, data=data)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as a dry mesh (shard 0 of it, its
    collectives recorded): 16 data x 16 tp, the reference's single pod of
    256 devices; ``multi_pod``: 32 data x 16 tp. The port's ``Mesh`` has no
    pod axis: the reference's two pods fold into the data axis. Its sharding
    rules place the batch and the ZeRO-1 moments on ("pod", "data")
    together (``models/sharding.py``), so 2 x 16 data shards cut the same
    rows as 32 and a device holds the same; only which links a collective
    crosses (between pods or within one) is not modelled."""
    data = 32 if multi_pod else 16
    return Mesh(tp=16, group=collectives.DryGroup(data * 16, collectives.Recorder()), data=data)


def make_local_mesh() -> Mesh:
    """One device, the reference's 1 x 1 mesh with its axis names: the
    whole batch on the caller's device."""
    return Mesh(tp=1)

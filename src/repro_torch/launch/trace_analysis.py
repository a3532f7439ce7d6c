"""One device's step reckoned without running it: the port's counterpart
of ``repro/launch/hlo_analysis.py``.

The reference compiles a cell with XLA and parses the optimised HLO (dot
FLOPs multiplied through its scans, collective bytes with ring factors)
and reads XLA's ``memory_analysis``. There is no HLO here: ``reckon``
runs the port's own program, the same Python a card runs, on tensors of
the meta device (shapes and dtypes, no storage; or on any device, for a
check against real tensors), under three counters:

  * **matmul FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` (every
    mm, bmm, addmm and convolution, the backward's too). The layer stack
    is a Python loop, so no scan correction is needed.
  * **contraction FLOPs**: contractions the port takes as an elementwise
    product summed by ``reduce.row_sum`` (decode attention, the mLSTM
    decode), where the reference has dots; FlopCounterMode does not see
    them. 2 x the product's elements, counted by ``reduce.contraction``
    into ``repro_torch.tally``; added to the dot total compared with the
    reference's.
  * **analog FLOPs**: an analog site on the ``"cuda"`` backend cannot
    launch on meta; the kernel wrapper reckons it
    (``kernels/analog_matmul.py`` ``reckon_on_meta``: the empty f32
    output, the route's workspace, 2·M·K·N FLOPs). Only a meta trace
    takes that branch; a run on the card launches the kernel.
  * **peak live bytes**: ``MemoryTracker``, a ``TorchDispatchMode`` that
    adds each new output storage's bytes on the traced device and
    subtracts them when the storage dies (a weak reference to it): the
    counterpart of XLA's ``memory_analysis``, over the same program as
    the card's allocator (whose ``max_memory_allocated`` it is held to on
    the card). The tensors alive before the step (``hold``) are counted
    from the start. It also keeps **the largest tensors** made.
  * **collective link bytes by kind**: the dry mesh's
    ``collectives.Recorder`` (``launch/mesh.py`` ``make_production_mesh``),
    with the reference's ring factors.
"""
from __future__ import annotations

import dataclasses
import heapq
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tally


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


class MemoryTracker(TorchDispatchMode):
    """Live bytes of the storages on ``device`` made inside the mode (and
    of those ``hold`` registers): ``now``, ``peak``, and the ``top``
    largest new tensors as (bytes, op, shape, dtype)."""

    def __init__(self, device, top: int = 12):
        super().__init__()
        self.device = torch.device(device)
        self.now = self.peak = 0
        self.top = top
        self.largest: list = []  # min-heap of (bytes, op, shape, dtype), each once
        self._live: Dict[int, weakref.ref] = {}

    def _on_device(self, t: torch.Tensor) -> bool:
        d = t.device
        return d.type == self.device.type and (self.device.index is None
                                               or d.index == self.device.index)

    def _track(self, t: torch.Tensor, op: Optional[str]) -> None:
        if not isinstance(t, torch.Tensor) or not self._on_device(t):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        nbytes = st.nbytes()

        def gone(_ref, key=key, nbytes=nbytes):
            if self._live.pop(key, None) is not None:
                self.now -= nbytes

        self._live[key] = weakref.ref(st, gone)
        self.now += nbytes
        self.peak = max(self.peak, self.now)
        if op is not None and nbytes:
            item = (nbytes, op, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            if item in self.largest:
                return
            if len(self.largest) < self.top:
                heapq.heappush(self.largest, item)
            elif item > self.largest[0]:
                heapq.heapreplace(self.largest, item)

    def hold(self, *trees) -> None:
        """Count the tensors of ``trees`` (alive before the step: nested
        dicts, lists, tuples and dataclasses) from now."""
        for t in _tensors(trees):
            self._track(t, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket.__name__)
        for t in tree_flatten(out)[0]:
            self._track(t, name)
        return out


@dataclasses.dataclass
class TraceStats:
    """One device's step: FLOPs by source, bytes, tensors and collectives."""

    matmul_flops: float
    contraction_flops: float
    analog_flops: float
    analog_sites: int
    base_bytes: int
    peak_bytes: int
    largest: list
    collective_counts: Dict[str, int]
    collective_bytes: Dict[str, float]  # result bytes by kind
    collective_link_bytes: Dict[str, float]  # ring link bytes by kind
    #: [(kind, result bytes, group size, calls)], by link bytes
    collective_calls: list = dataclasses.field(default_factory=list)

    @property
    def dot_flops(self) -> float:
        """The total compared with the reference's HLO dot FLOPs."""
        return self.matmul_flops + self.contraction_flops + self.analog_flops

    @property
    def total_collective_link_bytes(self) -> float:
        return sum(self.collective_link_bytes.values())

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["dot_flops"] = self.dot_flops
        out["largest"] = [dict(bytes=b, op=op, shape=list(sh), dtype=dt)
                          for b, op, sh, dt in self.largest]
        return out


def reckon(fn: Callable[[], Any], *, device="meta", hold=(), recorder=None,
           top: int = 12) -> tuple:
    """Run ``fn()`` under the counters: (its result, ``TraceStats``).
    ``hold``: trees of the tensors alive before the step (weights, state,
    inputs), counted in ``base_bytes`` and the peak. ``recorder``: the dry
    mesh's ``collectives.Recorder`` (None: no collectives)."""
    flops = FlopCounterMode(display=False)
    mem = MemoryTracker(device, top)
    mem.hold(*hold)
    base = mem.now
    n_calls = 0 if recorder is None else len(recorder.calls)
    with tally.counting() as counts, flops, mem:
        out = fn()
    calls = [] if recorder is None else recorder.calls[n_calls:]
    from repro_torch.launch.collectives import Recorder

    rec = Recorder(calls=list(calls))
    stats = TraceStats(
        matmul_flops=float(flops.get_total_flops()),
        contraction_flops=counts["contraction_flops"],
        analog_flops=counts["analog_flops"],
        analog_sites=int(counts["analog_sites"]),
        base_bytes=base,
        peak_bytes=mem.peak,
        largest=sorted(mem.largest, reverse=True),
        collective_counts=rec.counts(),
        collective_bytes=rec.result_bytes(),
        collective_link_bytes=rec.link_bytes(),
        collective_calls=rec.grouped(),
    )
    return out, stats


def meta_params(cfg):
    """The parameter tree of ``cfg`` on the meta device (the compute dtype,
    as ``lm.init_params`` makes it), allocating nothing."""
    from repro_torch.models import lm

    return lm.map_leaves(lambda _p, leaf: torch.empty(leaf.shape, dtype=cfg.compute_dtype,
                                                      device="meta"), lm.param_leaves(cfg))

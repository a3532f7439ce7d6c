"""Deterministic fault injection for the serving engine; port of
``repro/serving/faults.py`` (numpy only, so a plan's schedule is the
reference's event for event for the same seed and call order).

Deployed analog hardware fails in ways a digital stack does not: the noise
floor *drifts* as the device ages or heats, batches stall on a wedged
dispatch, and transient faults corrupt a row or kill a launch. The engine
owns every one of those sites (the noise operand it builds, the pool step
it dispatches, each tier call it makes), so faults are injected at the
engine's seams, never inside model code.

A :class:`FaultPlan` is the injection schedule. Explicit schedules name
exact injection points (the engine's fault clock for drift, stalls and
poison; a per-phase call counter for call faults), and the one
probabilistic knob draws from a seeded ``numpy`` generator, so the same
plan against the same traffic injects the same faults. Plans are stateful
(call counters, the log): use a fresh plan per run.

Sites:

``drift``
    A :class:`DriftRamp` mapping the engine's fault clock to a noise-scale
    factor ``d`` on every analog site's noise std, served as energies
    ``E / d**2`` through a 0-d tensor operand of every forward.

``exe_faults``
    ``(phase, n)`` pairs: the ``n``-th guarded call (0-based, counted per
    phase over the engine's life) of ``"prefill"``, ``"decode"`` or
    ``"insert"`` raises :class:`TransientExecutableFault` before any launch
    and before a cache is touched, so the engine can retry cleanly.

``stall_steps``
    Fault-clock steps at which a pool decode step is stuck: the engine
    skips the dispatch (optionally also sleeping ``stall_sleep_s``).

``poison``
    ``(clock, slot) -> token`` overrides of a decode step's emitted tokens;
    an out-of-vocab id models a corrupted readout row (per row: batch-mates
    are untouched).

Every injection is appended to ``plan.log``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class TransientExecutableFault(RuntimeError):
    """A prefill, decode or insert call transiently failed before dispatch.

    Carries the call's phase and its per-phase index so handlers and logs
    can name the exact injection point.
    """

    def __init__(self, phase: str, call_index: int, key=None):
        super().__init__(
            f"injected transient fault: {phase} call #{call_index}"
            + (f" (key={key!r})" if key is not None else "")
        )
        self.phase = phase
        self.call_index = call_index
        self.key = key


class QueueFull(RuntimeError):
    """Backpressure: the scheduler queue is at its high-water mark.

    Raised by ``submit`` instead of growing the queue without bound —
    callers shed load or retry later; nothing is silently dropped.
    (The precision governor raises it too, as its last rung: load is shed
    only once every queued request is already at its accuracy floor.)
    """


class BoundedLog(list):
    """An event log with list semantics and a ring-buffer bound.

    ``append`` keeps at most ``maxlen`` entries, evicting the oldest and
    counting evictions in ``dropped`` (optionally reporting each eviction
    batch through ``on_drop``) — long fault storms and policy episodes
    can't grow host memory without bound. It IS a ``list`` (equality,
    slicing, iteration all behave), so test assertions like
    ``engine.fault_log == []`` keep working; ``maxlen=None`` is an
    ordinary unbounded list with a drop counter pinned at zero.
    """

    def __init__(self, maxlen: Optional[int] = None, *, on_drop=None):
        super().__init__()
        if maxlen is not None and maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self.maxlen = maxlen
        self.on_drop = on_drop
        self.dropped = 0

    def append(self, item) -> None:
        if self.maxlen is not None and len(self) >= self.maxlen:
            n = len(self) - self.maxlen + 1
            del self[:n]
            self.dropped += n
            if self.on_drop is not None:
                self.on_drop(n)
        super().append(item)


@dataclasses.dataclass(frozen=True)
class DriftRamp:
    """Noise-scale drift schedule over the engine's fault clock.

    Scale is 1.0 before ``start``, then grows multiplicatively by
    ``rate`` per step, capped at ``max_scale``. ``rate=None`` is a step
    function: the scale jumps straight to ``max_scale`` at ``start``
    (the sharpest drift a watchdog can be asked to catch).
    """

    start: int
    rate: Optional[float] = 0.25
    max_scale: float = 2.0

    def scale_at(self, clock: int) -> float:
        if clock < self.start:
            return 1.0
        if self.rate is None:
            return float(self.max_scale)
        return float(min(self.max_scale, (1.0 + self.rate) ** (clock - self.start)))


class FaultPlan:
    """A deterministic, seedable injection schedule (see module docstring).

    Parameters
    ----------
    seed:
        Seeds the generator behind ``exe_fault_rate`` (the only stochastic
        knob); explicit schedules ignore it.
    drift:
        Optional :class:`DriftRamp`. ``noise_scale_at(clock)`` is 1.0
        without one.
    exe_faults:
        Iterable of ``(phase, nth_call)`` pairs — fail that phase's n-th
        executable invocation (0-based, counted across the engine's life).
    exe_fault_rate:
        Probability of failing any executable call, drawn from the seeded
        generator (deterministic given seed and call order). Composes with
        the explicit schedule.
    stall_steps:
        Fault-clock steps whose pool decode dispatch is stuck.
    stall_sleep_s:
        Optional real-time sleep per stalled step (wall-clock runs only;
        virtual-clock tests leave it 0).
    poison:
        Mapping ``(clock, slot) -> token`` (or an iterable of
        ``(clock, slot)`` pairs, poisoned with ``poison_token``) applied
        to the decode step's emitted tokens.
    poison_token:
        Token injected for iterable-form ``poison`` entries; out-of-vocab
        by default so the engine's row validation trips.
    """

    def __init__(
        self,
        *,
        seed: int = 0,
        drift: Optional[DriftRamp] = None,
        exe_faults: Iterable[Tuple[str, int]] = (),
        exe_fault_rate: float = 0.0,
        stall_steps: Iterable[int] = (),
        stall_sleep_s: float = 0.0,
        poison=(),
        poison_token: int = -1,
    ):
        if not 0.0 <= exe_fault_rate <= 1.0:
            raise ValueError(f"exe_fault_rate must be in [0, 1], got {exe_fault_rate}")
        self.seed = int(seed)
        self.drift = drift
        self.exe_faults = frozenset((str(p), int(n)) for p, n in exe_faults)
        self.exe_fault_rate = float(exe_fault_rate)
        self.stall_steps = frozenset(int(s) for s in stall_steps)
        self.stall_sleep_s = float(stall_sleep_s)
        if isinstance(poison, dict):
            self.poison_map: Dict[Tuple[int, int], int] = {
                (int(c), int(s)): int(t) for (c, s), t in poison.items()
            }
        else:
            self.poison_map = {
                (int(c), int(s)): int(poison_token) for c, s in poison
            }
        self._rng = np.random.default_rng(self.seed)
        self._calls: Dict[str, int] = {}
        #: every injection that actually fired, in order: dicts with a
        #: ``site`` field (drift is continuous, not logged per step)
        self.log: List[dict] = []

    # -- drift ---------------------------------------------------------------

    def noise_scale_at(self, clock: int) -> float:
        """Noise-std drift factor at a fault-clock step (1.0 = nominal)."""
        return 1.0 if self.drift is None else self.drift.scale_at(clock)

    # -- transient executable failures ---------------------------------------

    def check_executable(self, key) -> None:
        """Called by the engine's guard before every tier call (``key`` is
        the call's key, its phase first); raises
        :class:`TransientExecutableFault` at scheduled calls."""
        phase = key[0] if isinstance(key, tuple) and key else str(key)
        n = self._calls.get(phase, 0)
        self._calls[phase] = n + 1
        hit = (phase, n) in self.exe_faults
        if not hit and self.exe_fault_rate > 0.0:
            hit = bool(self._rng.random() < self.exe_fault_rate)
        if hit:
            self.log.append({"site": "executable", "phase": phase, "call": n})
            raise TransientExecutableFault(phase, n, key)

    # -- stuck batches -------------------------------------------------------

    def stalled(self, clock: int) -> bool:
        """True when the pool decode step at ``clock`` is stuck; the engine
        skips the dispatch (and this method sleeps ``stall_sleep_s``)."""
        if clock not in self.stall_steps:
            return False
        self.log.append({"site": "stall", "clock": clock})
        if self.stall_sleep_s > 0.0:
            import time

            time.sleep(self.stall_sleep_s)
        return True

    # -- poisoned rows -------------------------------------------------------

    def poison_rows(self, clock: int, tok: np.ndarray) -> List[int]:
        """Apply scheduled token overrides for ``clock`` in place; returns
        the poisoned slot indices (empty for an unscheduled step)."""
        slots = []
        for (c, s), t in self.poison_map.items():
            if c == clock and 0 <= s < tok.shape[0]:
                tok[s] = t
                slots.append(s)
                self.log.append({"site": "poison", "clock": c, "slot": s, "token": t})
        return slots


# ===========================================================================
# replica-level faults (cluster injection schedule, serving/cluster.py)
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class ReplicaFault:
    """One scheduled fault against a whole engine replica.

    ``replica`` is the ClusterRouter-assigned replica id; ``at`` is the
    round of the cluster's shared fault clock (one tick per
    ``ClusterRouter.pump_step``) at which the fault engages. Replica
    faults are declarative and deterministic like :class:`FaultPlan`
    schedules: the same fault list replayed against the same traffic
    produces the same failover episode event-for-event.
    """

    replica: int
    at: int

    def __post_init__(self):
        if self.replica < 0:
            raise ValueError(f"replica id must be >= 0, got {self.replica}")
        if self.at < 0:
            raise ValueError(f"fault round must be >= 0, got {self.at}")


@dataclasses.dataclass(frozen=True)
class ReplicaCrash(ReplicaFault):
    """Process death: from round ``at`` the replica never pumps again.

    Its queued and pooled requests are lost with it; new dispatches to it
    fail fast (the submit RPC has nobody listening). The router's health
    detector still has to *discover* the death through the stalled
    heartbeat — failover fires only when the detector declares the
    replica dead, never off this injection record."""


@dataclasses.dataclass(frozen=True)
class ReplicaHang(ReplicaFault):
    """A wedged pump loop: for ``steps`` rounds starting at ``at`` the
    replica's ``pump_step`` makes no progress, so its ``MetricsFeed``
    heartbeat stops advancing. A hang shorter than the detector's dead
    threshold must ride out as ``suspect`` and recover — the hysteresis
    the flap tests pin down."""

    steps: int = 4

    def __post_init__(self):
        super().__post_init__()
        if self.steps < 1:
            raise ValueError(f"hang steps must be >= 1, got {self.steps}")


@dataclasses.dataclass(frozen=True)
class ReplicaDegraded(ReplicaFault):
    """Sustained noise drift on one replica's analog array.

    From round ``at`` the replica serves at noise-scale ``scale`` (std
    multiplier; a runtime operand, never a retrace) and its feed carries
    the drift estimate a production watchdog would report. The router's
    detector quarantines the replica once the excursion outlasts its
    drift patience: queued work re-dispatches to nominal replicas, new
    traffic routes around it, and the cluster governor rebalances the
    power budget."""

    scale: float = 1.8

    def __post_init__(self):
        super().__post_init__()
        if self.scale <= 0.0 or self.scale == 1.0:
            raise ValueError(
                f"degraded scale must be > 0 and != 1.0 (nominal), "
                f"got {self.scale}"
            )

"""Noise-drift watchdog, load signals and the metrics feed; port of
``repro/serving/monitor.py``.

The engine's energy allocation was calibrated against a *nominal* noise
floor; deployed analog hardware drifts off it (temperature, aging). Drift is invisible to a digital health check: the kernels
still run, the tokens are still tokens, only the noise statistics moved.
The watchdog makes drift observable with the same machinery that
calibrated the model in the first place (core/calibrate.py): periodically
run a small *fixed* probe batch through the live analog config and compare
the residual RMS against a clean digital reference.

Because every noise model's std is proportional to ``1/sqrt(E)``
(core/noise.py Eqs. 9-11), the probe's residual RMS moves linearly (to
first order) with a global noise-scale drift factor — so

    estimate = rms(live energies) / rms(registered energies at attach)

is a direct estimate of the realized drift factor. The RMS averages over
``n_samples`` draws x every probe-batch element x the hidden dimension, so
the estimator is tight enough for a narrow band (a few percent) without
burning real probe energy.

A probe outside ``band`` raises a :class:`DriftEvent` (returned, not
thrown). The intended response loop is the engine's graceful-degradation
pair: ``engine.promote_tiers(event)`` serves new uniform-K traffic one
rung up the K ladder (repeats buy the drifted noise floor back at higher
energy), and ``engine.recalibrate()`` + ``watchdog.clear()`` return to
nominal once the hardware is re-trimmed.

Probing costs ``n_samples`` noisy forwards per interval (energies are
runtime arguments) and never touches the request stream.

The third surface here is the streaming observability feed
(:class:`MetricsFeed`): a bounded ring of per-pump-step samples — per-tier
token/decode counters, pool occupancy, queue depth, energy/token, drift
state, policy mode — with an optional JSONL sink. The engine samples it
once per pump/poll round (``ServingEngine(metrics=...)``). Tier
attribution rides the ``TierRegistry`` (serving/tiers.py): every tier in
the feed reports its own honest energy model and its ``drift_exempt``
flag, so a drift episode is attributable per tier — digital tiers ride
through it unpromoted and unconcerned.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.calibrate import noise_rms
from repro_torch.kernels.prng import PRNGKey, fold_in

__all__ = [
    "DriftEvent",
    "WatchdogConfig",
    "NoiseDriftWatchdog",
    "LoadSignals",
    "load_signals",
    "MetricsFeed",
]


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Probe cadence and detection band.

    ``interval``: probe every N watchdog steps (the caller decides what a
    step is — one ``pump_step``/``poll`` is the natural unit).
    ``n_samples``: noise draws averaged per probe (more = tighter
    estimate, linearly more probe compute).
    ``band``: (lo, hi) on the realized-scale estimate; outside -> event.
    The estimate is first-order in the true drift factor (noise propagates
    nonlinearly, compressing large factors toward 1), and small probe
    batches scatter a few percent — size the band to the probe, not to the
    drift you hope to see: the default comfortably detects a 1.5-2x drift
    while staying quiet at nominal even for tiny probe batches.
    """

    interval: int = 8
    n_samples: int = 4
    band: Tuple[float, float] = (0.7, 1.4)

    def __post_init__(self):
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")
        if not (0.0 < self.band[0] < 1.0 < self.band[1]):
            raise ValueError(
                f"band must straddle the nominal scale 1.0, got {self.band}"
            )


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """One out-of-band probe: the realized noise scale left calibration.

    ``clock`` is the engine's fault-clock step at the probe and
    ``residual_rms`` the triggering measurement (the probe's raw residual
    RMS, before dividing by the baseline) — the event lines up against
    stalls/timeouts/policy actions in the same ``fault_log``.
    """

    step: int  # watchdog step at which the probe fired
    probe_idx: int  # how many probes had run (0-based)
    estimate: float  # realized noise-scale estimate
    band: Tuple[float, float]
    clock: int = 0  # engine fault clock at the probe (attribution)
    residual_rms: float = 0.0  # the triggering measurement (raw probe RMS)


class NoiseDriftWatchdog:
    """Periodic realized-noise-scale estimation over a live engine.

    Attach once (computes the clean reference and the nominal-RMS
    baseline), then call
    :meth:`maybe_probe` from the serving loop. An active event is held
    until :meth:`clear` (the recalibration hook) — repeated out-of-band
    probes do not raise duplicate events, and ``estimates`` keeps the full
    probe trajectory.
    """

    def __init__(
        self,
        engine,
        tokens,
        *,
        config: WatchdogConfig = WatchdogConfig(),
        key=None,
    ):
        if engine.analog_cfg is None:
            raise ValueError("digital engine: no analog noise to watch")
        self.engine = engine
        self.config = config
        self.tokens = np.asarray(tokens, np.int32)
        if self.tokens.ndim != 2:
            raise ValueError(
                f"probe tokens must be (batch, seq), got {self.tokens.shape}"
            )
        self.key = key if key is not None else PRNGKey(0)
        self._x = torch.as_tensor(self.tokens, dtype=torch.long, device=engine.device)
        self._apply = engine.probe_apply()
        self._ref = engine.probe_reference(self._x)
        # nominal baseline at the *registered* energies: what a healthy
        # device's probe RMS looks like. Different key fold than the live
        # probes so baseline noise never cancels against a probe's.
        self._baseline = noise_rms(
            self._apply, engine.energies, self._x, self._ref,
            key=fold_in(self.key, 0xB43E),
            n_noise_samples=config.n_samples,
        )
        self._last_probe_step: Optional[int] = None
        self._n_probes = 0
        #: (step, realized-scale estimate) per probe, in order
        self.estimates: List[Tuple[int, float]] = []
        #: every event ever raised (active is the last un-cleared one)
        self.events: List[DriftEvent] = []
        self.active: Optional[DriftEvent] = None

    @property
    def baseline_rms(self) -> float:
        return self._baseline

    def probe(self, step: int = 0) -> Optional[DriftEvent]:
        """Run one probe now: estimate the realized noise scale through the
        engine's *effective* energies, record it, and return a new
        :class:`DriftEvent` when the estimate leaves the band (and no
        event is already active)."""
        rms = noise_rms(
            self._apply, self.engine.effective_energies(), self._x,
            self._ref, key=fold_in(self.key, self._n_probes),
            n_noise_samples=self.config.n_samples,
        )
        estimate = rms / self._baseline
        self.estimates.append((step, float(estimate)))
        self._n_probes += 1
        self._last_probe_step = step
        lo, hi = self.config.band
        if (estimate < lo or estimate > hi) and self.active is None:
            event = DriftEvent(
                step=step, probe_idx=self._n_probes - 1,
                estimate=float(estimate), band=(lo, hi),
                clock=int(getattr(self.engine, "_fault_clock", 0)),
                residual_rms=float(rms),
            )
            self.events.append(event)
            self.active = event
            return event
        return None

    def maybe_probe(self, step: int) -> Optional[DriftEvent]:
        """Probe when ``step`` has advanced ``config.interval`` past the
        last probe (first call always probes)."""
        if (
            self._last_probe_step is not None
            and step - self._last_probe_step < self.config.interval
        ):
            return None
        return self.probe(step)

    def clear(self) -> None:
        """Recalibration hook: drop the active event (probing continues)."""
        self.active = None


# ===========================================================================
# load / headroom signals (the precision governor's observation surface)
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class LoadSignals:
    """One observation of the engine's load and deadline headroom.

    The drift watchdog above watches the *noise* leave calibration; these
    signals watch the *load* leave capacity — together they are the
    monitoring surface the serving policy reacts to. All host-side reads,
    no dispatch: observing load never costs analog energy.

    ``queue_pressure`` is queue depth in units of one pool's slot capacity
    (batch-synchronous engines: the max batch) — 1.0 means a full pool's
    worth of work is waiting. ``urgent_frac`` is the fraction of queued
    SLO-carrying requests that have already burned over half their
    ``target_latency`` waiting — the p99-vs-deadline headroom signal: it
    climbs before deadlines start striking. ``min_slack`` is the tightest
    ``deadline - now`` over queued + pooled requests (``None`` without a
    clock or deadlines).

    ``drift`` is the latest realized-noise-scale estimate flowing through
    the engine's :class:`MetricsFeed` (``note_drift``), ``None`` when no
    feed is attached or no probe has run — it puts the *noise* axis on the
    same observation record as the load axes, so the precision governor
    can treat a hardware-health excursion as demote pressure with the
    identical registry-resolved retier path it uses for queue pressure.
    """

    clock: int  # engine fault clock at the observation
    queue_depth: int
    active: int  # occupied decode slots across live pools
    slots: int  # total decode slots across live pools (or max_batch)
    occupancy: float  # active / slots
    queue_pressure: float  # queue_depth / per-tier slot capacity
    min_slack: Optional[float]  # tightest deadline - now, None if unknowable
    urgent_frac: float  # queued SLO requests past half their latency budget
    drift: Optional[float] = None  # latest watchdog noise-scale estimate


def load_signals(engine, now: Optional[float] = None) -> LoadSignals:
    """Read the engine's current load/headroom signals (host-only)."""
    sched = engine.scheduler
    queued = sched.queued_requests()
    pooled = []
    for pool in engine.pools.values():
        for s in pool.active_slots():
            pooled.append(pool.record(s).request)
    unit = engine.pool_slots if engine.continuous else sched.max_batch
    slots = unit * max(1, len(engine.pools)) if engine.continuous else unit
    min_slack = None
    urgent = with_slo = 0
    if now is not None:
        slacks = [
            r.deadline - now for r in queued + pooled if r.deadline is not None
        ]
        if slacks:
            min_slack = float(min(slacks))
        for r in queued:
            if r.target_latency is not None:
                with_slo += 1
                if now - r.arrival >= 0.5 * r.target_latency:
                    urgent += 1
    feed = getattr(engine, "metrics", None)
    return LoadSignals(
        clock=int(getattr(engine, "_fault_clock", 0)),
        queue_depth=len(queued),
        active=len(pooled),
        slots=int(slots),
        occupancy=len(pooled) / max(1, slots),
        queue_pressure=len(queued) / max(1, unit),
        min_slack=min_slack,
        urgent_frac=urgent / with_slo if with_slo else 0.0,
        drift=None if feed is None else feed.drift_estimate,
    )


# ===========================================================================
# streaming observability: the per-tier metrics feed
# ===========================================================================


class MetricsFeed:
    """Bounded ring of per-pump-step serving samples with a JSONL sink.

    The engine calls :meth:`record` once per pump/poll round
    (``ServingEngine(metrics=MetricsFeed(...))``). Each sample is a plain
    JSON-ready dict: engine-level load (queue depth, in-flight, pool
    occupancy), drift state (noise scale, watchdog estimate, active
    promotion), policy mode, and a ``tiers`` block — one entry per tier
    that has served or pooled work, carrying cumulative tokens/decode-steps,
    the delta since the previous sample (divide by ``dt`` for tokens/s),
    pool occupancy, the tier's own honest energy/token, and its
    ``drift_exempt`` flag. Tier keys are stringified so samples round-trip
    through JSON unchanged. ``traces`` is the engine's ``trace_count``:
    the steps it built (each a CUDA graph on the card), flat once the
    traffic's shapes are warm.

    ``capacity`` bounds the in-memory ring (oldest samples drop);
    ``jsonl_path`` streams every sample as one JSON line (append mode,
    flushed per sample). The feed
    never dispatches device work: sampling is host-side reads only.

    ``replica_id`` names the engine replica this feed observes (set by
    the cluster's ``ClusterRouter`` when left unset;
    ``None`` for a standalone engine). Every sample also carries a
    monotone ``heartbeat_step`` — it advances exactly once per recorded
    sample, i.e. once per pump/poll round, so a reader that sees it stop
    is watching a crashed or wedged replica. Both are *additions*: every
    pre-existing sample field is unchanged, so old JSONL consumers keep
    working.
    """

    def __init__(self, capacity: int = 1024, jsonl_path=None, *,
                 replica_id: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.jsonl_path = None if jsonl_path is None else str(jsonl_path)
        self.replica_id = replica_id
        self._ring = deque(maxlen=self.capacity)
        self._fh = None
        self._step = 0
        self._heartbeat = 0
        self._drift_estimate: Optional[float] = None
        self._last_now: Optional[float] = None
        self._last_tokens: Dict[str, int] = {}

    @property
    def heartbeat_step(self) -> int:
        """Monotone liveness counter: the number of samples recorded so
        far. A replica whose heartbeat stops advancing between cluster
        rounds is stalled (crashed, hung, or partitioned) — the health
        detector's primary signal."""
        return self._heartbeat

    # -- drift attribution ---------------------------------------------------

    def note_drift(self, estimate: Optional[float]) -> None:
        """Feed the watchdog's latest realized-noise-scale estimate into
        subsequent samples (None clears it after recalibration)."""
        self._drift_estimate = None if estimate is None else float(estimate)

    @property
    def drift_estimate(self) -> Optional[float]:
        """The latest noted estimate (``load_signals``'s drift source)."""
        return self._drift_estimate

    # -- sampling ------------------------------------------------------------

    def record(self, engine, now: Optional[float] = None) -> dict:
        """Take one sample of the engine (host-side only) and append it to
        the ring (and the JSONL sink, when configured)."""
        sig = load_signals(engine, now)
        pools = engine.pools
        tier_ids = (
            set(engine.stats["tier_tokens"])
            | set(engine.stats["tier_decode_steps"])
            | set(pools)
        )
        tiers = {}
        for tid in tier_ids:
            key = str(tid)
            tokens = int(engine.stats["tier_tokens"].get(tid, 0))
            pool = pools.get(tid)
            try:
                tier_obj = engine.tiers.get(tid)
                energy = float(tier_obj.energy_per_token())
                exempt = bool(tier_obj.drift_exempt)
            except ValueError:
                energy, exempt = None, False  # unpriceable (pure digital)
            tiers[key] = {
                "tokens": tokens,
                "tokens_delta": tokens - self._last_tokens.get(key, 0),
                "decode_steps": int(
                    engine.stats["tier_decode_steps"].get(tid, 0)
                ),
                "pool_active": None if pool is None else pool.n_active,
                "pool_free": None if pool is None else pool.n_free,
                "energy_per_token_aj": energy,
                "drift_exempt": exempt,
            }
            self._last_tokens[key] = tokens
        governor = engine.governor
        self._heartbeat += 1
        sample = {
            "step": self._step,
            "clock": sig.clock,
            "now": None if now is None else float(now),
            "dt": (
                None if now is None or self._last_now is None
                else float(now - self._last_now)
            ),
            "queue_depth": sig.queue_depth,
            "in_flight": sig.queue_depth + sig.active,
            "pool_active": sig.active,
            "pool_slots": sig.slots,
            "occupancy": sig.occupancy,
            "queue_pressure": sig.queue_pressure,
            "urgent_frac": sig.urgent_frac,
            "policy_mode": None if governor is None else governor.mode,
            "noise_scale": float(engine.noise_scale),
            "drift_promoted": bool(engine.promoted),
            "drift_estimate": self._drift_estimate,
            "traces": int(engine.trace_count),
            "tokens_total": int(engine.stats["tokens_generated"]),
            "tiers": tiers,
            # replication fields (appended last: old JSONL consumers that
            # read the fields above see an unchanged schema)
            "replica_id": self.replica_id,
            "heartbeat_step": self._heartbeat,
        }
        self._step += 1
        if now is not None:
            self._last_now = float(now)
        self._ring.append(sample)
        if self.jsonl_path is not None:
            if self._fh is None:
                self._fh = open(self.jsonl_path, "a")
            self._fh.write(json.dumps(sample) + "\n")
            self._fh.flush()
        return sample

    # -- consumption ---------------------------------------------------------

    def samples(self) -> List[dict]:
        """The retained samples, oldest first (a copy)."""
        return list(self._ring)

    def tier_series(self, field: str) -> Dict[str, List]:
        """Per-tier time series of one tier field over the retained ring
        (e.g. ``tier_series("tokens")``)."""
        out: Dict[str, List] = {}
        for s in self._ring:
            for tid, rec in s["tiers"].items():
                out.setdefault(tid, []).append(rec.get(field))
        return out

    def __len__(self) -> int:
        return len(self._ring)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

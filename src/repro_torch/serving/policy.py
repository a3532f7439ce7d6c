"""SLA-aware precision governor: proactive overload policy over the K dial;
port of ``repro/serving/policy.py`` (pure Python).

The paper's central claim is that analog precision is a *runtime* dial —
repeat-and-average K trades accuracy against energy and throughput on the
fly. Deadlines, ``max_queue`` backpressure and drift-driven K promotion
are the reactive half of graceful degradation; this module is the
proactive half: a policy layer that *uses* the dial to keep SLOs under
load.

The :class:`PrecisionGovernor` closes the loop from observed load
(``serving/monitor.load_signals``: queue depth, pool occupancy,
deadline-headroom urgency) to the tier of every *queued* request:

``nominal -> demoted``
    Under pressure, each admissible queued request is **demoted** to the
    cheapest registered tier that still satisfies its ``accuracy_floor``
    (tier accuracy metadata comes from ``core/search.py`` evals, carried
    on :class:`~repro_torch.core.profile.PrecisionProfile` or passed as
    :class:`TierSpec`). Cheaper tiers decode at lower energy/token — on
    time-redundant analog hardware that is directly more throughput, so
    demotion drains the queue instead of letting deadlines burn.

``demoted -> shedding``
    Load shedding is the LAST rung: only once every queued request is
    already at its floor (demotion headroom exhausted) and pressure keeps
    climbing does ``submit`` start rejecting new traffic with
    :class:`~repro_torch.serving.faults.QueueFull`.

``-> back``
    When the queue drains the governor **promotes** still-queued demoted
    requests back to their original tiers and returns to nominal.

Two properties make the policy servable:

* **Hysteresis + min-dwell.** The demote threshold sits above the promote
  threshold (a band, not a line) and every mode transition must dwell
  ``min_dwell`` policy steps — the governor never oscillates
  demote->promote within a dwell window (asserted by a property test).
* **Registered tiers only.** Demotion picks among tiers named in the
  :class:`PolicyConfig` table, all resolved up front through the
  engine's tier registry.

An optional engine-level **power budget** (``power_budget_aj``, an
energy/token ceiling priced by ``engine.tier_energy_per_token``) adds
demote pressure independent of queue depth, and blocks promotion while
restoring original tiers would overrun the ceiling.

Requests already decoding in a pool keep their tier: their noise keys and
compiled executables are bound at admission, so the dial only turns on
queued work (which is exactly where overload lives).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.monitor import load_signals
from repro_torch.serving.scheduler import Request

__all__ = ["TierSpec", "PolicyConfig", "PolicyEvent", "PrecisionGovernor"]

NOMINAL = "nominal"
DEMOTED = "demoted"
SHEDDING = "shedding"

#: PolicyEvent kinds that are mode transitions (dwell-gated); "retier" is
#: the in-mode sweep that folds newly queued traffic into a running episode
TRANSITIONS = ("demote", "promote", "shed_on", "shed_off")


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One rung of the governor's precision ladder.

    ``tier`` is a uniform K int or a registered profile id. ``accuracy``
    is the tier's measured accuracy proxy (a ``core/search.py`` /
    ``core/calibrate.py`` eval); ``None`` reads it off the registered
    profile's ``accuracy`` metadata.
    """

    tier: object
    accuracy: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Governor knobs: the tier ladder, hysteresis band, dwell, budget.

    ``pressure`` is the governor's scalar load signal:
    ``queue_depth / pool_slots + urgency_weight * urgent_frac`` where
    ``urgent_frac`` is the fraction of queued SLO requests that have burned
    over half their latency budget waiting (see ``monitor.load_signals``).

    ``promote_at < demote_at <= shed_at`` is the hysteresis band: demote
    when pressure rises past ``demote_at``, promote back only once it has
    fallen below ``promote_at``, shed (reject new traffic) only past
    ``shed_at`` *and* with demotion headroom exhausted. ``min_dwell`` is
    the minimum number of policy steps between mode transitions — the
    anti-flapping floor.

    ``power_budget_aj``: optional energy/token ceiling (aJ, same unit as
    ``engine.tier_energy_per_token``) over the blended spend of queued +
    in-flight requests; exceeding it is demote pressure on its own, and
    promotion is blocked while restoring original tiers would overrun it.

    ``drift_band``: optional (lo, hi) band on the noise-drift estimate the
    engine's :class:`~repro_torch.serving.monitor.MetricsFeed` carries
    (``load_signals(...).drift``). A drifted device delivers less
    effective precision per unit energy, so *sustained* out-of-band drift
    — at least ``drift_patience`` consecutive policy steps — is demote
    pressure exactly like queue load, firing the same registry-resolved
    retier path; promotion back to nominal is blocked while the excursion
    persists. ``None`` estimates (no feed / no probe yet) never count
    toward the streak. Set the band at least as wide as the watchdog's
    probe band: the estimate scatters a few percent at nominal.
    """

    tiers: Tuple[TierSpec, ...]
    demote_at: float = 1.5
    promote_at: float = 0.25
    shed_at: float = 3.0
    min_dwell: int = 4
    urgency_weight: float = 1.0
    power_budget_aj: Optional[float] = None
    drift_band: Optional[Tuple[float, float]] = None
    drift_patience: int = 2

    def __post_init__(self):
        # convenience: bare tier ids (ints / profile names) become TierSpecs
        specs = tuple(
            t if isinstance(t, TierSpec) else TierSpec(t) for t in self.tiers
        )
        object.__setattr__(self, "tiers", specs)
        if not specs:
            raise ValueError("policy needs at least one tier to govern")
        if not 0.0 <= self.promote_at < self.demote_at <= self.shed_at:
            raise ValueError(
                "hysteresis band must satisfy 0 <= promote_at < demote_at "
                f"<= shed_at, got ({self.promote_at}, {self.demote_at}, "
                f"{self.shed_at})"
            )
        if self.min_dwell < 1:
            raise ValueError(f"min_dwell must be >= 1, got {self.min_dwell}")
        if self.urgency_weight < 0.0:
            raise ValueError(
                f"urgency_weight must be >= 0, got {self.urgency_weight}"
            )
        if self.power_budget_aj is not None and self.power_budget_aj <= 0.0:
            raise ValueError(
                f"power_budget_aj must be > 0, got {self.power_budget_aj}"
            )
        if self.drift_band is not None and not (
            0.0 < self.drift_band[0] < 1.0 < self.drift_band[1]
        ):
            raise ValueError(
                "drift_band must straddle the nominal scale 1.0, got "
                f"{self.drift_band}"
            )
        if self.drift_patience < 1:
            raise ValueError(
                f"drift_patience must be >= 1, got {self.drift_patience}"
            )


@dataclasses.dataclass(frozen=True)
class PolicyEvent:
    """One governor action, attributable across logs and dashboards.

    Carries the engine's fault-clock step (``clock``) and the triggering
    measurement (``pressure`` with its ``queue_depth``/``occupancy``
    inputs) so a policy episode lines up against drift events, stalls and
    timeouts in the same ``fault_log``. ``uids`` are the requests retiered
    by this action (empty for pure mode flips).
    """

    kind: str  # "demote" | "retier" | "promote" | "shed_on" | "shed_off"
    step: int  # governor policy step (one per engine pump/poll round)
    clock: int  # engine fault clock at the observation
    pressure: float  # the triggering measurement
    queue_depth: int
    occupancy: float
    moved: int = 0
    uids: Tuple[int, ...] = ()
    detail: str = ""


class PrecisionGovernor:
    """SLA-aware precision policy over a live engine (see module docstring).

    Built by the engine from ``ServingEngine(policy=PolicyConfig(...))``;
    the engine calls :meth:`step` once per pump/poll round and consults
    :attr:`shedding` in ``submit``. All state is host-side and
    deterministic: the same traffic and clock readings replay the same
    episode event-for-event.
    """

    def __init__(self, engine, config: PolicyConfig):
        if engine.analog_cfg is None:
            raise ValueError(
                "policy governor needs an analog engine: precision is the "
                "dial it turns (digital serving has no energy/accuracy "
                "tradeoff to govern)"
            )
        self.engine = engine
        self.config = config
        table = []
        for spec in config.tiers:
            tier = spec.tier
            acc = spec.accuracy
            # every target resolves through the engine's TierRegistry: the
            # ladder may span analog K / profile tiers and registered
            # digital tiers
            try:
                tier_obj = engine.tiers.get(tier)
            except ValueError as e:
                raise ValueError(
                    f"policy tier {tier!r} is not a registered profile or "
                    "tier; demotion must pick among already-registered "
                    "tiers"
                ) from e
            tier = tier_obj.tier_id
            if acc is None:
                acc = tier_obj.accuracy
            if acc is None:
                raise ValueError(
                    f"policy tier {tier!r} has no accuracy metadata: pass "
                    "TierSpec(tier, accuracy=...) or register the tier "
                    "with accuracy= from a core/search.py eval — floors "
                    "can't be enforced against an unmeasured tier"
                )
            table.append(
                (float(engine.tier_energy_per_token(tier)), float(acc), tier)
            )
        # the demotion ladder: (energy/token, accuracy, tier) cheapest
        # first — the registry's floor-ordered ladder, priced per tier
        table.sort(key=lambda row: (row[0], str(row[2])))
        self._table: Tuple[Tuple[float, float, object], ...] = tuple(table)
        self.mode = NOMINAL
        self._step = 0
        # allow an immediate first transition: dwell gates *re*-transitions
        self._last_change = -int(config.min_dwell)
        #: runtime override of the config's power budget (aJ/token), set
        #: by a cluster-level governor rebalancing budget across replicas
        self._budget_override: Optional[float] = None
        #: uid -> original tier of every currently-demoted queued request
        self._demoted: Dict[int, object] = {}
        #: consecutive policy steps with an out-of-band drift estimate
        self._drift_streak = 0
        #: every PolicyEvent ever emitted, in order (bench/test surface)
        self.events: List[PolicyEvent] = []

    # -- tier metadata -------------------------------------------------------

    @property
    def shedding(self) -> bool:
        """True while ``submit`` must reject new traffic (the last rung)."""
        return self.mode == SHEDDING

    @property
    def tiers(self) -> Tuple[Tuple[float, float, object], ...]:
        """The resolved ladder: (energy/token aJ, accuracy, tier), cheapest
        first (read-only)."""
        return self._table

    def tier_accuracy(self, tier) -> float:
        for _e, acc, t in self._table:
            if t == tier:
                return acc
        raise ValueError(
            f"tier {tier!r} is not in the policy table "
            f"{[t for _e, _a, t in self._table]}"
        )

    def tier_energy(self, tier) -> float:
        return float(self.engine.tier_energy_per_token(tier))

    @property
    def power_budget_aj(self) -> Optional[float]:
        """The energy/token ceiling currently in force: the runtime
        override (a cluster governor's rebalanced share) when set, else
        the config's static budget."""
        if self._budget_override is not None:
            return self._budget_override
        return self.config.power_budget_aj

    def set_power_budget(self, aj: Optional[float]) -> None:
        """Override the power budget at runtime (``None`` restores the
        config's static value). The cluster-level governor calls this
        when it rebalances the global budget across replicas — e.g. after
        a replica death shifts load, or to lend headroom to a replica
        that demoted. Takes effect at the next policy step (the budget is
        host-side policy state)."""
        if aj is not None and aj <= 0.0:
            raise ValueError(f"power budget must be > 0 aJ/token, got {aj}")
        self._budget_override = None if aj is None else float(aj)

    def cheapest_admissible(self, req: Request):
        """The cheapest policy tier strictly cheaper than the request's
        current tier that still satisfies its accuracy floor, or ``None``
        when the request has no demotion headroom left. A floorless
        request may ride all the way down the ladder."""
        floor = -float("inf") if req.accuracy_floor is None else req.accuracy_floor
        cur_e = self.tier_energy(req.tier)
        for e, acc, tier in self._table:
            if e < cur_e and acc >= floor:
                return tier
        return None

    # -- load / budget signals -----------------------------------------------

    def _live_requests(self) -> List[Request]:
        reqs = list(self.engine.scheduler.queued_requests())
        for pool in self.engine.pools.values():
            for s in pool.active_slots():
                reqs.append(pool.record(s).request)
        return reqs

    def blended_energy(self, *, restore: bool = False) -> float:
        """Mean energy/token over queued + in-flight requests — the
        engine's current spend rate. ``restore=True`` prices demoted
        requests at their *original* tiers (the promotion-feasibility
        check against the power budget)."""
        reqs = self._live_requests()
        if not reqs:
            return 0.0
        total = 0.0
        for r in reqs:
            tier = self._demoted.get(r.uid, r.tier) if restore else r.tier
            total += self.tier_energy(tier)
        return total / len(reqs)

    def _over_budget(self, *, restore: bool = False) -> bool:
        budget = self.power_budget_aj
        return budget is not None and self.blended_energy(restore=restore) > budget

    def _drift_sustained(self, sig) -> bool:
        """Update the out-of-band streak from this step's observation and
        report whether the excursion has outlasted ``drift_patience``.
        Missing estimates (no feed attached, no probe yet, or cleared by
        recalibration) reset the streak: absence of evidence is nominal."""
        band = self.config.drift_band
        if band is None:
            return False
        d = sig.drift
        if d is not None and not (band[0] <= d <= band[1]):
            self._drift_streak += 1
        else:
            self._drift_streak = 0
        return self._drift_streak >= self.config.drift_patience

    def _headroom_exhausted(self) -> bool:
        """True when no queued request can be demoted any further — the
        precondition for shedding (reject only as the last rung)."""
        return all(
            self.cheapest_admissible(r) is None
            for r in self.engine.scheduler.queued_requests()
        )

    # -- the policy step ------------------------------------------------------

    def _demote_assign(self, req: Request):
        return self.cheapest_admissible(req)

    def _promote_assign(self, req: Request):
        orig = self._demoted.get(req.uid)
        if orig is None or orig == req.tier:
            return None
        return orig

    def _demote_sweep(self):
        moved = self.engine.scheduler.reassign(self._demote_assign)
        for r, old, _new in moved:
            # keep the *first* original across repeated demotions so
            # promotion retraces the request's own ask, not a midpoint
            self._demoted.setdefault(r.uid, old)
        return moved

    def step(self, now: Optional[float] = None) -> List[PolicyEvent]:
        """One policy evaluation: observe load, maybe turn the dial.

        Called by the engine once per ``pump_step``/``poll`` round.
        Returns the events fired this step (also appended to
        :attr:`events` and the engine's ``fault_log``).
        """
        cfg = self.config
        sig = load_signals(self.engine, now)
        pressure = sig.queue_pressure + cfg.urgency_weight * sig.urgent_frac
        step = self._step
        self._step += 1
        fired: List[PolicyEvent] = []

        def emit(kind: str, moved=(), detail: str = "") -> PolicyEvent:
            ev = PolicyEvent(
                kind=kind, step=step, clock=sig.clock,
                pressure=float(pressure), queue_depth=sig.queue_depth,
                occupancy=sig.occupancy, moved=len(moved),
                uids=tuple(r.uid for r, _old, _new in moved), detail=detail,
            )
            self.events.append(ev)
            fired.append(ev)
            entry = dataclasses.asdict(ev)
            entry["policy_kind"] = entry.pop("kind")
            entry["kind"] = "policy"
            self.engine.fault_log.append(entry)
            return ev

        can_flip = (step - self._last_change) >= cfg.min_dwell
        over = self._over_budget()
        drifted = self._drift_sustained(sig)
        stats = self.engine.stats
        if self.mode == NOMINAL:
            if can_flip and (pressure >= cfg.demote_at or over or drifted):
                moved = self._demote_sweep()
                self.mode = DEMOTED
                self._last_change = step
                stats["demoted"] += len(moved)
                stats["policy_transitions"] += 1
                if pressure >= cfg.demote_at:
                    detail = "load"
                elif over:
                    detail = "power budget"
                else:
                    detail = "drift"
                emit("demote", moved, detail=detail)
        elif self.mode == DEMOTED:
            if can_flip and pressure >= cfg.shed_at and self._headroom_exhausted():
                self.mode = SHEDDING
                self._last_change = step
                stats["policy_transitions"] += 1
                emit("shed_on", detail="demotion headroom exhausted")
            elif (
                can_flip
                and pressure <= cfg.promote_at
                and not drifted
                and not self._over_budget(restore=True)
            ):
                moved = self.engine.scheduler.reassign(self._promote_assign)
                self._demoted.clear()
                self.mode = NOMINAL
                self._last_change = step
                stats["promoted_back"] += len(moved)
                stats["policy_transitions"] += 1
                emit("promote", moved)
            else:
                # the episode is live: newly queued traffic joins it
                moved = self._demote_sweep()
                if moved:
                    stats["demoted"] += len(moved)
                    emit("retier", moved)
        else:  # SHEDDING
            if can_flip and pressure <= cfg.demote_at:
                self.mode = DEMOTED
                self._last_change = step
                stats["policy_transitions"] += 1
                emit("shed_off")
            else:
                moved = self._demote_sweep()  # bounded fault requeues, etc.
                if moved:
                    stats["demoted"] += len(moved)
                    emit("retier", moved)
        return fired

"""Replicated serving cluster: health-checked failover with bit-identical
request re-dispatch; port of ``repro/serving/cluster.py``.

A single :class:`~repro_torch.serving.engine.ServingEngine` survives
drift, stalls, transient faults and overload. A deployment runs many
engine replicas, and a dead or wedged replica takes its queued and
in-flight requests with it. This module is the cluster layer: a
:class:`ClusterRouter` fronting N data-parallel replicas with health
checking, exactly-once-equivalent failover, hedged dispatch, and a
cluster-level power-budget governor. On one card the replicas are
separate engines over one set of weight tensors (the engine never
writes its ``params``), so the cluster holds one copy of the weights
plus each replica's caches.

The whole design leans on one property of the engine: **every request
carries its own stacked PRNG key**, so its token
stream depends only on (prompt, tier, key, noise scale) — never on which
replica, slot, batch-mates or padding served it. Failover is therefore
cheap and *verifiable*: re-dispatching a failed request to any nominal
replica reproduces bit-identical tokens, the already-streamed prefix can
be asserted equal and deduped (never re-emitted), and a hedged duplicate
is provably identical to its primary, which is what makes cancelling the
loser safe.

The pieces:

**Health checking.** Each replica's :class:`~repro_torch.serving.monitor.
MetricsFeed` carries a ``replica_id`` and a monotone ``heartbeat_step``
that advances once per pump round. The router's detector drives a
``healthy -> suspect -> dead`` machine off that heartbeat with hysteresis:
``suspect_after`` stalled rounds raise suspicion (new dispatches route
around the replica), ``dead_after`` stalled rounds declare death
(terminal; failover fires), and a suspect replica must heartbeat for
``recover_after`` consecutive rounds before it is healthy again — a
transient stall never flaps the detector. The feed's drift-estimate
series drives a parallel ``healthy -> degraded`` edge: a drift excursion
outside ``drift_band`` sustained for ``drift_patience`` rounds
quarantines the replica (its *queued* work re-dispatches to nominal
replicas, whose noise scale still matches the request's solo run; its
pooled rows finish where they are, honestly drift-tinted).

**Failover.** The router journals every request at submission: cluster
uid, prompt, tier ask, PRNG key, SLO fields, and — refreshed every round
from the serving replica's pool records — the tokens emitted so far (the
streamed prefix). When the detector declares a replica dead, its queued
and pooled requests re-dispatch to healthy replicas after a bounded,
seedable backoff (one jittered delay per failover event, so journal
replay re-enters the target queues in arrival order and never reorders a
tier's FIFO). The re-served stream is checked bit-identical against the
journaled prefix; only the suffix is newly delivered (``dedup_tokens``
counts what re-serving regenerated but never re-emitted). Re-dispatches
are bounded by ``max_redispatch``; exhaustion surfaces as a structured
:class:`~repro_torch.serving.engine.Failed`, never a lost request.

**Hedged dispatch.** A deadline-urgent request (slack below
``hedge_slack``, or ``submit(..., hedge=True)``) is additionally
submitted to a second healthy replica with the *same* key. First
finisher wins; the loser is cancelled (queued or mid-decode — per-request
keys make retiring a pool row safe) or, if it outruns cancellation, its
result is discarded after an identity check. A hedge whose primary dies
is promoted to primary on the spot: failover without re-dispatch.

**Cluster governor.** With ``power_budget_aj`` set, a thin coordinator
splits the global energy/token ceiling across the live replicas' own
:class:`~repro_torch.serving.policy.PrecisionGovernor`s (via their runtime
``set_power_budget`` override) and rebalances when membership changes or
a replica's governor demotes — lending headroom to the replica under
energy pressure while the load-weighted mean ceiling stays at the global
budget. Demote-before-shed
ordering is preserved per replica by the engine governor itself.

Everything here is host-side and deterministic: the same engines, traffic,
fault schedule and clock readings replay the same episode event-for-event.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels.prng import PRNGKey, fold_in
from repro_torch.serving.engine import Failed, RequestFailure, ServingEngine
from repro_torch.serving.faults import (
    BoundedLog,
    QueueFull,
    ReplicaCrash,
    ReplicaDegraded,
    ReplicaFault,
    ReplicaHang,
)
from repro_torch.serving.monitor import MetricsFeed

__all__ = [
    "ClusterGovernor",
    "ClusterRouter",
    "RequestJournalEntry",
    "DEAD",
    "DEGRADED",
    "HEALTHY",
    "SUSPECT",
]

#: replica health states. DEAD is terminal (a restarted process would
#: join as a *new* replica); DEGRADED and SUSPECT recover with hysteresis.
HEALTHY = "healthy"
SUSPECT = "suspect"
DEGRADED = "degraded"
DEAD = "dead"


@dataclasses.dataclass
class RequestJournalEntry:
    """Everything needed to re-dispatch one request bit-identically.

    The key fields are the determinism lever: ``key`` is the request's
    PRNG key, minted by the *router* (``fold_in(base_key, cuid)``) so it
    is independent of any replica's uid counter — the same (prompt, tier,
    key) served anywhere at nominal noise reproduces the same tokens.
    ``delivered`` is the streamed prefix, refreshed every round from the
    serving replica's pool records; on failover it is the dedup baseline
    the re-served stream is verified against. ``deadline`` is resolved to
    an absolute timestamp at first submission so a re-dispatch never
    extends the request's SLO.
    """

    cuid: int
    tokens: np.ndarray
    tier: object  # the submit-time ask, engine-agnostic (id / profile / tier)
    key: object  # raw (2,) uint32 key — replica-independent request identity
    max_new_tokens: Optional[int]
    stop_tokens: Tuple[int, ...]
    arrival: float
    deadline: Optional[float] = None
    target_latency: Optional[float] = None
    accuracy_floor: Optional[float] = None
    #: current primary assignment (replica id, engine-local uid)
    replica: Optional[int] = None
    engine_uid: Optional[int] = None
    #: live hedge assignment, if any
    hedge_replica: Optional[int] = None
    hedge_uid: Optional[int] = None
    #: tokens already streamed to the client (never re-emitted)
    delivered: List[int] = dataclasses.field(default_factory=list)
    attempts: int = 0  # dispatches so far (1 = primary only)
    retry_at: Optional[int] = None  # cluster round of the pending re-dispatch
    failed_over: bool = False
    hedged: bool = False
    done: bool = False


class _Replica:
    """Router-side handle on one engine replica: feed, detector state,
    and the engine-uid -> cluster-uid mapping for its live requests."""

    def __init__(self, rid: int, engine: ServingEngine):
        self.rid = rid
        self.engine = engine
        feed = engine.metrics
        if feed is None:
            feed = MetricsFeed(capacity=4096, replica_id=rid)
            engine.metrics = feed
        elif getattr(feed, "replica_id", None) is None:
            feed.replica_id = rid
        self.feed = feed
        self.state = HEALTHY
        self.last_heartbeat = int(feed.heartbeat_step)
        self.stalled_rounds = 0  # consecutive rounds without a heartbeat
        self.ok_rounds = 0  # consecutive rounds WITH one (recovery evidence)
        self.drift_rounds = 0  # consecutive out-of-band drift estimates
        self.inband_rounds = 0  # consecutive nominal estimates (recovery)
        self.crashed = False  # injection ground truth; detection is separate
        self.hang_until = -1  # injection: pump wedged while round < this
        self.injected_drift: Optional[float] = None
        self.uids: Dict[int, int] = {}  # engine uid -> cluster uid
        self.dispatched = 0  # router dispatches to this replica (tiebreak)

    @property
    def servable(self) -> bool:
        """Accepts new dispatches: only fully-healthy replicas do. A
        crashed replica's submit RPC fails fast (nobody listening), so
        the router skips it even before the detector declares death."""
        return self.state == HEALTHY and not self.crashed

    @property
    def alive(self) -> bool:
        """Still pumped by the router (its process exists)."""
        return not self.crashed and self.state != DEAD


class ClusterGovernor:
    """Splits a global power budget across replica precision governors.

    ``power_budget_aj`` is the cluster's energy/token ceiling — an
    *intensive* quantity, so the split preserves the mean: with every
    live replica nominal each gets the global ceiling; when one demotes
    (its governor left nominal — it is starving for energy headroom) the
    rebalance lends it headroom from the others while the weighted mean
    stays at the budget. Re-splits fire only when the live set or the
    demoted set changes, each one logged as a ``rebalance`` event.
    """

    def __init__(self, router: "ClusterRouter", power_budget_aj: float):
        if power_budget_aj <= 0.0:
            raise ValueError(
                f"power_budget_aj must be > 0, got {power_budget_aj}"
            )
        self.router = router
        self.power_budget_aj = float(power_budget_aj)
        self._last_key = None
        #: the current per-replica ceilings (rid -> aJ/token)
        self.split: Dict[int, float] = {}

    def _governed(self) -> List[_Replica]:
        return [
            h for h in self.router.replicas
            if h.alive and h.state in (HEALTHY, SUSPECT)
            and h.engine.governor is not None
        ]

    def step(self, rnd: int) -> None:
        live = self._governed()
        demoted = tuple(
            sorted(h.rid for h in live if h.engine.governor.mode != "nominal")
        )
        key = (tuple(h.rid for h in live), demoted)
        if key == self._last_key or not live:
            self._last_key = key if live else self._last_key
            return
        self._last_key = key
        # weight 2 for a demoted replica, 1 otherwise; ceilings scaled so
        # the unweighted mean across live replicas stays at the budget
        weights = {
            h.rid: 2.0 if h.engine.governor.mode != "nominal" else 1.0
            for h in live
        }
        total = sum(weights.values())
        self.split = {
            rid: self.power_budget_aj * w * len(live) / total
            for rid, w in weights.items()
        }
        for h in live:
            h.engine.governor.set_power_budget(self.split[h.rid])
        self.router.stats["rebalances"] += 1
        self.router._event(
            "rebalance", round=rnd,
            reason="demotion" if demoted else "membership",
            demoted=list(demoted),
            split={rid: round(v, 3) for rid, v in self.split.items()},
        )


class ClusterRouter:
    """N data-parallel ``ServingEngine`` replicas behind one submit/pump
    surface, with health-checked failover (see module docstring).

    Every engine must be continuous (``pump_step`` is the cluster's unit
    of progress) and the replicas are assumed interchangeable: same
    params, model config, analog config and energy tree — the premise
    under which a re-dispatched request is bit-identical. Each replica
    gets (or brings) a :class:`MetricsFeed`; the router stamps its
    ``replica_id``.

    ``faults`` is the deterministic replica-fault schedule
    (:class:`ReplicaCrash` / :class:`ReplicaHang` /
    :class:`ReplicaDegraded`), applied on the router's shared fault clock
    — one tick per :meth:`pump_step`.
    """

    def __init__(
        self,
        engines: Sequence[ServingEngine],
        *,
        seed: int = 0,
        suspect_after: int = 2,
        dead_after: int = 5,
        recover_after: int = 2,
        drift_band: Tuple[float, float] = (0.7, 1.4),
        drift_patience: int = 3,
        hedge_slack: Optional[float] = None,
        max_redispatch: int = 2,
        backoff_rounds: int = 1,
        backoff_jitter: int = 2,
        power_budget_aj: Optional[float] = None,
        faults: Sequence[ReplicaFault] = (),
        event_log_maxlen: Optional[int] = 4096,
    ):
        engines = list(engines)
        if not engines:
            raise ValueError("a cluster needs at least one engine replica")
        for i, eng in enumerate(engines):
            if not eng.continuous:
                raise ValueError(
                    f"replica {i} is not continuous: the cluster pumps "
                    "replicas round-by-round (construct engines with "
                    "continuous=True)"
                )
        if suspect_after < 1:
            raise ValueError(f"suspect_after must be >= 1, got {suspect_after}")
        if dead_after <= suspect_after:
            raise ValueError(
                "dead_after must exceed suspect_after (the hysteresis "
                f"window), got {dead_after} <= {suspect_after}"
            )
        if recover_after < 1:
            raise ValueError(f"recover_after must be >= 1, got {recover_after}")
        if not (0.0 < drift_band[0] < 1.0 < drift_band[1]):
            raise ValueError(
                f"drift_band must straddle the nominal scale 1.0, got {drift_band}"
            )
        if drift_patience < 1:
            raise ValueError(f"drift_patience must be >= 1, got {drift_patience}")
        if hedge_slack is not None and hedge_slack <= 0.0:
            raise ValueError(f"hedge_slack must be > 0, got {hedge_slack}")
        if max_redispatch < 0:
            raise ValueError(f"max_redispatch must be >= 0, got {max_redispatch}")
        if backoff_rounds < 0 or backoff_jitter < 0:
            raise ValueError("backoff_rounds/backoff_jitter must be >= 0")
        for f in faults:
            if not isinstance(f, ReplicaFault):
                raise TypeError(f"expected a ReplicaFault, got {type(f)!r}")
            if not 0 <= f.replica < len(engines):
                raise ValueError(
                    f"fault {f!r} names replica {f.replica} but the cluster "
                    f"has {len(engines)}"
                )
        self.replicas = [_Replica(i, eng) for i, eng in enumerate(engines)]
        self.suspect_after = int(suspect_after)
        self.dead_after = int(dead_after)
        self.recover_after = int(recover_after)
        self.drift_band = (float(drift_band[0]), float(drift_band[1]))
        self.drift_patience = int(drift_patience)
        self.hedge_slack = None if hedge_slack is None else float(hedge_slack)
        self.max_redispatch = int(max_redispatch)
        self.backoff_rounds = int(backoff_rounds)
        self.backoff_jitter = int(backoff_jitter)
        self._base_key = PRNGKey(seed)
        self._rng = np.random.default_rng(seed)  # backoff jitter (seedable)
        self._faults = sorted(faults, key=lambda f: (f.at, f.replica))
        self._faults_applied = 0
        self._round = 0  # the cluster's shared fault clock
        self._cuid = 0
        self.journal: Dict[int, RequestJournalEntry] = {}
        self.results: Dict[int, object] = {}
        self.events: List[dict] = BoundedLog(maxlen=event_log_maxlen)
        self.governor: Optional[ClusterGovernor] = None
        if power_budget_aj is not None:
            self.governor = ClusterGovernor(self, power_budget_aj)
        self.stats = {
            "submitted": 0,
            "delivered": 0,  # requests finished with tokens
            "failed": 0,  # structured cluster-level failures
            "dispatches": 0,  # engine submissions (incl. re-dispatches)
            "redispatched": 0,  # journal replays onto another replica
            "failed_over": 0,  # requests orphaned by a death
            "quarantined": 0,  # queued requests pulled off a degraded replica
            "hedges": 0,  # backup submissions placed
            "hedge_wins_primary": 0,
            "hedge_wins_backup": 0,
            "hedge_cancelled": 0,  # losers withdrawn before finishing
            "hedge_promoted": 0,  # hedges promoted to primary by a death
            "duplicates_discarded": 0,  # loser results dropped after the fact
            "dedup_tokens": 0,  # re-served tokens verified + never re-emitted
            "prefix_mismatches": 0,  # determinism violations (must stay 0)
            "replicas_dead": 0,
            "replicas_degraded": 0,
            "rebalances": 0,
        }

    # -- introspection -------------------------------------------------------

    @property
    def round(self) -> int:
        """The shared fault clock: pump rounds completed."""
        return self._round

    @property
    def n_in_flight(self) -> int:
        """Journaled requests not yet resolved (on any replica or awaiting
        re-dispatch)."""
        return sum(1 for e in self.journal.values() if not e.done)

    @property
    def health(self) -> Dict[int, str]:
        """Replica id -> current detector state."""
        return {h.rid: h.state for h in self.replicas}

    def replica(self, rid: int) -> _Replica:
        return self.replicas[rid]

    def replica_stats(self) -> List[dict]:
        """Per-replica serving summary (bench/artifact surface)."""
        out = []
        for h in self.replicas:
            out.append({
                "replica_id": h.rid,
                "state": h.state,
                "heartbeat_step": int(h.feed.heartbeat_step),
                "dispatched": h.dispatched,
                "traces": int(h.engine.trace_count),
                "requests": h.engine.stats["requests"],
                "tokens_generated": h.engine.stats["tokens_generated"],
                "demoted": h.engine.stats["demoted"],
                "shed": h.engine.stats["shed"],
                "cancelled": h.engine.stats["cancelled"],
            })
        return out

    def _event(self, kind: str, **fields) -> dict:
        ev = {"kind": kind, **fields}
        self.events.append(ev)
        return ev

    # -- intake --------------------------------------------------------------

    def submit(
        self,
        tokens,
        *,
        n_repeats: int = 1,
        profile=None,
        tier=None,
        max_new_tokens: Optional[int] = None,
        stop_tokens: Sequence[int] = (),
        now: Optional[float] = None,
        deadline: Optional[float] = None,
        target_latency: Optional[float] = None,
        accuracy_floor: Optional[float] = None,
        hedge: bool = False,
    ) -> int:
        """Journal one request and dispatch it to the least-loaded healthy
        replica; returns the cluster uid (the results key).

        The tier ask mirrors ``ServingEngine.submit`` (``n_repeats`` /
        ``profile`` / ``tier``) and is stored verbatim for re-dispatch —
        a failed-over request is always re-asked at its *original* tier.
        The router mints the request's PRNG key from its own base key and
        cluster uid, so the key (and with it the token stream) is
        independent of any replica's uid counter. ``hedge=True`` places
        an immediate backup submission on a second healthy replica.

        With no servable replica the request stays journaled and is
        dispatched by the next pump round that finds one (or failed once
        every replica is dead).
        """
        if tier is not None:
            if profile is not None or n_repeats != 1:
                raise ValueError(
                    "pass either tier, or the legacy n_repeats/profile "
                    "knobs, not both"
                )
            ask = tier
        elif profile is not None:
            if n_repeats != 1:
                raise ValueError("pass either n_repeats or profile, not both")
            ask = profile
        else:
            ask = int(n_repeats)
        cuid = self._cuid
        self._cuid += 1
        arrival = 0.0 if now is None else float(now)
        if deadline is None and target_latency is not None:
            # resolve the SLO to an absolute deadline NOW: a re-dispatch
            # must never restart the latency budget
            deadline = arrival + float(target_latency)
        entry = RequestJournalEntry(
            cuid=cuid,
            tokens=np.asarray(tokens, np.int32).reshape(-1),
            tier=ask,
            key=fold_in(self._base_key, cuid),
            max_new_tokens=max_new_tokens,
            stop_tokens=tuple(int(t) for t in stop_tokens),
            arrival=arrival,
            deadline=deadline,
            target_latency=target_latency,
            accuracy_floor=accuracy_floor,
        )
        self.journal[cuid] = entry
        self.stats["submitted"] += 1
        if not self._dispatch(entry, now=now):
            entry.retry_at = self._round  # first pump round retries
        if hedge:
            self._hedge(entry, now=now)
        return cuid

    # -- dispatch ------------------------------------------------------------

    def _servable(self, exclude: Sequence[int] = ()) -> List[_Replica]:
        return [
            h for h in self.replicas if h.servable and h.rid not in exclude
        ]

    def _pick(self, exclude: Sequence[int] = ()) -> Optional[_Replica]:
        cands = self._servable(exclude)
        if not cands:
            return None
        return min(
            cands, key=lambda h: (h.engine.n_in_flight, h.dispatched, h.rid)
        )

    def _submit_to(self, h: _Replica, entry: RequestJournalEntry,
                   now: Optional[float]) -> Optional[int]:
        try:
            return h.engine.submit(
                entry.tokens,
                tier=entry.tier,
                max_new_tokens=entry.max_new_tokens,
                stop_tokens=entry.stop_tokens,
                key=entry.key,
                now=now,
                deadline=entry.deadline,
                target_latency=entry.target_latency,
                accuracy_floor=entry.accuracy_floor,
            )
        except QueueFull:
            return None  # backpressure/shedding: try another replica

    def _dispatch(self, entry: RequestJournalEntry, *,
                  now: Optional[float], exclude: Sequence[int] = ()) -> bool:
        tried = list(exclude)
        while True:
            h = self._pick(exclude=tried)
            if h is None:
                return False
            uid = self._submit_to(h, entry, now)
            if uid is None:
                tried.append(h.rid)
                continue
            h.uids[uid] = entry.cuid
            h.dispatched += 1
            entry.replica, entry.engine_uid = h.rid, uid
            entry.attempts += 1
            entry.retry_at = None
            self.stats["dispatches"] += 1
            return True

    def _hedge(self, entry: RequestJournalEntry, *,
               now: Optional[float]) -> bool:
        """Place a backup submission on a second healthy replica. The
        duplicate shares the request's key, so determinism makes it
        provably identical to the primary — whichever finishes first
        wins, and cancelling the other is safe by construction."""
        if entry.done or entry.hedge_uid is not None or entry.replica is None:
            return False
        h = self._pick(exclude=(entry.replica,))
        if h is None:
            return False
        uid = self._submit_to(h, entry, now)
        if uid is None:
            return False
        h.uids[uid] = entry.cuid
        h.dispatched += 1
        entry.hedge_replica, entry.hedge_uid = h.rid, uid
        entry.hedged = True
        self.stats["hedges"] += 1
        self.stats["dispatches"] += 1
        self._event(
            "hedge", round=self._round, cuid=entry.cuid,
            primary=entry.replica, backup=h.rid,
        )
        return True

    # -- the cluster pump round ----------------------------------------------

    def pump_step(self, now: Optional[float] = None) -> Dict[int, object]:
        """One cluster round: apply scheduled replica faults, pump every
        live replica, refresh journal prefixes, run the health detector
        (failover on death, quarantine on degradation), re-dispatch due
        retries, place automatic hedges, and rebalance the power budget.
        Returns the requests resolved this round, keyed by cluster uid
        (token rows, or structured ``TimedOut``/``Failed``)."""
        rnd = self._round
        self._round += 1
        self._apply_faults(rnd)
        finished: Dict[int, object] = {}
        for h in self.replicas:
            if not h.alive:
                continue
            if rnd < h.hang_until:
                continue  # wedged pump: no progress, no heartbeat
            if h.injected_drift is not None:
                # what a NoiseDriftWatchdog would report; the injection
                # short-circuits the probe (the watchdog is tested on its own)
                h.feed.note_drift(h.injected_drift)
            for uid, val in h.engine.pump_step(now=now).items():
                self._on_result(h, uid, val, finished)
        self._snapshot_partials()
        self._update_health(rnd, now, finished)
        self._retry_due(rnd, now, finished)
        if self.hedge_slack is not None and now is not None:
            self._auto_hedge(now)
        if self.governor is not None:
            self.governor.step(rnd)
        return finished

    def run_until_drained(
        self, now: float, dt: float = 0.01, max_rounds: int = 2000
    ) -> Tuple[Dict[int, object], float]:
        """Pump the virtual clock until every journaled request resolves;
        returns (results, final time). Bounded: a hang is a failure."""
        results: Dict[int, object] = {}
        t = float(now)
        for _ in range(max_rounds):
            if not self.n_in_flight:
                return results, t
            t += dt
            results.update(self.pump_step(now=t))
        raise RuntimeError(
            f"cluster failed to drain within {max_rounds} rounds "
            f"({self.n_in_flight} still in flight)"
        )

    # -- fault injection -----------------------------------------------------

    def _apply_faults(self, rnd: int) -> None:
        while self._faults_applied < len(self._faults):
            f = self._faults[self._faults_applied]
            if f.at > rnd:
                break
            self._faults_applied += 1
            h = self.replicas[f.replica]
            if isinstance(f, ReplicaCrash):
                h.crashed = True
                self._event("crash_injected", round=rnd, replica=h.rid)
            elif isinstance(f, ReplicaHang):
                h.hang_until = max(h.hang_until, rnd + f.steps)
                self._event(
                    "hang_injected", round=rnd, replica=h.rid, steps=f.steps
                )
            elif isinstance(f, ReplicaDegraded):
                h.engine.set_noise_scale(f.scale)
                h.injected_drift = f.scale
                h.feed.note_drift(f.scale)
                self._event(
                    "degraded_injected", round=rnd, replica=h.rid,
                    scale=f.scale,
                )

    def clear_degradation(self, rid: int, *, now: Optional[float] = None) -> None:
        """Recalibrate one replica: nominal noise scale, drift estimate
        cleared (the detector walks it back to healthy with hysteresis)."""
        h = self.replicas[rid]
        h.injected_drift = None
        h.engine.recalibrate()
        h.feed.note_drift(None)
        self._event("recalibrated", round=self._round, replica=rid)

    # -- journal bookkeeping -------------------------------------------------

    def _snapshot_partials(self) -> None:
        """Refresh every live primary assignment's streamed prefix from
        its pool record — the journal's 'tokens emitted so far'. Only the
        primary streams to the client; hedge partials stay private until
        the hedge wins."""
        for h in self.replicas:
            if not h.alive:
                continue
            for pool in h.engine.pools.values():
                for s in pool.active_slots():
                    rec = pool.record(s)
                    cuid = h.uids.get(rec.request.uid)
                    if cuid is None:
                        continue
                    e = self.journal[cuid]
                    if (
                        not e.done
                        and e.replica == h.rid
                        and e.engine_uid == rec.request.uid
                        and len(rec.emitted) > len(e.delivered)
                    ):
                        e.delivered = [int(t) for t in rec.emitted]

    def _on_result(self, h: _Replica, uid: int, val, finished: dict) -> None:
        cuid = h.uids.pop(uid, None)
        if cuid is None:
            return
        entry = self.journal[cuid]
        is_hedge = entry.hedge_replica == h.rid and entry.hedge_uid == uid
        if entry.done:
            # a hedge loser (or stale duplicate) that outran cancellation:
            # discard — but verify determinism did what it promises
            self.stats["duplicates_discarded"] += 1
            prev = self.results.get(cuid)
            if (
                isinstance(val, np.ndarray)
                and isinstance(prev, np.ndarray)
                and not np.array_equal(prev, val)
            ):
                self.stats["prefix_mismatches"] += 1
                self._event(
                    "identity_violation", round=self._round, cuid=cuid,
                    replica=h.rid,
                )
            return
        if isinstance(val, RequestFailure):
            self._on_failure(h, entry, val, is_hedge, finished)
            return
        # success: verify the streamed prefix, dedup, deliver the suffix
        toks = np.asarray(val, np.int32)
        pre = np.asarray(entry.delivered, np.int32)
        if pre.size and not np.array_equal(toks[: pre.size], pre):
            self.stats["prefix_mismatches"] += 1
            self._event(
                "prefix_mismatch", round=self._round, cuid=cuid,
                replica=h.rid, delivered=int(pre.size),
            )
        elif entry.failed_over:
            # the re-served stream regenerated the already-streamed
            # prefix bit-identically; only the suffix is newly emitted
            self.stats["dedup_tokens"] += int(pre.size)
        entry.delivered = [int(t) for t in toks]
        entry.done = True
        entry.retry_at = None
        self.results[cuid] = toks
        finished[cuid] = toks
        self.stats["delivered"] += 1
        # hedge resolution: first finisher won, cancel the other copy
        if entry.hedged and (entry.hedge_uid is not None or is_hedge):
            if is_hedge:
                self.stats["hedge_wins_backup"] += 1
                loser_rid, loser_uid = entry.replica, entry.engine_uid
            else:
                self.stats["hedge_wins_primary"] += 1
                loser_rid, loser_uid = entry.hedge_replica, entry.hedge_uid
            entry.replica = h.rid
            entry.engine_uid = uid
            entry.hedge_replica = entry.hedge_uid = None
            if loser_rid is not None and loser_uid is not None:
                lh = self.replicas[loser_rid]
                if lh.alive and lh.engine.cancel(loser_uid):
                    self.stats["hedge_cancelled"] += 1
                lh.uids.pop(loser_uid, None)

    def _on_failure(self, h: _Replica, entry: RequestJournalEntry, val,
                    is_hedge: bool, finished: dict) -> None:
        if is_hedge:
            # the backup copy failed; the primary is still racing
            entry.hedge_replica = entry.hedge_uid = None
            return
        if entry.hedge_uid is not None:
            # primary failed but a live hedge is still racing: promote it
            entry.replica, entry.engine_uid = entry.hedge_replica, entry.hedge_uid
            entry.hedge_replica = entry.hedge_uid = None
            self.stats["hedge_promoted"] += 1
            return
        if isinstance(val, Failed) and entry.attempts <= self.max_redispatch:
            # a replica-local Failed (bounded retries exhausted THERE) is
            # a cluster-level retry opportunity elsewhere
            entry.replica = entry.engine_uid = None
            entry.retry_at = self._round
            return
        self._deliver_failure(entry, val, finished)

    def _deliver_failure(self, entry: RequestJournalEntry, val,
                         finished: dict) -> None:
        out = dataclasses.replace(val, uid=entry.cuid)
        entry.done = True
        entry.retry_at = None
        self.results[entry.cuid] = out
        finished[entry.cuid] = out
        self.stats["failed"] += 1

    def _fail(self, entry: RequestJournalEntry, detail: str,
              finished: dict) -> None:
        self._deliver_failure(
            entry,
            Failed(
                uid=entry.cuid,
                tokens=np.asarray(entry.delivered, np.int32),
                detail=detail,
                retries=entry.attempts,
            ),
            finished,
        )

    # -- health detection ----------------------------------------------------

    def _transition(self, h: _Replica, state: str, rnd: int,
                    detail: str) -> None:
        self._event(
            "health", round=rnd, replica=h.rid, frm=h.state, to=state,
            detail=detail,
        )
        h.state = state

    def _update_health(self, rnd: int, now, finished: dict) -> None:
        lo, hi = self.drift_band
        for h in self.replicas:
            if h.state == DEAD:
                continue
            hb = int(h.feed.heartbeat_step)
            advanced = hb > h.last_heartbeat
            h.last_heartbeat = hb
            if advanced:
                h.stalled_rounds = 0
                h.ok_rounds += 1
            else:
                h.stalled_rounds += 1
                h.ok_rounds = 0
            drift = h.feed.drift_estimate
            out_of_band = drift is not None and not (lo <= drift <= hi)
            if out_of_band:
                h.drift_rounds += 1
                h.inband_rounds = 0
            else:
                h.drift_rounds = 0
                h.inband_rounds += 1
            if h.stalled_rounds >= self.dead_after:
                self._transition(
                    h, DEAD, rnd,
                    f"no heartbeat for {h.stalled_rounds} rounds",
                )
                self.stats["replicas_dead"] += 1
                self._failover(h, rnd)
                continue
            if h.state == HEALTHY:
                if h.stalled_rounds >= self.suspect_after:
                    self._transition(
                        h, SUSPECT, rnd,
                        f"heartbeat stalled {h.stalled_rounds} rounds",
                    )
                elif h.drift_rounds >= self.drift_patience:
                    self._transition(
                        h, DEGRADED, rnd,
                        f"drift {drift:.3g} outside {self.drift_band} for "
                        f"{h.drift_rounds} rounds",
                    )
                    self.stats["replicas_degraded"] += 1
                    self._quarantine(h, rnd, now)
            elif h.state == SUSPECT:
                # hysteresis: recovery needs sustained heartbeats, so a
                # flickering pump can't flap the detector
                if h.ok_rounds >= self.recover_after:
                    self._transition(h, HEALTHY, rnd, "heartbeat recovered")
            elif h.state == DEGRADED:
                if h.inband_rounds >= self.recover_after:
                    self._transition(
                        h, HEALTHY, rnd, "drift back in band"
                    )

    # -- failover ------------------------------------------------------------

    def _failover(self, h: _Replica, rnd: int) -> None:
        """Re-dispatch everything the dead replica took with it. One
        jittered, seedable backoff per failover event — every orphaned
        request shares it, so journal replay (sorted by arrival, cuid)
        re-enters the target tier queues in their original FIFO order."""
        orphans: List[RequestJournalEntry] = []
        for cuid in sorted(self.journal):
            e = self.journal[cuid]
            if e.done:
                continue
            if e.hedge_replica == h.rid:
                # the hedge died with the replica; the primary races on
                e.hedge_replica = e.hedge_uid = None
            if e.replica == h.rid:
                if e.hedge_uid is not None:
                    # a live hedge IS a warm re-dispatch: promote it
                    e.replica, e.engine_uid = e.hedge_replica, e.hedge_uid
                    e.hedge_replica = e.hedge_uid = None
                    self.stats["hedge_promoted"] += 1
                else:
                    e.replica = e.engine_uid = None
                    orphans.append(e)
        h.uids.clear()
        if self.governor is not None:
            self.governor.step(rnd)  # membership changed: rebalance now
        if not orphans:
            return
        delay = self.backoff_rounds + int(
            self._rng.integers(0, self.backoff_jitter + 1)
        )
        for e in orphans:
            e.failed_over = True
            e.retry_at = rnd + delay
        self.stats["failed_over"] += len(orphans)
        self._event(
            "failover", round=rnd, replica=h.rid,
            uids=[e.cuid for e in orphans], retry_round=rnd + delay,
        )

    def _quarantine(self, h: _Replica, rnd: int, now) -> None:
        """Pull a degraded replica's *queued* work (no tokens emitted yet
        — nominal replicas will serve it bit-identical to its solo run)
        and route new traffic around it. Pooled rows finish where they
        are: their noise keys bound them at admission, and retiring them
        would trade a drift-tinted answer for no answer."""
        moved = []
        for r in list(h.engine.scheduler.queued_requests()):
            cuid = h.uids.get(r.uid)
            if cuid is None:
                continue
            e = self.journal[cuid]
            if e.done:
                continue
            if e.replica == h.rid and e.engine_uid == r.uid:
                if h.engine.cancel(r.uid):
                    h.uids.pop(r.uid, None)
                    e.replica = e.engine_uid = None
                    e.retry_at = rnd  # proactive: re-dispatch this round
                    moved.append(e.cuid)
            elif e.hedge_replica == h.rid and e.hedge_uid == r.uid:
                if h.engine.cancel(r.uid):
                    h.uids.pop(r.uid, None)
                    e.hedge_replica = e.hedge_uid = None
        self.stats["quarantined"] += len(moved)
        self._event("quarantine", round=rnd, replica=h.rid, uids=moved)

    def _retry_due(self, rnd: int, now, finished: dict) -> None:
        due = [
            e for e in self.journal.values()
            if not e.done and e.retry_at is not None and e.retry_at <= rnd
        ]
        # journal replay order: (arrival, cuid) — cross-engine re-dispatch
        # must not reorder any tier's FIFO
        due.sort(key=lambda e: (e.arrival, e.cuid))
        for e in due:
            if e.attempts > self.max_redispatch:
                self._fail(
                    e,
                    f"re-dispatch budget exhausted after {e.attempts} "
                    "dispatches",
                    finished,
                )
                continue
            redispatch = e.attempts > 0
            if self._dispatch(e, now=now):
                if redispatch:
                    self.stats["redispatched"] += 1
            elif not any(x.alive for x in self.replicas):
                self._fail(e, "no live replicas", finished)
            else:
                e.retry_at = rnd + 1  # backpressure: try again next round

    def _auto_hedge(self, now: float) -> None:
        for e in self.journal.values():
            if (
                e.done
                or e.hedged
                or e.replica is None
                or e.deadline is None
                or e.retry_at is not None
            ):
                continue
            if e.deadline - now <= self.hedge_slack:
                self._hedge(e, now=now)

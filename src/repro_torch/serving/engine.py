"""Bucket-batched analog serving engine.

Port of ``repro/serving/engine.py``:

  submit -> TierScheduler groups same-tier requests        (scheduler.py)
         -> pad into a power-of-two (batch, seq) bucket    (bucketing.py)
         -> a cached step per (phase, bucket, tier, mesh)  (cache.py, tiers.py)
         -> prefill, then decode steps                     (models/lm.py)

The steps are the reference's executables: on the card with the
``"cuda"`` backend each is a CUDA graph, captured at its first call and
replayed after (``ExecutableCache``, ``trace_count``, ``cache_stats()``);
elsewhere the eager step. A step reads static tensors the engine refills
before each call (tokens, positions, lengths and seed words through one
host-to-device copy, the decode token, the noise scale) and updates a
static cache in place: one cache per (batch bucket, cache length) in
batch-synchronous mode, each pool's own in continuous mode.

Two decode disciplines share that pipeline:

  batch-synchronous (default) - a dispatched batch decodes to completion,
      ``max(max_new_tokens)`` steps for every row.

  continuous (``continuous=True``) - each tier owns a persistent decode
      slot pool (pool.py) of ``pool_slots`` rows at ``pool_cache_len``
      that decodes every step with inactive slots as length-0 rows,
      retires a row the step it reaches its budget or emits a stop id,
      and admits freshly prefilled requests into freed slots mid-flight
      (the prefill runs at the pool's cache length and its cache rows are
      copied in on the device, ``lm.scatter_cache_rows``). Retiring needs
      each step's tokens on the host: a pool step ends with one read.

A tier is a uniform K (``n_repeats``), a registered per-layer
``PrecisionProfile`` (``profile=``, served at K_l in layer l and priced at
``sum_l K_l * E_l * MACs_l``, ``tier_energy_per_token``) or, on a digital
engine, the one digital base tier. Tiers never share a batch or a pool.

Every request is served with its own key stacked into the batch (its own
noise streams at every site), its own true prompt length (per-row decode
positions) and greedy sampling, so its tokens do not depend on what else
shares its batch or pool, its slot or its admission step. Request keys
are ``fold_in(PRNGKey(seed), uid)``; batch-padding rows carry
``PRNGKey(0)`` and length 0. Decode attention sums over the whole cache,
so tokens are bit-identical across the two disciplines when their cache
lengths are equal (one seq bucket).

Resilience (the reference's fault-tolerance layer): requests may carry a
``deadline`` (or an SLO ``target_latency`` that arms one) and resolve to a
structured ``TimedOut`` when it passes, queued (empty) or pooled (the
partial tokens, a prefix of the fault-free output); ``cancel`` withdraws a
request; a ``FaultPlan`` (faults.py) injects drift, stalled pool steps,
transient call faults and poisoned rows at the engine's seams. A call
fault raises before any launch and before a cache is touched; the
faulted batch retries once from scratch at its tier's promoted rung
(``max_retries``) or resolves to ``Failed``. Any other exception a call
raises is contained the same way and counted in ``stats["exe_errors"]``
(the reference's ``exe_error`` path).
The noise-std drift factor (``set_noise_scale``, or the plan's
``DriftRamp``) is a 0-d float32 tensor operand of every forward, served
as energies ``E / d**2``; at 1.0 the tokens are bit-identical to serving
without it. ``promote_tiers``/``recalibrate`` are the drift response, a
``PrecisionGovernor`` (policy.py, ``policy=``) moves queued requests
between tiers under load, and a ``MetricsFeed`` (monitor.py,
``metrics=``) takes one sample a poll or pump round.

Tensor parallelism (``mesh=``, ``attach_mesh``): every tensor the engine
holds stays replicated, and the analog matmuls of its forwards run as
column shards of the mesh (``core.analog._maybe_sharded_analog_dot``),
each drawing its noise at its global column offset, so the tokens are
bit-identical to the unsharded engine's. The dense and griffin families
serve under a mesh; moe and xlstm do not yet.

The engine runs on ``device`` (default ``"cuda"``; it raises without a
card unless the caller passes ``device="cpu"``). ``params`` and
``energies`` must already live there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig, raw_key
from repro_torch.core.profile import PrecisionProfile
from repro_torch.device import resolve_device
from repro_torch.kernels.prng import PRNGKey, fold_in
from repro_torch.models import lm, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.serving.bucketing import (
    DEFAULT_BATCH_BUCKETS,
    DEFAULT_SEQ_BUCKETS,
    bucket_shape,
    next_bucket,
    pad_to_bucket,
    pool_shape,
)
from repro_torch.kernels.dispatch import CUDA, resolve_backend
from repro_torch.serving.cache import ExecutableCache, Step, mesh_fingerprint
from repro_torch.serving.faults import BoundedLog, FaultPlan, QueueFull, TransientExecutableFault
from repro_torch.serving.policy import PolicyConfig, PrecisionGovernor
from repro_torch.serving.pool import DecodePool
from repro_torch.serving.scheduler import Request, TierScheduler
from repro_torch.serving.tiers import ExecutionTier, TierRegistry
from repro_torch.tree import map_leaves


def _step_of(exe) -> Step:
    """The ``Step`` behind a cache entry (the cache may wrap it in its fault
    guard)."""
    return getattr(exe, "__wrapped__", exe)


def batch_keys(keys: Sequence[np.ndarray], bb: int) -> np.ndarray:
    """Stack request keys into a (bb, 2) table; batch-padding rows get the
    fixed key ``PRNGKey(0)`` (their outputs are discarded)."""
    rows = [raw_key(k) for k in keys] + [PRNGKey(0)] * (bb - len(keys))
    return np.stack(rows)


@dataclasses.dataclass(frozen=True)
class RequestFailure:
    """A request the engine gave up on, in place of its token row.

    ``tokens`` holds what was generated before the failure (empty for a
    queued timeout), a prefix of the fault-free output; a failed or
    timed-out request resolves exactly once.
    """

    uid: int
    tokens: np.ndarray
    detail: str
    retries: int = 0

    @property
    def ok(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class TimedOut(RequestFailure):
    """The request's deadline passed while it was queued or decoding."""


@dataclasses.dataclass(frozen=True)
class Failed(RequestFailure):
    """The request hit an injected fault and ran out of retries."""


#: what poll()/flush() map a uid to: a token row or a structured failure
RequestResult = Union[np.ndarray, RequestFailure]


class ServingEngine:
    """Serves mixed-precision generation traffic over a frozen model.

    ``analog_cfg=None`` serves the digital model. ``energies`` is an
    ``init_energy_tree``-shaped allocation at K=1; a K-tier spends K times
    it. ``max_gen`` bounds every request's decode budget (a batch's cache
    length is its seq bucket plus ``max_gen``). ``profiles`` are
    registered as tiers at construction.

    ``continuous=True`` (not for the moe family, whose expert noise is
    batch-level) decodes through per-tier slot pools of
    ``pool_slots`` rows (default: the largest batch bucket) and a cache
    length of ``max(seq_buckets) + max_gen`` unless ``pool_cache_len``
    says otherwise; a request whose seq bucket plus budget does not fit a
    slot is rejected at submit.

    ``max_entries`` bounds the step cache (LRU; default unbounded).
    ``max_queue`` bounds the scheduler queue (``QueueFull`` past it).
    ``fault_plan`` arms the injection sites. As in the reference, the
    executable guard is armed only by a plan given at construction (it
    then reads the plan at every call, so ``fault_plan = None`` silences it
    and models repaired hardware); the drift and probe sites read the plan
    whenever it is set. ``max_retries`` bounds a faulted request's retries and
    ``k_ladder`` is the calibrated ladder of uniform K that retries and the
    drift response climb. ``fault_log`` keeps the last ``fault_log_maxlen``
    fault and policy events. ``policy`` builds a ``PrecisionGovernor``;
    ``metrics`` (a ``MetricsFeed``) is sampled once a poll or pump round.
    ``mesh``: a ``launch.mesh.Mesh`` to serve tensor-parallel over
    (``attach_mesh``).

    The engine serves token prompts: a config with a ``frames`` or
    ``patch`` frontend is refused (its inputs are embeddings, which the
    reference's engine does not take either; ``lm.prefill`` and
    ``lm.decode_step`` run such a model directly).
    """

    def __init__(
        self,
        params,
        model_cfg: ModelConfig,
        *,
        analog_cfg: Optional[AnalogConfig] = None,
        energies=None,
        max_gen: int = 32,
        max_batch: int = 8,
        max_wait: float = 0.05,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        seq_buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS,
        pad_id: int = 0,
        seed: int = 0,
        profiles: Optional[Sequence[PrecisionProfile]] = None,
        continuous: bool = False,
        pool_slots: Optional[int] = None,
        pool_cache_len: Optional[int] = None,
        max_entries: Optional[int] = None,
        max_queue: Optional[int] = None,
        fault_plan: Optional[FaultPlan] = None,
        max_retries: int = 1,
        k_ladder: Sequence[int] = (1, 2, 4, 8),
        fault_log_maxlen: Optional[int] = 4096,
        policy: Optional[PolicyConfig] = None,
        metrics=None,
        mesh=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if not k_ladder or any(int(k) < 1 for k in k_ladder):
            raise ValueError(f"k_ladder must be positive Ks, got {k_ladder}")
        if continuous and model_cfg.family == "moe":
            raise ValueError(
                "continuous batching is unavailable for the moe family: analog expert sites "
                "draw a batch-level noise stream (capacity buffers mix requests), so "
                "admitting or retiring a request would change another's noise mid-stream; "
                "serve MoE batch-synchronously (continuous=False)"
            )
        if model_cfg.frontend != "none":
            raise ValueError(f"{model_cfg.name}: the engine serves token prompts, not the "
                             f"{model_cfg.frontend!r} frontend's embeddings")
        if analog_cfg is not None and energies is None:
            raise ValueError("analog serving requires an energy tree")
        self.params = params
        self.model_cfg = model_cfg
        self.analog_cfg = analog_cfg
        self._energies = energies
        self.tiers = TierRegistry(self)
        for p in profiles or ():
            self.register_profile(p)
        self.max_gen = max_gen
        self.batch_buckets = tuple(batch_buckets)
        self.seq_buckets = tuple(seq_buckets)
        self.pad_id = pad_id
        self.scheduler = TierScheduler(
            max_batch=min(max_batch, max(batch_buckets)),
            max_wait=max_wait,
            seq_buckets=seq_buckets,
            max_queue=max_queue,
        )
        #: the injection schedule; None (set at any time) silences every site
        self.fault_plan = fault_plan
        self.max_retries = int(max_retries)
        self.k_ladder = tuple(sorted({int(k) for k in k_ladder}))

        def _exe_guard(key):
            if self.fault_plan is not None:
                self.fault_plan.check_executable(key)

        #: the built steps (serving/cache.py); the fault guard, armed by a
        #: plan given here, runs before every call
        self.exe_cache = ExecutableCache(
            max_entries=max_entries, fault_hook=_exe_guard if fault_plan is not None else None)
        #: steps on the card with the "cuda" backend are CUDA graphs: every
        #: phase (prefill, decode, insert) of every family (dense, griffin,
        #: xlstm, moe: no shape in a forward depends on the data)
        self.graphs = self.device.type == "cuda" and (
            analog_cfg is None or resolve_backend(analog_cfg, torch.empty(0, device=self.device))
            == CUDA)
        self._graph_pool = None
        #: (batch bucket, cache length) -> the static cache its prefill fills
        #: and its decode steps update
        self._batch_caches: Dict[tuple, dict] = {}
        self._traces = 0  # steps built (== cache misses since construction)
        self.continuous = bool(continuous)
        self.pool_slots, self.pool_cache_len = pool_shape(
            pool_slots if pool_slots is not None else max(batch_buckets), seq_buckets, max_gen
        )
        if pool_cache_len is not None:
            if pool_cache_len <= min(seq_buckets):
                raise ValueError(
                    f"pool_cache_len={pool_cache_len} can't hold even a "
                    f"minimum-bucket prompt ({min(seq_buckets)}) plus one "
                    "generated token"
                )
            self.pool_cache_len = int(pool_cache_len)
        #: tier -> persistent DecodePool, created at the tier's first admission
        self._pools: Dict[object, DecodePool] = {}
        self._base_key = PRNGKey(seed)
        self._uid = 0
        self._clock: Optional[str] = None  # "real" | "virtual", set on first use
        #: the attached tensor-parallel mesh (None: unsharded) and its cache
        #: key fingerprint (() unmeshed)
        self._mesh = None
        self._mesh_key: tuple = ()
        #: the realized noise-std drift factor (1.0 nominal) and its 0-d
        #: float32 operand on the device, refilled in place when it changes
        self._noise_scale = 1.0
        self._scale_t = torch.ones((), dtype=torch.float32, device=self.device)
        self._scale_filled = 1.0
        #: drift response: new uniform-K submissions serve one rung up
        self._promoted = False
        #: one tick a decode step attempted (stalled ones included): the
        #: fault plan's clock
        self._fault_clock = 0
        self.stats = {
            "requests": 0,
            "batches": 0,  # prefill batches (admission waves in continuous mode)
            "tokens_generated": 0,
            "padded_rows": 0,
            "decode_steps": 0,
            "decode_slot_steps": 0,  # decode steps x batch rows (or pool slots)
            "active_slot_steps": 0,  # of those, pool rows that carried a request
            "admitted": 0,  # requests admitted into a pool slot
            "retired": 0,  # pool retirements (budget, stop id, timeout, cancel, fault)
            "pool_read_s": 0.0,  # host seconds waiting for pool steps' tokens
            "timed_out": 0,  # requests retired past their deadline
            "failed": 0,  # requests that ran out of fault retries
            "retried": 0,  # fault-triggered resubmissions
            "stalled_steps": 0,  # pool decode steps lost to injected stalls
            "exe_faults": 0,  # injected call faults absorbed
            "exe_errors": 0,  # unexpected exceptions of a call contained
            "poisoned_rows": 0,  # corrupted decode rows detected and retired
            "cancelled": 0,  # requests withdrawn by cancel()
            "promotions": 0,  # drift responses switched on
            "shed": 0,  # submissions the governor's last rung refused
            "demoted": 0,  # queued requests moved down a tier under pressure
            "promoted_back": 0,  # demoted requests restored after the episode
            "policy_transitions": 0,  # governor mode changes
            "dropped_events": 0,  # fault_log entries evicted by its bound
            "tier_tokens": {},
            "tier_decode_steps": {},
        }
        #: every fault consequence and policy action, most recent last
        self.fault_log: List[dict] = BoundedLog(maxlen=fault_log_maxlen,
                                                on_drop=self._note_dropped_events)
        #: uid -> the tier the request was dispatched at (a retry overwrites it)
        self.served_tiers: Dict[int, object] = {}
        self.metrics = metrics
        self.governor: Optional[PrecisionGovernor] = None
        if policy is not None:
            self.governor = PrecisionGovernor(self, policy)
        if mesh is not None:
            self.attach_mesh(mesh)

    def _note_dropped_events(self, n: int) -> None:
        self.stats["dropped_events"] += n

    def _bump_tier(self, stat: str, tier, n: int) -> None:
        d = self.stats[stat]
        d[tier] = d.get(tier, 0) + n

    def _now(self, now: Optional[float], phase: str) -> float:
        """Resolve a timestamp, pinning the engine to one clock domain (the
        real clock when ``now`` is None, the caller's otherwise); a drained
        engine may switch."""
        mode = "real" if now is None else "virtual"
        if self._clock is None or (self._clock != mode and self.scheduler.n_pending == 0):
            self._clock = mode
        elif self._clock != mode:
            raise ValueError(
                f"{phase}() used the {mode} clock but this engine is on the "
                f"{self._clock} clock with requests pending; pass `now` "
                "consistently (or never), or drain before switching"
            )
        return time.monotonic() if now is None else now

    def register_profile(self, profile: PrecisionProfile) -> str:
        """Register a per-layer repeat schedule as a tier (add-only: a name
        stays bound to its schedule). Returns its id for ``submit(profile=)``."""
        return self.tiers.register_profile(profile)

    def register_tier(self, tier: ExecutionTier):
        """Register a custom tier of this engine (e.g. a ``DigitalTier``)
        for ``submit(tier=)``; add-only. Returns its id."""
        return self.tiers.register(tier)

    def submit(
        self,
        tokens,
        *,
        n_repeats: int = 1,
        profile=None,
        tier=None,
        max_new_tokens: Optional[int] = None,
        stop_tokens: Sequence[int] = (),
        key=None,
        now: Optional[float] = None,
        deadline: Optional[float] = None,
        target_latency: Optional[float] = None,
        accuracy_floor: Optional[float] = None,
        max_degradation: Optional[float] = None,
    ) -> int:
        """Enqueue one request; returns its uid (the key of its result).

        ``profile``: a registered profile's name or a ``PrecisionProfile``
        (registered here), exclusive with ``n_repeats``; a uniform profile
        is the ``n_repeats=K`` tier. ``tier``: the general form (a tier id,
        a ``PrecisionProfile`` or an ``ExecutionTier``), exclusive with
        both and honoured on a digital engine too; otherwise a digital
        engine serves every request on its one tier.

        ``deadline``: an absolute time on the engine's clock past which the
        request resolves to ``TimedOut`` (checked by clocked ``poll`` and
        ``pump_step``; ``flush`` checks none). SLO fields, the precision
        governor's inputs: ``target_latency`` (seconds from arrival) arms
        the deadline when none is given; ``accuracy_floor`` bounds how far
        the governor may demote the request; ``max_degradation`` is that
        floor relative to the requested tier's accuracy (needs a governor).

        Raises ``QueueFull`` at ``max_queue`` pending or while the governor
        sheds load, and ``ValueError`` for requests the engine could never
        serve: an empty prompt, a prompt longer than the largest seq
        bucket, a ``max_new_tokens`` outside ``[1, max_gen]`` (None asks
        for the full ``max_gen``), ``n_repeats < 1``, an unknown profile,
        bad SLO fields, or in continuous mode a request that does not fit
        a pool slot.
        """
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError(
                "empty prompt: a request must carry at least one token "
                "(there is no position to continue generation from)"
            )
        if tokens.size > max(self.seq_buckets):
            raise ValueError(
                f"prompt of {tokens.size} tokens exceeds the largest seq "
                f"bucket ({max(self.seq_buckets)}); extend seq_buckets or "
                "truncate the prompt"
            )
        if max_new_tokens is None:
            max_new_tokens = self.max_gen
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if max_new_tokens > self.max_gen:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} exceeds this engine's "
                f"decode budget max_gen={self.max_gen}; raise max_gen or "
                "lower the request"
            )
        if n_repeats < 1:
            raise ValueError(f"n_repeats must be >= 1, got {n_repeats}")
        if target_latency is not None and target_latency <= 0.0:
            raise ValueError(f"target_latency must be > 0 seconds, got {target_latency}")
        if accuracy_floor is not None and max_degradation is not None:
            raise ValueError(
                "pass either accuracy_floor or max_degradation, not both: "
                "max_degradation is the floor expressed relative to the "
                "requested tier's accuracy"
            )
        if max_degradation is not None:
            if max_degradation < 0.0:
                raise ValueError(f"max_degradation must be >= 0, got {max_degradation}")
            if self.governor is None:
                raise ValueError(
                    "max_degradation needs a policy governor: the floor is "
                    "relative to the requested tier's measured accuracy, "
                    "which lives in the governor's tier table (pass "
                    "accuracy_floor for an absolute bound instead)"
                )
        if self.continuous:
            sb = next_bucket(tokens.size, self.seq_buckets)
            if sb + max_new_tokens > self.pool_cache_len:
                raise ValueError(
                    f"request needs {sb} (seq bucket) + {max_new_tokens} (decode "
                    f"budget) cache slots but the decode pools hold "
                    f"{self.pool_cache_len}; raise pool_cache_len or size "
                    "seq_buckets/max_gen to the traffic"
                )
        if tier is not None:
            if profile is not None or n_repeats != 1:
                raise ValueError(
                    "pass either tier, or the legacy n_repeats/profile "
                    "knobs, not both: tier is the general form of the "
                    "same dial"
                )
            tier_id = self.tiers.resolve(tier)
        elif profile is not None:
            if n_repeats != 1:
                raise ValueError(
                    "pass either n_repeats or profile, not both: a profile "
                    "is the per-layer form of the same knob"
                )
            tier_id = self.tiers.resolve_profile(profile)
        else:
            tier_id = int(n_repeats)
        if max_degradation is not None:
            accuracy_floor = self.governor.tier_accuracy(tier_id) - float(max_degradation)
        if self.governor is not None and self.governor.shedding:
            self.stats["shed"] += 1
            self.fault_log.append({"kind": "shed", "clock": self._fault_clock,
                                   "queue_depth": self.scheduler.n_pending})
            raise QueueFull(
                f"precision governor is shedding load: every queued request "
                f"is already at its accuracy floor and pressure is still "
                f"above the shed threshold ({self.scheduler.n_pending} "
                "pending); retry after the queue drains"
            )
        uid = self._uid
        self._uid += 1
        if key is None:
            key = fold_in(self._base_key, uid)
        if tier is None and self.analog_cfg is None:
            tier_id = self.tiers.base_id  # K and profiles are no-ops without noise
        elif self._promoted:
            # drift response: new traffic serves one rung up its tier's ladder
            tier_id = self.tiers.drift_promote(tier_id)
        arrival = self._now(now, "submit")
        if deadline is None and target_latency is not None:
            deadline = arrival + float(target_latency)
        req = Request(
            uid=uid,
            tokens=tokens,
            max_new_tokens=int(max_new_tokens),
            key=raw_key(key),
            arrival=arrival,
            stop_tokens=tuple(int(t) for t in stop_tokens),
            tier=tier_id,
            deadline=deadline,
            target_latency=None if target_latency is None else float(target_latency),
            accuracy_floor=None if accuracy_floor is None else float(accuracy_floor),
        )
        self.scheduler.submit(req)
        self.stats["requests"] += 1
        return uid

    def poll(self, now: Optional[float] = None) -> Dict[int, RequestResult]:
        """Serve what is ready at ``now``; returns the finished uids' token
        rows (or ``TimedOut``/``Failed``). Batch-synchronous: each ready
        batch to completion, requests a fault requeued included.
        Continuous: admit ready requests and pump decode steps until the
        pools drain and nothing else is ready."""
        now = self._now(now, "poll")
        if self.continuous:
            return self._pump(now, force=False)
        results: Dict[int, RequestResult] = self._expire_queued(now)
        if self.governor is not None:
            self.governor.step(now)
        while True:
            batches = self.scheduler.pop_ready(now)
            if not batches:
                break
            for reqs in batches:
                results.update(self._run_batch(reqs))
        if self.metrics is not None:
            self.metrics.record(self, now=now)
        return results

    def cancel(self, uid: int) -> bool:
        """Withdraw a request: a queued one leaves the scheduler, a pooled
        one retires now (its slot is free for the next round; its partial
        tokens are dropped). Its batch-mates' tokens never depended on it.
        False when ``uid`` is unknown or already finished."""
        if self.scheduler.cancel(uid) is not None:
            self.stats["cancelled"] += 1
            self.fault_log.append({"kind": "cancel", "where": "queue", "uids": [uid]})
            return True
        for pool in self._pools.values():
            for s in pool.active_slots():
                if pool.record(s).request.uid == uid:
                    pool.retire(s)
                    self.stats["retired"] += 1
                    self.stats["cancelled"] += 1
                    self.fault_log.append({"kind": "cancel", "where": "pool", "uids": [uid]})
                    return True
        return False

    def flush(self) -> Dict[int, RequestResult]:
        """Drain the queue regardless of deadlines (end of replay/shutdown)."""
        if self.continuous:
            return self._pump(None, force=True)
        results: Dict[int, RequestResult] = {}
        while self.scheduler.n_pending:  # fault retries re-enter the queue
            for reqs in self.scheduler.flush():
                results.update(self._run_batch(reqs))
        return results

    # -- graceful degradation ------------------------------------------------

    def _expire_queued(self, now: Optional[float]) -> Dict[int, RequestResult]:
        """Retire queued requests whose deadline passed (clocked calls only)."""
        out: Dict[int, RequestResult] = {}
        if now is None:
            return out
        for r in self.scheduler.pop_expired(now):
            out[r.uid] = TimedOut(uid=r.uid, tokens=np.zeros((0,), np.int32), retries=r.retries,
                                  detail=f"deadline {r.deadline:g} passed at {now:g} in queue")
            self.stats["timed_out"] += 1
            self.fault_log.append({"kind": "timeout", "where": "queue", "uids": [r.uid]})
        return out

    def _expire_pooled(self, now: Optional[float]) -> Dict[int, RequestResult]:
        """Retire pooled requests past their deadline, keeping their partial
        tokens; their slots free at once."""
        out: Dict[int, RequestResult] = {}
        if now is None:
            return out
        for pool in self._pools.values():
            for s in pool.expired(now):
                rec = pool.retire(s)
                r = rec.request
                out[r.uid] = TimedOut(
                    uid=r.uid, tokens=np.asarray(rec.emitted, np.int32), retries=r.retries,
                    detail=f"deadline {r.deadline:g} passed at {now:g} after "
                           f"{len(rec.emitted)} tokens",
                )
                self.stats["timed_out"] += 1
                self.stats["retired"] += 1
                self.fault_log.append({"kind": "timeout", "where": "pool", "uids": [r.uid]})
        return out

    def _fault_requeue(self, reqs: List[Request], kind: str, detail: str) -> Dict[int, RequestResult]:
        """Requests whose batch hit a fault: one retry from scratch at the
        tier's promoted rung (``ExecutionTier.promote``) while retries
        remain, else ``Failed``. A faulted batch's partial tokens are
        dropped."""
        out: Dict[int, RequestResult] = {}
        entry = {"kind": kind, "clock": self._fault_clock, "detail": detail,
                 "uids": [r.uid for r in reqs], "retried": [], "failed": [], "promoted": {}}
        for r in reqs:
            if r.retries < self.max_retries:
                r2 = dataclasses.replace(r, retries=r.retries + 1)
                r2.retier(self.tiers.get(r.tier).promote())
                self.scheduler.submit(r2, force=True)  # a requeue never meets QueueFull
                self.stats["retried"] += 1
                entry["retried"].append(r.uid)
                entry["promoted"][r.uid] = r2.tier
            else:
                out[r.uid] = Failed(uid=r.uid, tokens=np.zeros((0,), np.int32), detail=detail,
                                    retries=r.retries)
                self.stats["failed"] += 1
                entry["failed"].append(r.uid)
        self.fault_log.append(entry)
        return out

    def set_noise_scale(self, scale: float) -> None:
        """Set the realized noise-std drift factor (1.0 = nominal), served
        from the next forward on as energies ``E / scale**2``."""
        if scale <= 0.0:
            raise ValueError(f"noise scale must be > 0, got {scale}")
        self._noise_scale = float(scale)

    @property
    def noise_scale(self) -> float:
        return self._noise_scale

    @property
    def promoted(self) -> bool:
        """True while the drift response promotes new uniform-K traffic."""
        return self._promoted

    def promote_tiers(self, event=None) -> None:
        """Drift response: until :meth:`recalibrate`, new uniform-K
        submissions serve one rung up ``k_ladder`` (more repeats buy back
        the drifted noise floor). Typically driven by a watchdog's
        ``DriftEvent``; idempotent."""
        if not self._promoted:
            self.stats["promotions"] += 1
        self._promoted = True
        self.fault_log.append({
            "kind": "drift_promotion", "clock": self._fault_clock,
            "event": event if event is None else dataclasses.asdict(event),
            "exempt_tiers": self.tiers.drift_exempt_ids(),
        })

    def recalibrate(self, *, noise_scale: float = 1.0) -> None:
        """Clear the drift response and pin the realized noise scale (1.0
        after a physical recalibration)."""
        self._promoted = False
        self.set_noise_scale(noise_scale)
        self.fault_log.append({"kind": "recalibrated", "clock": self._fault_clock,
                               "noise_scale": float(noise_scale)})

    def _sync_noise_scale(self) -> None:
        """Pull the fault plan's drift factor at the current fault clock."""
        if self.fault_plan is not None and self.fault_plan.drift is not None:
            self._noise_scale = self.fault_plan.noise_scale_at(self._fault_clock)

    def _scale_arr(self) -> torch.Tensor:
        """The drift operand of the next forward: one 0-d device tensor,
        filled in place when the factor changed (stream order keeps queued
        launches on the value they were given)."""
        if self._noise_scale != self._scale_filled:
            self._scale_t.fill_(self._noise_scale)
            self._scale_filled = self._noise_scale
        return self._scale_t

    # -- mesh attach / resize ------------------------------------------------

    @property
    def mesh(self):
        """The attached tensor-parallel mesh (None: unsharded serving)."""
        return self._mesh

    @property
    def mesh_key(self) -> tuple:
        """The mesh fingerprint appended to every cache key (() unmeshed)."""
        return self._mesh_key

    def attach_mesh(self, mesh) -> None:
        """Attach (or resize to) a tensor-parallel mesh; ``None`` detaches.

        Everything the engine holds stays replicated on its device: the
        analog matmuls of its forwards run as the mesh's column shards,
        whose noise is drawn at global column offsets, so the tokens equal
        the unsharded engine's bit for bit. Refused while requests are in
        flight (their decode state belongs to the old mesh); the pools
        are dropped and rebuilt lazily. Cache keys carry the mesh's
        fingerprint: a resize builds fresh steps once, and a resize back to
        a previous mesh hits its entries. The moe and xlstm families are
        not served under a mesh yet.
        """
        if self.n_in_flight:
            raise ValueError(
                f"cannot attach/resize a mesh with {self.n_in_flight} requests in flight "
                "(their decode state belongs to the current mesh); drain with flush() first")
        self._mesh = mesh
        self._mesh_key = mesh_fingerprint(mesh)
        for pool in self._pools.values():  # graphs on a dropped pool's cache go with it
            for _key, step in self.exe_cache.entries():
                step.forget(pool.cache)
        self._pools.clear()  # rebuilt lazily under the new mesh

    def _mesh_ctx(self):
        """The attached mesh as the ambient mesh of a forward (every
        analog matmul inside runs column-parallel); no-op unmeshed."""
        if self._mesh is None:
            return contextlib.nullcontext()
        return sharding.use_mesh(self._mesh)

    # -- steps ---------------------------------------------------------------
    # the builders and the cache-key identity live on the tiers
    # (serving/tiers.py): the engine composes ``tiers.exe_key(phase, tier,
    # *shape)`` with ``tier.build_*``, refills the step's inputs and calls it

    def _make_step(self, tier, fn, inputs, shape: tuple, params: bool = True,
                   **static) -> Step:
        """A tier's built step: a CUDA graph on the card with the "cuda"
        backend (``graphs``), else eager. ``shape``: the phase and shapes
        of its key; ``params``: whether it reads the tier's parameters (a
        swap of them captures again) and is the tier's (its cache_key)."""
        self._traces += 1
        ident = tier.cache_key() if params else None
        return Step(fn, inputs, capture=self.graphs, pool=self._shared_pool,
                    params=(lambda: tier.params) if params else None,
                    warm_key=(self.device, self.model_cfg, self.analog_cfg, self.mesh_key, ident)
                    + shape,
                    on_capture=self._captured, on_capture_error=self._drop_pool, **static)

    def _shared_pool(self):
        """The one graph memory pool every step of the engine shares."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _drop_pool(self) -> None:
        """A capture failed: PyTorch leaves its pool recording, so the next
        capture takes a new one."""
        self._graph_pool = None

    def _captured(self, seconds: float) -> None:
        self.exe_cache.compile_s += seconds

    def _batch_cache(self, bb: int, cache_len: int):
        """The static cache of a (bb, cache_len) bucket: what its prefill
        fills and its decode steps (or an admission's insert) read."""
        cache = self._batch_caches.get((bb, cache_len))
        if cache is None:
            cache = self._batch_caches[(bb, cache_len)] = lm.init_cache(
                self.model_cfg, bb, cache_len, device=self.device)
        return cache

    def _place(self, tree):
        """A cache tree on the engine's device (every shard's: the mesh
        keeps the engine's tensors replicated)."""
        return map_leaves(lambda _p, t: t.to(self.device), tree)

    # -- execution -----------------------------------------------------------

    def _prefill_batch(self, reqs: List[Request], cache_len: Optional[int] = None):
        """Pad into a bucket and prefill at ``cache_len`` (default: the
        batch's ``sb + max_gen``; admission passes the pool's) into the
        static cache of (bb, cache_len): returns (bb, cache_len, lengths
        (bb,) numpy, keys (bb, 2), first tokens (bb,), a copy on the
        device)."""
        tier_id = reqs[0].tier
        if any(r.tier != tier_id for r in reqs):
            raise ValueError("mixed-tier batch")
        for r in reqs:  # the tier is bound at dispatch
            self.served_tiers[r.uid] = tier_id
        tier = self.tiers.get(tier_id)
        bb, sb = bucket_shape(
            len(reqs), max(r.prompt_len for r in reqs),
            batch_buckets=self.batch_buckets, seq_buckets=self.seq_buckets,
        )
        if cache_len is None:
            cache_len = sb + self.max_gen
        tokens_np, lengths_np = pad_to_bucket(
            [r.tokens for r in reqs], (bb, sb), pad_id=self.pad_id
        )
        keys = batch_keys([r.key for r in reqs], bb)
        exe = self.exe_cache.get(self.tiers.exe_key("prefill", tier_id, bb, sb, cache_len),
                                 lambda: tier.build_prefill(bb, sb, cache_len))
        self._sync_noise_scale()
        self._scale_arr()
        tier.fill(_step_of(exe), keys, tokens=tokens_np, lengths=lengths_np)
        _logits, tok = exe(self._batch_cache(bb, cache_len))
        self.stats["batches"] += 1
        self.stats["padded_rows"] += bb - len(reqs)
        # a graph's outputs are rewritten by its next replay: keep a copy
        return bb, cache_len, lengths_np, keys, tok.clone()

    def _run_batch(self, reqs: List[Request]) -> Dict[int, RequestResult]:
        tier_id = reqs[0].tier
        tier = self.tiers.get(tier_id)
        try:
            bb, cache_len, lengths, keys, tok = self._prefill_batch(reqs)
        except TransientExecutableFault as f:
            self.stats["exe_faults"] += 1
            return self._fault_requeue(reqs, "exe_fault", str(f))
        except Exception as e:  # noqa: BLE001 - serving must not crash
            # any other exception of the call is contained the same way: the
            # batch retires into the bounded-retry path (Failed once retries
            # run out), never a crashed loop with requests stranded
            self.stats["exe_errors"] += 1
            return self._fault_requeue(reqs, "exe_error", repr(e))
        toks = [tok]
        stop_sets = [r.stop_set for r in reqs]
        has_stops = any(stop_sets)
        n_steps = max(r.max_new_tokens for r in reqs) - 1
        if has_stops:  # host reads only when EOS is in play
            tok0 = tok.cpu().numpy()
            emitted = [1] * len(reqs)
            done = [
                emitted[i] >= r.max_new_tokens or int(tok0[i]) in stop_sets[i]
                for i, r in enumerate(reqs)
            ]
        steps_run = 0
        if n_steps > 0:  # a one-token batch never needs the decode step
            exe = self.exe_cache.get(self.tiers.exe_key("decode", tier_id, bb, cache_len),
                                     lambda: tier.build_decode(bb, cache_len))
            step = _step_of(exe)
            step.static["tok"].copy_(tok)
            cache = self._batch_cache(bb, cache_len)
        for t in range(n_steps):
            if has_stops and all(done):
                break  # every real row hit its budget or a stop id
            self._fault_clock += 1
            self._sync_noise_scale()
            try:
                self._scale_arr()
                tier.fill(step, keys, fold=lengths + t, pos=lengths + t, lengths=lengths)
                _logits, nxt = exe(cache)
                step.static["tok"].copy_(nxt)
            except TransientExecutableFault as f:
                # raised before the step: the batch retries from scratch
                self.stats["exe_faults"] += 1
                self.stats["decode_steps"] += steps_run
                self.stats["decode_slot_steps"] += steps_run * bb
                return self._fault_requeue(reqs, "exe_fault", str(f))
            except Exception as e:  # noqa: BLE001 - serving must not crash
                self.stats["exe_errors"] += 1
                self.stats["decode_steps"] += steps_run
                self.stats["decode_slot_steps"] += steps_run * bb
                return self._fault_requeue(reqs, "exe_error", repr(e))
            tok = nxt.clone()
            toks.append(tok)
            steps_run += 1
            if has_stops:
                tok_np = tok.cpu().numpy()
                for i, r in enumerate(reqs):
                    if not done[i]:
                        emitted[i] += 1
                        done[i] = emitted[i] >= r.max_new_tokens or int(tok_np[i]) in stop_sets[i]

        seq = torch.stack(toks, dim=1).to(torch.int32).cpu().numpy()  # (bb, steps + 1)
        out: Dict[int, RequestResult] = {}
        for i, r in enumerate(reqs):
            row = seq[i, : min(r.max_new_tokens, seq.shape[1])]
            if stop_sets[i]:
                hits = np.flatnonzero(np.isin(row, list(stop_sets[i])))
                if hits.size:  # the stop id is the last emitted token
                    row = row[: hits[0] + 1]
            out[r.uid] = row.copy()
            self.stats["tokens_generated"] += int(row.size)
            self._bump_tier("tier_tokens", tier_id, int(row.size))
        self.stats["decode_steps"] += steps_run
        self.stats["decode_slot_steps"] += steps_run * bb
        self._bump_tier("tier_decode_steps", tier_id, steps_run)
        return out

    # -- continuous execution: persistent per-tier decode slot pools ---------

    def _pool(self, tier) -> DecodePool:
        pool = self._pools.get(tier)
        if pool is None:
            pool = DecodePool(
                tier=tier, slots=self.pool_slots, cache_len=self.pool_cache_len,
                cache=lm.init_cache(self.model_cfg, self.pool_slots, self.pool_cache_len,
                                    device=self.device),
                exec_tier=self.tiers.get(tier),
            )
            # the pool's cache is the static tree its decode and insert steps hold
            pool.place_cache(self._place)
            self._pools[tier] = pool
        return pool

    @property
    def n_in_flight(self) -> int:
        """Requests submitted but not finished: queued + pooled."""
        return self.scheduler.n_pending + sum(p.n_active for p in self._pools.values())

    def pump_step(self, now: Optional[float] = None, *, force: bool = False
                  ) -> Dict[int, RequestResult]:
        """One continuous-scheduling round: expire, one governor step, admit
        ready requests into free slots (every pending one that fits when
        ``force``), then one decode step of every pool with active slots.
        Returns the requests that finished in this round."""
        if not self.continuous:
            raise ValueError("pump_step() requires continuous=True")
        now = self._now(now, "poll")
        results, _ = self._pump_once(now, force)
        return results

    def _pump(self, now: Optional[float], force: bool) -> Dict[int, RequestResult]:
        results: Dict[int, RequestResult] = {}
        while True:
            step_results, progressed = self._pump_once(now, force)
            results.update(step_results)
            if not progressed:
                return results

    def _pump_once(self, now, force):
        """(finished requests, progressed) of one round. Deadlines are
        checked first (clocked calls only), then the governor turns the
        dial on queued work (not under ``force``), then admission, then one
        decode step a pool; ``progressed`` is False only when nothing
        expired, was admitted or decoded."""
        results: Dict[int, RequestResult] = {}
        results.update(self._expire_queued(now))
        results.update(self._expire_pooled(now))
        progressed = bool(results)
        if self.governor is not None and not force:
            self.governor.step(now)
        free = {}
        for tier in self.scheduler.pending_tiers():
            pool = self._pools.get(tier)
            free[tier] = pool.n_free if pool is not None else self.pool_slots
        for reqs in self.scheduler.pop_admissible(now, free, force=force):
            results.update(self._admit(reqs))
            progressed = True
        for pool in self._pools.values():
            if pool.n_active:
                results.update(self._pool_step(pool))
                progressed = True
        if self.metrics is not None:
            self.metrics.record(self, now=now)
        return results, progressed

    def _admit(self, reqs: List[Request]) -> Dict[int, RequestResult]:
        """Prefill a ready group at the pool's cache length and copy it into
        free slots. A request that finishes at its first token (budget 1,
        or a stop id) completes here and never takes a decode step. A fault
        at either call requeues the whole group (taken slots released)."""
        pool = self._pool(reqs[0].tier)
        if len(reqs) > pool.n_free:
            raise ValueError(f"admitting {len(reqs)} requests into {pool.n_free} free slots")
        try:
            bb, _cl, _lengths, _keys, tok = self._prefill_batch(reqs, pool.cache_len)
        except TransientExecutableFault as f:
            self.stats["exe_faults"] += 1
            return self._fault_requeue(reqs, "exe_fault", str(f))
        except Exception as e:  # noqa: BLE001 - serving must not crash
            # no slot is taken yet: the wave retires into the retry path
            self.stats["exe_errors"] += 1
            return self._fault_requeue(reqs, "exe_error", repr(e))
        tok0 = tok.cpu().numpy()  # admission needs the first tokens on the host
        slots = pool.take(len(reqs))
        # batch-padding rows aim past the pool and are dropped
        slot_ids = np.full((bb,), pool.slots, np.int64)
        slot_ids[: len(reqs)] = slots
        # tier-free key: the cache layout is parameter- and noise-free, so
        # one insert serves every tier's pool of this shape
        exe = self.exe_cache.get(
            self.tiers.exe_key("insert", None, pool.slots, pool.cache_len, bb),
            lambda: pool.exec_tier.build_insert(pool.slots, pool.cache_len, bb))
        try:
            _step_of(exe).inputs.fill(slot_ids=slot_ids)
            exe(pool.cache)
        except TransientExecutableFault as f:
            for s in slots:
                pool.release(s)
            self.stats["exe_faults"] += 1
            return self._fault_requeue(reqs, "exe_fault", str(f))
        except Exception as e:  # noqa: BLE001 - serving must not crash
            # the taken slots go back before the requeue: nothing leaks
            for s in slots:
                pool.release(s)
            self.stats["exe_errors"] += 1
            return self._fault_requeue(reqs, "exe_error", repr(e))
        self.stats["admitted"] += len(reqs)
        out: Dict[int, RequestResult] = {}
        for i, (r, s) in enumerate(zip(reqs, slots)):
            t0 = int(tok0[i])
            if r.max_new_tokens == 1 or t0 in r.stop_set:
                pool.release(s)
                out[r.uid] = np.asarray([t0], np.int32)
                self.stats["tokens_generated"] += 1
                self._bump_tier("tier_tokens", r.tier, 1)
                self.stats["retired"] += 1
            else:
                pool.activate(s, r, t0, r.key)
        return out

    def _retire_all(self, pool: DecodePool) -> List[Request]:
        reqs = []
        for s in pool.active_slots():
            reqs.append(pool.retire(s).request)
            self.stats["retired"] += 1
        return reqs

    def _pool_step(self, pool: DecodePool) -> Dict[int, RequestResult]:
        """One decode step over a whole pool: active rows decode at their
        own positions under their own keys, inactive rows are inert
        length-0 rows, and a row that reaches its budget or emits a stop
        id retires at once, its slot free for the next round.

        Fault sites: a stalled step dispatches nothing (a lost step on the
        fault clock); a call fault retires every active row into the retry
        path before any launch; a poisoned row (a token outside the vocab)
        retires that row alone. Per-request keys keep the other rows'
        tokens bit-identical through all of it."""
        plan = self.fault_plan
        clock = self._fault_clock
        self._fault_clock += 1
        if plan is not None and plan.stalled(clock):
            self.stats["stalled_steps"] += 1
            self.fault_log.append({"kind": "stall", "clock": clock, "tier": pool.tier,
                                   "uids": [pool.record(s).request.uid
                                            for s in pool.active_slots()]})
            return {}
        tier = pool.exec_tier
        exe = self.exe_cache.get(
            self.tiers.exe_key("decode", pool.tier, pool.slots, pool.cache_len),
            lambda: tier.build_decode(pool.slots, pool.cache_len))
        step = _step_of(exe)
        try:
            self._sync_noise_scale()
            self._scale_arr()
            tier.fill(step, pool.keys, fold=pool.pos, pos=pool.pos, lengths=pool.lengths)
            step.static["tok"].copy_(torch.from_numpy(pool.tok.astype(np.int64)),
                                     non_blocking=True)
            _logits, tok = exe(pool.cache)
        except TransientExecutableFault as f:
            self.stats["exe_faults"] += 1
            return self._fault_requeue(self._retire_all(pool), "exe_fault", str(f))
        except Exception as e:  # noqa: BLE001 - serving must not crash
            # every active row retires (slots freed, never aliased) into the
            # bounded-retry path
            self.stats["exe_errors"] += 1
            return self._fault_requeue(self._retire_all(pool), "exe_error", repr(e))
        t_read = time.perf_counter()
        tok_np = tok.cpu().numpy()  # retiring rows needs this step's tokens
        self.stats["pool_read_s"] += time.perf_counter() - t_read
        if plan is not None and plan.poison_map:
            tok_np = tok_np.copy()
            plan.poison_rows(clock, tok_np)  # detected below by value
        self.stats["decode_steps"] += 1
        self.stats["decode_slot_steps"] += pool.slots
        self.stats["active_slot_steps"] += pool.n_active
        self._bump_tier("tier_decode_steps", pool.tier, 1)
        out: Dict[int, RequestResult] = {}
        poisoned: List[Request] = []
        vocab = self.model_cfg.vocab_size
        for s in pool.active_slots():
            t = int(tok_np[s])
            if not 0 <= t < vocab:
                poisoned.append(pool.retire(s).request)
                self.stats["poisoned_rows"] += 1
                self.stats["retired"] += 1
                continue
            rec = pool.record(s)
            rec.emitted.append(t)
            pool.tok[s] = t
            pool.pos[s] += 1
            if rec.done:
                pool.retire(s)
                out[rec.request.uid] = np.asarray(rec.emitted, np.int32)
                self.stats["tokens_generated"] += len(rec.emitted)
                self._bump_tier("tier_tokens", pool.tier, len(rec.emitted))
                self.stats["retired"] += 1
        for r in poisoned:
            out.update(self._fault_requeue([r], "poison", "out-of-vocab token"))
        return out

    # -- introspection -------------------------------------------------------

    @property
    def energies(self):
        """The frozen energy allocation (None on a digital engine)."""
        return self._energies

    def effective_energies(self):
        """The energies the hardware delivers now: the allocation divided by
        the realized drift factor squared (the allocation itself at 1.0)."""
        if self._energies is None:
            raise ValueError("digital engine: no energy tree")
        s = self._noise_scale
        if s == 1.0:
            return self._energies
        return map_leaves(lambda _p, e: e / (s * s), self._energies)

    @property
    def profiles(self) -> Dict[str, PrecisionProfile]:
        """The registered per-layer precision tiers (a copy)."""
        return self.tiers.profiles

    @property
    def pools(self) -> Dict[object, DecodePool]:
        """The live per-tier decode pools (continuous mode; a copy)."""
        return dict(self._pools)

    def tier_energy_per_token(self, tier) -> float:
        """Modelled energy of one generated token of a tier (aJ), from the
        tier's own cost model: an analog tier's ``sum_l K_l * E_l *
        MACs_l`` over the frozen per-site energies (uniform K is the
        degenerate profile), a digital tier's per-MAC constant times its
        MACs. ``tier``: a tier id (K int, profile name) or an ad-hoc
        ``PrecisionProfile``."""
        if isinstance(tier, PrecisionProfile):
            if self._energies is None:
                raise ValueError("digital engine: no energy tree to account")
            return lm.profile_token_energy(self.model_cfg, self._energies, tier)
        return float(self.tiers.get(tier).energy_per_token())

    @property
    def trace_count(self) -> int:
        """Steps built since construction (== the cache's misses before any
        ``reset_stats``): the reference's retrace count."""
        return self._traces

    def cache_stats(self) -> dict:
        return self.exe_cache.stats()

    def probe_apply(self):
        """``(energies, tokens, key) -> final hidden states`` over the live
        model: the apply function of ``core.calibrate`` (``learn_energies``,
        ``eval_accuracy``, ``noise_rms``) for this engine's weights, noise
        model and backend, a forward that keeps no cache. ``tokens`` (B, T)
        with one raw (2,) key, or (S, B, T) with a stacked (S, 2) key: S
        noise samples, each computed as the batch alone under its key. The
        reference caches its jitted function on the engine; the port runs
        eagerly and needs no cache."""
        if self.analog_cfg is None:
            raise ValueError("digital engine: nothing to probe")

        def fn(energies, tokens, key):
            tok = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
            key = raw_key(key)
            lead = tok.shape[:-1]
            rows = int(np.prod(lead[1:], dtype=np.int64)) if key.ndim == 2 else 1
            spec = lm.AnalogSpec(cfg=self.analog_cfg, energies=energies, key=key,
                                 rows_per_key=rows)
            h = lm.hidden(self.params, tok.reshape(-1, tok.shape[-1]), self.model_cfg,
                          analog=spec)
            return h.reshape(*lead, *h.shape[1:])

        return fn

    def probe_reference(self, tokens) -> torch.Tensor:
        """Clean (digital) final hidden states of a probe batch (B, T): the
        zero-noise reference of ``probe_apply``."""
        tok = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        return lm.hidden(self.params, tok, self.model_cfg)

"""Bucket-batched analog serving engine.

Port of ``repro/serving/engine.py`` (without faults, deadlines, the
precision governor, metrics and meshes):

  submit -> TierScheduler groups same-tier requests        (scheduler.py)
         -> pad into a power-of-two (batch, seq) bucket    (bucketing.py)
         -> prefill, then decode steps                     (tiers.py, models/lm.py)

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

The engine runs on ``device`` (default ``"cuda"``; it raises without a
card unless the caller passes ``device="cpu"``). ``params`` and
``energies`` must already live there.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig, raw_key
from repro_torch.core.profile import PrecisionProfile
from repro_torch.device import resolve_device
from repro_torch.kernels.prng import PRNGKey, fold_in
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.serving.bucketing import (
    DEFAULT_BATCH_BUCKETS,
    DEFAULT_SEQ_BUCKETS,
    bucket_shape,
    next_bucket,
    pad_to_bucket,
    pool_shape,
)
from repro_torch.serving.pool import DecodePool
from repro_torch.serving.scheduler import Request, TierScheduler
from repro_torch.serving.tiers import TierRegistry


def batch_keys(keys: Sequence[np.ndarray], bb: int) -> np.ndarray:
    """Stack request keys into a (bb, 2) table; batch-padding rows get the
    fixed key ``PRNGKey(0)`` (their outputs are discarded)."""
    rows = [raw_key(k) for k in keys] + [PRNGKey(0)] * (bb - len(keys))
    return np.stack(rows)


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
        device="cuda",
    ):
        self.device = resolve_device(device)
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
        self.energies = energies
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
        )
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
        self.stats = {
            "requests": 0,
            "batches": 0,  # prefill batches (admission waves in continuous mode)
            "tokens_generated": 0,
            "padded_rows": 0,
            "decode_steps": 0,
            "decode_slot_steps": 0,  # decode steps x batch rows (or pool slots)
            "active_slot_steps": 0,  # of those, pool rows that carried a request
            "admitted": 0,  # requests admitted into a pool slot
            "retired": 0,  # pool retirements (budget reached or stop id)
            "pool_read_s": 0.0,  # host seconds waiting for pool steps' tokens
            "tier_tokens": {},
            "tier_decode_steps": {},
        }

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

    def submit(
        self,
        tokens,
        *,
        n_repeats: int = 1,
        profile=None,
        max_new_tokens: Optional[int] = None,
        stop_tokens: Sequence[int] = (),
        key=None,
        now: Optional[float] = None,
    ) -> int:
        """Enqueue one request; returns its uid (the key of its result).

        ``profile``: a registered profile's name or a ``PrecisionProfile``
        (registered here), exclusive with ``n_repeats``; a uniform profile
        is the ``n_repeats=K`` tier. A digital engine serves every request
        on its one tier.

        Raises ``ValueError`` for requests the engine could never serve: an
        empty prompt, a prompt longer than the largest seq bucket, a
        ``max_new_tokens`` outside ``[1, max_gen]`` (None asks for the full
        ``max_gen``), ``n_repeats < 1``, an unknown profile, or in
        continuous mode a request that does not fit a pool slot.
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
        if self.continuous:
            sb = next_bucket(tokens.size, self.seq_buckets)
            if sb + max_new_tokens > self.pool_cache_len:
                raise ValueError(
                    f"request needs {sb} (seq bucket) + {max_new_tokens} (decode "
                    f"budget) cache slots but the decode pools hold "
                    f"{self.pool_cache_len}; raise pool_cache_len or size "
                    "seq_buckets/max_gen to the traffic"
                )
        if profile is not None:
            if n_repeats != 1:
                raise ValueError(
                    "pass either n_repeats or profile, not both: a profile "
                    "is the per-layer form of the same knob"
                )
            tier_id = self.tiers.resolve_profile(profile)
        else:
            tier_id = int(n_repeats)
        if self.analog_cfg is None:
            tier_id = self.tiers.base_id  # K and profiles are no-ops without noise
        arrival = self._now(now, "submit")
        uid = self._uid
        self._uid += 1
        if key is None:
            key = fold_in(self._base_key, uid)
        req = Request(
            uid=uid,
            tokens=tokens,
            max_new_tokens=int(max_new_tokens),
            key=raw_key(key),
            arrival=arrival,
            stop_tokens=tuple(int(t) for t in stop_tokens),
            tier=tier_id,
        )
        self.scheduler.submit(req)
        self.stats["requests"] += 1
        return uid

    def poll(self, now: Optional[float] = None) -> Dict[int, np.ndarray]:
        """Serve what is ready at ``now``; returns the finished uids' token
        rows. Batch-synchronous: each ready batch to completion.
        Continuous: admit ready requests and pump decode steps until the
        pools drain and nothing else is ready."""
        now = self._now(now, "poll")
        if self.continuous:
            return self._pump(now, force=False)
        results: Dict[int, np.ndarray] = {}
        for reqs in self.scheduler.pop_ready(now):
            results.update(self._run_batch(reqs))
        return results

    def flush(self) -> Dict[int, np.ndarray]:
        """Drain the queue regardless of deadlines (end of replay/shutdown)."""
        if self.continuous:
            return self._pump(None, force=True)
        results: Dict[int, np.ndarray] = {}
        for reqs in self.scheduler.flush():
            results.update(self._run_batch(reqs))
        return results

    # -- execution -----------------------------------------------------------

    def _prefill_batch(self, reqs: List[Request], cache_len: Optional[int] = None):
        """Pad into a bucket and prefill at ``cache_len`` (default: the
        batch's ``sb + max_gen``; admission passes the pool's): returns
        (bb, lengths (bb,) numpy, keys (bb, 2), cache, first tokens (bb,) on
        the device)."""
        tier = self.tiers.get(reqs[0].tier)
        bb, sb = bucket_shape(
            len(reqs), max(r.prompt_len for r in reqs),
            batch_buckets=self.batch_buckets, seq_buckets=self.seq_buckets,
        )
        tokens_np, lengths_np = pad_to_bucket(
            [r.tokens for r in reqs], (bb, sb), pad_id=self.pad_id
        )
        keys = batch_keys([r.key for r in reqs], bb)
        cache, logits = tier.prefill(
            torch.from_numpy(tokens_np).to(self.device, non_blocking=True),
            torch.from_numpy(lengths_np).to(self.device, non_blocking=True),
            keys, sb + self.max_gen if cache_len is None else cache_len,
        )
        self.stats["batches"] += 1
        self.stats["padded_rows"] += bb - len(reqs)
        return bb, lengths_np, keys, cache, torch.argmax(logits, dim=-1)

    def _run_batch(self, reqs: List[Request]) -> Dict[int, np.ndarray]:
        tier_id = reqs[0].tier
        if any(r.tier != tier_id for r in reqs):
            raise ValueError("mixed-tier batch")
        tier = self.tiers.get(tier_id)
        bb, lengths, keys, cache, tok = self._prefill_batch(reqs)
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
        for t in range(n_steps):
            if has_stops and all(done):
                break  # every real row hit its budget or a stop id
            logits, cache = tier.decode(cache, tok, lengths + t, keys, lengths)
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
            steps_run += 1
            if has_stops:
                tok_np = tok.cpu().numpy()
                for i, r in enumerate(reqs):
                    if not done[i]:
                        emitted[i] += 1
                        done[i] = emitted[i] >= r.max_new_tokens or int(tok_np[i]) in stop_sets[i]

        seq = torch.stack(toks, dim=1).to(torch.int32).cpu().numpy()  # (bb, steps + 1)
        out: Dict[int, np.ndarray] = {}
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
            self._pools[tier] = pool
        return pool

    @property
    def n_in_flight(self) -> int:
        """Requests submitted but not finished: queued + pooled."""
        return self.scheduler.n_pending + sum(p.n_active for p in self._pools.values())

    def pump_step(self, now: Optional[float] = None, *, force: bool = False) -> Dict[int, np.ndarray]:
        """One continuous-scheduling round: admit ready requests into free
        slots (every pending one that fits when ``force``), then one
        decode step of every pool with active slots. Returns the requests
        that finished in this round."""
        if not self.continuous:
            raise ValueError("pump_step() requires continuous=True")
        now = self._now(now, "poll")
        results, _ = self._pump_once(now, force)
        return results

    def _pump(self, now: Optional[float], force: bool) -> Dict[int, np.ndarray]:
        results: Dict[int, np.ndarray] = {}
        while True:
            step_results, progressed = self._pump_once(now, force)
            results.update(step_results)
            if not progressed:
                return results

    def _pump_once(self, now, force):
        """(finished requests, progressed) of one admit-then-decode round.
        Admission comes first, so freed slots refill as soon as the
        scheduler's readiness rule allows; ``progressed`` is False only
        when nothing was admitted and no slot decoded."""
        results: Dict[int, np.ndarray] = {}
        progressed = False
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
        return results, progressed

    def _admit(self, reqs: List[Request]) -> Dict[int, np.ndarray]:
        """Prefill a ready group at the pool's cache length and copy it into
        free slots. A request that finishes at its first token (budget 1,
        or a stop id) completes here and never takes a decode step."""
        pool = self._pool(reqs[0].tier)
        if len(reqs) > pool.n_free:
            raise ValueError(f"admitting {len(reqs)} requests into {pool.n_free} free slots")
        bb, _lengths, _keys, src_cache, tok = self._prefill_batch(reqs, pool.cache_len)
        tok0 = tok.cpu().numpy()  # admission needs the first tokens on the host
        slots = pool.take(len(reqs))
        # batch-padding rows aim past the pool and are dropped
        slot_ids = np.full((bb,), pool.slots, np.int64)
        slot_ids[: len(reqs)] = slots
        lm.scatter_cache_rows(self.model_cfg, pool.cache, src_cache, slot_ids)
        self.stats["admitted"] += len(reqs)
        out: Dict[int, np.ndarray] = {}
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

    def _pool_step(self, pool: DecodePool) -> Dict[int, np.ndarray]:
        """One decode step over a whole pool: active rows decode at their
        own positions under their own keys, inactive rows are inert
        length-0 rows, and a row that reaches its budget or emits a stop
        id retires at once, its slot free for the next round."""
        tok_dev = torch.from_numpy(pool.tok.astype(np.int64)).to(self.device, non_blocking=True)
        logits, pool.cache = pool.exec_tier.decode(pool.cache, tok_dev, pool.pos, pool.keys,
                                                   pool.lengths)
        tok = torch.argmax(logits, dim=-1)
        t_read = time.perf_counter()
        tok_np = tok.cpu().numpy()  # retiring rows needs this step's tokens
        self.stats["pool_read_s"] += time.perf_counter() - t_read
        self.stats["decode_steps"] += 1
        self.stats["decode_slot_steps"] += pool.slots
        self.stats["active_slot_steps"] += pool.n_active
        self._bump_tier("tier_decode_steps", pool.tier, 1)
        out: Dict[int, np.ndarray] = {}
        for s in pool.active_slots():
            t = int(tok_np[s])
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
        return out

    # -- introspection -------------------------------------------------------

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
            if self.energies is None:
                raise ValueError("digital engine: no energy tree to account")
            return lm.profile_token_energy(self.model_cfg, self.energies, tier)
        return float(self.tiers.get(tier).energy_per_token())

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

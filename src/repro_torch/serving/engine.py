"""Bucket-batched analog serving engine (batch-synchronous).

Port of the batch-synchronous path of ``repro/serving/engine.py``:

  submit -> TierScheduler groups same-tier requests        (scheduler.py)
         -> pad into a power-of-two (batch, seq) bucket    (bucketing.py)
         -> prefill once, then decode steps to completion  (tiers.py, models/lm.py)

Every request is served with its own key stacked into the batch (its own
noise streams at every site), its own true prompt length (per-row decode
positions) and greedy sampling, so its tokens do not depend on what else
shares its batch. Request keys are ``fold_in(PRNGKey(seed), uid)``;
batch-padding rows carry ``PRNGKey(0)`` and length 0.

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
from repro_torch.device import resolve_device
from repro_torch.kernels.prng import PRNGKey, fold_in
from repro_torch.models.config import ModelConfig
from repro_torch.serving.bucketing import (
    DEFAULT_BATCH_BUCKETS,
    DEFAULT_SEQ_BUCKETS,
    bucket_shape,
    pad_to_bucket,
)
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
    it. ``max_gen`` bounds every request's decode budget (the batch's cache
    length is its seq bucket plus ``max_gen``).
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
        device="cuda",
    ):
        self.device = resolve_device(device)
        if analog_cfg is not None and energies is None:
            raise ValueError("analog serving requires an energy tree")
        self.params = params
        self.model_cfg = model_cfg
        self.analog_cfg = analog_cfg
        self.energies = energies
        self.tiers = TierRegistry(self)
        self.max_gen = max_gen
        self.batch_buckets = tuple(batch_buckets)
        self.seq_buckets = tuple(seq_buckets)
        self.pad_id = pad_id
        self.scheduler = TierScheduler(
            max_batch=min(max_batch, max(batch_buckets)),
            max_wait=max_wait,
            seq_buckets=seq_buckets,
        )
        self._base_key = PRNGKey(seed)
        self._uid = 0
        self._clock: Optional[str] = None  # "real" | "virtual", set on first use
        self.stats = {
            "requests": 0,
            "batches": 0,
            "tokens_generated": 0,
            "padded_rows": 0,
            "decode_steps": 0,
            "decode_slot_steps": 0,  # decode steps x batch rows dispatched
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

    def submit(
        self,
        tokens,
        *,
        n_repeats: int = 1,
        max_new_tokens: Optional[int] = None,
        stop_tokens: Sequence[int] = (),
        key=None,
        now: Optional[float] = None,
    ) -> int:
        """Enqueue one request; returns its uid (the key of its result).

        Raises ``ValueError`` for requests the engine could never serve: an
        empty prompt, a prompt longer than the largest seq bucket, a
        ``max_new_tokens`` outside ``[1, max_gen]`` (None asks for the full
        ``max_gen``), or ``n_repeats < 1``.
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
        uid = self._uid
        self._uid += 1
        if key is None:
            key = fold_in(self._base_key, uid)
        tier_id = self.tiers.base_id if self.analog_cfg is None else int(n_repeats)
        req = Request(
            uid=uid,
            tokens=tokens,
            max_new_tokens=int(max_new_tokens),
            key=raw_key(key),
            arrival=self._now(now, "submit"),
            stop_tokens=tuple(int(t) for t in stop_tokens),
            tier=tier_id,
        )
        self.scheduler.submit(req)
        self.stats["requests"] += 1
        return uid

    def poll(self, now: Optional[float] = None) -> Dict[int, np.ndarray]:
        """Serve every batch that is ready at ``now`` (each to completion);
        returns the finished uids' token rows."""
        now = self._now(now, "poll")
        results: Dict[int, np.ndarray] = {}
        for reqs in self.scheduler.pop_ready(now):
            results.update(self._run_batch(reqs))
        return results

    def flush(self) -> Dict[int, np.ndarray]:
        """Drain the queue regardless of deadlines (end of replay/shutdown)."""
        results: Dict[int, np.ndarray] = {}
        for reqs in self.scheduler.flush():
            results.update(self._run_batch(reqs))
        return results

    # -- execution -----------------------------------------------------------

    def _prefill_batch(self, reqs: List[Request]):
        """Pad into a bucket and prefill: returns (bb, lengths (bb,) numpy,
        keys (bb, 2), cache, first tokens (bb,) on the device)."""
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
            keys, sb + self.max_gen,
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
            logits, cache = tier.decode(cache, tok, lengths + t, keys)
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

"""Precision-tiered request scheduling; port of ``repro/serving/scheduler.py``
(without cancellation, retiering and queue bounds).

What a tier computes is fixed for a whole batch, so a batch never mixes
tiers. A tier id is an opaque grouping key: a uniform K int or a
registered profile's name. The scheduler keeps one FIFO queue per (tier,
seq_bucket) group and dispatches a group when it fills its batch or its
oldest request has waited ``max_wait`` seconds; ``pop_admissible`` does
the same for continuous batching, capped by each tier's free decode
slots. Pure Python and deterministic.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.bucketing import DEFAULT_SEQ_BUCKETS, next_bucket


@dataclasses.dataclass
class Request:
    """One generation request at a precision tier.

    ``key`` (a raw (2,) uint32 key) seeds the request's private noise
    streams, so its output does not depend on its batch-mates.
    ``stop_tokens`` end the request the step it emits one (the stop id is
    its last token).
    """

    uid: int
    tokens: np.ndarray  # (L,) prompt token ids
    tier: object = 1  # tier id: a uniform K int or a profile name
    max_new_tokens: int = 16
    key: Optional[np.ndarray] = None
    arrival: float = 0.0
    stop_tokens: Tuple[int, ...] = ()

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).reshape(-1).shape[0])

    @property
    def stop_set(self) -> frozenset:
        return frozenset(int(t) for t in self.stop_tokens)


class TierScheduler:
    """Groups same-tier requests into shared bucket batches with a deadline."""

    def __init__(self, *, max_batch: int = 8, max_wait: float = 0.05,
                 seq_buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS):
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.seq_buckets = tuple(seq_buckets)
        # (tier, seq_bucket) -> FIFO; ordered so dispatch follows submission
        self._queues: "OrderedDict[Tuple[object, int], List[Request]]" = OrderedDict()

    def group_of(self, req: Request) -> Tuple[object, int]:
        return (req.tier, next_bucket(req.prompt_len, self.seq_buckets))

    def submit(self, req: Request) -> Tuple[object, int]:
        g = self.group_of(req)
        self._queues.setdefault(g, []).append(req)
        return g

    @property
    def n_pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def pop_ready(self, now: float) -> List[List[Request]]:
        """Full groups, plus any group whose oldest request waited ``max_wait``."""
        batches: List[List[Request]] = []
        for g in list(self._queues):
            q = self._queues[g]
            while len(q) >= self.max_batch:
                batches.append(q[: self.max_batch])
                del q[: self.max_batch]
            if q and now - q[0].arrival >= self.max_wait:
                batches.append(q[:])
                q.clear()
            if not q:
                del self._queues[g]
        return batches

    def pending_tiers(self) -> set:
        """Tiers with queued requests (pools are created lazily, so the
        engine sizes its free-slot accounting off this set)."""
        return {tier for tier, _sb in self._queues}

    def pop_admissible(self, now: Optional[float], free_slots: Dict[object, int], *,
                       force: bool = False) -> List[List[Request]]:
        """Slot-aware admission for continuous batching.

        ``free_slots`` maps tier -> free decode slots in that tier's pool
        and is decremented in place as requests are admitted (the groups of
        one tier at different seq buckets share its pool). A group
        dispatches under ``pop_ready``'s rule, a full batch or an oldest
        request aged past ``max_wait`` (``force`` ignores both), but never
        more rows than its tier has free slots: the rest stays queued in
        FIFO order and is admitted as retirements free slots.
        """
        batches: List[List[Request]] = []
        for g in list(self._queues):
            tier, _sb = g
            q = self._queues[g]
            free = free_slots.get(tier, 0)
            while q and free > 0 and (
                force or len(q) >= self.max_batch or now - q[0].arrival >= self.max_wait
            ):
                n = min(len(q), self.max_batch, free)
                batches.append(q[:n])
                del q[:n]
                free -= n
            free_slots[tier] = free
            if not q:
                del self._queues[g]
        return batches

    def flush(self) -> List[List[Request]]:
        """Drain everything, deadline ignored."""
        batches = []
        for g in list(self._queues):
            q = self._queues.pop(g)
            for i in range(0, len(q), self.max_batch):
                batches.append(q[i : i + self.max_batch])
        return batches

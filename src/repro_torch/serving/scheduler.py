"""Precision-tiered request scheduling; port of ``repro/serving/scheduler.py``.

What a tier computes is fixed for a whole batch, so a batch never mixes
tiers. A tier id is an opaque grouping key: a uniform K int or a
registered profile's name. The scheduler keeps one FIFO queue per (tier,
seq_bucket) group and dispatches a group when it fills its batch or its
oldest request has waited ``max_wait`` seconds; ``pop_admissible`` does
the same for continuous batching, capped by each tier's free decode
slots. Queued requests can expire (``pop_expired``), be withdrawn
(``cancel``) and move between tiers (``reassign``, the precision
governor's sweep) with every queue kept in FIFO order; ``max_queue``
bounds the queue (``QueueFull``). Pure Python and deterministic.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.bucketing import DEFAULT_SEQ_BUCKETS, next_bucket
from repro_torch.serving.faults import QueueFull


@dataclasses.dataclass
class Request:
    """One generation request at a precision tier.

    ``key`` (a raw (2,) uint32 key) seeds the request's private noise
    streams, so its output does not depend on its batch-mates.
    ``stop_tokens`` end the request the step it emits one (the stop id is
    its last token).

    ``deadline`` is an absolute time on the engine's clock past which the
    request is retired with a ``TimedOut`` result; ``retries`` counts its
    fault-triggered resubmissions. ``target_latency`` (seconds from
    arrival) and ``accuracy_floor`` (the least tier accuracy the precision
    governor may demote it to) are its SLO.
    """

    uid: int
    tokens: np.ndarray  # (L,) prompt token ids
    tier: object = 1  # tier id: a uniform K int or a profile name
    max_new_tokens: int = 16
    key: Optional[np.ndarray] = None
    arrival: float = 0.0
    stop_tokens: Tuple[int, ...] = ()
    deadline: Optional[float] = None
    retries: int = 0
    target_latency: Optional[float] = None
    accuracy_floor: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).reshape(-1).shape[0])

    @property
    def stop_set(self) -> frozenset:
        return frozenset(int(t) for t in self.stop_tokens)

    def retier(self, tier) -> None:
        """Bind the request to another tier id."""
        self.tier = tier


class TierScheduler:
    """Groups same-tier requests into shared bucket batches with a deadline."""

    def __init__(self, *, max_batch: int = 8, max_wait: float = 0.05,
                 seq_buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS,
                 max_queue: Optional[int] = None):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.max_queue = max_queue
        self.seq_buckets = tuple(seq_buckets)
        # (tier, seq_bucket) -> FIFO; ordered so dispatch follows submission
        self._queues: "OrderedDict[Tuple[object, int], List[Request]]" = OrderedDict()

    def group_of(self, req: Request) -> Tuple[object, int]:
        return (req.tier, next_bucket(req.prompt_len, self.seq_buckets))

    def submit(self, req: Request, *, force: bool = False) -> Tuple[object, int]:
        """Enqueue one request; past ``max_queue`` pending raises
        ``QueueFull`` unless ``force`` (the engine's fault requeues: the
        request was admitted once already)."""
        if not force and self.max_queue is not None and self.n_pending >= self.max_queue:
            raise QueueFull(
                f"scheduler queue is at its high-water mark "
                f"({self.n_pending}/{self.max_queue} pending); poll/pump to "
                "drain or shed load upstream"
            )
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

    def pop_expired(self, now: float) -> List[Request]:
        """Remove and return every queued request whose deadline is at or
        before ``now``; the rest keep their FIFO order."""
        expired: List[Request] = []
        for g in list(self._queues):
            keep = []
            for r in self._queues[g]:
                (expired if r.deadline is not None and r.deadline <= now else keep).append(r)
            if keep:
                self._queues[g] = keep
            else:
                del self._queues[g]
        return expired

    def cancel(self, uid: int) -> Optional[Request]:
        """Withdraw one queued request; returns it, or None when ``uid`` is
        not queued (dispatched, finished or unknown)."""
        for g in list(self._queues):
            q = self._queues[g]
            for i, r in enumerate(q):
                if r.uid == uid:
                    del q[i]
                    if not q:
                        del self._queues[g]
                    return r
        return None

    def pending_tiers(self) -> set:
        """Tiers with queued requests (pools are created lazily, so the
        engine sizes its free-slot accounting off this set)."""
        return {tier for tier, _sb in self._queues}

    def queued_requests(self) -> List[Request]:
        """Every queued request, group by group, each in FIFO order."""
        return [r for q in self._queues.values() for r in q]

    def reassign(self, assign) -> List[Tuple[Request, object, object]]:
        """Move queued requests between tiers (the governor's sweep).

        ``assign(req)`` returns the request's new tier id, or None (or its
        current tier) to leave it; it must be idempotent, since a moved
        request can be offered again in a group not yet visited. Every
        queue a request moved into is re-sorted by ``(arrival, uid)``, so a
        moved request keeps its place against younger traffic. Returns
        ``[(request, old_tier, new_tier)]`` in sweep order; dispatched
        requests are out of reach (their tier is bound at admission).
        """
        moves: List[Tuple[Request, object, object]] = []
        touched = set()
        for g in list(self._queues):
            q = self._queues.get(g)
            if not q:
                continue
            keep: List[Request] = []
            for r in q:
                new = assign(r)
                if new is None or new == r.tier:
                    keep.append(r)
                    continue
                old = r.tier
                r.retier(new)
                ng = self.group_of(r)
                self._queues.setdefault(ng, []).append(r)
                touched.add(ng)
                moves.append((r, old, new))
            if keep:
                self._queues[g] = keep
            else:
                del self._queues[g]
        for ng in touched:
            self._queues[ng].sort(key=lambda r: (r.arrival, r.uid))
        return moves

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

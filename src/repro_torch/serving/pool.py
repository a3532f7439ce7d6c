"""Persistent decode slot pools: the state behind continuous batching.

Port of ``repro/serving/pool.py``.
A ``DecodePool`` is one tier's always-resident decode batch: ``slots``
rows, each free or carrying one in-flight request, over one device cache
tree (``lm.init_cache(cfg, slots, cache_len)``, placed by the engine with
``place_cache``) that the pool's decode steps and admissions update in
place: the static tree their CUDA graphs hold. The engine decodes the whole pool
every step; free slots ride along as length-0 rows at position 0 with key
words (0, 0), the batch-padding contract, and their outputs are
discarded. A slot retires the step its request reaches its token budget
or emits a stop id, and freshly prefilled requests are admitted into free
slots mid-flight by copying their cache rows in
(``lm.scatter_cache_rows``).

Host-side slot state (current token, position, true length, key words)
is O(slots) numbers passed with each step; the cache stays on the device.

``SlotAllocator`` is the pool's free list: a slot is never handed out
twice while held, never released twice, and a retired slot re-enters the
free list only after its record is cleared.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, List, Optional

import numpy as np


class SlotAllocator:
    """Lowest-index-first free list with invariant checks; the same
    take/release sequence always gives the same slots."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"allocator needs at least 1 slot, got {n_slots}")
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots))
        self._held: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_held(self) -> int:
        return len(self._held)

    def held(self) -> frozenset:
        return frozenset(self._held)

    def take(self, k: int) -> List[int]:
        """Claim the ``k`` lowest free slots; raises if fewer are free."""
        if k < 0:
            raise ValueError(f"cannot take {k} slots")
        if k > len(self._free):
            raise ValueError(f"take({k}) with only {len(self._free)} free slots")
        out, self._free = self._free[:k], self._free[k:]
        self._held.update(out)
        return out

    def release(self, slot: int) -> None:
        """Return a held slot; raises on a double release or a slot never taken."""
        if slot not in self._held:
            raise ValueError(f"slot {slot} is not held (double release?)")
        self._held.remove(slot)
        bisect.insort(self._free, slot)


@dataclasses.dataclass
class SlotRecord:
    """One in-flight request pinned to a decode slot."""

    request: Any  # serving.scheduler.Request
    emitted: List[int]  # greedy tokens so far (the first from prefill)
    stop_set: frozenset  # stop ids: emitting one retires the slot

    @property
    def done(self) -> bool:
        return len(self.emitted) >= self.request.max_new_tokens or (
            bool(self.emitted) and self.emitted[-1] in self.stop_set
        )


class DecodePool:
    """One execution tier's persistent decode batch.

    ``cache`` is the device cache tree; ``tok``/``pos``/``lengths``/``keys``
    are the per-slot host rows of the decode step (a free slot has length
    0, so pool occupancy never changes an active row's numbers). ``tier``
    is the scheduler's tier id, ``exec_tier`` the ``ExecutionTier`` the
    engine runs the pool's steps through.
    """

    def __init__(self, *, tier, slots: int, cache_len: int, cache, exec_tier=None):
        self.tier = tier
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        self.exec_tier = exec_tier
        self.cache = cache
        self.allocator = SlotAllocator(self.slots)
        self.tok = np.zeros((self.slots,), np.int32)
        self.pos = np.zeros((self.slots,), np.int32)
        self.lengths = np.zeros((self.slots,), np.int32)  # 0 == inactive row
        self.keys = np.zeros((self.slots, 2), np.uint32)
        self._rec: List[Optional[SlotRecord]] = [None] * self.slots

    def place_cache(self, put) -> None:
        """Place the pool's cache with ``put`` (tree -> tree), once, before
        its first step: the engine's device placement. Every step then
        updates this tree in place, and a step captured as a CUDA graph
        holds its addresses."""
        self.cache = put(self.cache)

    @property
    def n_free(self) -> int:
        return self.allocator.n_free

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._rec)

    def active_slots(self) -> List[int]:
        """Occupied slots (a snapshot: stable under retire-while-iterating)."""
        return [s for s, r in enumerate(self._rec) if r is not None]

    def record(self, slot: int) -> SlotRecord:
        rec = self._rec[slot]
        if rec is None:
            raise ValueError(f"slot {slot} is not active")
        return rec

    def expired(self, now: float) -> List[int]:
        """Active slots whose request's deadline is at or before ``now``
        (the engine retires them through :meth:`retire` with a partial
        ``TimedOut`` result)."""
        out = []
        for s in self.active_slots():
            d = self.record(s).request.deadline
            if d is not None and d <= now:
                out.append(s)
        return out

    def take(self, k: int) -> List[int]:
        """Claim ``k`` free slots for an admission wave; they decode only
        after :meth:`activate`."""
        return self.allocator.take(k)

    def activate(self, slot: int, request, first_token: int, key_row) -> None:
        """Arm a taken slot with a prefilled request: its first token, its
        decode position and true length (the prompt length) and its key."""
        if self._rec[slot] is not None:
            raise ValueError(f"slot {slot} already active")
        self._rec[slot] = SlotRecord(request=request, emitted=[int(first_token)],
                                     stop_set=request.stop_set)
        self.tok[slot] = int(first_token)
        self.pos[slot] = request.prompt_len
        self.lengths[slot] = request.prompt_len
        self.keys[slot] = np.asarray(key_row, np.uint32)

    def release(self, slot: int) -> None:
        """Return a taken slot that was never activated (the request
        finished at prefill)."""
        if self._rec[slot] is not None:
            raise ValueError(f"slot {slot} is active; retire() it")
        self.allocator.release(slot)

    def retire(self, slot: int) -> SlotRecord:
        """Free an active slot the step its request finishes: the row goes
        back to the inert length-0 state (position 0, key (0, 0)); its cache
        rows stay until the next admission overwrites them."""
        rec = self.record(slot)
        self._rec[slot] = None
        self.tok[slot] = 0
        self.pos[slot] = 0
        self.lengths[slot] = 0
        self.keys[slot] = 0
        self.allocator.release(slot)
        return rec

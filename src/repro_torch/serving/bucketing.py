"""Shape bucketing: pad heterogeneous requests into a bounded shape set.

Port of ``repro/serving/bucketing.py``. Batches are rounded up to
power-of-two (batch, seq) buckets; selection is a pure function of the
request shapes, so the same queue always lands in the same buckets.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

#: default power-of-two ladders; callers pass their own for other regimes.
DEFAULT_SEQ_BUCKETS = (32, 64, 128, 256, 512, 1024)
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16)


def next_bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value. Raises when the ladder can't hold it."""
    if value <= 0:
        raise ValueError(f"bucket input must be positive, got {value}")
    for b in sorted(buckets):
        if value <= b:
            return b
    raise ValueError(f"{value} exceeds largest bucket {max(buckets)}")


def pool_shape(slots: int, seq_buckets: Sequence[int], max_gen: int) -> Tuple[int, int]:
    """(slots, cache_len) of a persistent continuous-batching decode pool.

    The pool's cache keeps one shape for the tier's lifetime (admissions
    copy rows in), so a slot must hold the largest admissible prompt, the
    top of the seq ladder, plus the whole decode budget. A request
    prefilled at a smaller seq bucket lands in the same pool: its prefill
    runs at the pool's cache length.
    """
    if slots < 1:
        raise ValueError(f"pool needs at least 1 slot, got {slots}")
    if max_gen < 1:
        raise ValueError(f"max_gen must be >= 1, got {max_gen}")
    return int(slots), int(max(seq_buckets)) + int(max_gen)


def bucket_shape(
    n_rows: int,
    max_len: int,
    *,
    batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
    seq_buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS,
) -> Tuple[int, int]:
    """(batch_bucket, seq_bucket) for a group of requests."""
    return next_bucket(n_rows, batch_buckets), next_bucket(max_len, seq_buckets)


def pad_to_bucket(
    prompts: Sequence[np.ndarray],
    bucket: Tuple[int, int],
    *,
    pad_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad prompts into a (Bb, Sb) token block.

    Returns (tokens (Bb, Sb) int32, lengths (Bb,) int32). Rows beyond
    ``len(prompts)`` are batch padding: all-pad tokens with length 0.
    """
    bb, sb = bucket
    if len(prompts) > bb:
        raise ValueError(f"{len(prompts)} prompts > batch bucket {bb}")
    tokens = np.full((bb, sb), pad_id, np.int32)
    lengths = np.zeros((bb,), np.int32)
    for i, p in enumerate(prompts):
        p = np.asarray(p, np.int32).reshape(-1)
        if p.size == 0:
            raise ValueError(f"prompt {i} is empty; length 0 marks pad rows")
        if p.size > sb:
            raise ValueError(f"prompt length {p.size} > seq bucket {sb}")
        tokens[i, : p.size] = p
        lengths[i] = p.size
    return tokens, lengths

"""Deterministic synthetic data pipeline with background prefetch; the
port's own numpy copy of ``repro/data/pipeline.py`` (its batches are the
reference's bit for bit).

Properties a real cluster pipeline needs and tests assert:
  * deterministic: batch(step) is a pure function of (seed, step, rank) —
    restart-from-checkpoint replays identical data, and a run with failures
    reproduces a run without them bit-exactly.
  * sharded: each data-parallel rank draws a disjoint slice of the global
    batch (rank folded into the counter), so hosts never exchange data.
  * prefetched: a daemon thread keeps a bounded queue of upcoming batches.

The token task is a learnable first-order Markov chain over the vocab (so
example trainings show real loss decrease, not noise-fitting).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenTaskConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4  # next-token candidates per state (task difficulty)


def _chain(cfg: TokenTaskConfig) -> np.ndarray:
    """Fixed random transition table: (vocab, branching) candidate successors."""
    rng = np.random.default_rng(cfg.seed ^ 0xC0FFEE)
    return rng.integers(0, cfg.vocab_size, size=(cfg.vocab_size, cfg.branching))


_CHAIN_CACHE: Dict[tuple, np.ndarray] = {}


def markov_batch(
    cfg: TokenTaskConfig, step: int, rank: int = 0, world: int = 1
) -> Dict[str, np.ndarray]:
    """Batch for one (step, rank): tokens (b, T) and next-token labels."""
    key = (cfg.vocab_size, cfg.branching, cfg.seed)
    if key not in _CHAIN_CACHE:
        _CHAIN_CACHE[key] = _chain(cfg)
    chain = _CHAIN_CACHE[key]
    assert cfg.global_batch % world == 0
    b = cfg.global_batch // world
    rng = np.random.default_rng((cfg.seed, step, rank))
    toks = np.empty((b, cfg.seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
    choices = rng.integers(0, cfg.branching, size=(b, cfg.seq_len))
    for t in range(cfg.seq_len):
        toks[:, t + 1] = chain[toks[:, t], choices[:, t]]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class DataPipeline:
    """Prefetching iterator over markov_batch(step) with restart support."""

    def __init__(
        self,
        cfg: TokenTaskConfig,
        start_step: int = 0,
        rank: int = 0,
        world: int = 1,
        prefetch: int = 2,
    ):
        self.cfg = cfg
        self.rank = rank
        self.world = world
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        step = self._step
        while not self._stop.is_set():
            batch = markov_batch(self.cfg, step, self.rank, self.world)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

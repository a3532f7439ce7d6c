"""Deterministic synthetic datasets of the paper-validation experiments;
the port's own copy of ``repro/data/synthetic.py``.

The paper's image, entailment and tabular tasks are replaced by
procedurally generated ones that small networks learn well short of
perfect, so an energy-accuracy tradeoff under analog noise has room to
show. numpy only, the reference's code: the same seed gives the same
arrays bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_image_dataset(
    n: int, *, n_classes: int = 10, size: int = 16, channels: int = 3, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional structured images (N, size, size, channels) f32 and
    int32 labels: each class a fixed mixture of three 2-D sinusoids and a
    blob; each sample jitters their amplitudes and the blob's place and adds
    pixel noise. The classes are close on purpose (a small CNN lands around
    85-95 %), which leaves room for noise-induced degradation."""
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(1.0, 2.2, size=(n_classes, 3, 2))
    phases = rng.uniform(0, 2 * np.pi, size=(n_classes, 3))
    blob = rng.uniform(0.3, 0.7, size=(n_classes, 2))
    labels = rng.integers(0, n_classes, size=n)
    yy, xx = np.mgrid[0:size, 0:size] / size
    imgs = np.empty((n, size, size, channels), np.float32)
    for i in range(n):
        c = labels[i]
        jit = rng.normal(0, 0.35, size=3)
        img = np.zeros((size, size), np.float32)
        for k in range(3):
            img += (1.0 + jit[k]) * np.sin(
                2 * np.pi * (freqs[c, k, 0] * xx + freqs[c, k, 1] * yy) + phases[c, k]
            )
        bx, by = blob[c] + rng.normal(0, 0.08, size=2)
        img += 1.0 * np.exp(-(((xx - bx) ** 2 + (yy - by) ** 2) / 0.02))
        img = img[..., None] * np.array([1.0, 0.8, 0.6], np.float32)
        img += rng.normal(0, 1.0, size=img.shape)
        imgs[i] = img
    return imgs.astype(np.float32), labels.astype(np.int32)


def make_entailment_dataset(
    n: int, *, vocab: int = 64, seq_len: int = 24, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """MNLI-style 3-way task over token pairs (premise, separator,
    hypothesis): hypothesis tokens from the premise's topic -> entail (0),
    from another topic -> contradict (1), mixed -> neutral (2). Solving it
    needs attention across the two segments."""
    rng = np.random.default_rng(seed)
    half = seq_len // 2
    n_topics = 8
    per = (vocab - 4) // n_topics
    topic_words = rng.permutation(vocab - 4)[: n_topics * per].reshape(n_topics, per)
    toks = np.empty((n, seq_len), np.int32)
    labels = rng.integers(0, 3, size=n).astype(np.int32)
    sep = vocab - 1
    for i in range(n):
        t = rng.integers(0, n_topics)
        other = (t + 1 + rng.integers(0, n_topics - 1)) % n_topics
        prem = rng.choice(topic_words[t], size=half - 1)
        if labels[i] == 0:
            hyp = rng.choice(topic_words[t], size=half)
        elif labels[i] == 1:
            hyp = rng.choice(topic_words[other], size=half)
        else:
            k = half // 2
            hyp = np.concatenate(
                [rng.choice(topic_words[t], size=k), rng.choice(topic_words[other], size=half - k)]
            )
            rng.shuffle(hyp)
        toks[i] = np.concatenate([prem, [sep], hyp])
    return toks, labels


def make_tabular_dataset(
    n: int, *, dim: int = 32, n_classes: int = 8, depth: int = 3, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """MLP task: gaussian inputs labelled by a fixed random teacher MLP of
    ``depth`` tanh layers (nonlinear, learnable to high accuracy)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    h = x
    for _ in range(depth):
        w = rng.normal(size=(h.shape[1], dim)).astype(np.float32) / np.sqrt(h.shape[1])
        h = np.tanh(h @ w)
    w_out = rng.normal(size=(dim, n_classes)).astype(np.float32)
    labels = np.argmax(h @ w_out, axis=-1).astype(np.int32)
    return x, labels

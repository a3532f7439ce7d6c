"""Shared test setup.

Provides a minimal, deterministic stand-in for ``hypothesis`` when the real
package is not installed (the CI/container image bakes in the jax toolchain
but not hypothesis). The stub covers exactly the API surface this suite
uses — ``given`` with keyword strategies, ``settings(max_examples, deadline)``
and ``strategies.floats/integers`` — drawing a fixed number of samples from
a per-test seeded PRNG, always including both range endpoints, so the
property tests stay meaningful and reproducible without the dependency.
"""
from __future__ import annotations

import math
import random
import sys
import types
import zlib

try:  # pragma: no cover - prefer the real package when present
    import hypothesis  # noqa: F401
except ImportError:
    class _Strategy:
        def __init__(self, draw_fn):
            self._draw_fn = draw_fn

        def draw(self, rng, i):
            return self._draw_fn(rng, i)

    def _floats(min_value=None, max_value=None, **_kw):
        lo, hi = float(min_value), float(max_value)

        def draw(rng, i):
            if i == 0:
                return lo
            if i == 1:
                return hi
            if lo > 0 and hi / lo >= 1e3:  # wide positive range: log-uniform
                return math.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * rng.random())
            return lo + (hi - lo) * rng.random()

        return _Strategy(draw)

    def _integers(min_value=None, max_value=None, **_kw):
        lo, hi = int(min_value), int(max_value)

        def draw(rng, i):
            if i == 0:
                return lo
            if i == 1:
                return hi
            return rng.randint(lo, hi)

        return _Strategy(draw)

    def _given(*args, **strategies):
        if args:
            raise TypeError("hypothesis stub supports keyword strategies only")

        def deco(fn):
            # NOT functools.wraps: the wrapper must expose a zero-arg
            # signature or pytest mistakes the strategy params for fixtures.
            def wrapper():
                n = getattr(wrapper, "_stub_max_examples", 10)
                rng = random.Random(zlib.crc32(fn.__qualname__.encode()))
                for i in range(n):
                    drawn = {name: s.draw(rng, i) for name, s in strategies.items()}
                    fn(**drawn)

            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            wrapper.__dict__.update(fn.__dict__)
            return wrapper

        return deco

    def _settings(max_examples=10, deadline=None, **_kw):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn

        return deco

    _mod = types.ModuleType("hypothesis")
    _st = types.ModuleType("hypothesis.strategies")
    _st.floats = _floats
    _st.integers = _integers
    _mod.given = _given
    _mod.settings = _settings
    _mod.strategies = _st
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one; run on the card with -m cuda)"
    )

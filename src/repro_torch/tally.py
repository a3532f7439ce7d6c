"""Counts of work that a dispatch-level counter cannot see, for the dry
run's reckoning (``launch/trace_analysis.py``).

``counting()`` opens a tally for the calls inside it (per thread); ``add``
adds to the open tally and is a no-op when none is open, so the counted
code runs the same with or without one. Two kinds are counted:

  * ``"contraction_flops"``: contractions taken as an elementwise product
    summed by ``reduce.row_sum`` (decode attention, the mLSTM decode), 2 x
    the product's elements (``reduce.contraction``), where the reference
    has dots;
  * ``"analog_flops"`` and ``"analog_sites"``: analog sites on the
    ``"cuda"`` backend reckoned on the meta device without a launch
    (``kernels/analog_matmul.py`` ``reckon_on_meta``), 2·M·K·N each.
"""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from typing import Dict, Optional

_state = threading.local()


def active() -> Optional[Dict[str, float]]:
    return getattr(_state, "tally", None)


def add(kind: str, value: float) -> None:
    t = active()
    if t is not None:
        t[kind] += value


@contextlib.contextmanager
def counting():
    """A fresh tally (a dict of kind -> total) for the block."""
    prev = active()
    _state.tally = defaultdict(float)
    try:
        yield _state.tally
    finally:
        _state.tally = prev

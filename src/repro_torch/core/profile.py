"""Per-layer precision profiles: frozen, servable K-repeat schedules; port
of ``repro/core/profile.py``.

The paper learns the precision of each layer of a frozen model (§V-VI).
At serving time the per-layer knob is the repeat count ``K_l``: layer
``l`` runs its analog matmuls K_l times at its per-site energies and
averages them in the kernel (noise / sqrt(K_l) at K_l x energy).

A :class:`PrecisionProfile` freezes one schedule as a value: saved to
JSON, registered with the serving engine as a tier. Its JSON is the
reference's, so a profile saved by either package loads in the other. A
uniform schedule is the degenerate single-K profile, served exactly like
the ``n_repeats=K`` tier.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

#: default ladder of repeat counts a profile search may assign per layer.
DEFAULT_K_LEVELS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class PrecisionProfile:
    """A frozen per-layer repeat schedule ``K_l`` for one model.

    ``repeats[l]`` is the repeat count of model layer ``l`` (``n_layers``
    positive ints).

    ``coalesce`` selects scan segments in the reference, where
    ``coalesce=False`` runs every layer as its own segment (its unrolled
    test oracle). The port's layer loop is plain Python, one layer at a
    time either way, so the flag changes nothing the port computes; it is
    kept so ``cache_key`` and tier identity match the reference (an
    unrolled uniform profile stays its own tier).

    ``accuracy`` is optional metadata (the schedule's measured accuracy
    proxy), not part of the profile's identity.
    """

    repeats: Tuple[int, ...]
    name: str = "profile"
    coalesce: bool = True
    accuracy: Optional[float] = None

    def __post_init__(self):
        reps = tuple(int(k) for k in self.repeats)
        if not reps:
            raise ValueError("a profile needs at least one layer")
        if any(k < 1 for k in reps):
            raise ValueError(f"repeat counts must be >= 1, got {reps}")
        object.__setattr__(self, "repeats", reps)
        if not self.name:
            raise ValueError("a profile needs a non-empty name")
        if self.accuracy is not None:
            object.__setattr__(self, "accuracy", float(self.accuracy))

    @property
    def n_layers(self) -> int:
        return len(self.repeats)

    @property
    def is_uniform(self) -> bool:
        return len(set(self.repeats)) == 1

    @property
    def max_k(self) -> int:
        return max(self.repeats)

    @classmethod
    def uniform(cls, k: int, n_layers: int, name: Optional[str] = None) -> "PrecisionProfile":
        """The degenerate single-K profile (the ``n_repeats`` tier)."""
        return cls(repeats=(int(k),) * n_layers,
                   name=name if name is not None else f"uniform-{int(k)}")

    def cache_key(self):
        """Hashable identity of the schedule: a uniform coalesced profile
        is the bare int K (it is the ``n_repeats=K`` tier), any other the
        repeat tuple, tagged ``"unrolled"`` when ``coalesce`` is off."""
        if self.is_uniform and self.coalesce:
            return int(self.repeats[0])
        key: tuple = tuple(self.repeats)
        if not self.coalesce:
            key = ("unrolled",) + key
        return key

    def to_json(self) -> dict:
        obj = {"name": self.name, "repeats": list(self.repeats)}
        if self.accuracy is not None:
            obj["accuracy"] = self.accuracy
        return obj

    @classmethod
    def from_json(cls, obj: dict) -> "PrecisionProfile":
        return cls(repeats=tuple(obj["repeats"]), name=obj.get("name", "profile"),
                   accuracy=obj.get("accuracy"))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "PrecisionProfile":
        with open(path) as f:
            return cls.from_json(json.load(f))


def coalesce_runs(rows: Sequence, coalesce: bool = True) -> List[Tuple[int, int, object]]:
    """Split ``rows`` into contiguous equal-value runs ``[(start, stop,
    row)]``; with ``coalesce=False`` every row is its own run."""
    runs: List[Tuple[int, int, object]] = []
    start = 0
    for i in range(1, len(rows) + 1):
        if i == len(rows) or rows[i] != rows[start] or not coalesce:
            runs.append((start, i, rows[start]))
            start = i
    return runs

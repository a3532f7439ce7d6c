"""Binary search for the minimum energy/MAC at bounded accuracy loss, and
the greedy per-layer repeat-profile searches; the port's own copy of
``repro/core/search.py`` (pure Python: the port imports nothing of the
reference package).

Paper §VI-A: "we determine the minimum average energy/MAC for which the
accuracy does not degrade below floating point accuracy by 2% (within 0.1%)
by performing a binary search on the target energy/MAC."
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Callable, Optional, Tuple


@dataclasses.dataclass
class SearchResult:
    min_e_per_mac: float  # smallest feasible target found
    accuracy: float  # accuracy achieved at that target
    achieved_e_per_mac: float  # actual average E/MAC (may undershoot target)
    trace: list  # [(target, acc, achieved)] per bisection step
    artifact: object = None  # energies (or whatever make_fn returns) at best


def min_energy_search(
    make_fn: Callable[[float], Tuple[object, float]],
    acc_fn: Callable[[object], float],
    *,
    float_acc: float,
    max_degradation: float = 0.02,
    acc_tol: float = 0.001,
    lo: float = 1e-3,
    hi: float = 1e3,
    max_iters: int = 12,
) -> SearchResult:
    """Bisect (in log space) the smallest target energy/MAC meeting the
    accuracy floor ``float_acc - max_degradation``.

    ``make_fn(target) -> (artifact, achieved_e_per_mac)`` builds an energy
    allocation for the target (uniform assignment, or a full Eq.-14
    calibration run). ``acc_fn(artifact) -> accuracy`` evaluates it.
    Terminates early once the achieved accuracy is within ``acc_tol`` of the
    floor (paper's "within 0.1%").

    Warm starts: when ``make_fn`` accepts an ``init`` keyword, each probe
    after the first feasible one receives the best feasible probe's artifact
    (its energy allocation / log_e) as ``init``. Successive bisection targets
    are close together, so a calibration-backed make_fn converges in far
    fewer Eq.-14 steps starting from the neighbouring optimum. The probe
    *decisions* (feasible / infeasible) and the bisection trajectory are
    unchanged for make_fns that ignore ``init``.
    """
    floor = float_acc - max_degradation
    trace = []
    best: Optional[tuple] = None  # (target, acc, achieved, artifact)
    try:
        takes_init = "init" in inspect.signature(make_fn).parameters
    except (TypeError, ValueError):  # builtins / C callables: no plumbing
        takes_init = False

    def probe(target: float):
        nonlocal best
        if takes_init:
            artifact, achieved = make_fn(target, init=best[3] if best else None)
        else:
            artifact, achieved = make_fn(target)
        acc = acc_fn(artifact)
        trace.append((target, acc, achieved))
        if acc >= floor and (best is None or achieved < best[2]):
            best = (target, acc, achieved, artifact)
        return acc

    # Ensure the bracket actually brackets feasibility.
    acc_hi = probe(hi)
    if acc_hi < floor:
        return SearchResult(math.inf, acc_hi, math.inf, trace, None)
    acc_lo = probe(lo)
    if acc_lo >= floor:
        # Both bracket probes are feasible. Report the best feasible probe
        # *whole*: a calibration-backed make_fn can undershoot its target, so
        # the hi probe may have achieved less energy than the lo probe — in
        # which case (target, acc, achieved, artifact) must all come from hi,
        # never a mix of the two probes' fields.
        target, acc, achieved, art = best
        return SearchResult(target, acc, achieved, trace, art)

    llo, lhi = math.log(lo), math.log(hi)
    for _ in range(max_iters):
        mid = math.exp(0.5 * (llo + lhi))
        acc = probe(mid)
        if acc >= floor:
            lhi = math.log(mid)
            if acc - floor <= acc_tol:  # inside the paper's 0.1% window
                break
        else:
            llo = math.log(mid)

    assert best is not None
    target, acc, achieved, art = best
    return SearchResult(target, acc, achieved, trace, art)


# ===========================================================================
# per-layer repeat-count profiles (paper §V-VI: learn each layer's precision)
# ===========================================================================


@dataclasses.dataclass
class ProfileSearchResult:
    """Outcome of :func:`repeat_profile_search` (and its online variant)."""

    repeats: Tuple[int, ...]  # the learned per-layer K schedule
    accuracy: float  # accuracy achieved by that schedule
    cost: float  # sum_l K_l * w_l (w = per-layer energy weight)
    uniform_cost: float  # cost of the uniform max-K schedule (the baseline)
    feasible: bool  # False: the starting schedule itself missed the floor
    trace: list  # [(repeats, acc)] per evaluated schedule
    n_evals: int = 0
    #: online variant only: the frozen schedule missed the floor at the
    #: live statistics and had to be raised before descent
    repaired: bool = False


def repeat_profile_search(
    acc_fn: Callable[[Tuple[int, ...]], float],
    *,
    n_layers: int,
    float_acc: float,
    max_degradation: float = 0.02,
    k_levels: Tuple[int, ...] = (1, 2, 4, 8),
    weights: Optional[Tuple[float, ...]] = None,
    init: Optional[Tuple[int, ...]] = None,
) -> ProfileSearchResult:
    """Greedy per-layer descent of the repeat schedule ``K_l`` subject to the
    paper's accuracy floor ``float_acc - max_degradation``.

    ``acc_fn(repeats) -> accuracy`` evaluates a candidate schedule (serving
    at K repeats equals one draw at K x energy on the "torch" path, so
    ``repro_torch.core.calibrate.eval_profile_accuracy`` is the usual adapter).
    ``weights[l]`` is layer ``l``'s energy cost per unit K (``E_l * MACs_l``)
    — it orders the descent (largest savings first) and prices the result;
    defaults to all-ones.

    Starting from the uniform max level (or ``init`` — e.g. the schedule
    learned at a neighbouring accuracy floor, the profile analogue of
    ``min_energy_search``'s warm starts), the search repeatedly lowers the
    single layer whose step down the level ladder saves the most energy
    while keeping the accuracy floor, until no single-layer decrement is
    feasible. Evaluations are memoized; the search is deterministic for a
    deterministic ``acc_fn``.
    """
    levels = tuple(sorted(set(int(k) for k in k_levels)))
    if not levels or levels[0] < 1:
        raise ValueError(f"bad k_levels {k_levels!r}")
    w = tuple(float(x) for x in (weights or (1.0,) * n_layers))
    if len(w) != n_layers:
        raise ValueError(f"{len(w)} weights for {n_layers} layers")
    start = tuple(int(k) for k in (init or (levels[-1],) * n_layers))
    if len(start) != n_layers or any(k not in levels for k in start):
        raise ValueError(f"init {start!r} is not on the {levels} ladder")
    floor = float_acc - max_degradation

    trace: list = []
    memo: dict = {}

    def evaluate(reps: Tuple[int, ...]) -> float:
        if reps not in memo:
            memo[reps] = float(acc_fn(reps))
            trace.append((reps, memo[reps]))
        return memo[reps]

    def cost(reps: Tuple[int, ...]) -> float:
        return float(sum(k * wl for k, wl in zip(reps, w)))

    # the savings baseline is always uniform max-K, even when a warm-start
    # init begins the descent below it
    uniform_cost = cost((levels[-1],) * n_layers)
    cur = start
    acc = evaluate(cur)
    if acc < floor:
        return ProfileSearchResult(
            cur, acc, cost(cur), uniform_cost, False, trace, len(memo)
        )

    improved = True
    while improved:
        improved = False
        moves = []  # (savings, layer, lowered schedule)
        for l in range(n_layers):
            idx = levels.index(cur[l])
            if idx == 0:
                continue
            cand = cur[:l] + (levels[idx - 1],) + cur[l + 1 :]
            moves.append((w[l] * (cur[l] - levels[idx - 1]), l, cand))
        # biggest energy saving first; layer index breaks ties deterministically
        for _, _, cand in sorted(moves, key=lambda m: (-m[0], m[1])):
            cand_acc = evaluate(cand)
            if cand_acc >= floor:
                cur, acc, improved = cand, cand_acc, True
                break

    return ProfileSearchResult(
        cur, acc, cost(cur), uniform_cost, True, trace, len(memo)
    )


# ===========================================================================
# online re-trim: repair + descend from a frozen serving profile
# ===========================================================================


class _BudgetExhausted(Exception):
    """Internal: the online eval budget ran out mid-search."""


class _BudgetedAccFn:
    """Memoizing, budget-bounded wrapper around a live ``acc_fn``.

    Memo hits are free; only genuinely new schedule evaluations consume
    the budget (an online eval against live traffic costs real probe
    compute/energy, a memo lookup does not). The memo doubles as the
    combined eval trace — dict insertion order IS eval order.
    """

    def __init__(self, acc_fn, max_evals: Optional[int]):
        self.acc_fn = acc_fn
        self.max_evals = max_evals
        self.memo: dict = {}

    def __call__(self, reps) -> float:
        reps = tuple(reps)
        if reps in self.memo:
            return self.memo[reps]
        if self.max_evals is not None and len(self.memo) >= self.max_evals:
            raise _BudgetExhausted()
        self.memo[reps] = float(self.acc_fn(reps))
        return self.memo[reps]


def online_repeat_profile_search(
    acc_fn: Callable[[Tuple[int, ...]], float],
    *,
    frozen,
    float_acc: float,
    max_degradation: float = 0.02,
    k_levels: Tuple[int, ...] = (1, 2, 4, 8),
    weights: Optional[Tuple[float, ...]] = None,
    max_evals: Optional[int] = None,
) -> ProfileSearchResult:
    """Re-trim a frozen serving profile against *live* statistics, between
    serving epochs, under a bounded eval budget.

    The offline search (:func:`repeat_profile_search`) learns a schedule
    once against a calibration set; a deployed engine then watches the
    world move — the noise floor drifts (``NoiseDriftWatchdog``), the
    traffic mix shifts the per-layer energy weights, the realized accuracy
    proxy walks. This variant closes that loop: ``acc_fn`` should evaluate
    candidates against the live statistics (e.g. ``eval_profile_accuracy``
    at the engine's *effective* drifted energies over a traffic-weighted
    probe batch) and ``weights`` should price layers by live spend.

    ``frozen`` is the currently-served schedule (a ``PrecisionProfile`` or
    a repeat tuple) — the warm start. Two phases:

    1. **Repair** (upward): if the frozen schedule misses the floor at the
       live stats, greedily raise one layer at a time — cheapest increment
       first, accepting the first candidate that restores feasibility,
       else the best-accuracy probe — until feasible (or the ladder tops
       out: ``feasible=False``, serve the watchdog's K-promotion instead).
    2. **Descent**: delegate to :func:`repeat_profile_search` warm-started
       from the (repaired) schedule, trimming layers the live traffic
       shows are over-provisioned.

    ``max_evals`` bounds total *new* ``acc_fn`` evaluations (memo hits are
    free). On exhaustion the cheapest feasible schedule seen so far is
    returned; if none is known, the frozen schedule itself comes back with
    ``feasible=False`` — serving keeps its vetted profile rather than
    adopting an unvetted one. Deterministic for a deterministic
    ``acc_fn``; ``repaired`` records whether phase 1 had to act.
    """
    reps0 = tuple(
        int(k) for k in (frozen.repeats if hasattr(frozen, "repeats") else frozen)
    )
    n_layers = len(reps0)
    levels = tuple(sorted(set(int(k) for k in k_levels)))
    if not levels or levels[0] < 1:
        raise ValueError(f"bad k_levels {k_levels!r}")
    if any(k not in levels for k in reps0):
        raise ValueError(f"frozen schedule {reps0!r} is not on the {levels} ladder")
    w = tuple(float(x) for x in (weights or (1.0,) * n_layers))
    if len(w) != n_layers:
        raise ValueError(f"{len(w)} weights for {n_layers} layers")
    if max_evals is not None and max_evals < 1:
        raise ValueError(f"max_evals must be >= 1, got {max_evals}")
    floor = float_acc - max_degradation
    budget = _BudgetedAccFn(acc_fn, max_evals)

    def cost(reps: Tuple[int, ...]) -> float:
        return float(sum(k * wl for k, wl in zip(reps, w)))

    uniform_cost = cost((levels[-1],) * n_layers)

    def result(reps, acc, feasible, repaired):
        return ProfileSearchResult(
            reps, acc, cost(reps), uniform_cost, feasible,
            list(budget.memo.items()), len(budget.memo), repaired,
        )

    def best_known_feasible():
        feas = [(cost(r), r, a) for r, a in budget.memo.items() if a >= floor]
        if not feas:
            return None
        c, reps, acc = min(feas, key=lambda t: (t[0], t[1]))
        return reps, acc

    # phase 1: repair upward until the live floor holds again
    cur = reps0
    repaired = False
    try:
        acc = budget(cur)
        while acc < floor:
            moves = []  # (increment cost, layer, raised schedule)
            for l in range(n_layers):
                idx = levels.index(cur[l])
                if idx == len(levels) - 1:
                    continue
                cand = cur[:l] + (levels[idx + 1],) + cur[l + 1 :]
                moves.append((w[l] * (levels[idx + 1] - cur[l]), l, cand))
            if not moves:
                # ladder topped out everywhere and still infeasible: the
                # live floor is unreachable by repeats alone
                return result(cur, acc, False, repaired)
            repaired = True
            # cheapest increment first; take the first feasible candidate,
            # else the best-accuracy probe (ties broken by layer index)
            moves.sort(key=lambda m: (m[0], m[1]))
            best_cand, best_acc = None, -float("inf")
            for _c, _l, cand in moves:
                a = budget(cand)
                if a >= floor:
                    best_cand, best_acc = cand, a
                    break
                if a > best_acc:
                    best_cand, best_acc = cand, a
            cur, acc = best_cand, best_acc
    except _BudgetExhausted:
        known = best_known_feasible()
        if known is not None:
            return result(known[0], known[1], True, repaired)
        return result(reps0, budget.memo.get(reps0, float("nan")), False, repaired)

    # phase 2: descend from the (repaired) schedule — the offline greedy,
    # warm-started, sharing the memo and the remaining eval budget
    try:
        res = repeat_profile_search(
            budget, n_layers=n_layers, float_acc=float_acc,
            max_degradation=max_degradation, k_levels=levels,
            weights=w, init=cur,
        )
        return result(res.repeats, res.accuracy, True, repaired)
    except _BudgetExhausted:
        known = best_known_feasible()
        assert known is not None  # `cur` itself is feasible and memoized
        return result(known[0], known[1], True, repaired)

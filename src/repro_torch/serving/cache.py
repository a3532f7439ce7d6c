"""Executable cache: build once per (phase, bucket, tier, mesh), then hit.

Port of ``repro/serving/cache.py``. Keys are built by the engine from
everything that changes a step's program: phase (prefill/decode/insert),
bucket or pool shape, cache length, the mesh fingerprint and the tier's
identity (``ExecutionTier.cache_key``: repeat schedule, backend, noise
kind). The reference's values are ``jax.jit(...).lower(...).compile()``
executables; the port's counterpart is a ``torch.cuda.CUDAGraph`` captured
once and replayed (``capture_step``, ``Step``): a replay runs the step's
kernels, the analog-matmul routes among them, without the host issuing
one operation of the forward. On the CPU an entry is the eager step, so
hits and misses count as the reference counts them there too.

Hit/miss/compile-time counters are first-class: ``max_entries`` bounds
the cache with LRU eviction (an evicted key simply builds again on its
next use, a miss and an eviction in ``stats()``); ``compile_s`` counts a
graph's first run plus its capture.
"""
from __future__ import annotations

import gc
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, Hashable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import analog_matmul as am
from repro_torch.tree import leaves


def mesh_fingerprint(mesh) -> tuple:
    """Hashable identity of a mesh for cache keys.

    The axis names, the axis sizes and the order of the shards' devices
    (``launch/mesh.py``: the local form runs every shard on the caller's
    device, the distributed form one shard a rank of its group), and
    nothing else; a mesh of one data shard names only its tp axis. ``()``
    for no mesh, so unmeshed engines keep their exact keys. Two meshes
    with equal fingerprints run the same steps, which is what lets a
    reshard back to a previous mesh hit its entries.
    """
    if mesh is None:
        return ()
    if mesh.group is None:
        order = tuple(f"local:{r}" for r in range(mesh.size))
    else:
        import torch.distributed as dist

        order = tuple(f"rank:{r}" for r in dist.get_process_group_ranks(mesh.group))
    if mesh.data == 1:
        return (("tp",), (mesh.tp,), order)
    return (("data", "tp"), (mesh.data, mesh.tp), order)


class ExecutableCache:
    """Maps hashable keys -> built steps, counting hits/misses.

    ``max_entries=None`` (default) never evicts. With a bound, the cache is
    LRU: a hit refreshes the key, an insert beyond the bound evicts the
    least-recently-used step (counted in ``evictions``).

    ``fault_hook`` is the fault-injection seam (serving/faults.py): called
    with the cache key before *every* invocation of a cached step, raising
    to simulate a transient executable failure. The guard fires strictly
    before the call, so no state a step updates in place (a decode cache)
    is touched by a faulted call. ``None`` (the default) wraps nothing.
    """

    def __init__(self, max_entries: Optional[int] = None, fault_hook=None):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self.fault_hook = fault_hook
        self._exes: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compile_s = 0.0
        #: per-miss records [(key, seconds)]: the retrace audit trail,
        #: capped for a bounded cache (which churns: eviction -> rebuild)
        self.miss_log: Deque[tuple] = deque(maxlen=self._miss_log_cap())

    def _miss_log_cap(self) -> Optional[int]:
        if self.max_entries is None:
            return None  # unbounded cache: every miss is a one-time build
        return max(64, 4 * self.max_entries)

    def _guard(self, key: Hashable, exe: Any) -> Any:
        """Wrap a step so ``fault_hook(key)`` runs before the call."""
        if self.fault_hook is None:
            return exe
        hook = self.fault_hook

        def guarded(*args, **kwargs):
            hook(key)  # may raise TransientExecutableFault, before the call
            return exe(*args, **kwargs)

        guarded.__wrapped__ = exe
        return guarded

    def get(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """Return the step for ``key``, building it via ``build`` on a miss."""
        exe = self._exes.get(key)
        if exe is not None:
            self.hits += 1
            self._exes.move_to_end(key)  # LRU refresh (no-op when unbounded)
            return self._guard(key, exe)
        self.misses += 1
        t0 = time.perf_counter()
        exe = build()
        dt = time.perf_counter() - t0
        self.compile_s += dt
        self.miss_log.append((key, dt))
        self._exes[key] = exe
        if self.max_entries is not None:
            while len(self._exes) > self.max_entries:
                self._exes.popitem(last=False)
                self.evictions += 1
        return self._guard(key, exe)

    def entries(self) -> list:
        """(key, step) of every resident entry, least recently used first."""
        return list(self._exes.items())

    def __len__(self) -> int:
        return len(self._exes)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._exes

    def reset_stats(self) -> None:
        """Zero the counters, keeping built steps (warmup -> steady)."""
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compile_s = 0.0
        self.miss_log = deque(maxlen=self._miss_log_cap())

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "entries": len(self._exes),
            "evictions": self.evictions,
            "max_entries": self.max_entries,
            "compile_s": self.compile_s,
        }


# ---------------------------------------------------------------------------
# host inputs of a step
# ---------------------------------------------------------------------------

_NP = {torch.int64: np.int64, torch.int32: np.int32}


class HostInputs:
    """The host-made inputs of one step (tokens, positions, lengths, slot
    ids, seed words): named integer fields laid out in one device buffer,
    refilled by one host-to-device copy a call, before the step runs and
    never inside it. On the card the copy is made from a ring of two
    pinned staging buffers, each written again only once its previous copy
    has run, so the host can run ahead of the card; on the CPU the fields
    are written in place."""

    def __init__(self, fields: Dict[str, Tuple[tuple, torch.dtype]], device):
        self.device = torch.device(device)
        self._layout = {}
        off = 0
        for name, (shape, dtype) in fields.items():
            n = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
            self._layout[name] = (off, n, tuple(shape), dtype)
            off += -(-n // 16) * 16  # 16-byte aligned fields
        self.nbytes = max(off, 16)
        self.buf = torch.zeros((self.nbytes,), dtype=torch.uint8, device=self.device)
        self._views = {name: self.buf[o:o + n].view(dt).view(shape)
                       for name, (o, n, shape, dt) in self._layout.items()}
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stage = [torch.zeros((self.nbytes,), dtype=torch.uint8, pin_memory=True)
                           for _ in range(2)]
            self._done = [None, None]
            self._turn = 0

    @property
    def names(self) -> tuple:
        return tuple(self._layout)

    def __getitem__(self, name: str) -> torch.Tensor:
        """Field ``name`` on the device: the tensor the step reads."""
        return self._views[name]

    def fill(self, **values) -> None:
        """Write every field (numpy or ints, cast to the field's type)."""
        if set(values) != set(self._layout):
            raise ValueError(f"fill() needs exactly the fields {sorted(self._layout)}, "
                             f"got {sorted(values)}")
        if not self._cuda:
            target = self.buf.numpy()
        else:
            turn = self._turn
            if self._done[turn] is not None:
                self._done[turn].synchronize()  # its last copy has run
            target = self._stage[turn].numpy()
        for name, v in values.items():
            off, n, shape, dtype = self._layout[name]
            target[off:off + n].view(_NP[dtype]).reshape(shape)[...] = np.asarray(v)
        if self._cuda:
            self.buf.copy_(self._stage[turn], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._done[turn] = ev
            self._turn = 1 - turn


# ---------------------------------------------------------------------------
# captured steps
# ---------------------------------------------------------------------------

#: device -> the side stream every capture records on
_CAPTURE_STREAMS: dict = {}
#: the steps (``Step.warm_key``: device, model, phase, shapes, tier, mesh)
#: this process has run eagerly once: every tensor such a step keeps from
#: call to call exists, so a capture of the same step needs no warm-up
_WARMED: set = set()


def _launch_counts():
    return dict(am.LAUNCHES), dict(am.LAUNCHES_BY_K), dict(am.LAUNCHES_BY_SHAPE)


def _set_counts(counts) -> None:
    for live, saved in zip((am.LAUNCHES, am.LAUNCHES_BY_K, am.LAUNCHES_BY_SHAPE), counts):
        live.clear()
        live.update(saved)


def _count_delta(after, before):
    return tuple({k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}
                 for a, b in zip(after, before))


def _add_counts(delta) -> None:
    for live, d in zip((am.LAUNCHES, am.LAUNCHES_BY_K, am.LAUNCHES_BY_SHAPE), delta):
        for k, v in d.items():
            live[k] = live.get(k, 0) + v


def capture_step(fn, static_inputs: Sequence[Any], pool, warm: bool = True):
    """Run ``fn(*static_inputs)`` once and capture it into a
    ``torch.cuda.CUDAGraph``; the port's ``aot_compile``. Returns
    ``(replay, outputs)``: ``outputs`` what the call returned, and
    ``replay`` a callable that replays the graph and returns the graph's
    outputs (the tensors ``fn`` returned at capture, rewritten by every
    replay: read or copy them before the next replay of any graph of
    ``pool``), with ``seconds``, the run plus the capture.

    With ``warm`` the run comes first, eager on the caller's stream: the
    step's warm-up, which loads the kernels' libraries and makes every
    tensor a step keeps from call to call (such as the noise-free operands
    of the digital decode route) outside the graph. The capture that
    follows records and executes nothing, so the state ``fn`` updates in
    place (a decode cache) moves once. Without (the same step has run
    eagerly before in this process), the first replay is the run. The
    capture records on a side stream into ``pool`` (an engine's one
    ``torch.cuda.graph_pool_handle()``: every graph of the engine shares its
    memory, so the graphs together hold what one step needs), without the
    device synchronisation and cache release of ``torch.cuda.graph``. A
    tensor ``fn`` reads is read at its address at every replay: the caller
    refills it in place and never rebinds it.

    A capture that fails raises (the caller never falls back to the eager
    step); ``pool`` is then left recording by PyTorch, so the caller takes
    a new one for its next capture.

    The analog-matmul wrapper counts a launch where it launches a kernel.
    The run's launches count; a capture launches nothing, so its counts are
    taken back, and each replay counts the kernels its graph launches.
    """
    t0 = time.perf_counter()
    outputs = fn(*static_inputs) if warm else None
    dev = torch.cuda.current_stream().device
    stream = _CAPTURE_STREAMS.get(dev)
    if stream is None:
        stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph()
    before = _launch_counts()
    # no cyclic collection while capturing: an engine collected then would
    # destroy its graphs, a call a capture does not allow
    collecting = gc.isenabled()
    gc.disable()
    stream.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                captured = fn(*static_inputs)
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:  # noqa: BLE001 - the first error is the one to raise
                    pass
                raise
            graph.capture_end()
    finally:
        if collecting:
            gc.enable()
        delta = _count_delta(_launch_counts(), before)
        _set_counts(before)
    torch.cuda.current_stream().wait_stream(stream)

    def replay():
        graph.replay()
        _add_counts(delta)
        return captured

    if not warm:
        outputs = replay()
    replay.graph = graph
    replay.seconds = time.perf_counter() - t0
    return replay, outputs


class Step:
    """One served step (a prefill, a decode step or an admission's insert)
    over static inputs: ``step(state)`` runs ``fn(state)``, where ``state``
    is the cache tree the step updates in place and every other input is a
    tensor that the caller refills before the call (``inputs``, a
    ``HostInputs``, and the named device tensors ``static``).

    With ``capture`` (a step on the ``"cuda"`` backend on the card) the
    step is captured into the graph pool ``pool()`` returns, once per state
    tree it runs on (``capture_step``: the first call on a state runs and
    captures, every later call replays), and again when the parameter
    tensors ``params()`` returns are swapped (a graph holds the addresses
    it read); a step whose ``warm_key`` has run before in this process is
    captured without a warm-up. Without ``capture``, ``fn`` runs eagerly:
    the CPU's entry. ``capture_s`` lists the seconds of each capture;
    ``on_capture(seconds)`` is told of each, ``on_capture_error()`` of a
    capture that raised (before the error goes on to the caller).
    """

    def __init__(self, fn, inputs: HostInputs, *, capture: bool, pool=None, params=None,
                 warm_key=None, on_capture=None, on_capture_error=None, **static):
        self.fn = fn
        self.inputs = inputs
        self.static = static
        self.capture = bool(capture)
        self._pool = pool
        self._params = params
        self.warm_key = warm_key
        self._on_capture = on_capture
        self._on_capture_error = on_capture_error
        self._graphs: list = []  # [(state, parameter leaves, replay)]
        self.capture_s: list = []

    def __call__(self, state):
        if not self.capture:
            return self.fn(state)
        held = [] if self._params is None else leaves(self._params())
        for i, (s, p, replay) in enumerate(self._graphs):
            if s is state:
                if len(p) == len(held) and all(a is b for a, b in zip(p, held)):
                    return replay()
                del self._graphs[i]  # the parameters were swapped: capture again
                break
        warm = self.warm_key is None or self.warm_key not in _WARMED
        try:
            replay, outputs = capture_step(self.fn, (state,), self._pool(), warm=warm)
        except BaseException:
            if self._on_capture_error is not None:
                self._on_capture_error()
            raise
        if self.warm_key is not None:
            _WARMED.add(self.warm_key)
        self._graphs.append((state, held, replay))
        self.capture_s.append(replay.seconds)
        if self._on_capture is not None:
            self._on_capture(replay.seconds)
        return outputs

    def forget(self, state) -> None:
        """Drop the graph captured on ``state`` (a pool the engine dropped)."""
        self._graphs = [g for g in self._graphs if g[0] is not state]

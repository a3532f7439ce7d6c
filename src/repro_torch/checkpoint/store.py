"""Atomic, async checkpoints of the port's trees; the port's counterpart of
``repro/checkpoint/store.py`` (``save_checkpoint``, ``latest_step``,
``restore_checkpoint``, ``CheckpointManager``).

Layout: ``<dir>/step_<N>/shard_00000.ckpt`` and ``MANIFEST.json``, written
last. A writer stages both in a temporary directory and renames it into
place, so a reader never sees a partial checkpoint; a directory is valid
iff its manifest exists and the SHA-256 of every leaf's stream in the
shard matches it, and ``latest_step`` skips the others (a corrupt shard,
a save cut short).

The format is the port's own, not the reference's (msgpack and zstd are
not needed): a shard is the zlib streams of the tree's leaves one after
another, each leaf's raw bytes in C order (bfloat16 as its uint16 bits),
and the manifest names each leaf's path, dtype, shape, offset, length and
SHA-256. The streams are stored (zlib level 0): the leaves are floats of
random weights and moments, which deflate shrinks by a tenth at a small
fraction of a copy's speed. Leaves are framed, hashed and checked on a
thread pool (zlib and hashlib release the interpreter lock). A tree is
nested dicts and dataclasses (the optimizer's ``AdamState``) over
tensors, numpy arrays and numbers; a restore with a
``template`` refolds the leaves into its structure as CPU tensors of the
saved dtypes.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any
_MANIFEST = "MANIFEST.json"
_SHARD = "shard_00000.ckpt"
_FORMAT = "npraw+zlib/v1"
_LEVEL = 0


def _flatten(tree: Tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in a fixed order: dict keys sorted, dataclass
    fields in declaration order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _flatten(tree[k], path + (str(k),))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [pair for f in dataclasses.fields(tree)
                for pair in _flatten(getattr(tree, f.name), path + (f.name,))]
    return [("/".join(path), tree)]


def _unflatten(template: Tree, leaves: Dict[str, torch.Tensor], path: Tuple[str, ...] = ()):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, path + (str(k),)) for k, v in template.items()}
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves, path + (f.name,))
            for f in dataclasses.fields(template)})
    return leaves["/".join(path)]


def _to_host(leaf) -> torch.Tensor:
    """A leaf as a CPU tensor of its own (a copy even on the CPU: the
    caller may update its tensors in place while an async save runs)."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf, copy=True))


def _raw(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(dtype name, the leaf's C-order bytes as a numpy buffer, not copied)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy()
    return str(t.dtype).replace("torch.", ""), t.numpy()


def _from_raw(dtype: str, shape, data: bytes) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(data, np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(data, np.dtype(dtype)).reshape(shape).copy())


def _compress(t: torch.Tensor) -> Tuple[str, list, bytes, str]:
    dtype, data = _raw(t)
    blob = zlib.compress(data, _LEVEL)
    return dtype, list(t.shape), blob, hashlib.sha256(blob).hexdigest()


def _pool():
    return concurrent.futures.ThreadPoolExecutor(max(1, min(16, os.cpu_count() or 1)))


def save_checkpoint(directory: str, step: int, tree: Tree) -> str:
    """Atomic save: stage the shard and the manifest (last), fsync, rename."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    stage = tempfile.mkdtemp(prefix=".stage_", dir=directory)
    try:
        flat = [(p, _to_host(l)) for p, l in _flatten(tree)]
        with _pool() as pool:
            blobs = list(pool.map(lambda pl: _compress(pl[1]), flat))
        records, offset = [], 0
        with open(os.path.join(stage, _SHARD), "wb") as f:
            for (path, _), (dtype, shape, blob, digest) in zip(flat, blobs):
                f.write(blob)
                records.append({"path": path, "dtype": dtype, "shape": shape, "offset": offset,
                                "length": len(blob), "sha256": digest})
                offset += len(blob)
            f.flush()
            os.fsync(f.fileno())
        manifest = {"step": step, "format": _FORMAT, "shard": _SHARD, "leaves": records}
        with open(os.path.join(stage, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(stage, final)
        return final
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise


def _read(ckpt_dir: str) -> Tuple[dict, memoryview]:
    """(manifest, shard bytes) of a checkpoint; raises ``ValueError`` where a
    leaf's stream does not match its SHA-256 (or lies outside the shard)."""
    with open(os.path.join(ckpt_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    with open(os.path.join(ckpt_dir, manifest["shard"]), "rb") as f:
        blob = memoryview(f.read())

    def ok(rec):
        end = rec["offset"] + rec["length"]
        return end <= len(blob) and \
            hashlib.sha256(blob[rec["offset"]:end]).hexdigest() == rec["sha256"]

    with _pool() as pool:
        if not all(pool.map(ok, manifest["leaves"])):
            raise ValueError(f"{ckpt_dir}: shard does not match its manifest")
    return manifest, blob


def _valid(ckpt_dir: str) -> bool:
    if not os.path.exists(os.path.join(ckpt_dir, _MANIFEST)):
        return False
    try:
        _read(ckpt_dir)
        return True
    except (OSError, ValueError, KeyError, TypeError):
        return False


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n[5:]) for n in os.listdir(directory)
                  if n.startswith("step_") and n[5:].isdigit())


def latest_step(directory: str) -> Optional[int]:
    """The highest step with a valid checkpoint (newest first: the first
    valid one is the answer), or None."""
    for step in reversed(_steps(directory)):
        if _valid(os.path.join(directory, f"step_{step:09d}")):
            return step
    return None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       template: Optional[Tree] = None) -> Tuple[int, Tree]:
    """Returns (step, tree): the latest valid step unless ``step`` is given;
    with a ``template``, the leaves refolded into its structure, else a
    flat {path: tensor} dict. Leaves are CPU tensors of the saved dtypes."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {directory}")
    manifest, blob = _read(os.path.join(directory, f"step_{step:09d}"))

    def one(rec):
        data = zlib.decompress(blob[rec["offset"]:rec["offset"] + rec["length"]])
        return rec["path"], _from_raw(rec["dtype"], rec["shape"], data)

    with _pool() as pool:
        leaves = dict(pool.map(one, manifest["leaves"]))
    if template is None:
        return step, leaves
    return step, _unflatten(template, leaves)


class CheckpointManager:
    """Async save (one background thread at a time), retention of the
    ``keep`` newest valid checkpoints, restore of the latest valid one."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Tree, *, blocking: bool = True) -> None:
        """Copy ``tree`` to the host now, then write it (in the background
        unless ``blocking``). A background save's exception is raised by
        the next ``wait``."""
        host = [(p, _to_host(l)) for p, l in _flatten(tree)]
        host_tree = _unflatten(tree, dict(host))

        def work():
            with self._lock:
                save_checkpoint(self.directory, step, host_tree)
                self._gc()

        if blocking:
            work()
            return
        self.wait()

        def background():
            try:
                work()
            except BaseException as e:  # handed to the caller by wait()
                self._error = e

        self._pending = threading.Thread(target=background, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, template: Tree) -> Optional[Tuple[int, Tree]]:
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None
        return restore_checkpoint(self.directory, step, template)

    def _gc(self) -> None:
        valid = [s for s in _steps(self.directory)
                 if _valid(os.path.join(self.directory, f"step_{s:09d}"))]
        for s in valid[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)

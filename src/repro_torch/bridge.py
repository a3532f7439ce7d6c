"""Carry reference parameter trees into the port.

``params_from_numpy`` takes a parameter tree in the reference layout
(``repro.models.lm.param_leaves`` structure, layer-stacked leaves) as numpy
arrays and returns the port's tree on ``device``; ``energies_from_numpy``
does the same for an ``init_energy_tree`` tree (with griffin's ``tail``
subtrees where the model has tail layers, and the (G, m) mLSTM and
(G, E) expert leaves at their shapes). Both packages then compute
from identical weights. Shapes are checked against ``lm.param_leaves``;
dtypes are kept (numpy bfloat16 arrays become ``torch.bfloat16``).
``tensor_shard_tree`` cuts a whole parameter tree (numpy or tensors) into
tensor shard t's (``models.sharding.tensor_plan``, contiguous slices: a
rank's layout) and ``gather_tensor_shards`` joins the shards' trees back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.sharding import join_tensor_shards, take_tensor_shard, tensor_plan


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, cfg, device="cuda"):
    dev = resolve_device(device)

    def convert(path, leaf, a):
        if tuple(np.shape(a)) != leaf.shape:
            raise ValueError(f"{'/'.join(path)}: shape {np.shape(a)} != {leaf.shape}")
        return _to_torch(a, dev)

    return lm.map_leaves(convert, lm.param_leaves(cfg), tree)


def energies_from_numpy(tree, cfg, device="cuda"):
    """An energy tree on ``device`` in float32; its group sites (and the
    griffin tail's, where the model has a tail) must be the model's."""
    dev = resolve_device(device)
    want = {"groups": lm.group_sites(cfg)}
    if lm.n_tail(cfg):
        want["tail"] = lm.TAIL_SITES
    if set(tree) - {"lm_head"} != set(want):
        raise ValueError(f"energy subtrees {sorted(tree)} != {sorted(want) + ['lm_head']}")
    shapes = lm.map_leaves(lambda _p, a: tuple(a.shape), lm.init_energy_tree(cfg, 1.0, "meta"))
    out = {"lm_head": _to_torch(tree["lm_head"], dev).to(torch.float32)}
    for sub, sites in want.items():
        if set(tree[sub]) != set(sites):
            raise ValueError(f"{sub} energy sites {sorted(tree[sub])} != {sorted(sites)}")
        for s in sites:
            if tuple(np.shape(tree[sub][s])) != shapes[sub][s]:
                raise ValueError(f"{sub}/{s}: shape {np.shape(tree[sub][s])} != {shapes[sub][s]}")
        out[sub] = {s: _to_torch(tree[sub][s], dev).to(torch.float32) for s in sites}
    return out


def tensor_shard_tree(tree, cfg, tp: int, t: int):
    """Tensor shard ``t`` of ``tp`` of a whole parameter tree."""
    return take_tensor_shard(tree, tensor_plan(cfg, tp), tp, t)


def gather_tensor_shards(trees, cfg, tp: int):
    """The whole parameter tree from its ``tp`` shards' trees, in order."""
    return join_tensor_shards(trees, tensor_plan(cfg, tp))

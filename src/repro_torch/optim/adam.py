"""AdamW as pure functions over the port's trees; port of
``repro/optim/adam.py``.

Used for the paper's energy-allocation learning (Adam, lr=0.01, Appendix
A). Parameters, gradients and moments are nested dicts of tensors
(``repro_torch.tree``); the update math is float32 whatever the storage
type, the moments may be stored in another type (``state_dtype``), and
weight decay is decoupled (AdamW). It is not ``torch.optim.Adam``: its
steps are the reference's, operation for operation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.tree import map_leaves

F32 = torch.float32
Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: Optional[torch.dtype] = None  # e.g. torch.bfloat16 for large models


@dataclasses.dataclass
class AdamState:
    step: torch.Tensor  # int32 scalar
    mu: Tree
    nu: Tree


def adam_init(params: Tree, cfg: AdamConfig) -> AdamState:
    def zeros(_path, p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype or p.dtype, device=p.device)

    return AdamState(step=torch.zeros((), dtype=torch.int32), mu=map_leaves(zeros, params),
                     nu=map_leaves(zeros, params))


def _bias_corrections(step: torch.Tensor, cfg: AdamConfig) -> tuple:
    """``1 - b ** step`` for b1 and b2 in float32, as Python numbers (on
    the host: no copy to the parameters' device)."""
    c1 = float(1.0 - torch.tensor(cfg.b1, dtype=F32) ** step.to(F32))
    c2 = float(1.0 - torch.tensor(cfg.b2, dtype=F32) ** step.to(F32))
    return c1, c2


def _update(g, m, v, p, c1: float, c2: float, cfg: AdamConfig):
    """One leaf's (or slice's) update in float32: (new p, m, v), each in
    its storage dtype."""
    g32 = g.to(F32)
    m32 = m.to(F32) * cfg.b1 + (1 - cfg.b1) * g32
    v32 = v.to(F32) * cfg.b2 + (1 - cfg.b2) * g32 * g32
    mhat = m32 / c1
    vhat = v32 / c2
    delta = mhat / (torch.sqrt(vhat) + cfg.eps)
    if cfg.weight_decay:
        delta = delta + cfg.weight_decay * p.to(F32)
    newp = p.to(F32) - cfg.lr * delta
    return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


@torch.no_grad()
def adam_update(grads: Tree, state: AdamState, params: Tree,
                cfg: AdamConfig) -> tuple[Tree, AdamState]:
    """Returns (new_params, new_state). Decoupled weight decay (AdamW)."""
    step = state.step + 1
    c1, c2 = _bias_corrections(step, cfg)
    out = map_leaves(lambda _p, g, m, v, p: _update(g, m, v, p, c1, c2, cfg),
                     grads, state.mu, state.nu, params)
    pick = lambda i: map_leaves(lambda _p, o: o[i], out)  # noqa: E731
    return pick(0), AdamState(step=step, mu=pick(1), nu=pick(2))


#: elements of a leaf taken at once by ``adam_update_`` (and
#: ``clip.global_norm``): a larger leaf goes in slices along its leading
#: axes, bounding the float32 temporaries (about eight copies of a slice)
#: whatever the leaf's size
SLICE_ELEMS = 1 << 25


def leading_slices(t: torch.Tensor):
    """Index tuples covering ``t`` in slices of its leading axis of at most
    ``SLICE_ELEMS`` elements (one row at least; ``()`` for a 0-d tensor).
    Where a row of a tensor of three or more axes is larger (a layer of
    MoE experts, (E, d, f)), each row is cut the same way along the next
    axis."""
    return _slices(tuple(t.shape))


def _slices(shape: tuple) -> list:
    if not shape:
        return [()]
    rows, row = shape[0], math.prod(shape[1:])
    if row > SLICE_ELEMS and len(shape) > 2:
        return [(i,) + rest for i in range(rows) for rest in _slices(shape[1:])]
    per = max(1, SLICE_ELEMS // max(1, row))
    return [(slice(lo, lo + per),) for lo in range(0, rows, per)]


@torch.no_grad()
def adam_update_(grads: Tree, state: AdamState, params: Tree, cfg: AdamConfig,
                 grad_scale: Optional[torch.Tensor] = None,
                 regions: Optional[Tree] = None) -> tuple[Tree, AdamState]:
    """``adam_update`` in place: the parameters and moments are overwritten
    (the reference's train step donates them) and returned with the new
    step. A leaf goes in ``leading_slices``; the update is elementwise, so
    the bits are ``adam_update``'s. ``grad_scale``: a global-norm clip's
    scale, applied to each slice of the gradient as
    ``clip_by_global_norm`` applies it (float32 product, cast back).
    ``regions``: a tree of index tuples (or None: the whole leaf); a leaf's
    moments then hold only ``params[region]``'s (ZeRO-1), and only that
    region of the parameter is updated."""
    step = state.step + 1
    c1, c2 = _bias_corrections(step, cfg)

    def upd(_path, g, m, v, p, reg=None):
        if reg is not None:
            g, p = g[reg], p[reg]
        for sl in leading_slices(p):
            gs = g[sl] if grad_scale is None else (g[sl].to(F32) * grad_scale).to(g.dtype)
            new = _update(gs, m[sl], v[sl], p[sl], c1, c2, cfg)
            for dst, src in zip((p, m, v), new):
                dst[sl] = src

    if regions is None:
        map_leaves(upd, grads, state.mu, state.nu, params)
    else:
        map_leaves(upd, grads, state.mu, state.nu, params, regions)
    return params, AdamState(step=step, mu=state.mu, nu=state.nu)

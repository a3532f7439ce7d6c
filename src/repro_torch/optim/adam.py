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


@torch.no_grad()
def adam_update(grads: Tree, state: AdamState, params: Tree,
                cfg: AdamConfig) -> tuple[Tree, AdamState]:
    """Returns (new_params, new_state). Decoupled weight decay (AdamW)."""
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    # bias corrections in float32 on the host, as Python numbers (no copy
    # to the parameters' device)
    c1 = float(1.0 - torch.tensor(b1, dtype=F32) ** step.to(F32))
    c2 = float(1.0 - torch.tensor(b2, dtype=F32) ** step.to(F32))

    def upd(_path, g, m, v, p):
        g32 = g.to(F32)
        m32 = m.to(F32) * b1 + (1 - b1) * g32
        v32 = v.to(F32) * b2 + (1 - b2) * g32 * g32
        mhat = m32 / c1
        vhat = v32 / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(F32)
        newp = p.to(F32) - cfg.lr * delta
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = map_leaves(upd, grads, state.mu, state.nu, params)
    pick = lambda i: map_leaves(lambda _p, o: o[i], out)  # noqa: E731
    return pick(0), AdamState(step=step, mu=pick(1), nu=pick(2))

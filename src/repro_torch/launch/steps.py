"""Step functions of training and of the LM calibration; port of
``repro/launch/steps.py`` (``TrainConfig``, ``make_train_step``,
``make_opt_init``, ``make_calibrate_step``).

There is no jit: each ``make_*`` returns a plain callable. On one device
only (``mesh`` None or a mesh of one shard): the reference's training
placement (parameter and ZeRO-1 optimizer shardings, ``compressed_psum``)
comes with sharded training (ROADMAP A). The serving steps are the
engine's (``serving/tiers.py``).

Every family trains and calibrates (dense, griffin, xlstm, moe). The
train step updates the parameters and the optimizer state in place, as
the reference's donates them. Its gradients accumulate in the
parameters' dtype (the reference's ``g0 = zeros_like(p)``): every
layer-stacked leaf is handed to the loss as a list of per-layer views
(mLSTM and expert leaves as lists of per-block or per-expert views),
each an autograd leaf whose ``.grad`` is the matching slice of one
preallocated gradient buffer, so the backward adds each layer's gradient
in place and no stacked gradient is assembled from slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.energy import log_energy_penalty, to_energy
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update, adam_update_
from repro_torch.optim.clip import clip_scale, global_norm
from repro_torch.optim.compress import ef_int8_roundtrip
from repro_torch.tree import map_leaves

F32 = torch.float32
Tree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    opt_state_dtype: str = "bfloat16"  # bf16 moments
    grad_compression: Optional[str] = None  # None | "int8_ef"
    #: gradient-accumulation microbatches per step (activation peak / m)
    microbatches: int = 1

    def adam(self) -> AdamConfig:
        return AdamConfig(lr=self.lr, b1=self.b1, b2=self.b2, weight_decay=self.weight_decay,
                          state_dtype=getattr(torch, self.opt_state_dtype))


def _one_device(mesh, what: str) -> None:
    if mesh is not None and mesh.tp > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {mesh.tp} shards: sharded training is not ported (ROADMAP A: "
            "spec, tree_shardings, zero1_axes, compressed_psum); pass mesh=None")


def batch_tensors(batch, device) -> dict:
    """A batch of numpy arrays or tensors (``markov_batch``'s) as tensors
    on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _grad_leaves(params: Tree, grads: Tree) -> Tree:
    """``params`` as autograd leaves accumulating into ``grads``: a stacked
    leaf becomes a list of per-layer views (``lm`` indexes a list as it
    indexes the stacked tensor), an mLSTM or expert leaf a list of lists,
    one view a block or expert (``lm.stacked_axes``); each view's ``.grad``
    is preset to its slice of the gradient buffer, which the backward then
    adds to in place. So no layer's or expert's gradient is scattered into
    a zero tensor of its whole stack first."""

    def leaf(p, g):
        v = p.detach().requires_grad_()
        v.grad = g
        return v

    def views(p, g, depth):
        if depth == 0:
            return leaf(p, g)
        return [views(p[i], g[i], depth - 1) for i in range(p.shape[0])]

    return map_leaves(lambda path, p, g: views(p, g, lm.stacked_axes(path)), params, grads)


def make_train_step(cfg: ModelConfig, mesh=None, tcfg: TrainConfig = TrainConfig()):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the mean loss over ``tcfg.microbatches`` microbatches (each a backward
    into gradients in the parameters' dtype, then divided by m), the int8
    roundtrip with ``grad_compression="int8_ef"``, the global-norm clip and
    AdamW, in place. ``metrics``: ``{"loss", "grad_norm"}`` (0-d float32,
    the norm before clipping)."""
    _one_device(mesh, "make_train_step")
    adam_cfg = tcfg.adam()
    m = tcfg.microbatches

    def step(params, opt_state, batch):
        dev = params["final_ln"].device
        batch = batch_tensors(batch, dev)
        rows = next(iter(batch.values())).shape[0]
        if rows % m:
            raise ValueError(f"batch of {rows} rows in {m} microbatches")
        grads = map_leaves(lambda _p, p: torch.zeros_like(p), params)
        leaves = _grad_leaves(params, grads)
        loss = torch.zeros((), dtype=F32, device=dev)
        bm = rows // m
        for i in range(m):
            part = lm.train_loss(leaves, {k: v[i * bm:(i + 1) * bm] for k, v in batch.items()},
                                 cfg)
            part.backward()
            loss = loss + part.detach()
        del leaves
        if m > 1:
            loss = loss / m
            map_leaves(lambda _p, g: g.div_(m), grads)
        if tcfg.grad_compression == "int8_ef":
            grads = ef_int8_roundtrip(grads)
        gnorm = global_norm(grads)
        params, opt_state = adam_update_(grads, opt_state, params, adam_cfg,
                                         grad_scale=clip_scale(gnorm, tcfg.clip_norm))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def make_opt_init(cfg: ModelConfig, mesh=None, tcfg: TrainConfig = TrainConfig()):
    """``init(params) -> AdamState``: zero moments in ``tcfg``'s state dtype."""
    _one_device(mesh, "make_opt_init")
    adam_cfg = tcfg.adam()
    return lambda params: adam_init(params, adam_cfg)


def make_calibrate_step(cfg: ModelConfig, mesh=None, *, analog_cfg: AnalogConfig, seq_len: int,
                        target_e_per_mac: float, lam: float = 2.0, lr: float = 0.01):
    """The paper's Eq. 14 at LM scale, the weights frozen:
    ``step(log_e, opt_state, params, batch, key) -> (log_e, opt_state,
    metrics)``. The log energies become energies (``to_energy``), the loss
    is the analog ``train_loss`` (every site and the lm_head noisy under
    ``analog_cfg`` with ``key``) plus ``log_energy_penalty`` against
    ``target_e_per_mac`` over ``energy_macs(cfg, seq_len)``, and Adam at
    ``lr`` steps the log energies. ``metrics``: ``{"loss", "nll"}``. The
    gradient needs a backend with a backward (``"torch"`` or ``"tile"``);
    the CUDA kernel has none."""
    _one_device(mesh, "make_calibrate_step")
    macs = lm.energy_macs(cfg, seq_len)
    adam_cfg = AdamConfig(lr=lr)

    def step(log_e, opt_state, params, batch, key):
        batch = batch_tensors(batch, params["final_ln"].device)
        le = map_leaves(lambda _p, t: t.detach().requires_grad_(), log_e)
        e = to_energy(le)
        nll = lm.train_loss(params, batch, cfg,
                            analog=lm.AnalogSpec(cfg=analog_cfg, energies=e, key=key))
        loss = nll + log_energy_penalty(e, macs, target_e_per_mac, lam)
        loss.backward()
        grads = map_leaves(lambda _p, t: torch.zeros_like(t) if t.grad is None else t.grad, le)
        log_e, opt_state = adam_update(grads, opt_state, log_e, adam_cfg)
        return log_e, opt_state, {"loss": loss.detach(), "nll": nll.detach()}

    step.macs = macs
    return step

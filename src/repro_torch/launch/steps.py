"""Step functions of training and of the LM calibration; port of
``repro/launch/steps.py`` (``TrainConfig``, ``make_train_step``,
``make_opt_init``, ``make_calibrate_step``).

There is no jit: each ``make_*`` returns a plain callable. The serving
steps are the engine's (``serving/tiers.py``).

Every family trains and calibrates (dense, griffin, xlstm, moe). The
train step updates the parameters and the optimizer state in place, as
the reference's donates them. Its gradients accumulate in the
parameters' dtype (the reference's ``g0 = zeros_like(p)``): every
layer-stacked leaf is handed to the loss as a list of per-layer views
(mLSTM and expert leaves as lists of per-block or per-expert views),
each an autograd leaf whose ``.grad`` is the matching slice of one
preallocated gradient buffer, so the backward adds each layer's gradient
in place and no stacked gradient is assembled from slices.

Training takes a mesh of data shards (``launch/mesh.py``, ``tp`` 1): the
reference's data parallelism with ZeRO-1 moments. Data shard r takes its
contiguous 1/data of the batch's rows; the shards' gradients (and
losses) are added in shard order in the gradients' dtype and divided by
``data``; then, as in the reference, the int8 roundtrip, the global norm
of the whole reduced gradient (the same bits on every shard), the clip and
AdamW. Each leaf's moments are cut among the shards along the dim its
``zero1_axes`` placement gives the "data" axis (``zero1_dims``; whole
where it does not divide), each shard updates its region of the
parameters, and the regions are gathered. At ``microbatches = 1`` a mesh
of ``data`` shards equals the one-device step at ``microbatches = data``
bit for bit, in either form of the mesh. Tensor-parallel training (``tp``
> 1) and a sharded ``make_calibrate_step`` are not ported (ROADMAP A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.energy import log_energy_penalty, to_energy
from repro_torch.launch import collectives
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import PROFILES, tree_shardings, zero1_axes
from repro_torch.optim.adam import AdamConfig, AdamState, adam_init, adam_update, adam_update_
from repro_torch.optim.clip import clip_scale, global_norm
from repro_torch.optim.compress import ef_int8_roundtrip
from repro_torch.tree import leaves, map_leaves

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


def _data_shards(mesh, what: str) -> int:
    """The mesh's data shards; raises on tensor shards."""
    if mesh is None:
        return 1
    if mesh.tp > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {mesh.tp} tensor shards: tensor-parallel training is not "
            "ported (ROADMAP A); take a mesh of data shards (tp=1)")
    return mesh.data


def _one_device(mesh, what: str) -> None:
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {mesh.size} shards: the sharded LM calibration is not ported "
            "(ROADMAP A); pass mesh=None")


def zero1_dims(cfg: ModelConfig, mesh) -> dict:
    """The dim along which each parameter's Adam moments are cut among the
    mesh's data shards, or None (whole): the reference's ZeRO-1 placement,
    ``spec`` of the leaf's ``zero1_axes`` under ``cfg.sharding_profile``'s
    rules, read for the dim that takes the "data" axis."""
    data = 1 if mesh is None else mesh.data
    shapes = map_leaves(lambda _p, leaf: leaf.shape, lm.param_leaves(cfg))
    if data == 1:
        return map_leaves(lambda _p, _s: None, shapes)
    axes = map_leaves(lambda _p, a: zero1_axes(a), lm.param_axes(cfg))
    placed = tree_shardings(axes, shapes, mesh, PROFILES[cfg.sharding_profile])

    def dim(_path, place):
        hits = [i for i, a in enumerate(place) if "data" in (a if isinstance(a, tuple) else (a,))]
        return hits[0] if hits else None

    return map_leaves(dim, placed)


def _region(shape, dim, parts: int, r: int):
    """Shard r's index tuple of a leaf cut in ``parts`` along ``dim``."""
    if dim is None:
        return None
    n = shape[dim] // parts
    return (slice(None),) * dim + (slice(r * n, (r + 1) * n),)


def zero1_regions(cfg: ModelConfig, mesh, r: int) -> dict:
    """Data shard r's index tuple of every parameter (None: whole)."""
    shapes = map_leaves(lambda _p, leaf: leaf.shape, lm.param_leaves(cfg))
    data = 1 if mesh is None else mesh.data
    return map_leaves(lambda _p, sh, d: _region(sh, d, data, r), shapes, zero1_dims(cfg, mesh))


def shard_opt_state(opt: AdamState, cfg: ModelConfig, mesh) -> AdamState:
    """Whole moments -> this process's: its data shard's regions (copies) in
    the distributed form, the whole moments in the local form."""
    if mesh is None or not mesh.distributed or mesh.data == 1:
        return opt
    regions = zero1_regions(cfg, mesh, mesh.data_shards()[0])

    def take(_p, t, reg):
        return t if reg is None else t[reg].clone()

    return AdamState(step=opt.step, mu=map_leaves(take, opt.mu, regions),
                     nu=map_leaves(take, opt.nu, regions))


@torch.no_grad()
def gather_opt_state(opt: AdamState, cfg: ModelConfig, mesh) -> AdamState:
    """This process's moments -> the whole moments (a collective in the
    distributed form; every rank gets them)."""
    if mesh is None or not mesh.distributed or mesh.data == 1:
        return opt
    dims = zero1_dims(cfg, mesh)

    def whole(_p, t, d):
        return t if d is None else torch.cat(collectives.all_gather(t, mesh.group), dim=d)

    return AdamState(step=opt.step, mu=map_leaves(whole, opt.mu, dims),
                     nu=map_leaves(whole, opt.nu, dims))


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


def _backward(params, grads, batch: dict, cfg: ModelConfig, m: int) -> torch.Tensor:
    """``m`` microbatches of ``batch`` through the loss and its backward,
    the gradients added into ``grads`` in place; returns the float32 sum
    of their losses."""
    rows = next(iter(batch.values())).shape[0]
    leaves_ = _grad_leaves(params, grads)
    loss = torch.zeros((), dtype=F32, device=params["final_ln"].device)
    bm = rows // m
    for i in range(m):
        part = lm.train_loss(leaves_, {k: v[i * bm:(i + 1) * bm] for k, v in batch.items()}, cfg)
        part.backward()
        loss = loss + part.detach()
    return loss


def make_train_step(cfg: ModelConfig, mesh=None, tcfg: TrainConfig = TrainConfig()):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the mean loss over ``tcfg.microbatches`` microbatches (each a backward
    into gradients in the parameters' dtype, then divided by m), the int8
    roundtrip with ``grad_compression="int8_ef"``, the global-norm clip and
    AdamW, in place. ``metrics``: ``{"loss", "grad_norm"}`` (0-d float32,
    the norm before clipping). ``mesh``: None or a mesh of data shards
    (module docstring); ``opt_state`` then comes from ``make_opt_init`` on
    the same mesh."""
    dp = _data_shards(mesh, "make_train_step")
    adam_cfg = tcfg.adam()
    m = tcfg.microbatches
    group = mesh.group if mesh is not None and mesh.distributed and dp > 1 else None
    regions = by_leaf = None
    if group is not None:
        regions = zero1_regions(cfg, mesh, mesh.data_shards()[0])
        # each leaf's regions of every rank, in ``leaves`` order
        by_leaf = list(zip(*(leaves(zero1_regions(cfg, mesh, r)) for r in range(dp))))

    def step(params, opt_state, batch):
        dev = params["final_ln"].device
        batch = batch_tensors(batch, dev)
        rows = next(iter(batch.values())).shape[0]
        if rows % (dp * m):
            raise ValueError(f"batch of {rows} rows in {dp} data shards of {m} microbatches")
        per = rows // dp
        grads = map_leaves(lambda _p, p: torch.zeros_like(p), params)
        loss = None
        for r in (mesh.data_shards() if mesh is not None else range(1)):
            part = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
            # a later shard's microbatches go to a buffer of their own, added
            # to the sum after their mean, as a rank's mean joins the sum
            # across ranks; with one microbatch the backward adds in place
            own = loss is None or m == 1
            target = grads if own else map_leaves(lambda _p, p: torch.zeros_like(p), params)
            part_loss = _backward(params, target, part, cfg, m)
            if m > 1:
                part_loss = part_loss / m
                map_leaves(lambda _p, g: g.div_(m), target)
            if not own:
                map_leaves(lambda _p, g, t: g.add_(t), grads, target)
            loss = part_loss if loss is None else loss + part_loss
        if group is not None:
            for g in leaves(grads):
                collectives.sum_in_rank_order_(g, group)
            loss = collectives.sum_in_rank_order_(loss.reshape(1), group)[0]
        if dp > 1:
            loss = loss / dp
            map_leaves(lambda _p, g: g.div_(dp), grads)
        if tcfg.grad_compression == "int8_ef":
            grads = ef_int8_roundtrip(grads)
        gnorm = global_norm(grads)
        params, opt_state = adam_update_(grads, opt_state, params, adam_cfg,
                                         grad_scale=clip_scale(gnorm, tcfg.clip_norm),
                                         regions=regions)
        if by_leaf is not None:
            for p, regs in zip(leaves(params), by_leaf):
                if regs[0] is not None:
                    collectives.gather_regions_(p, list(regs), group)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def make_opt_init(cfg: ModelConfig, mesh=None, tcfg: TrainConfig = TrainConfig()):
    """``init(params) -> AdamState``: zero moments in ``tcfg``'s state dtype;
    on a distributed data mesh only this rank's regions of them (ZeRO-1)."""
    _data_shards(mesh, "make_opt_init")
    adam_cfg = tcfg.adam()
    if mesh is None or not mesh.distributed or mesh.data == 1:
        return lambda params: adam_init(params, adam_cfg)
    regions = zero1_regions(cfg, mesh, mesh.data_shards()[0])

    def init(params):
        mine = map_leaves(lambda _p, p, reg: p if reg is None else p[reg], params, regions)
        return adam_init(mine, adam_cfg)

    return init


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

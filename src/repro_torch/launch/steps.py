"""Step functions of training, serving and the LM calibration; port of
``repro/launch/steps.py`` (``TrainConfig``, ``make_train_step``,
``make_opt_init``, ``make_prefill_step``, ``make_decode_step``,
``make_calibrate_step``).

There is no jit: each ``make_*`` returns a plain callable. The engine
serves through its own tiers (``serving/tiers.py``); ``make_prefill_step``
and ``make_decode_step`` are the reference's step API, which the dry run
(``launch/dryrun.py``) reckons.

Every family trains and calibrates (dense, griffin, xlstm, moe). The
train step updates the parameters and the optimizer state in place, as
the reference's donates them. Its gradients accumulate in the
parameters' dtype (the reference's ``g0 = zeros_like(p)``): every
layer-stacked leaf is handed to the loss as a list of per-layer views
(mLSTM and expert leaves as lists of per-block or per-expert views),
each an autograd leaf whose ``.grad`` is the matching slice of one
preallocated gradient buffer, so the backward adds each layer's gradient
in place and no stacked gradient is assembled from slices.

Training takes a mesh of data x tensor shards (``launch/mesh.py``;
``train_layout``). Under the ``"tp"`` profile each tensor shard holds
its Megatron shard of every cut leaf (``models.sharding.tensor_plan``):
the local form cuts them from the whole parameters at each step as
contiguous copies (a rank's layout) and runs the shards in turn inside
each block, a rank holds its own (``shard_params``). Data shard r takes
its contiguous block of the batch's rows (the reference's placement of
"batch", ``row_blocks``); the shards' gradients (and losses) are added in
shard order in the gradients' dtype and divided by the data shards; each
whole leaf with a partial gradient on each tensor shard is summed over
tp; then, as in the reference, the int8 roundtrip (a cut leaf's scale
from its max over tp), the global norm (a cut leaf's squares summed over
tp, a whole leaf counted once: the same bits on every shard), the clip
and AdamW. Each leaf's moments are cut among the data shards along the
dim its ``zero1_axes`` placement gives the "data" axis (``zero1_dims``;
whole where it does not divide), each data shard updates its region of
its tensor shard, and the regions are gathered. Under ``"dp"``
(xlstm-1.3b) the weights are whole and the batch and the moments go over
``data * tp`` shards. At ``microbatches = 1`` a mesh of ``data`` shards
equals the one-device step at ``microbatches = data`` bit for bit, and
the local form of any mesh equals its ranks bit for bit.

The LM calibration takes the same mesh of data x tensor shards, as the
reference's step places the frozen parameters by ``param_shardings`` and
replicates the log energies and their Adam state. The frozen parameters
are cut as the train step cuts them (a rank holds its own,
``shard_params``); each tensor shard reads the log energies through
autograd leaves of its own (``Shards``), and an analog site takes its
shard and its form as arguments (``models/hooks.py``): a column-cut site
draws its window of the whole call's noise, a row-cut site's partials
are summed over tp and its noise drawn once after the sum, a whole site
draws the whole call's on every shard. An energy leaf's gradient is
summed over tp in shard order where each shard's part reads its own
columns (``models.sharding.energy_sums``), else taken once. Data shard
r's rows run under ``models.sharding.use_data_shard``, so every analog
site draws the noise of its rows of the whole call (``core/analog.py``),
and a checkpointed region's recompute re-enters that place
(``models.sharding.remat``); the shards' NLLs and energy gradients are
added in shard order in their dtype (over the ranks with
``collectives.sum_in_rank_order_``) and divided by ``data``, the penalty
and its gradient added once after, and Adam steps the replicated log
energies with the same bits on every rank. Thermal noise on a data axis
needs the distributed form (its input range spans the shards); MoE needs
whole expert groups in a shard (``MoEGroupsAcrossShards``); calibrated
site quantizers do not run on tensor shards
(``core.analog.QuantizersUnderTensorShards``).

The serving steps cut the batch's rows by ``data`` the same way (a batch
that ``data`` does not divide runs whole on every shard, as the
reference's shape-aware placement replicates it) and run under the
mesh's tensor shards (``use_mesh``: the analog sites' columns). In the
distributed form a step returns its shard's rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.energy import log_energy_penalty, to_energy
from repro_torch.launch import collectives
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (
    PROFILES,
    DataShard,
    Shards,
    TensorShard,
    TPLeaf,
    energy_sums,
    join_tensor_shards,
    shard_shape,
    spec,
    take_tensor_shard,
    tensor_plan,
    tree_shardings,
    use_data_shard,
    use_mesh,
    zero1_axes,
)
from repro_torch.optim.adam import AdamConfig, AdamState, adam_init, adam_update, adam_update_
from repro_torch.optim.clip import clip_scale, global_norm, norm_of, sum_squares
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


class MoEGroupsAcrossShards(NotImplementedError):
    """A data shard of an MoE model whose tokens are not whole expert
    groups: the reference's groups come from the flattened tokens of the
    whole batch (``models/moe.py``), so a group would span shards, and
    its routing and capacity would need an exchange the port does not
    make."""


def _shard_rows(cfg: ModelConfig, rows: int, tokens: int, dp: int, what: str) -> int:
    """Rows a data shard takes of ``rows`` (``tokens`` a row); raises on a
    cut that would split an MoE expert group."""
    if rows % dp:
        raise ValueError(f"{what}: a batch of {rows} rows in {dp} data shards")
    per = rows // dp
    if cfg.family == "moe" and dp > 1 and (per * tokens) % cfg.moe_group_size:
        raise MoEGroupsAcrossShards(
            f"{what}: a data shard of {per} x {tokens} tokens is not whole expert groups of "
            f"{cfg.moe_group_size}; take rows x tokens a shard a multiple of moe_group_size")
    return per


def _shard(mesh, r: int, dp: int, group=None):
    """Data shard r's ambient place (None for one shard); ``group``: the
    data group of a distributed mesh (default: the mesh's)."""
    if dp == 1:
        return None
    if group is None and mesh.distributed:
        group = mesh.data_group
    return DataShard(r, dp, group)


def _tokens(batch: dict) -> int:
    """Positions a row of a batch dict holds (the patch prefix counted)."""
    if "labels" in batch:
        return batch["labels"].shape[1]
    t = batch["embeds" if "embeds" in batch else "tokens"].shape[1]
    return t + (batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A train step's place on a mesh under ``cfg.sharding_profile``:
    ``tp`` tensor shards of the weights (``"tp"``: the mesh's; ``"dp"``:
    1), ``dp`` data shards of the batch and the moments (``"tp"``:
    ``data``; ``"dp"``: ``data * tp``), the data shards this process runs
    and their group (None: the local form, or one shard), the tensor
    shards it runs (every one of the local form, a rank's own, ``()`` at
    tp 1) and each leaf's ``TPLeaf``."""

    tp: int
    dp: int
    data_ids: range
    data_group: Any
    tensor: tuple
    plan: dict


def train_layout(cfg: ModelConfig, mesh) -> Layout:
    dp_profile = cfg.sharding_profile == "dp"
    tp = 1 if mesh is None or dp_profile else mesh.tp
    dp = 1 if mesh is None else mesh.size if dp_profile else mesh.data
    plan = tensor_plan(cfg, tp)
    if mesh is None or not mesh.distributed:
        return Layout(tp, dp, range(dp), None,
                      tuple(TensorShard(t, tp) for t in range(tp)) if tp > 1 else (), plan)
    r = collectives.rank(mesh.group) if dp_profile else mesh.data_shards()[0]
    group = None if dp == 1 else mesh.group if dp_profile else mesh.data_group
    tensor = (TensorShard(mesh.shards()[0], tp, mesh.tp_group),) if tp > 1 else ()
    return Layout(tp, dp, range(r, r + 1), group, tensor, plan)


def row_blocks(cfg: ModelConfig, mesh, rows: int) -> int:
    """The distinct blocks a batch of ``rows`` is cut into among the data
    shards: the reference's placement of "batch" (a tuple of mesh axes
    degrades to its longest prefix that divides the rows); ``dp / blocks``
    data shards in a row take each block."""
    if mesh is None:
        return 1
    place = spec(("batch",), PROFILES[cfg.sharding_profile], mesh, shape=(rows,))[0]
    axes = () if place is None else place if isinstance(place, tuple) else (place,)
    return math.prod({"data": mesh.data, "model": mesh.tp}[a] for a in axes)


def _shard_shapes(cfg: ModelConfig, mesh) -> dict:
    """Every parameter's shape on one tensor shard of ``mesh``."""
    lay = train_layout(cfg, mesh)
    return map_leaves(lambda _p, leaf, place: shard_shape(leaf.shape, place, lay.tp),
                      lm.param_leaves(cfg), lay.plan)


def zero1_dims(cfg: ModelConfig, mesh) -> dict:
    """The ``(dim, parts)`` along which each parameter's Adam moments are
    cut among the mesh's data shards, or None (whole): the reference's
    ZeRO-1 placement, ``spec`` of the leaf's ``zero1_axes`` under
    ``cfg.sharding_profile``'s rules, read for the dim that takes the
    "data" axis, in as many parts as the mesh axes it takes (``"dp"``:
    ("data", "model") is ``data * tp`` parts, its prefix ("data",)
    ``data``)."""
    dp = train_layout(cfg, mesh).dp
    shapes = map_leaves(lambda _p, leaf: leaf.shape, lm.param_leaves(cfg))
    if dp == 1:
        return map_leaves(lambda _p, _s: None, shapes)
    axes = map_leaves(lambda _p, a: zero1_axes(a), lm.param_axes(cfg))
    placed = tree_shardings(axes, shapes, mesh, PROFILES[cfg.sharding_profile])
    sizes = {"data": mesh.data, "model": mesh.tp}

    def cut(_path, place):
        for i, a in enumerate(place):
            names = a if isinstance(a, tuple) else (a,)
            if "data" in names:
                return i, math.prod(sizes[n] for n in names)
        return None

    return map_leaves(cut, placed)


def _region(shape, cut, r: int, dp: int):
    """Data shard r's index tuple of a leaf cut in ``cut = (dim, parts)``
    (``dp / parts`` shards in a row share a part)."""
    if cut is None:
        return None
    dim, parts = cut
    n, i = shape[dim] // parts, r // (dp // parts)
    return (slice(None),) * dim + (slice(i * n, (i + 1) * n),)


def zero1_regions(cfg: ModelConfig, mesh, r: int) -> dict:
    """Data shard r's index tuple of every parameter's tensor shard (None:
    whole)."""
    dp = train_layout(cfg, mesh).dp
    return map_leaves(lambda _p, sh, c: _region(sh, c, r, dp), _shard_shapes(cfg, mesh),
                      zero1_dims(cfg, mesh))


def shard_params(params: Tree, cfg: ModelConfig, mesh) -> Tree:
    """The whole parameters -> this process's: its tensor shard of each cut
    leaf (a contiguous copy) in the distributed form of a tensor mesh; the
    whole tree otherwise."""
    lay = train_layout(cfg, mesh)
    if lay.tp == 1 or not mesh.distributed:
        return params
    return take_tensor_shard(params, lay.plan, lay.tp, lay.tensor[0].t)


@torch.no_grad()
def gather_params(params: Tree, cfg: ModelConfig, mesh) -> Tree:
    """``shard_params``' inverse (a collective over the tp group in the
    distributed form; every rank gets the whole tree)."""
    lay = train_layout(cfg, mesh)
    if lay.tp == 1 or not mesh.distributed:
        return params
    group = lay.tensor[0].group
    return map_leaves(lambda _p, t, place: t if place.dim is None else torch.cat(
        collectives.all_gather(t.contiguous(), group), dim=place.dim), params, lay.plan)


def shard_opt_state(opt: AdamState, cfg: ModelConfig, mesh) -> AdamState:
    """Whole moments -> this process's: in the distributed form its tensor
    shard's, and of those its data shard's regions (copies); the whole
    moments in the local form."""
    lay = train_layout(cfg, mesh)
    if lay.data_group is None and (lay.tp == 1 or not mesh.distributed):
        return opt
    regions = zero1_regions(cfg, mesh, lay.data_ids[0])

    def take(_p, t, reg):
        return t if reg is None else t[reg].clone()

    mu, nu = (shard_params(m, cfg, mesh) for m in (opt.mu, opt.nu))
    return AdamState(step=opt.step, mu=map_leaves(take, mu, regions),
                     nu=map_leaves(take, nu, regions))


@torch.no_grad()
def gather_opt_state(opt: AdamState, cfg: ModelConfig, mesh) -> AdamState:
    """This process's moments -> the whole moments (collectives in the
    distributed form; every rank gets them)."""
    lay = train_layout(cfg, mesh)
    if lay.data_group is None and (lay.tp == 1 or not mesh.distributed):
        return opt
    dims = zero1_dims(cfg, mesh)

    def whole(_p, t, cut):
        if cut is None or lay.data_group is None:
            return t
        parts = collectives.all_gather(t.contiguous(), lay.data_group)
        return torch.cat(parts[::lay.dp // cut[1]], dim=cut[0])

    mu, nu = (map_leaves(whole, m, dims) for m in (opt.mu, opt.nu))
    return AdamState(step=opt.step, mu=gather_params(mu, cfg, mesh),
                     nu=gather_params(nu, cfg, mesh))


def batch_tensors(batch, device) -> dict:
    """A batch of numpy arrays or tensors (``markov_batch``'s) as tensors
    on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _grad_leaves(params: Tree, grads: Tree, plan: Optional[dict] = None,
                 shards: tuple = ()) -> Tree:
    """``params`` as autograd leaves accumulating into ``grads``: a stacked
    leaf becomes a list of per-layer views (``lm`` indexes a list as it
    indexes the stacked tensor), an mLSTM or expert leaf a list of lists,
    one view a block or expert (``lm.stacked_axes``); each view's ``.grad``
    is preset to its slice of the gradient buffer, which the backward then
    adds to in place. So no layer's or expert's gradient is scattered into
    a zero tensor of its whole stack first.

    With ``plan`` (``tensor_plan``), ``params`` and ``grads`` are lists,
    one tree each of the tensor shards ``shards``: a leaf cut or summed
    over them becomes (at each layer or expert) ``Shards`` of one view a
    shard, a whole leaf shard 0's view."""
    if plan is None:
        params, grads = [params], [grads]
        plan = map_leaves(lambda _p, _l: TPLeaf(), params[0])
    n = len(params)

    def leaf(p, g):
        v = p.detach().requires_grad_()
        v.grad = g
        return v

    def views(ps, gs, depth, per_shard):
        if depth == 0:
            if per_shard:
                return Shards((leaf(p, g) for p, g in zip(ps, gs)), shards)
            return leaf(ps[0], gs[0])
        return [views([p[i] for p in ps], [g[i] for g in gs], depth - 1, per_shard)
                for i in range(ps[0].shape[0])]

    return map_leaves(lambda path, place, *pg: views(pg[:n], pg[n:], lm.stacked_axes(path),
                                                     place.per_shard), plan, *params, *grads)


def _backward(trees: list, grads: list, batch: dict, cfg: ModelConfig, m: int,
              lay: Layout) -> torch.Tensor:
    """``m`` microbatches of ``batch`` through the loss and its backward on
    the tensor shards' trees, the gradients added into ``grads`` in place;
    returns the float32 sum of their losses."""
    rows = next(iter(batch.values())).shape[0]
    leaves_ = _grad_leaves(trees, grads, lay.plan, lay.tensor)
    loss = torch.zeros((), dtype=F32, device=trees[0]["final_ln"].device)
    bm = rows // m
    for i in range(m):
        part = lm.train_loss(leaves_, {k: v[i * bm:(i + 1) * bm] for k, v in batch.items()}, cfg)
        part.backward()
        loss = loss + part.detach()
    return loss


def _shard_trees(params: Tree, lay: Layout) -> list:
    """The tree each tensor shard this process runs computes with: the
    local form's every shard, cut from the whole parameters as contiguous
    copies (a rank's layout); else the parameters themselves."""
    if len(lay.tensor) < 2:
        return [params]
    return [take_tensor_shard(params, lay.plan, lay.tp, s.t) for s in lay.tensor]


def _per_leaf(grads: list, plan: dict) -> list:
    """[(TPLeaf, [the leaf in each tree])] in ``leaves`` order."""
    return list(zip(leaves(plan), zip(*(leaves(g) for g in grads))))


@torch.no_grad()
def _tp_reduce(grads: list, lay: Layout, tcfg: TrainConfig) -> tuple:
    """After the data shards' sum: each summed whole leaf's partials added
    over tp; the int8 roundtrip (a cut leaf's scale from its max over tp);
    the global norm, each cut leaf's squares summed over tp and each whole
    leaf counted once. Returns (grads, norm)."""
    shards, per_leaf = lay.tensor, _per_leaf(grads, lay.plan)
    for place, gs in per_leaf:
        if place.summed:
            collectives.sum_over_tp_(list(gs), shards)
    if tcfg.grad_compression == "int8_ef":
        amax = {}
        cut = [i for i, (place, _g) in enumerate(per_leaf) if place.dim is not None]
        if shards and cut:
            paths = leaves(map_leaves(lambda path, _l: path, lay.plan))
            top = collectives.max_over_tp(
                [torch.stack([torch.amax(torch.abs(per_leaf[i][1][j].to(F32))) for i in cut])
                 for j in range(len(grads))], shards)
            amax = {paths[i]: top[k] for k, i in enumerate(cut)}
        grads = [ef_int8_roundtrip(tree, amax) for tree in grads]
        per_leaf = _per_leaf(grads, lay.plan)
    if not shards:
        return grads, global_norm(grads[0])
    sq = [[sum_squares(g) for g in (gs if place.dim is not None else gs[:1])]
          for place, gs in per_leaf]
    cut = [i for i, (place, _g) in enumerate(per_leaf) if place.dim is not None]
    if cut:  # one sum over tp for every cut leaf
        acc = collectives.reduce_from_tp(
            [torch.stack([sq[i][j] for i in cut]) for j in range(len(grads))], shards)
        for k, i in enumerate(cut):
            sq[i] = [acc[k]]
    return grads, norm_of([s[0] for s in sq])


def _whole_grads(grads: list, lay: Layout) -> Tree:
    """The gradient tree the update reads: the local form's shards joined
    into whole leaves; else this process's tree."""
    if len(grads) == 1:
        return grads[0]
    return join_tensor_shards(grads, lay.plan)


def make_train_step(cfg: ModelConfig, mesh=None, tcfg: TrainConfig = TrainConfig()):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the mean loss over ``tcfg.microbatches`` microbatches (each a backward
    into gradients in the parameters' dtype, then divided by m), the int8
    roundtrip with ``grad_compression="int8_ef"``, the global-norm clip and
    AdamW, in place. ``metrics``: ``{"loss", "grad_norm"}`` (0-d float32,
    the norm before clipping). ``mesh``: None or a mesh of data x tensor
    shards (module docstring): ``params`` are the whole tree in the local
    form, a rank's tensor shard (``shard_params``) in the distributed form;
    ``opt_state`` comes from ``make_opt_init`` on the same mesh; ``batch``
    is the whole batch."""
    lay = train_layout(cfg, mesh)
    adam_cfg = tcfg.adam()
    m = tcfg.microbatches
    regions = by_leaf = None
    if lay.data_group is not None:
        regions = zero1_regions(cfg, mesh, lay.data_ids[0])
        # each leaf's regions of every data shard, in ``leaves`` order
        by_leaf = list(zip(*(leaves(zero1_regions(cfg, mesh, r)) for r in range(lay.dp))))

    def step(params, opt_state, batch):
        dev = params["final_ln"].device
        batch = batch_tensors(batch, dev)
        rows = next(iter(batch.values())).shape[0]
        blocks = row_blocks(cfg, mesh, rows)
        if rows % (blocks * m):
            raise ValueError(f"batch of {rows} rows in {blocks} data shards of {m} microbatches")
        per, share = rows // blocks, lay.dp // blocks
        trees = _shard_trees(params, lay)
        zeros = lambda: [map_leaves(lambda _p, p: torch.zeros_like(p), t) for t in trees]  # noqa
        grads = zeros()
        loss = None
        for r in lay.data_ids:
            b = r // share
            part = {k: v[b * per:(b + 1) * per] for k, v in batch.items()}
            # a later shard's microbatches go to buffers of their own, added
            # to the sum after their mean, as a rank's mean joins the sum
            # across ranks; with one microbatch the backward adds in place
            own = loss is None or m == 1
            target = grads if own else zeros()
            part_loss = _backward(trees, target, part, cfg, m, lay)
            if m > 1:
                part_loss = part_loss / m
                for t in target:
                    map_leaves(lambda _p, g: g.div_(m), t)
            if not own:
                for g_tree, t_tree in zip(grads, target):
                    map_leaves(lambda _p, g, t: g.add_(t), g_tree, t_tree)
            loss = part_loss if loss is None else loss + part_loss
        if lay.data_group is not None:
            for g in (g for tree in grads for g in leaves(tree)):
                collectives.sum_in_rank_order_(g, lay.data_group)
            loss = collectives.sum_in_rank_order_(loss.reshape(1), lay.data_group)[0]
        if lay.dp > 1:
            loss = loss / lay.dp
            for tree in grads:
                map_leaves(lambda _p, g: g.div_(lay.dp), tree)
        grads, gnorm = _tp_reduce(grads, lay, tcfg)
        params, opt_state = adam_update_(_whole_grads(grads, lay), opt_state, params, adam_cfg,
                                         grad_scale=clip_scale(gnorm, tcfg.clip_norm),
                                         regions=regions)
        if by_leaf is not None:
            for p, regs in zip(leaves(params), by_leaf):
                if regs[0] is not None:
                    collectives.gather_regions_(p, list(regs), lay.data_group)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def make_opt_init(cfg: ModelConfig, mesh=None, tcfg: TrainConfig = TrainConfig()):
    """``init(params) -> AdamState``: zero moments in ``tcfg``'s state dtype
    of the parameters ``make_train_step`` takes on ``mesh``; on a
    distributed mesh of data shards only this rank's regions of them
    (ZeRO-1)."""
    lay = train_layout(cfg, mesh)
    adam_cfg = tcfg.adam()
    if lay.data_group is None:
        return lambda params: adam_init(params, adam_cfg)
    regions = zero1_regions(cfg, mesh, lay.data_ids[0])

    def init(params):
        mine = map_leaves(lambda _p, p, reg: p if reg is None else p[reg], params, regions)
        return adam_init(mine, adam_cfg)

    return init


def _frozen_views(trees: list, lay: Layout) -> Tree:
    """The tensor shards' trees as ``lm`` reads them, without gradients:
    a leaf cut or summed over the shards as ``Shards`` at each layer (or
    expert, or mLSTM block), a whole leaf shard 0's; one tree as it is."""
    if not lay.tensor:
        return trees[0]

    def views(ps, depth, per_shard):
        if depth == 0:
            return Shards(ps, lay.tensor) if per_shard else ps[0]
        return [views([p[i] for p in ps], depth - 1, per_shard) for i in range(ps[0].shape[0])]

    return map_leaves(lambda path, place, *ps: views(list(ps), lm.stacked_axes(path),
                                                     place.per_shard), lay.plan, *trees)


def _grads_of(tree: Tree) -> Tree:
    """The ``.grad`` of each autograd leaf of ``tree`` (zeros where none
    reached it)."""
    return map_leaves(lambda _p, t: torch.zeros_like(t) if t.grad is None else t.grad, tree)


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
    the CUDA kernel has none. ``mesh``: None or a mesh of data x tensor
    shards (module docstring): ``params`` are the whole tree in the local
    form, a rank's tensor shard (``shard_params``) in the distributed form;
    ``batch`` is the whole batch and ``key`` one (2,) key. The log
    energies and their Adam state are replicated. A data shard's place
    reaches every analog site through ``use_data_shard``, the recompute of
    a checkpointed region included (``models.sharding.remat``), a tensor
    shard's through the ``Shards`` leaves and the sites' arguments."""
    lay = train_layout(cfg, mesh)
    macs = lm.energy_macs(cfg, seq_len)
    adam_cfg = AdamConfig(lr=lr)
    sums = energy_sums(cfg, lay.tp) if lay.tensor else None

    def energies_of(log_e):
        """(the energies the loss reads, each tensor shard's log-energy
        leaves): a tree of autograd leaves a tensor shard this process
        runs, joined as ``Shards`` under tp."""
        les = [map_leaves(lambda _p, t: t.detach().requires_grad_(), log_e)
               for _ in range(max(1, len(lay.tensor)))]
        es = [to_energy(le) for le in les]
        if not lay.tensor:
            return es[0], les
        return map_leaves(lambda _p, *parts: Shards(parts, lay.tensor), *es), les

    def shard_grads(les):
        """The energy gradients of one data shard: each leaf summed over
        tp in shard (rank) order where ``energy_sums`` says so, else the
        first tensor shard's (the same on every shard)."""
        grads = [_grads_of(le) for le in les]
        if not lay.tensor:
            return grads[0]

        def combine(_p, summed, *gs):
            if summed:
                collectives.sum_over_tp_(list(gs), lay.tensor)
            return gs[0]

        return map_leaves(combine, sums, *grads)

    def step(log_e, opt_state, params, batch, key):
        batch = batch_tensors(batch, params["final_ln"].device)
        rows = next(iter(batch.values())).shape[0]
        per = _shard_rows(cfg, rows, _tokens(batch), lay.dp, "make_calibrate_step")
        tree = _frozen_views(_shard_trees(params, lay), lay)
        nll = grads = None
        for r in lay.data_ids:
            part = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
            with use_data_shard(_shard(mesh, r, lay.dp, lay.data_group)):
                energies, les = energies_of(log_e)
                part_nll = lm.train_loss(tree, part, cfg, analog=lm.AnalogSpec(
                    cfg=analog_cfg, energies=energies, key=key))
                part_nll.backward()
            part_nll, part_grads = part_nll.detach(), shard_grads(les)
            if nll is None:
                nll, grads = part_nll, part_grads
            else:  # in shard order, as the ranks' sum below
                nll = nll + part_nll
                map_leaves(lambda _p, g, t: g.add_(t), grads, part_grads)
        if lay.data_group is not None:
            for g in leaves(grads):
                collectives.sum_in_rank_order_(g, lay.data_group)
            nll = collectives.sum_in_rank_order_(nll.reshape(1), lay.data_group)[0]
        nll = nll / lay.dp
        map_leaves(lambda _p, g: g.div_(lay.dp), grads)
        le = map_leaves(lambda _p, t: t.detach().requires_grad_(), log_e)
        pen = log_energy_penalty(to_energy(le), macs, target_e_per_mac, lam)
        pen.backward()
        map_leaves(lambda _p, g, t: g.add_(t), grads, _grads_of(le))
        log_e, opt_state = adam_update(grads, opt_state, log_e, adam_cfg)
        return log_e, opt_state, {"loss": nll + pen.detach(), "nll": nll}

    step.macs = macs
    return step


# ---------------------------------------------------------------------------
# serving (prefill + decode), optionally analog
# ---------------------------------------------------------------------------


def _check_tree(params, param_tree) -> None:
    if param_tree is not None and type(params) is not type(param_tree):
        raise TypeError(f"the step was made for a {type(param_tree).__name__} tree, "
                        f"called with a {type(params).__name__}")


def _serving_parts(cfg: ModelConfig, mesh, rows: int, tokens: int, what: str):
    """[(data shard or None, rows slice)] this process runs: each shard's
    rows, or the whole batch once where ``data`` does not divide it (the
    reference replicates such a batch)."""
    dp = 1 if mesh is None else mesh.data
    if dp == 1 or rows % dp:
        return [(None, slice(None))]
    per = _shard_rows(cfg, rows, tokens, dp, what)
    return [(_shard(mesh, r, dp), slice(r * per, (r + 1) * per)) for r in mesh.data_shards()]


def _cache_rows(cfg: ModelConfig, cache, rows: slice):
    """Views of ``cache``'s rows ``rows`` along each leaf's batch dim."""
    if rows == slice(None):
        return cache

    def take(_path, leaf, axis):
        return leaf[(slice(None),) * axis + (rows,)]

    return map_leaves(take, cache, lm.cache_batch_axes(cfg))


def _tp_mesh(mesh):
    return mesh if mesh is not None and mesh.tp > 1 else None


def make_prefill_step(cfg: ModelConfig, mesh=None, cache_len: Optional[int] = None,
                      analog_cfg: Optional[AnalogConfig] = None, param_tree=None):
    """``step(params, batch, energies, key) -> (cache, logits)``: ``lm.prefill``
    of a batch dict (or a bare token tensor), then ``lm.logits_last``;
    analog under ``analog_cfg`` (``energies`` an ``init_energy_tree``, one
    (2,) ``key``), digital otherwise (``energies``, ``key`` unread). The
    cache holds ``cache_len`` positions (default the prompt's, or the
    window). ``mesh``: the analog sites run as its tensor shards, the
    batch's rows are cut by its data shards (module docstring): ``batch``
    is the whole batch; in the distributed form the cache and the logits
    are the shard's rows.
    ``param_tree``: the tree the step serves when it is not the bf16 one
    (an int8 tree, ``quant.weights.quantize_params``'s); the reference
    places its shards by it, the port places nothing and checks that
    ``params`` has its type."""

    def step(params, batch, energies, key):
        _check_tree(params, param_tree)
        batch = lm._as_batch(batch)
        h_rows = next(iter(batch.values())).shape[0]
        analog = None if analog_cfg is None else lm.AnalogSpec(
            cfg=analog_cfg, energies=energies, key=key)
        t = _tokens(batch)
        parts = _serving_parts(cfg, mesh, h_rows, t, "make_prefill_step")
        length = cache_len
        if length is None:
            w = lm._window(cfg)
            length = t if w is None else max(t, w)
        sizes = [len(range(h_rows)[rows]) for _s, rows in parts]
        cache = lm.init_cache(cfg, sum(sizes), length, device=params["final_ln"].device)
        logits, lo = [], 0
        with use_mesh(_tp_mesh(mesh)):
            for (shard, rows), n in zip(parts, sizes):
                part = {k: v[rows] for k, v in batch.items()}
                # this process's cache holds its parts' rows, in order
                views = _cache_rows(cfg, cache, slice(lo, lo + n) if len(parts) > 1 else
                                    slice(None))
                lo += n
                with use_data_shard(shard):
                    _, h_last = lm.prefill(params, part, cfg, analog=analog, cache_len=length,
                                           cache=views)
                logits.append(lm.logits_last(params, h_last, cfg))
        return cache, torch.cat(logits)

    return step


def make_decode_step(cfg: ModelConfig, mesh=None, analog_cfg: Optional[AnalogConfig] = None,
                     param_tree=None):
    """``step(params, cache, batch, pos, energies, key) -> (logits,
    cache)``: one ``lm.decode_step`` at positions ``pos`` (an int, or a
    (B,) tensor), the cache updated in place, as the reference donates it.
    ``mesh``, ``analog_cfg``, ``param_tree``: as ``make_prefill_step``'s:
    ``batch`` and ``pos`` are the whole batch's; in the distributed form
    ``cache`` is the shard's, as the prefill step returned it."""

    def step(params, cache, batch, pos, energies, key):
        _check_tree(params, param_tree)
        batch = lm._as_batch(batch)
        h_rows = next(iter(batch.values())).shape[0]
        analog = None if analog_cfg is None else lm.AnalogSpec(
            cfg=analog_cfg, energies=energies, key=key)
        dev = params["final_ln"].device
        pos = torch.as_tensor(pos).to(dev).long().reshape(-1).expand(h_rows)
        local = mesh is None or not mesh.distributed
        logits = []
        with use_mesh(_tp_mesh(mesh)):
            for shard, rows in _serving_parts(cfg, mesh, h_rows, 1, "make_decode_step"):
                part = {k: v[rows] for k, v in batch.items()}
                view = _cache_rows(cfg, cache, rows if local else slice(None))
                with use_data_shard(shard):
                    out, _ = lm.decode_step(params, view, part, pos[rows], cfg, analog=analog)
                logits.append(out)
        return torch.cat(logits), cache

    return step

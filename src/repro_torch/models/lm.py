"""Language model; port of ``repro/models/lm.py`` (every family: the forward
and the train loss).

Families:

  dense    - pre-norm transformer, GQA/MQA, SwiGLU or GELU MLP (with
             biases), optional QKV bias; with ``sliding_window`` its
             attention is windowed over a ring cache. Inputs are a batch
             dict: ``{"tokens"}``, ``{"embeds"}`` (the ``frames``
             frontend: precomputed frame embeddings, no embedding table)
             or ``{"tokens", "patch_embeds"}`` (``patch``: image patch
             embeddings ahead of the text); ``n_codebooks`` LM heads
  moe      - the transformer with every ``moe_every``-th layer's MLP a
             GShard-style mixture of experts (``models/moe.py``, with
             shared experts where configured): grok-1 in every layer,
             llama4 in every second
  griffin  - RecurrentGemma: groups of (rec, rec, local-attention) layers,
             plus the tail layers that do not fill a group (recurrent)
  xlstm    - groups of ``slstm_ratio - 1`` mLSTM blocks and one sLSTM
             block (``models/xlstm.py``)

Parameters are a nested dict of tensors with the reference's structure and
group-stacked leaves (``params["blocks"]["attn0"]["wq"]`` is (G, d, H*hd);
xlstm's mLSTM leaves are (G, m, ...); griffin's tail layers stack under
``params["tail"]``), so a reference tree carries over leaf by leaf
(``repro_torch.bridge``). The layer stack is a Python loop over the groups
and then the tail that passes the global index to every hook, as the
reference's scan does with ``arange(G)``: a group's sublayers share the
group's key ``fold_key(key, g)``, tail layer j runs at ``fold_key(key,
G*per + j)``. xlstm's mLSTM sites carry bare names (``mlstm_q``), so the
mLSTM blocks of a group draw one noise stream, as in the reference.

Every attention, recurrence and MLP matmul routes through a hook: digital
by default, or an ``AnalogHook`` carrying the group's energies and its row
of the forward's seed table (``seed_tables``: the whole (groups, sites,
requests) key chain is folded on the host, ``core.analog.site_seed_words``,
and copied to the card once per forward, or read from the caller's device
buffers, ``AnalogSpec.seeds``; the MoE expert sites' batch-level keys come
from ``core.analog.expert_seed_words``). The ``lm_head`` stays a digital
matmul (the transposed embedding under ``tie_embeddings``), except in the
analog train loss (``train_loss``), where it is a site of its own. Under a
``PrecisionProfile`` layer ``l`` runs its sites at its own K_l;
``energy_macs`` and ``profile_token_energy`` price that schedule.

Prefill writes every cache leaf, of a new cache or, reset first, of the
caller's (``hidden`` keeps none: the forward the calibration
differentiates); decode updates the cache in place (one KV slot per row,
the recurrent states whole) and returns it; ``scatter_cache_rows`` copies
prefilled rows into a decode pool's cache along each leaf's own batch dim,
from slot ids on the device. A served step so reads nothing from the host
and copies nothing to the device: a CUDA graph can hold it
(``serving/cache.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.analog import (
    AnalogConfig,
    expert_seed_words,
    fold_key,
    key_seed,
    site_key,
    site_seed_words,
)
from repro_torch.core.energy import apply_repeats, total_energy
from repro_torch.core.profile import PrecisionProfile
from repro_torch.device import resolve_device
from repro_torch.models import griffin as griffin_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.hooks import AnalogHook, MatmulHook, PrefixHook, hook_for_layer
from repro_torch.models.layers import (
    apply_rope,
    chunked_attention,
    chunked_xent,
    decode_attention,
    local_attention,
    mlp,
    rms_norm,
    rope_tables,
)
from repro_torch.models.sharding import Shards, tensor_parallel
from repro_torch.quant.weights import Int8Params, Int8Weight, dequantize_params, dequantize_weight
from repro_torch.tree import map_leaves

F32 = torch.float32
#: analog sites of a griffin tail layer (one recurrent layer, sublayer 0)
TAIL_SITES = ("rec0_rec_gate", "rec0_rec_in", "rec0_rec_a", "rec0_rec_i", "rec0_rec_out",
              "mlp0_gate", "mlp0_up", "mlp0_out")


@dataclasses.dataclass
class AnalogSpec:
    """Analog execution request for a forward pass.

    ``energies``: an ``init_energy_tree``-shaped tree. ``key``: one raw
    (2,) uint32 key or a stacked (B, 2) array, one stream per batch row.
    ``n_repeats``: the K-repeat dynamic-precision knob for every site.
    ``profile``: its per-layer form, a ``PrecisionProfile`` giving layer
    ``l`` its own K_l; it overrides ``n_repeats``, which must stay 1.
    ``rows_per_key``: with a stacked key of S rows over a batch of S * G
    rows, G; each key's G rows then run as one request (``AnalogHook``).
    ``noise_scale``: an optional 0-d float32 tensor, the drift factor on
    every site's noise std, served as energies ``E / d**2``: the forward
    divides the energy tree once (``drifted_energies``).
    ``seeds``: the forward's ``seed_tables`` already on the device (a
    captured step's static buffers, refilled before each replay); ``key``
    is then not read.
    """

    cfg: AnalogConfig
    energies: Dict[str, Any]
    key: Optional[np.ndarray]
    n_repeats: int = 1
    profile: Optional[PrecisionProfile] = None
    rows_per_key: int = 1
    noise_scale: Optional[torch.Tensor] = None
    seeds: Optional[Dict[str, torch.Tensor]] = None

    def __post_init__(self):
        if self.profile is not None and self.n_repeats != 1:
            raise ValueError(
                f"AnalogSpec carries both n_repeats={self.n_repeats} and profile "
                f"{self.profile.name!r}; a profile is the per-layer form of the same "
                "knob and overrides n_repeats, which must stay 1"
            )


# ===========================================================================
# parameters and energies
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A parameter's shape, its logical axis names (``models/sharding.py``
    maps them onto mesh axes) and its init scale."""

    shape: tuple
    axes: tuple
    scale: float = 1.0


def group_structure(cfg: ModelConfig):
    """(n_groups, layers_per_group) of the layer loop: one layer a group in
    the dense family, ``moe_every`` in moe (the MoE layer closes its group),
    ``griffin_pattern`` in griffin, ``slstm_ratio`` in xlstm."""
    if cfg.family == "griffin":
        return cfg.n_layers // len(cfg.griffin_pattern), len(cfg.griffin_pattern)
    per = {"moe": cfg.moe_every, "xlstm": cfg.slstm_ratio}.get(cfg.family, 1)
    return cfg.n_layers // per, per


def n_tail(cfg: ModelConfig) -> int:
    """Griffin layers after the last whole group (0 in the dense family)."""
    g, per = group_structure(cfg)
    return cfg.n_layers - g * per


def _attn_leaves(cfg: ModelConfig, lead: tuple, la: tuple) -> Dict[str, Leaf]:
    d, hd, qh, kh = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    s = d**-0.5
    leaves = {
        "wq": Leaf(lead + (d, qh * hd), la + (None, "heads"), s),
        "wk": Leaf(lead + (d, kh * hd), la + (None, "kv_heads"), s),
        "wv": Leaf(lead + (d, kh * hd), la + (None, "kv_heads"), s),
        "wo": Leaf(lead + (qh * hd, d), la + ("heads", None), (qh * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        leaves["bq"] = Leaf(lead + (qh * hd,), la + ("heads",), 0.0)
        leaves["bk"] = Leaf(lead + (kh * hd,), la + ("kv_heads",), 0.0)
        leaves["bv"] = Leaf(lead + (kh * hd,), la + ("kv_heads",), 0.0)
    return leaves


def _mlp_leaves(cfg: ModelConfig, lead: tuple, la: tuple) -> Dict[str, Leaf]:
    d, ff = cfg.d_model, cfg.d_ff
    s = d**-0.5
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": Leaf(lead + (d, ff), la + (None, "mlp"), s),
            "w_up": Leaf(lead + (d, ff), la + (None, "mlp"), s),
            "w_down": Leaf(lead + (ff, d), la + ("mlp", None), ff**-0.5),
        }
    return {
        "w_in": Leaf(lead + (d, ff), la + (None, "mlp"), s),
        "b_in": Leaf(lead + (ff,), la + ("mlp",), 0.0),
        "w_down": Leaf(lead + (ff, d), la + ("mlp", None), ff**-0.5),
        "b_out": Leaf(lead + (d,), la + (None,), 0.0),
    }


def _moe_leaves(cfg: ModelConfig, lead: tuple, la: tuple) -> Dict[str, Any]:
    d, e = cfg.d_model, cfg.n_experts * cfg.moe_ff_split
    ff = cfg.d_ff // cfg.moe_ff_split
    s = d**-0.5
    el, ea = lead + (e,), la + ("experts",)
    leaves: Dict[str, Any] = {"router": Leaf(lead + (d, cfg.n_experts), la + (None, None), s)}
    if cfg.mlp_type == "swiglu":
        leaves["w_gate"] = Leaf(el + (d, ff), ea + ("expert_embed", "expert_mlp"), s)
        leaves["w_up"] = Leaf(el + (d, ff), ea + ("expert_embed", "expert_mlp"), s)
    else:
        leaves["w_in"] = Leaf(el + (d, ff), ea + ("expert_embed", "expert_mlp"), s)
    leaves["w_down"] = Leaf(el + (ff, d), ea + ("expert_mlp", "expert_embed"), ff**-0.5)
    if cfg.n_shared_experts:
        leaves["shared"] = _mlp_leaves(cfg, lead, la)
    return leaves


def _mlstm_leaves(cfg: ModelConfig, lead: tuple, la: tuple) -> Dict[str, Leaf]:
    d, h = cfg.d_model, cfg.n_heads
    s = d**-0.5
    return {
        "w_z": Leaf(lead + (d, d), la + (None, "rnn"), s),
        "w_q": Leaf(lead + (d, d), la + (None, "rnn"), s),
        "w_k": Leaf(lead + (d, d), la + (None, "rnn"), s),
        "w_v": Leaf(lead + (d, d), la + (None, "rnn"), s),
        "w_o": Leaf(lead + (d, d), la + ("rnn", None), s),
        "w_gates": Leaf(lead + (d, 2 * h), la + (None, None), s),
        "b_gates": Leaf(lead + (2 * h,), la + (None,), 0.0),
        "norm": Leaf(lead + (d,), la + (None,), 0.0),
        "ln": Leaf(lead + (d,), la + (None,), 0.0),
    }


def _slstm_leaves(cfg: ModelConfig, lead: tuple, la: tuple) -> Dict[str, Leaf]:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    return {
        "w_x": Leaf(lead + (d, 4 * d), la + (None, "rnn"), d**-0.5),
        "b": Leaf(lead + (4 * d,), la + (None,), 0.0),
        "r": Leaf(lead + (4, h, hd, hd), la + (None, "heads", None, None), hd**-0.5),
        "w_o": Leaf(lead + (d, d), la + (None, None), d**-0.5),
        "ln": Leaf(lead + (d,), la + (None,), 0.0),
    }


def _rec_leaves(cfg: ModelConfig, lead: tuple, la: tuple) -> Dict[str, Leaf]:
    d, r, cw = cfg.d_model, cfg.rnn_width, cfg.conv_width
    return {
        "w_gate": Leaf(lead + (d, r), la + (None, "rnn"), d**-0.5),
        "w_x": Leaf(lead + (d, r), la + (None, "rnn"), d**-0.5),
        "w_a": Leaf(lead + (r, r), la + ("rnn", None), r**-0.5),
        "b_a": Leaf(lead + (r,), la + (None,), 0.0),
        "w_i": Leaf(lead + (r, r), la + ("rnn", None), r**-0.5),
        "b_i": Leaf(lead + (r,), la + (None,), 0.0),
        "lambda": Leaf(lead + (r,), la + (None,), 1.0),
        "conv_w": Leaf(lead + (cw, r), la + ("conv", "rnn"), cw**-0.5),
        "conv_b": Leaf(lead + (r,), la + ("rnn",), 0.0),
        "w_out": Leaf(lead + (r, d), la + ("rnn", None), r**-0.5),
    }


def _kinds(cfg: ModelConfig) -> tuple:
    """The attention-or-recurrence kind of each sublayer of a group with an
    attention/recurrence + MLP layout (xlstm's blocks have their own)."""
    if cfg.family == "griffin":
        return cfg.griffin_pattern
    return () if cfg.family == "xlstm" else ("attn",) * group_structure(cfg)[1]


def _is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    """Whether sublayer ``i`` of a group has the MoE block for its MLP."""
    return cfg.family == "moe" and i == cfg.moe_every - 1


def expert_sites(cfg: ModelConfig) -> list:
    """The expert-batched analog sites of a group (suffix (E * split,))."""
    return [s for s, suf in group_sites(cfg).items() if cfg.family == "moe" and suf]


def param_leaves(cfg: ModelConfig) -> Dict[str, Any]:
    """Shapes, logical axes and init scales of every parameter (``lm.py``
    reference)."""
    d, v = cfg.d_model, cfg.padded_vocab
    g, per = group_structure(cfg)
    lead, la = (g,), ("layers",)
    tree: Dict[str, Any] = {"final_ln": Leaf((d,), (None,), 0.0)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = Leaf((d, v * cfg.n_codebooks), (None, "vocab"), d**-0.5)
    if cfg.frontend != "frames":
        tree["embed"] = Leaf((v, d), ("vocab", None), 0.02)
    blocks: Dict[str, Any] = {}
    if cfg.family == "xlstm":
        blocks["mlstm"] = _mlstm_leaves(cfg, (g, per - 1), ("layers", "stack"))
        blocks["slstm"] = _slstm_leaves(cfg, lead, la)
    for i, kind in enumerate(_kinds(cfg)):
        blocks[f"ln1_{i}"] = Leaf(lead + (d,), la + (None,), 0.0)
        blocks[f"ln2_{i}"] = Leaf(lead + (d,), la + (None,), 0.0)
        if kind == "rec":
            blocks[f"rec{i}"] = _rec_leaves(cfg, lead, la)
        else:
            blocks[f"attn{i}"] = _attn_leaves(cfg, lead, la)
        if _is_moe_layer(cfg, i):
            blocks["moe"] = _moe_leaves(cfg, lead, la)
        else:
            blocks[f"mlp{i}"] = _mlp_leaves(cfg, lead, la)
    tail = n_tail(cfg)
    if tail:
        tl, tla = (tail,), ("layers",)
        tree["tail"] = {
            "ln1": Leaf(tl + (d,), tla + (None,), 0.0),
            "ln2": Leaf(tl + (d,), tla + (None,), 0.0),
            "rec": _rec_leaves(cfg, tl, tla),
            "mlp": _mlp_leaves(cfg, tl, tla),
        }
    tree["blocks"] = blocks
    return tree


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axis names of every parameter (the reference's
    ``param_axes``): a tree of tuples, one name (or None) a dim."""
    return map_leaves(lambda _p, leaf: leaf.axes, param_leaves(cfg))


#: the parameter subtrees whose leaves stack one entry a layer group (or a
#: griffin tail layer) on their leading axis
STACKED = ("blocks", "tail")
#: the MoE block's expert-batched leaves: (G, E * split, ...)
EXPERT_LEAVES = ("w_gate", "w_up", "w_in", "w_down")


def stacked_axes(path: tuple) -> int:
    """How many leading axes of the parameter at ``path`` index layers the
    forward takes one at a time: 2 for an mLSTM leaf (group, block) and an
    expert leaf (group, expert), 1 for another stacked leaf, 0 else."""
    if path[0] not in STACKED:
        return 0
    if path[1] == "mlstm" or (path[1] == "moe" and len(path) == 3 and path[2] in EXPERT_LEAVES):
        return 2
    return 1


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random weights at the reference's shapes and scales, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``. Stacked
    leaves are drawn one layer (or expert) at a time: bounded float32
    scratch."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = cfg.compute_dtype

    def make(path, leaf: Leaf):
        out = torch.zeros(leaf.shape, dtype=dtype, device=dev)
        if leaf.scale == 0.0:
            return out
        # a stacked leaf a layer at a time, and an expert (or mLSTM block)
        # at a time where it has one more stacked dim
        parts = out if path[0] in STACKED else out[None]
        if len(leaf.shape) >= 4:
            parts = parts.flatten(0, 1)
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=gen, device=dev, dtype=F32) * leaf.scale)
        return out

    return map_leaves(make, param_leaves(cfg))


def _mlp_sites(cfg: ModelConfig) -> tuple:
    """Site suffixes of one MLP: its names are hashed into the noise streams."""
    return ("gate", "up", "out") if cfg.mlp_type == "swiglu" else ("in", "out")


def group_sites(cfg: ModelConfig) -> Dict[str, tuple]:
    """Analog matmul sites of one layer group -> energy leaf suffix: ()
    for a site run once a group, (m,) for xlstm's mLSTM sites (each of the
    group's m blocks), (E * split,) for an expert-batched MoE site."""
    sites: Dict[str, tuple] = {}
    if cfg.family == "xlstm":
        m = group_structure(cfg)[1] - 1
        for s in ("mlstm_z", "mlstm_q", "mlstm_k", "mlstm_v", "mlstm_o"):
            sites[s] = (m,)
        return {**sites, "slstm_wx": (), "slstm_o": ()}
    for i, kind in enumerate(_kinds(cfg)):
        if kind == "rec":
            for s in ("rec_gate", "rec_in", "rec_a", "rec_i", "rec_out"):
                sites[f"rec{i}_{s}"] = ()
        else:
            for s in ("q", "k", "v", "o"):
                sites[f"attn{i}_{s}"] = ()
        if _is_moe_layer(cfg, i):
            sites["router"] = ()
            experts = ("gate", "up", "down") if cfg.mlp_type == "swiglu" else ("in", "down")
            for s in experts:
                sites[f"moe_{s}"] = (cfg.n_experts * cfg.moe_ff_split,)
            if cfg.n_shared_experts:
                for s in ("moe_shared_gate", "moe_shared_up", "moe_shared_out"):
                    sites[s] = ()
        else:
            for s in _mlp_sites(cfg):
                sites[f"mlp{i}_{s}"] = ()
    return sites


def init_energy_tree(cfg: ModelConfig, e0: float, device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    g, _ = group_structure(cfg)
    tree = {
        "groups": {
            s: torch.full((g,) + suf, float(e0), dtype=F32, device=dev)
            for s, suf in group_sites(cfg).items()
        },
        "lm_head": torch.tensor(float(e0), dtype=F32, device=dev),
    }
    tail = n_tail(cfg)
    if tail:
        tree["tail"] = {s: torch.full((tail,), float(e0), dtype=F32, device=dev)
                        for s in TAIL_SITES}
    return tree


def _site_macs(cfg: ModelConfig, site: str, t: int) -> float:
    """Per-example MACs of one site over ``t`` tokens (the reference's name
    rules, in its order: a later rule overrides an earlier one). An expert
    site counts its expected load, ``t * top_k / E`` tokens, and a virtual
    expert (``moe_ff_split``) the whole expert's ``d * d_ff``, as the
    reference writes it."""
    d, ff, hd, r = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.rnn_width or cfg.d_model
    e = cfg.n_experts
    base = None
    if "_q" in site or site.endswith("_o"):
        base = t * d * cfg.n_heads * hd
    if "_k" in site or "_v" in site:
        base = t * d * cfg.n_kv_heads * hd
    if "mlp" in site or "shared" in site:
        base = t * d * ff
    if site == "router":
        base = t * d * e
    if site.startswith("moe_") and "shared" not in site:
        base = (t * cfg.top_k / e) * d * ff
    if "rec_gate" in site or "rec_in" in site:
        base = t * d * r
    if "rec_a" in site or "rec_i" in site:
        base = t * r * r
    if "rec_out" in site:
        base = t * r * d
    if site.startswith("mlstm"):
        base = t * d * d
    if site == "slstm_wx":
        base = t * d * 4 * d
    if site == "slstm_o":
        base = t * d * d
    assert base is not None, site
    return base


def energy_macs(cfg: ModelConfig, seq_len: int) -> Dict[str, Any]:
    """Per-example MAC counts in ``init_energy_tree``'s structure (float32,
    on the CPU): ``seq_len`` tokens through every analog site of every
    layer, and the lm_head. ``E_tot = sum E * macs`` (``core.energy``)."""
    g, _ = group_structure(cfg)
    t = seq_len
    tree = {
        "groups": {s: torch.full((g,) + suf, float(_site_macs(cfg, s, t)), dtype=F32)
                   for s, suf in group_sites(cfg).items()},
        "lm_head": torch.tensor(float(t * cfg.d_model * cfg.vocab_size * cfg.n_codebooks),
                                dtype=F32),
    }
    tail = n_tail(cfg)
    if tail:
        tree["tail"] = {s: torch.full((tail,), float(_site_macs(cfg, s, t)), dtype=F32)
                        for s in TAIL_SITES}
    return tree


# ===========================================================================
# precision profiles (paper §V-VI: per-layer K on the layer stack)
# ===========================================================================


def group_site_subs(cfg: ModelConfig) -> Dict[str, object]:
    """Analog site -> its sublayer within one layer group: the index in the
    site's prefix (``attn{i}_*``, ``mlp{i}_*``, ``rec{i}_*``); the last
    sublayer for the MoE sites (the MoE layer closes its group) and for
    xlstm's sLSTM sites; ``"stack"`` for the mLSTM sites, whose (m,) energy
    leaves carry their blocks' own dim."""
    _, per = group_structure(cfg)
    subs: Dict[str, object] = {}
    for site in group_sites(cfg):
        if cfg.family == "xlstm":
            subs[site] = "stack" if site.startswith("mlstm") else per - 1
        elif site == "router" or site.startswith("moe_"):
            subs[site] = per - 1
        else:
            subs[site] = int("".join(c for c in site.split("_")[0] if c.isdigit()))
    return subs


def profile_rows(cfg: ModelConfig, profile: PrecisionProfile):
    """Validate a profile against the model and split it onto the layer
    groups: ``(rows, tail_ks)``, ``rows[g]`` the K-tuple of group ``g``'s
    sublayers, ``tail_ks`` the Ks of griffin's tail layers (empty
    otherwise). ``profile.repeats[l]`` belongs to model layer ``l``."""
    if profile.n_layers != cfg.n_layers:
        raise ValueError(
            f"profile {profile.name!r} has {profile.n_layers} layers but "
            f"model {cfg.name!r} has {cfg.n_layers}"
        )
    g, per = group_structure(cfg)
    reps = profile.repeats
    return [tuple(reps[i * per:(i + 1) * per]) for i in range(g)], list(reps[g * per:])


def profile_repeat_tree(cfg: ModelConfig, profile: PrecisionProfile) -> Dict[str, Any]:
    """Per-site repeat factors in ``init_energy_tree``'s structure: each
    site's leaf carries its sublayer's K along the group dim (an mLSTM
    site's (G, m) leaf each block's K); the lm_head
    (a digital matmul) stays at 1. With ``core.energy.apply_repeats`` it
    gives the served energy ``sum_l K_l * E_l * MACs_l``."""
    rows, tail_ks = profile_rows(cfg, profile)
    g, per = group_structure(cfg)
    ks = torch.tensor(rows, dtype=F32).reshape(g, per)
    subs = group_site_subs(cfg)
    tree = {
        "groups": {s: ks[:, : per - 1] if subs[s] == "stack"
                   else ks[:, subs[s]].reshape((g,) + (1,) * len(suf))
                   for s, suf in group_sites(cfg).items()},
        "lm_head": torch.tensor(1.0, dtype=F32),
    }
    if tail_ks:
        tree["tail"] = {s: torch.tensor(tail_ks, dtype=F32) for s in TAIL_SITES}
    return tree


def profile_token_energy(cfg: ModelConfig, energies, profile: PrecisionProfile) -> float:
    """Serving energy per generated token, ``sum_l K_l * E_l * MACs_l``
    over the analog sites plus the lm_head at K=1 (decode: one token)."""
    scaled = apply_repeats(energies, profile_repeat_tree(cfg, profile))
    return float(total_energy(scaled, energy_macs(cfg, 1)))


# ===========================================================================
# caches
# ===========================================================================


def _window(cfg: ModelConfig) -> Optional[int]:
    """The attention window of the family (None: global attention)."""
    return cfg.local_window if cfg.family == "griffin" else cfg.sliding_window


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device="cuda", dtype=None):
    """The decode state of ``batch`` rows at ``cache_len`` positions.

    dense and moe: ``{"groups": {"k", "v"}}``, each (G, per, B, S, KH, hd)
    with S = ``min(cache_len, sliding_window)``. griffin: per sublayer
    ``i`` of a group ``h{i}`` (G, B, R) f32 and ``conv{i}`` (G, B, cw-1, R)
    for a recurrent one, ``k{i}``/``v{i}`` (G, B, S, KH, hd), S =
    ``min(cache_len, local_window)``, for attention; the tail's ``h0`` and
    ``conv0`` under ``"tail"`` with the tail layers leading. xlstm (f32,
    constant in ``cache_len``): the mLSTM states ``C`` (G, m, B, H, hd,
    hd), ``n`` (G, m, B, H, hd), ``m`` (G, m, B, H) and the sLSTM states
    ``sc``, ``sn``, ``sh``, ``sm`` (G, B, d); ``m`` and ``sm`` start at
    -1e30.
    """
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    g, per = group_structure(cfg)
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    w = _window(cfg)
    s = cache_len if w is None else min(cache_len, w)
    zeros = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    if cfg.family in ("dense", "moe"):
        shape = (g, per, batch, s, kh, hd)
        return {"groups": {"k": zeros(shape), "v": zeros(shape)}}
    if cfg.family == "xlstm":
        m, d, h = per - 1, cfg.d_model, cfg.n_heads
        hd_m = d // h
        full = lambda shape: torch.full(shape, xlstm_lib.NEG, dtype=F32, device=dev)
        return {"groups": {
            "C": zeros((g, m, batch, h, hd_m, hd_m), F32), "n": zeros((g, m, batch, h, hd_m), F32),
            "m": full((g, m, batch, h)), "sc": zeros((g, batch, d), F32),
            "sn": zeros((g, batch, d), F32), "sh": zeros((g, batch, d), F32),
            "sm": full((g, batch, d))}}
    r, cw = cfg.rnn_width, cfg.conv_width
    groups = {}
    for i, kind in enumerate(cfg.griffin_pattern):
        if kind == "rec":
            groups[f"h{i}"] = zeros((g, batch, r), F32)
            groups[f"conv{i}"] = zeros((g, batch, cw - 1, r))
        else:
            groups[f"k{i}"] = zeros((g, batch, s, kh, hd))
            groups[f"v{i}"] = zeros((g, batch, s, kh, hd))
    cache = {"groups": groups}
    tail = n_tail(cfg)
    if tail:
        cache["tail"] = {"h0": zeros((tail, batch, r), F32),
                         "conv0": zeros((tail, batch, cw - 1, r))}
    return cache


def reset_cache(cfg: ModelConfig, cache) -> Dict[str, Any]:
    """Fill ``cache`` in place with ``init_cache``'s values (zeros; xlstm's
    ``m`` and ``sm`` -1e30), so a prefill into it is a prefill into a new
    cache. Returns ``cache``."""
    map_leaves(lambda path, t: t.fill_(xlstm_lib.NEG) if cfg.family == "xlstm"
               and path[-1] in ("m", "sm") else t.zero_(), cache)
    return cache


def cache_batch_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The batch dim of every leaf of ``init_cache``'s tree (the "batch"
    entry of the reference's ``cache_axes``): 2 under the leading (G, per)
    or (G, m) dims, 1 under G alone."""
    return map_leaves(
        lambda path, _l: 2 if cfg.family in ("dense", "moe") or path[-1] in ("C", "n", "m") else 1,
        init_cache(cfg, 1, 1, device="meta"))


def scatter_cache_rows(cfg: ModelConfig, dst, src, slot_ids) -> Dict[str, Any]:
    """Copy the rows of a freshly prefilled cache ``src`` (batch b) into
    the decode pool's cache ``dst`` (batch ``slots``) at ``slot_ids`` (b,),
    in place along each leaf's batch dim (``cache_batch_axes``). Both share
    the pool's cache length. Ids outside ``[0, slots)`` are dropped, as the
    reference's ``mode="drop"`` drops them: the engine aims prefill
    batch-padding rows at ``slots``. Returns ``dst``.

    ``slot_ids``: host ints, or an int64 tensor on ``dst``'s device (a
    captured insert's static buffer). Every slot takes the value of the row
    aimed at it, or keeps its own: a device-side select of the whole leaf,
    no host read of the ids."""
    axes = cache_batch_axes(cfg)
    leaves = []
    map_leaves(lambda _p, d, axis: leaves.append(d.shape[axis]) or d, dst, axes)
    dev = next(iter(dst["groups"].values())).device
    slots = leaves[0]
    ids = (slot_ids if torch.is_tensor(slot_ids)
           else torch.from_numpy(np.asarray(slot_ids, np.int64))).to(dev).reshape(-1)
    b = ids.shape[0]
    # which row lands in each slot: b for none; ids outside the pool (the
    # padding rows) write the extra entry ``slots``, which is dropped
    aim = torch.where((ids >= 0) & (ids < slots), ids, torch.full_like(ids, slots))
    row_of = torch.full((slots + 1,), b, dtype=torch.int64, device=dev)
    row_of.scatter_(0, aim, torch.arange(b, dtype=torch.int64, device=dev))
    row_of = row_of[:slots]
    hit = row_of < b
    src_row = torch.clamp(row_of, max=b - 1)

    def scatter(_path, d, s, axis):
        shape = [1] * d.dim()
        shape[axis] = slots
        d.copy_(torch.where(hit.reshape(shape), s.index_select(axis, src_row).to(d.dtype), d))

    map_leaves(scatter, dst, src, axes)
    return dst


def _cache_store(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """Write each row's one-token KV slab (B, 1, KH, hd) at its own slot, in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot] = new[:, 0].to(cache.dtype)


def _ring_fill(dst: torch.Tensor, kv: torch.Tensor, window: int, lengths) -> None:
    """Write a prompt's keys or values (B, T, KH, hd) into a ring cache
    ``dst`` (B, ring, KH, hd) in place: slot s holds the row's latest real
    position p with ``p % window == s`` (a ring shorter than the window is
    linear, slot == position). Slots whose position is negative (a row
    shorter than the window) are zero and stay masked at decode."""
    b, t = kv.shape[:2]
    ring = dst.shape[1]
    dev = kv.device
    if lengths is not None:
        lens = lengths.to(dev).long()[:, None]
        slots = torch.arange(ring, device=dev)[None, :]
        if ring == window:
            start = lens - window
            p_abs = start + torch.remainder(slots - start, window)  # (B, ring)
        else:  # ring == cache_len > t: linear layout, slot == pos
            p_abs = slots.expand(b, ring)
        p_abs = torch.where(p_abs < lens, p_abs, torch.full_like(p_abs, -1))
        idx = torch.clamp(p_abs, 0, t - 1)[..., None, None].expand(b, ring, *kv.shape[2:])
        got = torch.gather(kv, 1, idx)
        dst.copy_(torch.where((p_abs >= 0)[..., None, None], got, torch.zeros_like(got)))
    elif t >= ring:
        dst.copy_(torch.roll(kv[:, -ring:], t % ring, dims=1))
    else:
        dst.zero_()
        dst[:, :t] = kv.to(dst.dtype)


# ===========================================================================
# forward
# ===========================================================================


def _shard_kv(k, v, cfg: ModelConfig, shard, qh: int):
    """The kv heads (B, T, KH, hd) that tensor shard ``shard``'s ``qh``
    query heads read, where every shard holds them all: grouped as the
    whole attention groups them where its heads cover whole groups or lie
    in one, else one kv head a query head."""
    q_per_kv = cfg.n_heads // cfg.n_kv_heads
    ids = [(shard.t * qh + i) // q_per_kv for i in range(qh)]
    lo, hi = ids[0], ids[-1] + 1
    if qh % (hi - lo) == 0 and ids == [lo + i // (qh // (hi - lo)) for i in range(qh)]:
        return k[:, :, lo:hi], v[:, :, lo:hi]
    return k[:, :, ids], v[:, :, ids]


def _attn_sublayer(x, p, cfg: ModelConfig, hook: MatmulHook, prefix: str, **kw):
    """Attention; with its weights cut among tensor shards (``Shards``: wq,
    bq by whole heads, wk, wv, bk, bv by whole kv heads or whole, wo by
    rows) a Megatron block (``sharding.tensor_parallel``)."""
    return tensor_parallel(functools.partial(_attention, cfg=cfg, hook=hook, prefix=prefix, **kw),
                           x, p)


def _attention(x, p, shard, *, cfg: ModelConfig, hook: MatmulHook, prefix: str, rope, mode,
               cache, pos=None, window=None, lengths=None):
    """The attention of the query heads ``p`` holds (every head, or tensor
    shard ``shard``'s), its output projected by ``p["wo"]``."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    cos, sin = rope
    q = hook(f"{prefix}_q", x, p["wq"])
    k = hook(f"{prefix}_k", x, p["wk"])
    v = hook(f"{prefix}_v", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    qh, kh = q.shape[-1] // hd, k.shape[-1] // hd
    q, k, v = q.reshape(b, t, qh, hd), k.reshape(b, t, kh, hd), v.reshape(b, t, kh, hd)
    if shard is not None and kh == cfg.n_kv_heads and qh < cfg.n_heads:
        k, v = _shard_kv(k, v, cfg, shard, qh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if mode == "decode":
        k_cache, v_cache = cache
        if window is None:
            _cache_store(k_cache, k, pos)
            _cache_store(v_cache, v, pos)
            out = decode_attention(q, k_cache, v_cache, pos)
        else:
            s_len = k_cache.shape[1]
            slot = pos % window
            _cache_store(k_cache, k, slot)
            _cache_store(v_cache, v, slot)
            base = torch.arange(s_len, device=x.device)[None, :]
            off = (pos - slot)[:, None]
            slot_pos = torch.where(base <= slot[:, None], off + base, off - s_len + base)
            out = decode_attention(q, k_cache, v_cache, pos, slot_pos=slot_pos, window=window)
    else:
        if window is None:
            out = chunked_attention(q, k, v, q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
        else:
            out = local_attention(q, k, v, window=window)
        if cache is not None:
            k_cache, v_cache = cache
            if window is None:
                k_cache[:, :t] = k.to(k_cache.dtype)
                v_cache[:, :t] = v.to(v_cache.dtype)
            else:
                _ring_fill(k_cache, k.to(k_cache.dtype), window, lengths)
                _ring_fill(v_cache, v.to(v_cache.dtype), window, lengths)
    return hook(f"{prefix}_o", out.reshape(b, t, qh * hd), p["wo"])


def _sublayer(x, cfg: ModelConfig, hook, i: int, kind: str, ln1, ln2, mix_p, ffn, *, rope,
              mode, cache, pos, pad_mask, lengths):
    """One layer: norm, temporal mix (attention or the recurrent block),
    residual, norm, ``ffn`` (the MLP or the MoE block: h -> y), residual.
    ``cache``: the layer's (k, v) views, or its (h, conv) state views for
    a recurrent layer, updated in place; None in a prefill that keeps no
    cache."""
    h = rms_norm(x, ln1, cfg.norm_eps)
    if kind == "rec":
        rec_hook = PrefixHook(hook, f"rec{i}_")
        if mode == "decode":
            y, h_new, cs_new = griffin_lib.recurrent_decode(h, mix_p, rec_hook, *cache)
        else:
            y, h_new, cs_new = griffin_lib.recurrent_mix(h, mix_p, rec_hook, pad_mask=pad_mask,
                                                         lengths=lengths)
        if cache is not None:
            h_state, conv_state = cache
            h_state.copy_(h_new)
            conv_state.copy_(cs_new)
    else:
        y = _attn_sublayer(h, mix_p, cfg, hook, f"attn{i}", rope=rope, mode=mode, cache=cache,
                           pos=pos, window=_window(cfg), lengths=lengths)
    x = x + y
    return x + ffn(rms_norm(x, ln2, cfg.norm_eps))


def _xlstm_group(x, gp, cfg: ModelConfig, hooks, *, mode, cache, pad_mask, remat=False):
    """One xlstm group: ``m`` mLSTM blocks, then the sLSTM block, each a
    pre-norm residual. ``hooks[j]``: block j's hook. ``cache``: the
    group's state views (``C``, ``n``, ``m`` with the blocks leading, the
    sLSTM's ``sc``, ``sn``, ``sh``, ``sm``), read in decode and written in
    place; None in a prefill that keeps no cache. ``remat`` (training):
    each mLSTM block is recomputed in the backward on its own, as the
    reference's ``mlstm_one`` is, so the group's recompute keeps one
    block's chunk-scan residuals alive at a time."""
    m = group_structure(cfg)[1] - 1
    decode = mode == "decode"

    def mlstm_one(x, j, views):
        pj = {k: v[j] for k, v in gp["mlstm"].items()}
        y, st = xlstm_lib.mlstm_block(
            rms_norm(x, pj["ln"], cfg.norm_eps), pj, hooks[j], n_heads=cfg.n_heads,
            chunk=min(cfg.attn_kv_chunk, 512), state=views if decode else None, decode=decode,
            pad_mask=pad_mask)
        return x + y, st

    for j in range(m):
        views = None if cache is None else (cache["C"][j], cache["n"][j], cache["m"][j])
        if remat:
            x, st = torch.utils.checkpoint.checkpoint(mlstm_one, x, j, views,
                                                      use_reentrant=False)
        else:
            x, st = mlstm_one(x, j, views)
        for view, new in zip(views or (), st):
            view.copy_(new)
    views = None if cache is None else tuple(cache[k] for k in ("sc", "sn", "sh", "sm"))
    y, st = xlstm_lib.slstm_block(
        rms_norm(x, gp["slstm"]["ln"], cfg.norm_eps), gp["slstm"], hooks[m], n_heads=cfg.n_heads,
        state=views if decode else None, pad_mask=pad_mask)
    for view, new in zip(views or (), st):
        view.copy_(new)
    return x + y


def _moe(x, p, cfg: ModelConfig, hook, pad_mask):
    """The MoE block; with stacked noise samples (``rows_per_key`` > 1)
    each sample's rows are routed as that batch alone under its own key,
    as the reference runs a sample (capacity buffers never mix samples)."""
    r = getattr(hook, "rows_per_key", 1)
    if r == 1:
        return moe_lib.moe_block(x, p, cfg, hook, pad_mask=pad_mask)
    return torch.cat([
        moe_lib.moe_block(x[i * r:(i + 1) * r], p, cfg, hook.sample(i),
                          pad_mask=None if pad_mask is None else pad_mask[i * r:(i + 1) * r])
        for i in range(x.shape[0] // r)])


def _layer_ks(cfg: ModelConfig, analog: AnalogSpec):
    """(rows, tail_ks): each group's per-sublayer K and the tail's."""
    if analog.profile is not None:
        return profile_rows(cfg, analog.profile)
    g, per = group_structure(cfg)
    return [(analog.n_repeats,) * per] * g, [analog.n_repeats] * n_tail(cfg)


def seed_tables(cfg: ModelConfig, key, valid=None, rows_per_key: int = 1
                ) -> Dict[str, np.ndarray]:
    """The seed words of every analog site of one forward, on the host:
    ``"groups"`` (G, S, [B,] 4) over ``group_sites``, ``"tail"`` (tail, 8,
    [B,] 4) for griffin's tail layers and ``"experts"`` (G, S_e, E·split,
    4), or (G, S_e, S, E·split, 4) for stacked noise samples
    (``rows_per_key`` > 1), for MoE's expert sites. The global group index
    keys the noise: a profile's layer l draws the stream of the uniform
    path's layer l. ``valid`` (B,) bool: the rows the expert sites' batch
    key folds in (False: batch padding)."""
    g, per = group_structure(cfg)
    tail = n_tail(cfg)
    out = {"groups": site_seed_words(key, g, list(group_sites(cfg)))}
    if tail:
        out["tail"] = site_seed_words(key, [g * per + j for j in range(tail)], TAIL_SITES)
    if expert_sites(cfg):
        n_e = cfg.n_experts * cfg.moe_ff_split
        if rows_per_key > 1:  # one stream a noise sample
            out["experts"] = np.stack([expert_seed_words(k, g, expert_sites(cfg), n_e, None)
                                       for k in key], axis=2)
        else:
            out["experts"] = expert_seed_words(key, g, expert_sites(cfg), n_e, valid)
    return out


def drifted_energies(energies, noise_scale: torch.Tensor):
    """The energy tree that serves a noise std drifted by ``noise_scale``
    ``d`` (a 0-d float32 tensor): every leaf ``E / (d * d)``, elementwise in
    float32 and so the bits of ``AnalogHook``'s per-site division, exact at
    ``d = 1``. One division a leaf, once a forward."""
    d2 = noise_scale * noise_scale
    return map_leaves(lambda _p, e: e / d2, energies)


def _run_stack(params, h, cfg: ModelConfig, *, mode, cache, pos, positions,
               analog: Optional[AnalogSpec], lengths=None, hook: Optional[MatmulHook] = None,
               remat: bool = False):
    """The layer groups, then griffin's tail layers.

    ``remat``: each layer group runs under ``torch.utils.checkpoint``
    (non-reentrant), its activations recomputed in the backward, as the
    reference's train-mode scan body is (``cfg.remat``); inside a group,
    as in the reference, each griffin sublayer and each xlstm mLSTM block
    is checkpointed again. Griffin's tail layers run outside both.

    ``hook``: the matmul hook of a digital forward (``analog`` None),
    ``MatmulHook`` by default; the serving tiers pass their own. A tree of
    ``quantize_params`` is dequantized one layer slice at a time.

    ``lengths`` (B,): per-row true lengths. In prefill, positions past a
    row's length are padding; in decode, a row of length 0 is batch
    padding: xlstm pins its gates (its state stays as it was) and MoE
    leaves its token out of expert capacity, and in both modes the MoE
    expert sites fold the rows of length 0 out of their batch-level key.
    Seeds made here from ``analog.key`` read that fold from ``lengths`` on
    the host (a card tensor is copied back once); ``analog.seeds`` carry it
    already."""
    g, per = group_structure(cfg)
    tail = n_tail(cfg)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    pad_mask = None
    seeds = None if analog is None else analog.seeds
    if analog is not None and seeds is None:
        valid = None
        if lengths is not None and cfg.family == "moe":
            valid = lengths.cpu().numpy() > 0
        # the "torch" backend seeds its generators from host words: its
        # tables stay on the CPU
        dev = "cpu" if analog.cfg.backend == "torch" else h.device
        # non-blocking: a blocking copy would wait for every queued kernel
        seeds = {k: torch.from_numpy(v).to(dev, non_blocking=True) for k, v in
                 seed_tables(cfg, analog.key, valid, analog.rows_per_key).items()}
    if lengths is not None:
        lengths = lengths.to(h.device, non_blocking=True).long()
        if mode == "decode":
            pad_mask = (lengths == 0)[:, None]
        else:
            pad_mask = torch.arange(h.shape[1], device=h.device)[None, :] >= lengths[:, None]
    sites = list(group_sites(cfg))
    table = tail_table = experts = None
    rows, tail_ks = [(1,) * per] * g, [1] * tail
    if analog is not None:
        table, tail_table, experts = seeds["groups"], seeds.get("tail"), seeds.get("experts")
        rows, tail_ks = _layer_ks(cfg, analog)
        energy_tree = (analog.energies if analog.noise_scale is None
                       else drifted_energies(analog.energies, analog.noise_scale))

    def hooks(sub, idx, names, seeds, ks):
        """One hook per layer of a group (``sub`` "groups") or a tail layer;
        xlstm's block j takes entry j of the mLSTM sites' (m,) energies."""
        if analog is None:
            return [hook or MatmulHook()] * len(ks)
        energies = {s: energy_tree[sub][s][idx] for s in names}
        row = {s: seeds[idx, i] for i, s in enumerate(names)}
        ex = None if sub != "groups" or experts is None else {
            s: experts[idx, i] for i, s in enumerate(expert_sites(cfg))}
        out = []
        for j, k in enumerate(ks):
            e_j = energies
            if cfg.family == "xlstm" and j < len(ks) - 1:
                e_j = {s: e[j] if s.startswith("mlstm") else e for s, e in energies.items()}
            out.append(hook_for_layer(analog.cfg, e_j, row, n_repeats=k,
                                      rows_per_key=analog.rows_per_key, expert_seeds=ex))
        return out

    # the reference's per-sublayer remat of a griffin group (more than one
    # sublayer): without it the group's recompute keeps every sublayer's
    # scan levels alive in the backward
    sub_remat = remat and cfg.family == "griffin" and len(cfg.griffin_pattern) > 1
    # int8 serving: the int8 tree stays resident, each bf16 layer is transient
    deq = dequantize_params if isinstance(params, Int8Params) else (lambda tree: tree)
    gcache = None if cache is None else cache["groups"]

    def group(h, gi):
        gp = deq(map_leaves(lambda _p, a: a[gi], params["blocks"]))
        layer_hooks = hooks("groups", gi, sites, table, rows[gi])
        if cfg.family == "xlstm":
            lc = None if gcache is None else {k: v[gi] for k, v in gcache.items()}
            return _xlstm_group(h, gp, cfg, layer_hooks, mode=mode, cache=lc, pad_mask=pad_mask,
                                remat=remat)
        for i, kind in enumerate(_kinds(cfg)):
            hook = layer_hooks[i]
            if gcache is None:
                lc = None
            elif cfg.family in ("dense", "moe"):
                lc = (gcache["k"][gi, i], gcache["v"][gi, i])
            elif kind == "rec":
                lc = (gcache[f"h{i}"][gi], gcache[f"conv{i}"][gi])
            else:
                lc = (gcache[f"k{i}"][gi], gcache[f"v{i}"][gi])
            if _is_moe_layer(cfg, i):
                ffn = lambda y, hook=hook: _moe(y, gp["moe"], cfg, hook, pad_mask)
            else:
                ffn = lambda y, hook=hook, i=i: mlp(y, gp[f"mlp{i}"], hook, prefix=f"mlp{i}",
                                                    mlp_type=cfg.mlp_type)
            mix = gp[f"rec{i}"] if kind == "rec" else gp[f"attn{i}"]
            sub = functools.partial(_sublayer, cfg=cfg, hook=hook, i=i, kind=kind,
                                    ln1=gp[f"ln1_{i}"], ln2=gp[f"ln2_{i}"], mix_p=mix, ffn=ffn,
                                    rope=rope, mode=mode, cache=lc, pos=pos, pad_mask=pad_mask,
                                    lengths=lengths)
            if sub_remat:  # griffin: each sublayer recomputed on its own
                h = torch.utils.checkpoint.checkpoint(sub, h, use_reentrant=False)
            else:
                h = sub(h)
        return h

    for gi in range(g):
        if remat:  # the group's activations are recomputed in the backward
            h = torch.utils.checkpoint.checkpoint(group, h, gi, use_reentrant=False)
        else:
            h = group(h, gi)
    for j in range(tail):
        tp = deq(map_leaves(lambda _p, a: a[j], params["tail"]))
        (hook,) = hooks("tail", j, TAIL_SITES, tail_table, (tail_ks[j],))
        lc = None if cache is None else (cache["tail"]["h0"][j], cache["tail"]["conv0"][j])
        ffn = lambda y, hook=hook, tp=tp: mlp(y, tp["mlp"], hook, prefix="mlp0",
                                              mlp_type=cfg.mlp_type)
        h = _sublayer(h, cfg, hook, 0, "rec", tp["ln1"], tp["ln2"], tp["rec"], ffn,
                      rope=rope, mode=mode, cache=lc, pos=pos, pad_mask=pad_mask,
                      lengths=lengths)
    return h


def _as_batch(batch) -> Dict[str, torch.Tensor]:
    """A batch dict; a bare (B, T) tensor is ``{"tokens": tensor}``."""
    return batch if isinstance(batch, dict) else {"tokens": batch}


def _embed_inputs(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Token or frontend embedding -> h (B, T, d): ``frames`` takes
    ``embeds`` as they are, ``patch`` puts ``patch_embeds`` ahead of the
    embedded ``tokens``."""
    batch = _as_batch(batch)
    if cfg.frontend == "frames":
        return batch["embeds"].to(cfg.compute_dtype)
    h = _lookup(params["embed"], batch["tokens"]).to(cfg.compute_dtype)
    if cfg.frontend == "patch":
        h = torch.cat([batch["patch_embeds"].to(cfg.compute_dtype), h], dim=1)
    return h


def _lookup(embed, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``; an embedding whose vocabulary rows are cut among
    the tensor shards (``Shards``) is looked up vocab-parallel: each shard
    zeroes the tokens outside its rows, then *g* sums the shards'."""
    if not isinstance(embed, Shards):
        return embed[tokens]
    from repro_torch.launch import collectives

    shards = embed.shards
    parts = []
    for e, s in zip(embed, shards):
        rows = e.shape[0]
        at = tokens.long() - s.t * rows
        hit = (at >= 0) & (at < rows)
        parts.append(torch.where(hit[..., None], e[torch.clamp(at, 0, rows - 1)],
                                 torch.zeros((), dtype=e.dtype, device=e.device)))
    return collectives.reduce_from_tp(parts, shards)


def forward_hidden(params, h, cfg: ModelConfig, *, cache=None, analog=None, lengths=None,
                   hook=None, remat: bool = False):
    """Prefill trunk: embedded inputs h (B, T, d) (``_embed_inputs``) ->
    normed hidden (B, T, d); writes every leaf of ``cache``, or keeps no
    cache when it is None (the reference's ``mode="train"`` forward, which
    calibration and the train loss differentiate). ``hook``: a digital
    forward's matmul hook; ``remat``: as in ``_run_stack``."""
    positions = torch.arange(h.shape[1], device=h.device)
    h = _run_stack(params, h, cfg, mode="prefill", cache=cache, pos=None,
                   positions=positions, analog=analog, lengths=lengths, hook=hook, remat=remat)
    return rms_norm(h, params["final_ln"], cfg.norm_eps)


def hidden(params, batch, cfg: ModelConfig, analog=None) -> torch.Tensor:
    """Normed hidden states (B, T, d) of a whole batch, no cache kept: the
    reference's ``forward_hidden(..., mode="train")``, through which the
    calibration's gradient runs."""
    return forward_hidden(params, _embed_inputs(params, batch, cfg), cfg, analog=analog)


def _lm_head(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:  # one tensor a shard for both uses: its gradient adds both
        e = params["embed"]
        return Shards((t.T for t in e), e.shards) if isinstance(e, Shards) else e.T
    head = params["lm_head"]
    return dequantize_weight(head) if isinstance(head, Int8Weight) else head


#: the reference's fold of the analog key for the lm_head of the train loss
LM_HEAD_FOLD = 0x1A57


def train_loss(params, batch, cfg: ModelConfig, analog: Optional[AnalogSpec] = None
               ) -> torch.Tensor:
    """Mean next-token NLL of a batch (``{"tokens", "labels"}``, or the
    frontend's inputs with ``"labels"``): the cache-free forward
    (``hidden``'s), each layer group recomputed in the backward when
    ``cfg.remat``, then ``chunked_xent`` over the lm_head. Under
    ``analog`` the lm_head is an analog site too, at ``analog.energies
    ["lm_head"]`` with the key ``fold_key(analog.key, 0x1A57)``, as in the
    reference. Every family: a stacked leaf may come as a list of
    per-layer tensors (``launch.steps``' gradient views), an expert or
    mLSTM leaf as a list of lists (``stacked_axes``)."""
    batch = _as_batch(batch)
    h = forward_hidden(params, _embed_inputs(params, batch, cfg), cfg, analog=analog,
                       remat=cfg.remat)
    hook = MatmulHook()
    if analog is not None:
        dev = "cpu" if analog.cfg.backend == "torch" else h.device
        seed = key_seed(site_key(fold_key(analog.key, LM_HEAD_FOLD), "lm_head"), dev)
        hook = AnalogHook(cfg=analog.cfg, energies={"lm_head": analog.energies["lm_head"]},
                          seeds={"lm_head": seed}, rows_per_key=analog.rows_per_key,
                          noise_scale=analog.noise_scale)
    return chunked_xent(h, _lm_head(params, cfg), batch["labels"], chunk=cfg.loss_chunk,
                        vocab=cfg.vocab_size, n_codebooks=cfg.n_codebooks, hook=hook)


def logits_last(params, h_last: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, 1, d) -> (B, 1, n_codebooks, V): a digital matmul, one request at
    a time (a GEMM of B rows may sum in another order than one of 1, and a
    request's tokens must not depend on its batch), vocab padding sliced
    off."""
    b = h_last.shape[0]
    head = _lm_head(params, cfg).to(h_last.dtype)
    logits = torch.cat([torch.matmul(h_last[i:i + 1], head) for i in range(b)])
    return logits.reshape(b, 1, cfg.n_codebooks, cfg.padded_vocab)[..., : cfg.vocab_size]


def prefill(params, batch, cfg: ModelConfig, analog=None, cache_len=None,
            lengths: Optional[torch.Tensor] = None, hook: Optional[MatmulHook] = None,
            cache=None):
    """Run the prompt; returns (cache, last hidden (B, 1, d)).

    ``batch``: ``{"tokens"}``, ``{"embeds"}`` or ``{"tokens",
    "patch_embeds"}`` as the config's frontend reads it; a bare (B, T)
    tensor is tokens. Under ``patch`` the positions (and ``lengths``)
    count the image prefix.

    ``lengths`` (B,): per-row true prompt lengths of a right-padded bucket
    batch; the last hidden is gathered at each row's final real token, and
    pad positions are inert in every state: causal attention keeps them
    out of real rows, ring caches gather each row's last real tokens, the
    recurrences treat pad steps as the identity, and MoE routing leaves
    pad tokens out of expert capacity. Length 0 marks a batch-padding row.
    Without ``cache_len`` the cache holds the prompt (a ring cache: the
    whole window, as the reference sizes it). ``hook``: the matmul hook of
    a digital forward (``analog`` None; default plain matmuls). ``cache``:
    an ``init_cache(cfg, B, cache_len)``-shaped tree to prefill in place
    (reset first, ``reset_cache``) instead of a new one.
    """
    h = _embed_inputs(params, batch, cfg)
    b, t = h.shape[:2]
    if cache is not None:
        reset_cache(cfg, cache)
    else:
        if cache_len is None:
            w = _window(cfg)
            cache_len = t if w is None else max(t, w)
        cache = init_cache(cfg, b, cache_len, device=h.device)
    h = forward_hidden(params, h, cfg, cache=cache, analog=analog, lengths=lengths, hook=hook)
    if lengths is None:
        return cache, h[:, -1:]
    idx = torch.clamp(lengths.to(h.device).long() - 1, 0, t - 1)
    return cache, h[torch.arange(b, device=h.device), idx][:, None]


def decode_step(params, cache, batch, pos: torch.Tensor, cfg: ModelConfig, analog=None,
                lengths: Optional[torch.Tensor] = None, hook: Optional[MatmulHook] = None):
    """One step: ``{"tokens": (B, 1)}`` (or the bare tensor) or, under
    ``frames``, ``{"embeds": (B, 1, d)}``, at per-row positions ``pos``
    (B,). Under ``patch`` a step reads plain tokens (the image prefix is
    prefill's). ``lengths`` (B,): the rows' true prompt lengths; a row of
    length 0 is batch padding, left out of MoE capacity and of the expert
    sites' noise key, and its xlstm state is not advanced (every other op
    is row-independent). ``hook``: as in ``prefill``. Returns (logits (B,
    1, n_codebooks, V), cache), the cache updated in place."""
    batch = _as_batch(batch)
    if cfg.frontend == "patch" and "patch_embeds" not in batch:
        h = params["embed"][batch["tokens"]].to(cfg.compute_dtype)
    else:
        h = _embed_inputs(params, batch, cfg)
    pos = pos.to(h.device).long().reshape(-1).expand(h.shape[0])
    h = _run_stack(params, h, cfg, mode="decode", cache=cache, pos=pos,
                   positions=pos[:, None], analog=analog, lengths=lengths, hook=hook)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return logits_last(params, h, cfg), cache

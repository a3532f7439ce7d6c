"""Dense transformer LM; port of the dense branch of ``repro/models/lm.py``.

Parameters are a nested dict of tensors with the reference's structure and
layer-stacked leaves (``params["blocks"]["attn0"]["wq"]`` is (L, d, H*hd)),
so a reference tree carries over leaf by leaf (``repro_torch.bridge``).
The layer stack is a Python loop that passes the global layer index to
every hook, as the reference's scan does with ``arange(L)``.

Every attention and MLP matmul routes through a hook: digital by default,
or an ``AnalogHook`` carrying the layer's energies and its row of the
forward's seed table (``core.analog.site_seed_table``: the whole
(layers, sites, requests) key chain is folded on the host and copied to
the card once per forward). The ``lm_head`` stays a digital matmul.
Under a ``PrecisionProfile`` layer ``l`` runs its sites at its own K_l;
``energy_macs`` and ``profile_token_energy`` price that schedule.

Decode updates the KV cache in place (one slot per row) and returns it;
``scatter_cache_rows`` copies prefilled rows into a decode pool's cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig, site_seed_table
from repro_torch.core.energy import apply_repeats, total_energy
from repro_torch.core.profile import PrecisionProfile
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.hooks import MatmulHook, hook_for_layer
from repro_torch.models.layers import (
    apply_rope,
    causal_attention,
    decode_attention,
    mlp,
    rms_norm,
    rope_tables,
)
from repro_torch.tree import map_leaves

F32 = torch.float32


@dataclasses.dataclass
class AnalogSpec:
    """Analog execution request for a forward pass.

    ``energies``: an ``init_energy_tree``-shaped tree. ``key``: one raw
    (2,) uint32 key or a stacked (B, 2) array, one stream per batch row.
    ``n_repeats``: the K-repeat dynamic-precision knob for every site.
    ``profile``: its per-layer form, a ``PrecisionProfile`` giving layer
    ``l`` its own K_l; it overrides ``n_repeats``, which must stay 1.
    """

    cfg: AnalogConfig
    energies: Dict[str, Any]
    key: np.ndarray
    n_repeats: int = 1
    profile: Optional[PrecisionProfile] = None

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
    shape: tuple
    scale: float = 1.0


def param_leaves(cfg: ModelConfig) -> Dict[str, Any]:
    """Shapes and init scales of every parameter (``lm.py`` reference)."""
    d, v, ff, hd = cfg.d_model, cfg.padded_vocab, cfg.d_ff, cfg.head_dim
    qh, kh, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    s = d**-0.5
    return {
        "final_ln": Leaf((d,), 0.0),
        "lm_head": Leaf((d, v), s),
        "embed": Leaf((v, d), 0.02),
        "blocks": {
            "ln1_0": Leaf((n, d), 0.0),
            "ln2_0": Leaf((n, d), 0.0),
            "attn0": {
                "wq": Leaf((n, d, qh * hd), s),
                "wk": Leaf((n, d, kh * hd), s),
                "wv": Leaf((n, d, kh * hd), s),
                "wo": Leaf((n, qh * hd, d), (qh * hd) ** -0.5),
            },
            "mlp0": {
                "w_gate": Leaf((n, d, ff), s),
                "w_up": Leaf((n, d, ff), s),
                "w_down": Leaf((n, ff, d), ff**-0.5),
            },
        },
    }


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random weights at the reference's shapes and scales, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``. Stacked
    leaves are drawn one layer at a time (bounded float32 scratch)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = cfg.compute_dtype

    def make(path, leaf: Leaf):
        out = torch.zeros(leaf.shape, dtype=dtype, device=dev)
        if leaf.scale == 0.0:
            return out
        parts = out if path[0] == "blocks" else out[None]
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=gen, device=dev, dtype=F32) * leaf.scale)
        return out

    return map_leaves(make, param_leaves(cfg))


def group_sites(cfg: ModelConfig) -> Dict[str, tuple]:
    """Analog matmul sites of one layer -> energy leaf suffix."""
    return {
        "attn0_q": (), "attn0_k": (), "attn0_v": (), "attn0_o": (),
        "mlp0_gate": (), "mlp0_up": (), "mlp0_out": (),
    }


def init_energy_tree(cfg: ModelConfig, e0: float, device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    return {
        "groups": {
            s: torch.full((cfg.n_layers,) + suf, float(e0), dtype=F32, device=dev)
            for s, suf in group_sites(cfg).items()
        },
        "lm_head": torch.tensor(float(e0), dtype=F32, device=dev),
    }


def energy_macs(cfg: ModelConfig, seq_len: int) -> Dict[str, Any]:
    """Per-example MAC counts in ``init_energy_tree``'s structure (float32,
    on the CPU): ``seq_len`` tokens through every analog site of every
    layer, and the lm_head. ``E_tot = sum E * macs`` (``core.energy``)."""
    d, ff, hd, t = cfg.d_model, cfg.d_ff, cfg.head_dim, seq_len
    qo, kv, mlp_macs = t * d * cfg.n_heads * hd, t * d * cfg.n_kv_heads * hd, t * d * ff
    per_site = {"attn0_q": qo, "attn0_k": kv, "attn0_v": kv, "attn0_o": qo,
                "mlp0_gate": mlp_macs, "mlp0_up": mlp_macs, "mlp0_out": mlp_macs}
    return {
        "groups": {s: torch.full((cfg.n_layers,) + suf, float(per_site[s]), dtype=F32)
                   for s, suf in group_sites(cfg).items()},
        "lm_head": torch.tensor(float(t * d * cfg.vocab_size), dtype=F32),
    }


# ===========================================================================
# precision profiles (paper §V-VI: per-layer K on the layer stack)
# ===========================================================================


def group_site_subs(cfg: ModelConfig) -> Dict[str, int]:
    """Analog site -> its sublayer within one layer group. The dense family
    has one layer a group, so every site belongs to sublayer 0."""
    return dict.fromkeys(group_sites(cfg), 0)


def profile_rows(cfg: ModelConfig, profile: PrecisionProfile):
    """Validate a profile against the model and split it onto the layer
    groups: ``(rows, tail_ks)``, ``rows[l]`` the K-tuple of group ``l``
    (one layer each in the dense family), ``tail_ks`` empty."""
    if profile.n_layers != cfg.n_layers:
        raise ValueError(
            f"profile {profile.name!r} has {profile.n_layers} layers but "
            f"model {cfg.name!r} has {cfg.n_layers}"
        )
    return [(k,) for k in profile.repeats], []


def profile_repeat_tree(cfg: ModelConfig, profile: PrecisionProfile) -> Dict[str, Any]:
    """Per-site repeat factors in ``init_energy_tree``'s structure: each
    site's leaf carries K_l along the layer dim; the lm_head (a digital
    matmul) stays at 1. With ``core.energy.apply_repeats`` it gives the
    served energy ``sum_l K_l * E_l * MACs_l``."""
    rows, _ = profile_rows(cfg, profile)
    ks = torch.tensor([r[0] for r in rows], dtype=F32)
    return {
        "groups": {s: ks.reshape((cfg.n_layers,) + (1,) * len(suf))
                   for s, suf in group_sites(cfg).items()},
        "lm_head": torch.tensor(1.0, dtype=F32),
    }


def profile_token_energy(cfg: ModelConfig, energies, profile: PrecisionProfile) -> float:
    """Serving energy per generated token, ``sum_l K_l * E_l * MACs_l``
    over the analog sites plus the lm_head at K=1 (decode: one token)."""
    scaled = apply_repeats(energies, profile_repeat_tree(cfg, profile))
    return float(total_energy(scaled, energy_macs(cfg, 1)))


# ===========================================================================
# forward
# ===========================================================================


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device="cuda", dtype=None):
    """KV cache {"groups": {"k", "v"}}, each (L, 1, B, S, KH, hd)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, 1, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.compute_dtype
    return {"groups": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}}


def _cache_store(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """Write each row's one-token KV slab (B, 1, KH, hd) at its own slot, in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot] = new[:, 0].to(cache.dtype)


def _attn_sublayer(x, p, cfg: ModelConfig, hook: MatmulHook, prefix: str, *, rope, mode,
                   cache=None, pos=None):
    b, t, _ = x.shape
    hd, qh, kh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cos, sin = rope
    q = hook(f"{prefix}_q", x, p["wq"]).reshape(b, t, qh, hd)
    k = hook(f"{prefix}_k", x, p["wk"]).reshape(b, t, kh, hd)
    v = hook(f"{prefix}_v", x, p["wv"]).reshape(b, t, kh, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k_cache, v_cache = cache
    if mode == "decode":
        _cache_store(k_cache, k, pos)
        _cache_store(v_cache, v, pos)
        out = decode_attention(q, k_cache, v_cache, pos)
    else:
        k_cache[:, :t] = k.to(k_cache.dtype)
        v_cache[:, :t] = v.to(v_cache.dtype)
        g = qh // kh
        out = causal_attention(q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2))
    return hook(f"{prefix}_o", out.reshape(b, t, qh * hd), p["wo"])


def _transformer_layer(x, lp, cfg: ModelConfig, hook, *, rope, mode, cache, pos):
    h = rms_norm(x, lp["ln1_0"], cfg.norm_eps)
    x = x + _attn_sublayer(h, lp["attn0"], cfg, hook, "attn0", rope=rope, mode=mode,
                           cache=cache, pos=pos)
    h = rms_norm(x, lp["ln2_0"], cfg.norm_eps)
    return x + mlp(h, lp["mlp0"], hook, prefix="mlp0")


def _run_stack(params, h, cfg: ModelConfig, *, mode, cache, pos, positions,
               analog: Optional[AnalogSpec]):
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    blocks = params["blocks"]
    sites = list(group_sites(cfg))
    table = None
    if analog is not None:
        table = site_seed_table(analog.key, cfg.n_layers, sites, h.device)
        energies = analog.energies["groups"]
        if analog.profile is None:
            ks = [analog.n_repeats] * cfg.n_layers
        else:
            ks = [row[0] for row in profile_rows(cfg, analog.profile)[0]]
    for l in range(cfg.n_layers):
        lp = map_leaves(lambda _p, a: a[l], blocks)
        hook = MatmulHook()
        if analog is not None:
            # the global layer index keys the noise: a profile's layer l
            # draws the stream of the uniform path's layer l
            hook = hook_for_layer(
                analog.cfg, {s: energies[s][l] for s in sites},
                {s: table[l, i] for i, s in enumerate(sites)}, n_repeats=ks[l],
            )
        layer_cache = (cache["groups"]["k"][l, 0], cache["groups"]["v"][l, 0])
        h = _transformer_layer(h, lp, cfg, hook, rope=rope, mode=mode, cache=layer_cache, pos=pos)
    return h


def scatter_cache_rows(cfg: ModelConfig, dst, src, slot_ids) -> Dict[str, Any]:
    """Copy the rows of a freshly prefilled cache ``src`` (batch b) into
    the decode pool's cache ``dst`` (batch ``slots``) at ``slot_ids`` (b,),
    in place along the batch dim (dim 2 of (L, 1, B, S, KH, hd)). Both
    share the pool's cache length. Ids >= ``slots`` are dropped, as the
    reference's ``mode="drop"`` drops them: the engine aims prefill
    batch-padding rows at ``slots``. Returns ``dst``."""
    del cfg  # one cache layout in the dense family
    ids = np.asarray(slot_ids, np.int64).reshape(-1)
    for name, d in dst["groups"].items():
        s = src["groups"][name]
        keep = np.flatnonzero((ids >= 0) & (ids < d.shape[2]))
        if keep.size == 0:
            continue
        rows = torch.from_numpy(keep).to(s.device)
        d.index_copy_(2, torch.from_numpy(ids[keep]).to(d.device), s.index_select(2, rows).to(d.dtype))
    return dst


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.compute_dtype)


def forward_hidden(params, tokens, cfg: ModelConfig, *, cache, analog=None):
    """Prefill trunk: (B, T) tokens -> normed hidden (B, T, d); fills the
    first T slots of ``cache``."""
    h = _embed(params, tokens, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    h = _run_stack(params, h, cfg, mode="prefill", cache=cache, pos=None,
                   positions=positions, analog=analog)
    return rms_norm(h, params["final_ln"], cfg.norm_eps)


def logits_last(params, h_last: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, 1, d) -> (B, 1, 1, V): a digital matmul, vocab padding sliced off."""
    b = h_last.shape[0]
    logits = torch.matmul(h_last, params["lm_head"].to(h_last.dtype))
    return logits.reshape(b, 1, 1, cfg.padded_vocab)[..., : cfg.vocab_size]


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, analog=None, cache_len=None,
            lengths: Optional[torch.Tensor] = None):
    """Run the prompt; returns (cache, last hidden (B, 1, d)).

    ``lengths`` (B,): per-row true prompt lengths of a right-padded bucket
    batch; the last hidden is gathered at each row's final real token
    (causal attention keeps pad positions out of real rows). Length 0 marks
    a batch-padding row.
    """
    b, t = tokens.shape
    cache = init_cache(cfg, b, cache_len or t, device=tokens.device)
    h = forward_hidden(params, tokens, cfg, cache=cache, analog=analog)
    if lengths is None:
        return cache, h[:, -1:]
    idx = torch.clamp(lengths.to(h.device).long() - 1, 0, t - 1)
    return cache, h[torch.arange(b, device=h.device), idx][:, None]


def decode_step(params, cache, tokens: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                analog=None):
    """One token step: tokens (B, 1) at per-row positions ``pos`` (B,).
    Returns (logits (B, 1, 1, V), cache), the cache updated in place."""
    h = _embed(params, tokens, cfg)
    pos = pos.to(h.device).long().reshape(-1).expand(h.shape[0])
    h = _run_stack(params, h, cfg, mode="decode", cache=cache, pos=pos,
                   positions=pos[:, None], analog=analog)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return logits_last(params, h, cfg), cache

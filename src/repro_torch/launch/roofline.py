"""Roofline terms of one H100 from the dry run's reckoning; port of
``repro/launch/roofline.py``, whose formulas carry over unchanged.

Hardware constants (``H100``, per card): NVIDIA's H100 SXM specification
(data sheet, dense, at 700 W): 989e12 bf16 FLOP/s on the tensor cores,
3.35e12 B/s of HBM3, 450e9 B/s of NVLink a direction, 80e9 B of HBM.
Spec figures, not measurements.

Three terms per (arch x shape x mesh), all in seconds per step:

  compute    = dot_FLOPs_per_device / peak_flops
  memory     = HBM_traffic_per_device / hbm_bw
  collective = collective_link_bytes_per_device / link_bw

The dot FLOPs and the collective link bytes come from the port's
reckoning of one device's step on the meta device
(``launch/trace_analysis.py``, the counterpart of the reference's HLO
parse); HBM traffic is the reference's analytic per-step model
(weights / optimizer / cache / activation-boundary traffic, formulas
below). MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (forward
only).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig

#: NVIDIA H100 SXM, per card (spec): bf16 dense FLOP/s, HBM3 B/s, NVLink
#: B/s a direction, HBM bytes
H100 = dict(
    peak_flops=989e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
)


def matmul_param_count(cfg: ModelConfig, active_only: bool = True) -> int:
    """Params that participate in matmuls (embedding gather excluded;
    lm_head included — tied or not, the logits matmul runs)."""
    n = cfg.active_param_count() if active_only else cfg.param_count()
    n -= cfg.vocab_size * cfg.d_model  # embed gather is not a matmul
    if cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model * cfg.n_codebooks  # logits matmul
    return n


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Global useful FLOPs per step: 6·N·D train, 2·N·D forward-only."""
    n = matmul_param_count(cfg)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def attention_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Global attention score+value FLOPs (excluded from 6ND; reported so
    the useful-ratio denominator is honest for long sequences). Causal
    factor 1/2; window caps the context; train multiplies by 3 (bwd ~ 2x).
    """
    if cfg.family == "xlstm":
        return 0.0
    b, t = shape.global_batch, shape.seq_len
    n_attn = cfg.n_layers
    window = None
    if cfg.family == "griffin":
        n_attn = cfg.n_layers // len(cfg.griffin_pattern)
        window = cfg.local_window
    hd, qh = cfg.head_dim, cfg.n_heads
    if shape.kind == "decode":
        ctx = min(t, window) if window else t
        return 4.0 * b * qh * hd * ctx * n_attn
    ctx_per_q = (min(t, window) if window else t) / 2.0
    mult = 3.0 if shape.kind == "train" else 1.0
    return mult * 4.0 * b * t * qh * hd * ctx_per_q * n_attn


def analytic_hbm_traffic(
    cfg: ModelConfig, shape: ShapeSpec, n_chips: int, opt_bytes_per_param: float = 4.0,
    cache_bytes_global: float = None, param_bytes_global: float = None,
) -> float:
    """Per-device HBM bytes per step (documented coarse model).

    train:  params: read fwd + read remat-fwd + read bwd (3x)
            grads:  write + read (2x)
            opt:    m,v read+write (4x at state dtype) + param write
            acts:   per layer-group boundary (B_loc, T, d) x 2B x
                    (fwd write + bwd read + remat write) = 3x
    prefill: params 1x + cache write + act boundary 1x
    decode:  params 1x (weight streaming dominates) + cache read + write
    """
    p_bytes = (param_bytes_global if param_bytes_global is not None
               else cfg.param_count() * 2.0)  # bf16 default
    # dense params shard on "model" (16) only; MoE expert weights (the bulk)
    # span experts x ff = all chips
    p_ways = n_chips if cfg.family == "moe" else min(n_chips, 16)
    p_shard = p_bytes / p_ways
    b_loc = max(shape.global_batch / max(n_chips / 16, 16), 1)  # batch over data axis
    d = cfg.d_model
    g = cfg.n_layers  # boundary per layer (scan group boundaries are finer; upper bound)
    act_boundary = b_loc * shape.seq_len * d * 2.0 * g

    if shape.kind == "train":
        opt = cfg.param_count() / n_chips * opt_bytes_per_param  # ZeRO-1: /all chips
        return 3.0 * p_shard + 2.0 * p_shard + opt + p_shard + 3.0 * act_boundary

    cache = (cache_bytes_global if cache_bytes_global is not None
             else _cache_bytes(cfg, shape)) / n_chips
    if shape.kind == "prefill":
        return p_shard + cache + act_boundary
    # decode: read whole cache + write one slot; stream all (active... all
    # resident) weights once; activations negligible
    return p_shard + cache + b_loc * d * 2.0 * g


def _cache_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family in ("dense", "moe"):
        return 2.0 * b * s * cfg.n_kv_heads * cfg.head_dim * 2.0 * cfg.n_layers
    if cfg.family == "griffin":
        n_attn = cfg.n_layers // len(cfg.griffin_pattern)
        n_rec = cfg.n_layers - n_attn
        w = min(s, cfg.local_window)
        attn = 2.0 * b * w * cfg.n_kv_heads * cfg.head_dim * 2.0 * n_attn
        rec = b * cfg.rnn_width * 4.0 * n_rec
        return attn + rec
    # xlstm: matrix memories
    g, m = cfg.n_layers // cfg.slstm_ratio, cfg.slstm_ratio - 1
    hd = cfg.d_model // cfg.n_heads
    c_state = g * m * b * cfg.n_heads * hd * hd * 4.0
    return c_state + g * b * cfg.d_model * 4.0 * 4


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_global: float
    attention_flops_global: float
    dot_flops_per_device: float
    useful_ratio: float
    dominant: str

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def terms(
    cfg: ModelConfig,
    shape: ShapeSpec,
    n_chips: int,
    *,
    dot_flops: float,
    collective_link_bytes: float,
    cache_bytes_global: float = None,
    param_bytes_global: float = None,
) -> RooflineTerms:
    """The three terms of one device's step at ``H100``'s spec rates;
    ``dot_flops``: the device's reckoned dot FLOPs (the reference's
    ``hlo_dot_flops``)."""
    compute_s = dot_flops / H100["peak_flops"]
    memory_s = analytic_hbm_traffic(
        cfg, shape, n_chips, cache_bytes_global=cache_bytes_global,
        param_bytes_global=param_bytes_global,
    ) / H100["hbm_bw"]
    collective_s = collective_link_bytes / H100["link_bw"]
    mf = model_flops(cfg, shape)
    af = attention_flops(cfg, shape)
    useful = (mf + af) / max(n_chips * dot_flops, 1.0)
    doms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(doms, key=doms.get)
    return RooflineTerms(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        model_flops_global=mf,
        attention_flops_global=af,
        dot_flops_per_device=dot_flops,
        useful_ratio=useful,
        dominant=dominant,
    )

"""Model layers: RMS norm, RoPE, attention and the SwiGLU MLP.

Port of the dense and windowed functions of ``repro/models/layers.py``.
Attention is plain tensor code in float32, computed the way the reference
computes it (one online-softmax block for prefill, the (previous,
current) chunk pairs of local attention, a masked softmax for decode), so
the numbers follow the reference rather than a fused library kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.hooks import MatmulHook

F32 = torch.float32
NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given positions; shapes (..., T, head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=F32, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=F32, device=positions.device), exps)
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, D) in the halves layout; cos/sin: (B, T, half) or (T, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Causal prefill attention; q/k/v: (B, T, H, D) (KV already expanded
    to the query heads). The reference's online softmax over a single
    (T x T) block: scores in f32, max-shifted exp, normalised after P @ V.
    ``window``: a query sees only the ``window`` latest positions, itself
    included (the reference's ``chunked_attention(window=...)``)."""
    b, t, h, d = q.shape
    scale = 1.0 / (d**0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(F32), k.to(F32)) * scale
    pos = torch.arange(t, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=F32, device=q.device))
    m = torch.clamp_min(torch.amax(s, dim=-1), NEG_INF)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.to(F32))
    out = acc / torch.clamp_min(l, 1e-30).permute(0, 2, 1)[..., None]
    return out.to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    """Sliding-window causal attention; q/k/v: (B, T, H, D), KV expanded to
    the query heads. Short or unaligned sequences (``t <= window`` or
    ``t % window``) take the masked path; otherwise each query chunk of
    ``window`` rows attends to its (previous, current) key chunks only, so
    the cost is linear in T."""
    b, t, h, d = q.shape
    if t <= window or t % window:
        return causal_attention(q, k, v, window=window)
    scale = 1.0 / (d**0.5)
    outs = []
    for q_lo in range(0, t, window):
        k_lo = max(0, q_lo - window)
        qc = q[:, q_lo:q_lo + window]
        kc = k[:, k_lo:q_lo + window]
        vc = v[:, k_lo:q_lo + window]
        s = torch.einsum("bqhd,bkhd->bhqk", qc.to(F32), kc.to(F32)) * scale
        qp = torch.arange(window, device=q.device) + q_lo
        kp = torch.arange(kc.shape[1], device=q.device) + k_lo
        mask = (qp[:, None] >= kp[None, :]) & ((qp[:, None] - kp[None, :]) < window)
        s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=F32, device=q.device))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, vc.to(F32)))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    slot_pos: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, 1, H, D); caches: (B, S, KH, D); pos: (B,) position of the new
    token. ``slot_pos`` (S,) or (B, S): the absolute position each cache
    slot holds (a ring cache), default ``arange(S)``; slots holding a
    position beyond the row's, a negative one, or one ``window`` or more
    behind it are masked.
    """
    b, _, h, d = q.shape
    _, s, kh, _ = k_cache.shape
    g = h // kh
    scale = 1.0 / (d**0.5)
    if slot_pos is None:
        slot_pos = torch.arange(s, device=q.device)
    if slot_pos.dim() == 1:
        slot_pos = slot_pos[None, :]
    pos_b = pos.reshape(-1, 1).expand(b, 1)
    q5 = q.reshape(b, kh, g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", q5.to(F32), k_cache.to(F32)) * scale
    valid = (slot_pos <= pos_b) & (slot_pos >= 0)
    if window is not None:
        valid &= (pos_b - slot_pos) < window
    scores = torch.where(
        valid[:, None, None, :], scores, torch.tensor(NEG_INF, dtype=F32, device=q.device)
    )
    e = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    p = e / torch.sum(e, dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.to(F32))
    return out.reshape(b, 1, h, d).to(q.dtype)


def mlp(x: torch.Tensor, p: dict, hook: MatmulHook, prefix: str = "mlp") -> torch.Tensor:
    """SwiGLU MLP: down(silu(gate(x)) * up(x))."""
    gate = hook(f"{prefix}_gate", x, p["w_gate"])
    up = hook(f"{prefix}_up", x, p["w_up"])
    h = torch.nn.functional.silu(gate.to(F32)).to(x.dtype) * up
    return hook(f"{prefix}_out", h, p["w_down"])

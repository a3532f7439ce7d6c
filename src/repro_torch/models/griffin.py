"""Griffin / RecurrentGemma blocks: RG-LRU recurrence + local attention.

Port of ``repro/models/griffin.py``. The RG-LRU (Real-Gated Linear
Recurrent Unit, arXiv:2402.19427):

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * r_t * softplus(Lambda)   (a = sigmoid(Lambda)^(c r_t))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The temporal-mixing block is: [gate branch: GELU(W_g x)] * [recurrent
branch: conv1d(W_x x) -> RG-LRU] -> out projection. GELU is the tanh
approximation, as ``jax.nn.gelu``'s default.

Tensor shards (training, ``models/sharding.py``): the block cuts its
recurrent width "rnn" among the shards. ``w_gate``, ``w_x``, ``conv_w``
and ``conv_b`` are column shards, and the conv and the scan run on the
shard's channels; ``w_a`` and ``w_i`` are placed ``("rnn", None)``, so a
shard holds their rows for its channels: each gate's pre-activation is a
partial product over the shard's input channels, summed over tp before
the sigmoid with each shard keeping its own channels (the hook's
``reduce_scatter``; no ``xr`` is gathered). ``b_a``, ``b_i`` and
``lambda`` stay whole, as the placement has them: each shard slices its
channels, and their gradients are summed over tp. ``w_out`` is a row
shard, summed by *g* (the hook's ``row_parallel``).

The diagonal linear recurrence runs as a Hillis-Steele scan for prefill
(``log2 T`` steps; at step s position t combines with t - 2^s) and as one
fused update for decode. Position t's result is a function of positions
0..t alone, never of T, so a right-padded row gives its real positions
the bits of its unpadded run. The reference's ``lax.associative_scan``
groups the products in another order: the two agree to float32 rounding,
not bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.hooks import MatmulHook
from repro_torch.models.sharding import shard_part, shards_of

F32 = torch.float32
LRU_C = 8.0


def rg_lru_coeffs(xr: torch.Tensor, p: Dict[str, torch.Tensor], hook: MatmulHook):
    """(a, beta * gated input) coefficients per position; xr: (B, T, R)
    post-conv recurrent-branch activations."""
    return _lru_coeffs(hook("rec_a", xr, p["w_a"]).to(F32), hook("rec_i", xr, p["w_i"]).to(F32),
                       xr, p)


def _lru_coeffs(pre_a: torch.Tensor, pre_i: torch.Tensor, xr: torch.Tensor, p):
    """``rg_lru_coeffs`` from the gates' f32 pre-activations."""
    r = torch.sigmoid(pre_a + p["b_a"])
    i = torch.sigmoid(pre_i + p["b_i"])
    lam = p["lambda"].to(F32)
    log_a = -LRU_C * r * torch.logaddexp(lam, torch.zeros_like(lam))  # softplus
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    return a, beta * i * xr.to(F32)


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1 (time); a, b: (B, T, R) f32."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0  # fold the carried state into the first step
    t = a.shape[1]
    s = 1
    while s < t:
        # (a1, b1) earlier, (a2, b2) later: (a1 a2, a2 b1 + b2)
        a_new = a[:, :-s] * a[:, s:]
        b_new = a[:, s:] * b[:, :-s] + b[:, s:]
        a = torch.cat([a[:, :s], a_new], dim=1)
        b = torch.cat([b[:, :s], b_new], dim=1)
        s *= 2
    return b


def causal_conv1d(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time. x: (B, T, R); w: (cw, R); b: (R,).

    ``state``: (B, cw-1, R) trailing inputs of the previous segment.
    ``lengths``: (B,) true lengths of a right-padded batch; the returned
    state then holds each row's last ``cw-1`` real inputs (rows shorter
    than ``cw-1`` backfill from the zero or previous state). Outputs at pad
    positions are garbage the caller never reads. Returns (y, new_state).
    """
    cw = w.shape[0]
    bsz, t, r = x.shape
    if state is None:
        state = torch.zeros((bsz, cw - 1, r), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, T+cw-1, R)
    y = torch.zeros((bsz, t, r), dtype=F32, device=x.device)
    for i in range(cw):
        y = y + xp[:, i:i + t].to(F32) * w[i].to(F32)
    y = y + b.to(F32)
    if lengths is None:
        new_state = xp[:, t:]  # last cw-1 inputs
    else:
        # xp index L..L+cw-2 == x positions L-cw+1..L-1 (state region if < 0)
        idx = (lengths.to(x.device).long()[:, None]
               + torch.arange(cw - 1, device=x.device)[None, :])
        new_state = torch.gather(xp, 1, idx[..., None].expand(bsz, cw - 1, r))
    return y.to(x.dtype), new_state


def recurrent_mix(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    hook: MatmulHook,
    *,
    pad_mask: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
):
    """The Griffin recurrent temporal-mixing block over a prompt, from a
    zero state (prefill).

    x: (B, T, d). Returns (y (B, T, d), h_last (B, R) f32, conv_state
    (B, cw-1, R)). ``pad_mask`` (B, T) / ``lengths`` (B,): right-padded
    batches. Pad steps become the scan identity (a=1, b=0) and ``h_last``
    is read at each row's last real position, so it is exactly the state
    after the row's last real token; the conv state is gathered at the
    length boundary. Outputs at pad positions are garbage.

    With ``p`` cut among tensor shards (``Shards`` leaves, the module
    docstring) the block runs on each shard's channels in turn and returns
    (y, None, None): a training forward keeps no state.
    """
    shards = shards_of(p)
    if shards:
        from repro_torch.launch import collectives

        xs, ps = collectives.copy_to_tp(x, shards), [shard_part(p, i) for i in range(len(shards))]
    else:
        xs, ps = [x], [p]
    gates, xrs = [], []
    for j, (xi, pi) in enumerate(zip(xs, ps)):
        s = shards[j] if shards else None
        gates.append(F.gelu(hook("rec_gate", xi, pi["w_gate"], shard=s).to(F32),
                            approximate="tanh"))
        xr = hook("rec_in", xi, pi["w_x"], shard=s)  # (B, T, R)
        xr, conv_state = causal_conv1d(xr, pi["conv_w"], pi["conv_b"], lengths=lengths)
        xrs.append(xr)
    if shards:
        pre_a = [a.to(F32) for a in hook.reduce_scatter("rec_a", xrs, [pi["w_a"] for pi in ps],
                                                        shards)]
        pre_i = [i.to(F32) for i in hook.reduce_scatter("rec_i", xrs, [pi["w_i"] for pi in ps],
                                                        shards)]
    else:
        pre_a = [hook("rec_a", xrs[0], p["w_a"]).to(F32)]
        pre_i = [hook("rec_i", xrs[0], p["w_i"]).to(F32)]
    ys = []
    for j, (xr, pi, gate) in enumerate(zip(xrs, ps, gates)):
        if shards:  # the whole per-channel leaves: this shard's channels
            lo, n = shards[j].t * xr.shape[-1], xr.shape[-1]
            pi = {**pi, **{k: pi[k][lo:lo + n] for k in ("b_a", "b_i", "lambda")}}
        a, b = _lru_coeffs(pre_a[j], pre_i[j], xr, pi)
        if pad_mask is not None:
            a = torch.where(pad_mask[..., None], torch.ones_like(a), a)
            b = torch.where(pad_mask[..., None], torch.zeros_like(b), b)
        h = rg_lru_scan(a, b)  # (B, T, R) f32
        if lengths is None:
            h_last = h[:, -1]
        else:
            last = torch.clamp(lengths.to(h.device).long() - 1, 0, h.shape[1] - 1)
            h_last = h[torch.arange(h.shape[0], device=h.device), last]
        ys.append((h * gate).to(x.dtype))
    if shards:
        return hook.row_parallel("rec_out", ys, [pi["w_out"] for pi in ps], shards), None, None
    return hook("rec_out", ys[0], p["w_out"]), h_last, conv_state


def recurrent_decode(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    hook: MatmulHook,
    h0: torch.Tensor,
    conv_state: torch.Tensor,
):
    """Single-token recurrent step. x: (B, 1, d); h0 (B, R) f32."""
    gate = F.gelu(hook("rec_gate", x, p["w_gate"]).to(F32), approximate="tanh")
    xr = hook("rec_in", x, p["w_x"])
    xr, conv_state = causal_conv1d(xr, p["conv_w"], p["conv_b"], conv_state)
    a, b = rg_lru_coeffs(xr, p, hook)
    h = a[:, 0] * h0 + b[:, 0]  # (B, R)
    y = (h[:, None] * gate).to(x.dtype)
    y = hook("rec_out", y, p["w_out"])
    return y, h, conv_state

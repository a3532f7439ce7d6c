"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory) with stabilized exponential gating.

Port of ``repro/models/xlstm.py``. mLSTM recurrence per head (state C:
(dk, dv), n: (dk,), m: scalar):

    m_t = max(logf_t + m_{t-1}, logi_t)
    C_t = exp(logf_t + m_{t-1} - m_t) C_{t-1} + exp(logi_t - m_t) k_t v_t^T
    n_t = exp(logf_t + m_{t-1} - m_t) n_{t-1} + exp(logi_t - m_t) k_t
    h_t = (q_t C_t) / max(|q_t . n_t|, exp(-m_t))

evaluated chunkwise for a prompt: a loop over chunks carrying (C, n, m)
with quadratic attention inside a chunk (the cummax stabiliser), and one
step at a time in decode. sLSTM is a loop over time with block-diagonal
(per-head) recurrent weights and the same stabilized gates.

A request's bits do not depend on its batch: the chunk scan, the gate
projection and sLSTM's recurrent product run one request at a time (a
batched GEMM may split its sums another way for another batch size),
and decode's contractions and the head norm sum in fixed stages
(``repro_torch.reduce``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.hooks import MatmulHook
from repro_torch.models.layers import _chunk
from repro_torch.reduce import contraction, row_norm, row_sum

F32 = torch.float32
NEG = -1e30


def _mlstm_one(q, k, v, log_i, log_f, chunk, state):
    """``mlstm_chunkwise`` of one request (B = 1)."""
    b, t, h, d = q.shape
    scale = 1.0 / (d**0.5)
    qs, ks, vs = q.to(F32) * scale, k.to(F32), v.to(F32)
    lis, lfs = log_i.to(F32), log_f.to(F32)
    if state is None:
        c_prev = torch.zeros((b, h, d, d), dtype=F32, device=q.device)
        n_prev = torch.zeros((b, h, d), dtype=F32, device=q.device)
        m_prev = torch.full((b, h), NEG, dtype=F32, device=q.device)
    else:
        c_prev, n_prev, m_prev = (s.to(F32) for s in state)
    out = []
    for lo in range(0, t, chunk):
        qc, kc, vc = qs[:, lo:lo + chunk], ks[:, lo:lo + chunk], vs[:, lo:lo + chunk]
        li, lf = lis[:, lo:lo + chunk], lfs[:, lo:lo + chunk]
        n_c = qc.shape[1]
        bcum = torch.cumsum(lf, dim=1)  # (B, c, H) inclusive cumsum of logf
        b_end = bcum[:, -1]  # (B, H)
        # log weight of source j seen from target i: bcum_i - bcum_j + li_j
        src = -bcum + li
        src_max = torch.cummax(src, dim=1).values  # running max over j <= i
        m_intra = bcum + src_max
        m_inter = bcum + m_prev[:, None, :]
        m_i = torch.maximum(m_intra, m_inter)
        logw = (bcum[:, :, None, :] - bcum[:, None, :, :] + li[:, None, :, :]
                - m_i[:, :, None, :])  # (B, i, j, H)
        idx = torch.arange(n_c, device=q.device)
        causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
        wgt = torch.exp(torch.where(causal, logw, torch.full_like(logw, NEG)))
        s_ij = torch.einsum("bihd,bjhd->bijh", qc, kc) * wgt  # decayed scores
        num_intra = torch.einsum("bijh,bjhd->bihd", s_ij, vc)
        den_intra = torch.sum(s_ij, dim=2)  # (B, i, H): n_i . q_i
        w_inter = torch.exp(m_inter - m_i)
        num_inter = torch.einsum("bihd,bhde->bihe", qc, c_prev) * w_inter[..., None]
        den_inter = torch.einsum("bihd,bhd->bih", qc, n_prev) * w_inter
        denom = torch.maximum(torch.abs(den_intra + den_inter), torch.exp(-m_i))
        out.append((num_intra + num_inter) / denom[..., None])
        # carry to the end of the chunk
        m_next = torch.maximum(b_end + m_prev, b_end + src_max[:, -1])
        wk = torch.exp(b_end[:, None, :] + src - m_next[:, None, :])  # (B, j, H)
        decay = torch.exp(b_end + m_prev - m_next)
        c_prev = decay[:, :, None, None] * c_prev + torch.einsum("bjh,bjhd,bjhe->bhde", wk, kc, vc)
        n_prev = decay[:, :, None] * n_prev + torch.einsum("bjh,bjhd->bhd", wk, kc)
        m_prev = m_next
    return torch.cat(out, dim=1).to(q.dtype), (c_prev, n_prev, m_prev)


def mlstm_chunkwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_i: torch.Tensor,
    log_f: torch.Tensor,
    *,
    chunk: int,
    state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
):
    """q, k, v: (B, T, H, D); log_i / log_f: (B, T, H) (log_i = i_tilde,
    log_f = logsigmoid(f_tilde)). Returns (h, final state) with state = (C
    (B, H, D, D), n (B, H, D), m (B, H)) in float32.

    Chunks are the reference's (the largest divisor of T not above
    ``chunk``) unless that leaves chunks under an eighth of it (a T with no
    useful divisor, such as a prime): then ``chunk`` rows, the last chunk
    short (``layers._chunk``); the same recurrence, summed in another
    order. Each request runs alone."""
    chunk = _chunk(q.shape[1], chunk)
    outs, states = [], []
    for i in range(q.shape[0]):
        one = slice(i, i + 1)
        st = None if state is None else tuple(s[one] for s in state)
        h, st = _mlstm_one(q[one], k[one], v[one], log_i[one], log_f[one], chunk, st)
        outs.append(h)
        states.append(st)
    return torch.cat(outs), tuple(torch.cat(s) for s in zip(*states))


def mlstm_decode(q, k, v, log_i, log_f, state):
    """One mLSTM step. q, k, v: (B, 1, H, D); gates (B, 1, H); state (C, n,
    m). The contractions over D sum in fixed stages (``row_sum``)."""
    b, _, h, d = q.shape
    c0, n0, m0 = (s.to(F32) for s in state)
    scale = 1.0 / (d**0.5)
    qt = q[:, 0].to(F32) * scale
    kt, vt = k[:, 0].to(F32), v[:, 0].to(F32)
    li, lf = log_i[:, 0].to(F32), log_f[:, 0].to(F32)
    m_t = torch.maximum(lf + m0, li)
    fw = torch.exp(lf + m0 - m_t)
    iw = torch.exp(li - m_t)
    c_t = fw[..., None, None] * c0 + iw[..., None, None] * (kt[..., :, None] * vt[..., None, :])
    n_t = fw[..., None] * n0 + iw[..., None] * kt
    num = row_sum(contraction(qt[..., :, None] * c_t).transpose(-1, -2))  # (B, H, E)
    den = torch.maximum(torch.abs(row_sum(contraction(qt * n_t))), torch.exp(-m_t))
    h_t = (num / den[..., None]).reshape(b, 1, h, d)
    return h_t.to(q.dtype), (c_t, n_t, m_t)


def _gate_proj(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x @ w + bias`` in float32, one request at a time."""
    w32 = w.to(F32)
    return torch.cat([torch.matmul(x[i:i + 1].to(F32), w32) for i in range(x.shape[0])]) + \
        bias.to(F32)


def mlstm_block(x, p: Dict[str, torch.Tensor], hook: MatmulHook, *, n_heads: int,
                chunk: int = 256, state=None, decode: bool = False,
                pad_mask: Optional[torch.Tensor] = None):
    """The mLSTM block: z/q/k/v projections, exponential gates, the
    recurrence, a headwise norm, the silu(z) output gate and the down
    projection. Returns (y (B, T, d), new state).

    ``pad_mask`` (B, T): right-padded rows. Pad steps are pinned to the
    recurrence identity at the gates (log_i = -1e30, log_f = 0): they add
    nothing to (C, n, m), and the state crosses the pad suffix exactly.
    Outputs at pad positions are garbage the caller never reads."""
    b, t, d = x.shape
    hd = d // n_heads
    z = hook("mlstm_z", x, p["w_z"])
    q = hook("mlstm_q", x, p["w_q"]).reshape(b, t, n_heads, hd)
    k = hook("mlstm_k", x, p["w_k"]).reshape(b, t, n_heads, hd)
    v = hook("mlstm_v", x, p["w_v"]).reshape(b, t, n_heads, hd)
    li, lf_pre = torch.chunk(_gate_proj(x, p["w_gates"], p["b_gates"]), 2, dim=-1)
    lf = F.logsigmoid(lf_pre)
    if pad_mask is not None:
        pad = pad_mask[..., None]
        li = torch.where(pad, torch.full_like(li, NEG), li)
        lf = torch.where(pad, torch.zeros_like(lf), lf)
    if decode:
        h, new_state = mlstm_decode(q, k, v, li, lf, state)
    else:
        h, new_state = mlstm_chunkwise(q, k, v, li, lf, chunk=chunk, state=state)
    h32 = h.to(F32)
    nrm = row_norm(h32, keepdim=True)
    var = nrm * nrm / hd
    h_n = h32 * torch.rsqrt(var + 1e-6) * (1.0 + p["norm"].to(F32).reshape(n_heads, hd))
    h_n = h_n.reshape(b, t, d).to(x.dtype)
    y = h_n * F.silu(z.to(F32)).to(x.dtype)
    return hook("mlstm_o", y, p["w_o"]), new_state


def _recurrent(hb: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """sLSTM's recurrent term ``einsum("bhk,ghkl->bghl")``: hb (B, H, hd),
    r (4, H, hd, hd) -> (B, 4, H*hd), one request at a time."""
    b, h, hd = hb.shape
    return torch.stack([torch.matmul(hb[i][None, :, None, :], r).reshape(4, h * hd)
                        for i in range(b)])


def slstm_block(x, p: Dict[str, torch.Tensor], hook: MatmulHook, *, n_heads: int, state=None,
                pad_mask: Optional[torch.Tensor] = None):
    """The sLSTM block: a loop over time with block-diagonal recurrent
    weights. state = (c, n, h, m), each (B, d) float32; gates z/i/f/o from
    W x + R h_{t-1}. Returns (y (B, T, d), new state).

    ``pad_mask`` (B, T): right-padded rows. Pad steps pin the input gate's
    pre-activation to -1e30 and the forget gate's to +1e30, so (c, n, m)
    carry through the pad suffix exactly; h drifts at pad steps, so the
    returned h is gathered at each row's last real step (an all-pad row
    keeps its initial h). A decode step is the loop at T = 1."""
    b, t, d = x.shape
    hd = d // n_heads
    wx = hook("slstm_wx", x, p["w_x"]).to(F32) + p["b"].to(F32)  # (B, T, 4d): [z | i | f | o]
    if pad_mask is not None:
        col = torch.arange(4 * d, device=x.device) // d
        pad3 = pad_mask[..., None]
        wx = torch.where(pad3 & (col == 1), torch.full_like(wx, NEG), wx)
        wx = torch.where(pad3 & (col == 2), torch.full_like(wx, -NEG), wx)
    r = p["r"].to(F32)
    if state is None:
        zeros = torch.zeros((b, d), dtype=F32, device=x.device)
        state = (zeros, zeros, zeros, torch.full((b, d), NEG, dtype=F32, device=x.device))
    c, n, h_prev, m = (s.to(F32) for s in state)
    hs = []
    for step in range(t):
        pre = wx[:, step].reshape(b, 4, d) + _recurrent(h_prev.reshape(b, n_heads, hd), r)
        z_t = torch.tanh(pre[:, 0])
        i_t = pre[:, 1]
        f_t = F.logsigmoid(pre[:, 2])
        o_t = torch.sigmoid(pre[:, 3])
        m_new = torch.maximum(f_t + m, i_t)
        iw = torch.exp(i_t - m_new)
        fw = torch.exp(f_t + m - m_new)
        c = fw * c + iw * z_t
        n = fw * n + iw
        h_prev = o_t * (c / torch.clamp_min(n, 1e-12))
        m = m_new
        hs.append(h_prev)
    hs = torch.stack(hs, dim=1)  # (B, T, d)
    h_last = h_prev
    if pad_mask is not None:
        lengths = torch.sum(~pad_mask, dim=1)
        idx = torch.clamp(lengths - 1, 0, t - 1)
        h_real = hs[torch.arange(b, device=x.device), idx]
        h_last = torch.where((lengths > 0)[:, None], h_real, state[2].to(F32))
    y = hook("slstm_o", hs.to(x.dtype), p["w_o"])
    return y, (c, n, h_last, m)

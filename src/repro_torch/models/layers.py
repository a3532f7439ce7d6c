"""Model layers: RMS norm, RoPE, attention, the SwiGLU and GELU MLPs and
the chunked cross-entropy.

Port of the dense and windowed functions of ``repro/models/layers.py``.
Attention is plain tensor code in float32, computed the way the reference
computes it (an online softmax over (q-chunk x kv-chunk) blocks for
prefill, the (previous, current) chunk pairs of local attention, a masked
softmax for decode), with the KV heads grouped rather than expanded, so
the numbers follow the reference rather than a fused library kernel.
Attention runs one request at a time and norms sum in fixed stages
(``repro_torch.reduce``), so a request's bits do not depend on its batch.
Where a gradient is taken, prefill attention is the reference's flash
attention with its two-pass recompute backward (``_FlashAttention``).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.models.hooks import MatmulHook
from repro_torch.models import sharding
from repro_torch.models.sharding import Shards, tensor_parallel
from repro_torch.reduce import contraction, row_norm, row_sum

F32 = torch.float32
NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(F32)
    nrm = row_norm(x32, keepdim=True)
    var = nrm * nrm / x.shape[-1]
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given positions; shapes (..., T, head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=F32, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=F32, device=positions.device), exps)
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


def _per_request(fn, q, k, v, **kw) -> torch.Tensor:
    """``fn`` on each request (leading row) alone, concatenated. A batched
    GEMM or a long reduction may split its sums another way for another
    batch size, so a request's attention runs alone, in a batch too: its
    bits do not depend on its batch."""
    return torch.cat([fn(q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw) for i in range(q.shape[0])])


def _divisor_chunk(n: int, chunk: int) -> int:
    """The largest divisor of ``n`` not above ``chunk`` (the reference's rule)."""
    c = min(chunk, n)
    while n % c:
        c -= 1
    return c


def _chunk(n: int, chunk: int) -> int:
    """Rows of a block: the reference's rule, unless it leaves blocks under
    an eighth of the chunk (a length with no useful divisor, such as a
    prime); then the chunk itself, the last block short. The reference's
    scan runs one-row blocks at no cost a block, a Python loop cannot; the
    online softmax gives the same result either way, summed in another
    order."""
    c = _divisor_chunk(n, chunk)
    return c if c >= min(chunk, n) // 8 else min(chunk, n)


def _visible_blocks(t: int, s: int, qc: int, kc: int, window: Optional[int]):
    """The (q-chunk x kv-chunk) blocks the causal and ``window`` masks leave
    any pair in: ``[(q_lo, qn, [(k_lo, kn, partial), ...]), ...]`` per query
    chunk, ``partial`` when the masks cut the block (else every pair in it
    is visible). A skipped block leaves the online softmax as it is (p = 0,
    correction 1) and adds zero to every gradient, so the numbers are the
    same as over every block."""
    out = []
    for q_lo in range(0, t, qc):
        qn = min(qc, t - q_lo)
        q_hi = q_lo + qn - 1
        ks = []
        for k_lo in range(0, s, kc):
            kn = min(kc, s - k_lo)
            k_hi = k_lo + kn - 1
            if k_lo > q_hi:
                break  # this block and every later one are after every query
            if window is not None and q_lo - k_hi >= window:
                continue  # every key is a window or more behind every query
            ks.append((k_lo, kn, k_hi > q_lo or (window is not None and q_hi - k_lo >= window)))
        out.append((q_lo, qn, ks))
    return out


def _block_scores(qblk, kblk, q_lo, qn, k_lo, kn, partial, window, scale, shape):
    """Scaled scores of one block, (B, KH, G, qn, kn), masked where the
    block is ``partial``. qblk (B, KH, G*qn, D), kblk (B, KH, kn, D)."""
    sc = torch.matmul(qblk, kblk.transpose(-1, -2)).view(shape).mul_(scale)
    if partial:
        dev = qblk.device
        qp = torch.arange(q_lo, q_lo + qn, device=dev)[:, None]
        kp = torch.arange(k_lo, k_lo + kn, device=dev)[None, :]
        mask = qp >= kp
        if window is not None:
            mask &= (qp - kp) < window
        sc.masked_fill_(~mask, NEG_INF)
    return sc


def _grouped(q, k, v):
    """q (B, T, H, D) -> (B, KH, G, T, D); k, v (B, S, KH, D) -> (B, KH, S,
    D); all float32: the block products are batched matmuls."""
    b, t, h, d = q.shape
    kh = k.shape[2]
    q5 = q.reshape(b, t, kh, h // kh, d).permute(0, 2, 3, 1, 4).to(F32)
    return q5, k.permute(0, 2, 1, 3).to(F32), v.permute(0, 2, 1, 3).to(F32)


def _online_softmax(q, k, v, qc: int, kc: int, window: Optional[int]):
    """The forward's blocks: per query chunk (q_lo, qn, normalised output
    (B, KH, G, qn, D) f32, running max m and sum l (B, KH, G, qn))."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / (d**0.5)
    q5, kt, vt = _grouped(q, k, v)
    for q_lo, qn, ks in _visible_blocks(t, s, qc, kc, window):
        m = torch.full((b, kh, g, qn), NEG_INF, dtype=F32, device=q.device)
        l = torch.zeros((b, kh, g, qn), dtype=F32, device=q.device)
        acc = torch.zeros((b, kh, g, qn, d), dtype=F32, device=q.device)
        qblk = q5[:, :, :, q_lo:q_lo + qn].reshape(b, kh, g * qn, d)
        for k_lo, kn, partial in ks:
            sc = _block_scores(qblk, kt[:, :, k_lo:k_lo + kn], q_lo, qn, k_lo, kn, partial,
                               window, scale, (b, kh, g, qn, kn))
            m_new = torch.maximum(m, torch.amax(sc, dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.matmul(p.view(b, kh, g * qn, kn), vt[:, :, k_lo:k_lo + kn])
            acc = acc * corr[..., None] + pv.view(b, kh, g, qn, d)
            m = m_new
        yield q_lo, qn, acc / torch.clamp_min(l, 1e-30)[..., None], m, l


class _FlashAttention(torch.autograd.Function):
    """Chunked causal attention with the reference's flash backward
    (``_flash_attention``'s custom VJP): the forward is the serving
    forward's block loop, the whole batch at once, and saves only (q, k,
    v, out, lse); the backward recomputes each block's probabilities from
    (q, k, lse) in two passes, dq over the KV blocks of each query chunk,
    then dk and dv over the query chunks of each KV block. No tensor
    larger than one block of scores is held, and the KV heads stay grouped
    (their gradients sum over the G query heads of the group)."""

    @staticmethod
    def forward(ctx, q, k, v, qc: int, kc: int, window: Optional[int]):
        b, t, h, d = q.shape
        kh = k.shape[2]
        out = torch.empty((b, kh, h // kh, t, d), dtype=F32, device=q.device)
        lse = torch.empty((b, kh, h // kh, t), dtype=F32, device=q.device)
        for q_lo, qn, blk, m, l in _online_softmax(q, k, v, qc, kc, window):
            out[:, :, :, q_lo:q_lo + qn] = blk
            lse[..., q_lo:q_lo + qn] = m + torch.log(torch.clamp_min(l, 1e-30))
        out = out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (qc, kc, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        qc, kc, window = ctx.cfg
        b, t, h, d = q.shape
        s, kh = k.shape[1], k.shape[2]
        g = h // kh
        scale = 1.0 / (d**0.5)
        q5, kt, vt = _grouped(q, k, v)
        do5 = do.to(F32).reshape(b, t, kh, g, d).permute(0, 2, 3, 1, 4)
        delta = torch.sum(do5 * out.reshape(b, t, kh, g, d).permute(0, 2, 3, 1, 4), dim=-1)
        blocks = _visible_blocks(t, s, qc, kc, window)

        def chunk(q_lo, qn):
            rows = slice(q_lo, q_lo + qn)
            return (q5[:, :, :, rows].reshape(b, kh, g * qn, d),
                    do5[:, :, :, rows].reshape(b, kh, g * qn, d),
                    lse[..., rows, None], delta[..., rows, None])

        def probs(qblk, doblk, lse_c, dlt, q_lo, qn, k_lo, kn, partial):
            """(p, ds) of one block, (B, KH, G*qn, kn)."""
            shape = (b, kh, g, qn, kn)
            sc = _block_scores(qblk, kt[:, :, k_lo:k_lo + kn], q_lo, qn, k_lo, kn, partial,
                               window, scale, shape)
            p = torch.exp(sc - lse_c)
            dp = torch.matmul(doblk, vt[:, :, k_lo:k_lo + kn].transpose(-1, -2)).view(shape)
            ds = p * (dp - dlt)
            return p.view(b, kh, g * qn, kn), ds.view(b, kh, g * qn, kn)

        # pass 1: dq, query chunk by query chunk
        dq = torch.empty((b, kh, g, t, d), dtype=F32, device=q.device)
        for q_lo, qn, ks in blocks:
            qblk, doblk, lse_c, dlt = chunk(q_lo, qn)
            acc = torch.zeros((b, kh, g * qn, d), dtype=F32, device=q.device)
            for k_lo, kn, partial in ks:
                _, ds = probs(qblk, doblk, lse_c, dlt, q_lo, qn, k_lo, kn, partial)
                acc = acc + torch.matmul(ds, kt[:, :, k_lo:k_lo + kn]) * scale
            dq[:, :, :, q_lo:q_lo + qn] = acc.view(b, kh, g, qn, d)
        # pass 2: dk and dv, KV block by KV block
        dk = torch.zeros((b, kh, s, d), dtype=F32, device=q.device)
        dv = torch.zeros((b, kh, s, d), dtype=F32, device=q.device)
        by_kv = {}
        for q_lo, qn, ks in blocks:
            for k_lo, kn, partial in ks:
                by_kv.setdefault((k_lo, kn), []).append((q_lo, qn, partial))
        for (k_lo, kn), qs in sorted(by_kv.items()):
            dk_c = torch.zeros((b, kh, kn, d), dtype=F32, device=q.device)
            dv_c = torch.zeros((b, kh, kn, d), dtype=F32, device=q.device)
            for q_lo, qn, partial in qs:
                qblk, doblk, lse_c, dlt = chunk(q_lo, qn)
                p, ds = probs(qblk, doblk, lse_c, dlt, q_lo, qn, k_lo, kn, partial)
                dv_c = dv_c + torch.matmul(p.transpose(-1, -2), doblk)
                dk_c = dk_c + torch.matmul(ds.transpose(-1, -2), qblk) * scale
            dk[:, :, k_lo:k_lo + kn] = dk_c
            dv[:, :, k_lo:k_lo + kn] = dv_c
        dq = dq.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)
        return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
                dv.permute(0, 2, 1, 3).to(v.dtype), None, None, None)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_chunk: int,
                      kv_chunk: int, window: Optional[int] = None) -> torch.Tensor:
    """Causal prefill attention in (q-chunk x kv-chunk) blocks with an
    online softmax: the reference's ``chunked_attention``.

    q: (B, T, H, D); k/v: (B, S, KH, D), grouped (not expanded to the query
    heads): queries run as (B, T, KH, G, D). The chunks are the largest
    divisors of T (of S) not above ``q_chunk`` (``kv_chunk``), as in the
    reference (``_chunk``). Each query chunk keeps a running max, sum and
    P @ V accumulator in f32 over its KV blocks and normalises once at the
    end; the causal and ``window`` masks apply per block. A block the masks
    empty for every query of the chunk is skipped: the reference's scan
    leaves the running state unchanged there (p = 0, correction 1) or
    resets it at the first visible block (correction 0), so the numbers are
    the same. No tensor larger than one (B, KH, G, q-chunk, kv-chunk) block
    of scores is built.

    Without a gradient to take (serving) each request runs alone, so its
    bits do not depend on its batch. When q, k or v requires grad the
    whole batch runs through ``_FlashAttention``, whose backward is the
    reference's two recompute passes.
    """
    b, t, h, d = q.shape
    qc, kc = _chunk(t, q_chunk), _chunk(k.shape[1], kv_chunk)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, qc, kc, window).to(q.dtype)
    if b > 1:
        return _per_request(chunked_attention, q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk,
                            window=window)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    for q_lo, qn, blk, _m, _l in _online_softmax(q, k, v, qc, kc, window):
        out[:, q_lo:q_lo + qn] = blk.permute(0, 3, 1, 2, 4).reshape(b, qn, h, d).to(q.dtype)
    return out


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    """Sliding-window causal attention; q: (B, T, H, D), k/v: (B, T, KH, D)
    grouped. Short or unaligned sequences (``t <= window`` or ``t %
    window``) take the chunked path with ``q_chunk = min(t, window)``, as
    the reference does; otherwise each query chunk of ``window`` rows
    attends to its (previous, current) key chunks only, so the cost is
    linear in T."""
    b, t, h, d = q.shape
    if b > 1:
        return _per_request(local_attention, q, k, v, window=window)
    kh = k.shape[2]
    g = h // kh
    if t <= window or t % window:
        return chunked_attention(q, k, v, q_chunk=min(t, window),
                                 kv_chunk=min(k.shape[1], window), window=window)
    scale = 1.0 / (d**0.5)
    q5 = q.reshape(b, t, kh, g, d)
    outs = []
    for q_lo in range(0, t, window):
        k_lo = max(0, q_lo - window)
        qc = q5[:, q_lo:q_lo + window]
        kc = k[:, k_lo:q_lo + window]
        vc = v[:, k_lo:q_lo + window]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc.to(F32), kc.to(F32)) * scale
        qp = torch.arange(window, device=q.device) + q_lo
        kp = torch.arange(kc.shape[1], device=q.device) + k_lo
        mask = (qp[:, None] >= kp[None, :]) & ((qp[:, None] - kp[None, :]) < window)
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=F32, device=q.device))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", p, vc.to(F32)))
    return torch.cat(outs, dim=1).reshape(b, t, h, d).to(q.dtype)


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
    behind it are masked. The products are taken elementwise and summed
    with ``row_sum`` (over D for the scores, over S for softmax and P @ V),
    not by a batched GEMM, whose split of the sums may change with B.
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
    q5 = q.reshape(b, kh, g, 1, d).to(F32)
    kt = k_cache.permute(0, 2, 1, 3).to(F32)[:, :, None]  # (B, KH, 1, S, D)
    scores = row_sum(contraction(q5 * kt)) * scale  # (B, KH, G, S)
    valid = (slot_pos <= pos_b) & (slot_pos >= 0)
    if window is not None:
        valid &= (pos_b - slot_pos) < window
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    e = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    p = e / row_sum(e, keepdim=True)
    vt = v_cache.permute(0, 2, 3, 1).to(F32)[:, :, None]  # (B, KH, 1, D, S)
    out = row_sum(contraction(p[:, :, :, None, :] * vt))  # (B, KH, G, D)
    return out.reshape(b, 1, h, d).to(q.dtype)


def _mlp_hidden(x, p, shard, *, hook, prefix, mlp_type):
    """The MLP up to its down projection's input (on tensor shard
    ``shard``'s columns, or whole)."""
    if mlp_type == "swiglu":
        gate = hook(f"{prefix}_gate", x, p["w_gate"], shard=shard)
        up = hook(f"{prefix}_up", x, p["w_up"], shard=shard)
        return torch.nn.functional.silu(gate.to(F32)).to(x.dtype) * up
    h = hook(f"{prefix}_in", x, p["w_in"], shard=shard)
    if "b_in" in p:
        h = h + p["b_in"].to(h.dtype)
    return torch.nn.functional.gelu(h.to(F32), approximate="tanh").to(x.dtype)


def mlp(x: torch.Tensor, p: dict, hook: MatmulHook, prefix: str = "mlp",
        mlp_type: str = "swiglu") -> torch.Tensor:
    """SwiGLU, ``down(silu(gate(x)) * up(x))``, or GELU,
    ``out(gelu(in(x) + b_in)) + b_out`` with the tanh form of GELU (the
    reference's ``jax.nn.gelu``) in f32; the biases are optional leaves.
    Tensor shards (``Shards`` leaves): gate, up, in and ``b_in`` are column
    shards, down a row shard (``tensor_parallel``), ``b_out`` added once
    after the shards' sum."""
    y = tensor_parallel(lambda xi, pi, s: _mlp_hidden(xi, pi, s, hook=hook, prefix=prefix,
                                                      mlp_type=mlp_type),
                        x, p, hook, f"{prefix}_out", "w_down")
    if "b_out" in p:
        y = y + p["b_out"].to(y.dtype)
    return y


def chunked_xent(h: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor, *, chunk: int,
                 vocab: int, n_codebooks: int = 1, hook: Optional[MatmulHook] = None,
                 ignore_label: int = -1) -> torch.Tensor:
    """Mean token NLL without materialising (B, T, V) logits; port of the
    reference's ``chunked_xent``.

    h: (B, T, d); lm_head: (d, n_codebooks * vocab_padded), the pad
    columns beyond ``vocab`` masked out of the logsumexp; labels (B, T) or
    (B, T, n_codebooks), ``ignore_label`` entries counted in neither the
    sum nor the mean. The sequence runs in chunks of the largest divisor
    of T not above ``chunk``; each chunk's logits (``hook("lm_head", ...)``,
    float32) are recomputed in the backward (``sharding.remat``),
    so no chunk's logits outlive its forward. A ``Shards`` head (its
    columns cut among the tensor shards) takes the vocab-parallel loss,
    ``_vocab_parallel_nll``.
    """
    b, t, _ = h.shape
    hook = hook or MatmulHook()
    chunk = _divisor_chunk(t, chunk)
    if labels.dim() == 2:
        labels = labels[..., None]

    def chunk_nll(hc, lc):
        logits = hook("lm_head", hc, lm_head).to(F32)
        logits = logits.reshape(b, chunk, n_codebooks, vocab_padded)
        if vocab_padded != vocab:
            pad = torch.arange(vocab_padded, device=logits.device) < vocab
            logits = logits.masked_fill(~pad, NEG_INF)
        logz = torch.logsumexp(logits, dim=-1)
        lbl = torch.clamp(lc, 0, vocab - 1).long()
        gold = torch.gather(logits, -1, lbl[..., None])[..., 0]
        mask = (lc != ignore_label).to(F32)
        return torch.sum((logz - gold) * mask), torch.sum(mask)

    if isinstance(lm_head, Shards):  # its columns cut among the tensor shards
        vocab_padded = lm_head[0].shape[-1] * lm_head.shards[0].tp // n_codebooks
        chunk_nll = functools.partial(_vocab_parallel_nll, heads=lm_head, hook=hook, vocab=vocab,
                                      vocab_padded=vocab_padded, ignore_label=ignore_label)
    else:
        vocab_padded = lm_head.shape[-1] // n_codebooks
    tot = torch.zeros((), dtype=F32, device=h.device)
    cnt = torch.zeros((), dtype=F32, device=h.device)
    for lo in range(0, t, chunk):
        hc, lc = h[:, lo:lo + chunk], labels[:, lo:lo + chunk]
        if torch.is_grad_enabled() and hc.requires_grad:
            t_, c_ = sharding.remat(chunk_nll, hc, lc)
        else:
            t_, c_ = chunk_nll(hc, lc)
        tot, cnt = tot + t_, cnt + c_
    return tot / torch.clamp_min(cnt, 1.0)


def _by_codebook(x: torch.Tensor, c0: int, vocab_padded: int, n_codebooks: int, reduce,
                 fill: float) -> torch.Tensor:
    """``reduce`` over the last dim of ``x`` (columns ``[c0, c0 + n)`` of
    the head) within each codebook: (..., n_codebooks), ``fill`` where a
    codebook has no column here."""
    n = x.shape[-1]
    out = []
    for k in range(n_codebooks):
        lo, hi = max(c0, k * vocab_padded), min(c0 + n, (k + 1) * vocab_padded)
        out.append(reduce(x[..., lo - c0:hi - c0], dim=-1) if lo < hi else
                   torch.full(x.shape[:-1], fill, dtype=x.dtype, device=x.device))
    return torch.stack(out, dim=-1)


def _vocab_parallel_nll(hc, lc, *, heads, hook, vocab: int, vocab_padded: int,
                        ignore_label: int):
    """One chunk's (sum of NLL, count) with the lm_head's columns cut among
    the tensor shards (``heads``: each shard's (d, C / tp) slice of the
    (d, n_codebooks * vocab_padded) head; a slice may cut across a codebook
    boundary). Megatron's vocab-parallel loss: each shard's logits, a local
    max a codebook, the max over tp; a local sum of exp, the sum over tp;
    the gold logit from the shard that holds it, summed over tp. Pad
    columns (``>= vocab`` within a codebook) are masked on their shard."""
    from repro_torch.launch import collectives

    shards = heads.shards
    n_cb = lc.shape[-1]
    cols = heads[0].shape[-1]
    logits, maxes = [], []
    for x, w, s in zip(collectives.copy_to_tp(hc, shards), heads, shards):
        lg = hook("lm_head", x, w, shard=s).to(F32)
        c0 = s.t * cols
        if vocab_padded != vocab:
            col = torch.arange(c0, c0 + cols, device=lg.device)
            lg = lg.masked_fill(col % vocab_padded >= vocab, NEG_INF)
        logits.append(lg)
        maxes.append(_by_codebook(lg, c0, vocab_padded, n_cb, torch.amax, NEG_INF))
    gmax = collectives.max_over_tp(maxes, shards)  # (b, chunk, n_cb), no gradient
    sums, golds = [], []
    lbl = torch.clamp(lc, 0, vocab - 1).long()
    for lg, s in zip(logits, shards):
        c0 = s.t * cols
        cb = torch.arange(c0, c0 + cols, device=lg.device) // vocab_padded
        e = torch.exp(lg - gmax.index_select(-1, cb))
        sums.append(_by_codebook(e, c0, vocab_padded, n_cb, torch.sum, 0.0))
        at = lbl + torch.arange(n_cb, device=lg.device) * vocab_padded - c0
        hit = (at >= 0) & (at < cols)
        gold = torch.gather(lg, -1, torch.clamp(at, 0, cols - 1))
        golds.append(torch.where(hit, gold, torch.zeros((), dtype=F32, device=lg.device)))
    logz = torch.log(collectives.reduce_from_tp(sums, shards)) + gmax
    gold = collectives.reduce_from_tp(golds, shards)
    mask = (lc != ignore_label).to(F32)
    return torch.sum((logz - gold) * mask), torch.sum(mask)

"""Mixture-of-Experts block: GShard-style grouped dispatch with
capacity-factor token dropping, top-k routing and optional shared experts.

Port of ``repro/models/moe.py`` (its forward; the reference's sharding
annotations do nothing on one card and are left out, and the load-balance
loss is training's). Tokens are routed in groups of ``moe_group_size``;
each expert takes at most ``capacity`` tokens of a group, earlier routing
slots first, and a token past its expert's capacity is dropped there.

Tensor shards (training, ``models/sharding.py``): each expert's gate, up
and in are column shards and its down a row shard on "expert_mlp", the
shards' outputs summed by *g* before the combine; the router and the
dispatch stay whole and run the same bits on every shard. The experts
stay whole across data shards, as in the data-parallel step: expert
parallelism over "data" and the "expert_embed" cut are ROADMAP A.4, A.5.

Analog integration: the expert matmuls run through ``hook.batched`` with
per-expert energies, one batch-level noise stream per site (capacity
buffers mix requests; ``hooks.AnalogHook.batched``).

The expert buffers are filled by the reference's dispatch product (each
slot holds one token or zeros, so the sum is exact in any order). The
combine gathers each token's k (times ``moe_ff_split``) expert outputs
and adds them in a fixed order, slot by slot: a token's bits do not
depend on how many tokens share its group or how the experts' capacity
is laid out, which a GEMM over the (expert, slot) axis would not promise.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.hooks import MatmulHook
from repro_torch.models.layers import mlp
from repro_torch.models.sharding import tensor_parallel
from repro_torch.reduce import row_sum

F32 = torch.float32


def router_topk(logits: torch.Tensor, top_k: int):
    """(gate weights, expert ids) of the ``top_k`` most probable experts;
    the weights renormalized over the k. Ties go to the lower expert index,
    as ``jax.lax.top_k`` breaks them (a stable descending sort). The
    softmax sums in fixed stages (``row_sum``): a token's probabilities do
    not depend on how many tokens are routed at once."""
    z = logits.to(F32)
    e = torch.exp(z - torch.amax(z, dim=-1, keepdim=True))
    probs = e / row_sum(e, keepdim=True)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, ids = vals[..., :top_k], ids[..., :top_k]
    if top_k > 1:
        gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return gate_vals, ids


def route_slots(ids: torch.Tensor, n_experts: int, capacity: int,
                valid: Optional[torch.Tensor] = None):
    """Each (token, slot)'s place in its expert's queue: ``(pos, keep)``,
    each (G, S, k); ``keep`` False where the expert is full or the token
    is not ``valid`` (bucket padding takes no capacity and shifts no real
    token's place). Earlier slots get capacity first."""
    g, s, k = ids.shape
    counts = torch.zeros((g, n_experts), dtype=torch.int64, device=ids.device)
    pos_all, keep_all = [], []
    for slot in range(k):
        onehot = F.one_hot(ids[..., slot], n_experts)  # (G, S, E) int64
        if valid is not None:
            onehot = onehot * valid.to(onehot.dtype)[..., None]
        pos = torch.cumsum(onehot, dim=1) - onehot + counts[:, None, :]  # exclusive cumsum
        keep = (pos < capacity) & (onehot > 0)
        counts = counts + torch.sum(onehot * keep, dim=1)
        pos_all.append(torch.sum(pos * onehot, dim=-1))
        keep_all.append(torch.any(keep, dim=-1))
    return torch.stack(pos_all, dim=-1), torch.stack(keep_all, dim=-1)


def _slot_places(ids, pos, keep, n_experts: int, capacity: int):
    """Each routing slot's (G, S, E, C) bool table: the (expert, capacity
    position) its token takes; a dropped token's row is empty, as
    ``jax.nn.one_hot`` gives a position past the capacity."""
    cap = torch.arange(capacity, device=ids.device)
    return [(F.one_hot(ids[..., s], n_experts).bool() & keep[..., s, None])[..., None]
            & (pos[..., s, None, None] == cap) for s in range(ids.shape[-1])]


def make_dispatch(ids: torch.Tensor, gate_vals: torch.Tensor, n_experts: int, capacity: int,
                  valid: Optional[torch.Tensor] = None):
    """GShard dispatch and combine tensors, each (G, S, E, C) float32, from
    ids / gate_vals (G, S, k)."""
    pos, keep = route_slots(ids, n_experts, capacity, valid)
    combine = sum(at.to(F32) * gate_vals[..., s, None, None]
                  for s, at in enumerate(_slot_places(ids, pos, keep, n_experts, capacity)))
    return (combine > 0.0).to(F32), combine


def _expert_ff(xe: torch.Tensor, p, cfg: ModelConfig, hook: MatmulHook) -> torch.Tensor:
    """Every expert's FF on its buffer: (E * split, G, C, d) -> the same."""
    if cfg.mlp_type == "swiglu":
        gate = hook.batched("moe_gate", xe, p["w_gate"])
        up = hook.batched("moe_up", xe, p["w_up"])
        h = F.silu(gate.to(F32)).to(xe.dtype) * up
    else:
        h = hook.batched("moe_in", xe, p["w_in"])
        h = F.gelu(h.to(F32), approximate="tanh").to(xe.dtype)
    return hook.batched("moe_down", h, p["w_down"])


def moe_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig, hook: MatmulHook,
              pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d).

    ``pad_mask`` (B, T): True marks bucket padding, excluded from dispatch
    (no capacity, zero output), so a real token's routing depends only on
    the real tokens of its group."""
    b, t, d = x.shape
    n_tok = b * t
    gs = min(cfg.moe_group_size, n_tok)
    while n_tok % gs:  # the largest divisor of n_tok not above the target
        gs -= 1
    g = n_tok // gs
    e, k, split = cfg.n_experts, cfg.top_k, cfg.moe_ff_split
    cap = max(1, int(-(-gs * k * cfg.capacity_factor // e)))

    # route on the (B, T, d) layout: the router is a per-request site
    logits = hook("router", x, p["router"]).reshape(g, gs, e)
    gate_vals, ids = router_topk(logits, k)
    valid = None if pad_mask is None else (~pad_mask).reshape(g, gs)
    pos, keep = route_slots(ids, e, cap, valid)

    # expert buffers (E * split, G, C, d): virtual expert v = id * split + j
    # takes every token routed to expert id
    dispatch = sum(at.to(x.dtype) for at in _slot_places(ids, pos, keep, e, cap))
    if split > 1:
        dispatch = torch.repeat_interleave(dispatch, split, dim=2)
    xe = torch.einsum("gsd,gsec->gecd", x.reshape(g, gs, d), dispatch).transpose(0, 1)

    experts = {k: p[k] for k in ("w_gate", "w_up", "w_in", "w_down") if k in p}
    ye = tensor_parallel(lambda xi, pi, _s: _expert_ff(xi, pi, cfg, hook), xe, experts)

    # combine: each token's kept slots, its expert's split partials in
    # order, weighted by the gate value in the activation dtype
    rows = ye.transpose(0, 1).reshape(g, e * split * cap, d)
    y = torch.zeros((g, gs, d), dtype=F32, device=x.device)
    for slot in range(k):
        wgt = (gate_vals[..., slot] * keep[..., slot]).to(x.dtype).to(F32)[..., None]
        for j in range(split):
            flat = (ids[..., slot] * split + j) * cap + torch.clamp(pos[..., slot], max=cap - 1)
            y = y + wgt * torch.gather(rows, 1, flat[..., None].expand(g, gs, d)).to(F32)
    y = y.to(x.dtype).reshape(b, t, d)
    if cfg.n_shared_experts:
        y = y + mlp(x, p["shared"], hook, prefix="moe_shared", mlp_type=cfg.mlp_type)
    return y

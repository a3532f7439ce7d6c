"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 — early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

400B total / 17B active with these dims requires interleaved MoE (every
2nd layer) and 1 shared expert, matching the public Llama-4 description;
MoE in every layer would be ~790B. Totals: ~397B params, ~17B active. The
smoke config's ``loss_chunk`` is left out: the port has no such field.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp_type="swiglu",
    n_experts=128,
    top_k=1,
    moe_every=2,
    n_shared_experts=1,
    capacity_factor=1.25,
    rope_theta=500000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke", family="moe", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, mlp_type="swiglu",
        n_experts=4, top_k=1, moe_every=2, n_shared_experts=1,
        capacity_factor=2.0, moe_group_size=64,
        attn_q_chunk=32, attn_kv_chunk=32, loss_chunk=32,
    )

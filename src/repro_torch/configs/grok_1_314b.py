"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2. [hf:xai-org/grok-1; unverified]

The smoke config's ``loss_chunk`` is left out: the port has no such field.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    mlp_type="swiglu",  # grok-1 experts are gated 3-matrix MLPs (~309B of the 314B)
    n_experts=8,
    top_k=2,
    moe_every=1,
    capacity_factor=1.25,
    moe_ff_split=2,  # 16 virtual experts
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok1-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, mlp_type="swiglu",
        n_experts=4, top_k=2, moe_every=1, capacity_factor=2.0,
        moe_group_size=64, attn_q_chunk=32, attn_kv_chunk=32,
    )

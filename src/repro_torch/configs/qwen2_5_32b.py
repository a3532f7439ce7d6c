"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    mlp_type="swiglu",
    qkv_bias=True,
    rope_theta=1000000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen32-smoke", family="dense", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        mlp_type="swiglu", qkv_bias=True,
        attn_q_chunk=32, attn_kv_chunk=32, loss_chunk=32,
    )

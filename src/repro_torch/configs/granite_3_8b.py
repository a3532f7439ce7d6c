"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155. [hf:ibm-granite/granite-3.0-8b-base]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    n_layers=40,
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    mlp_type="swiglu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite3-smoke", family="dense", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        mlp_type="swiglu", attn_q_chunk=32, attn_kv_chunk=32, loss_chunk=32,
    )

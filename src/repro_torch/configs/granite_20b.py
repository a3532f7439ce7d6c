"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — code model. [arXiv:2405.04324; hf]

d_ff = 4*d and the MQA layout match the GPTBigCode-style granite-20b-code:
GELU MLP (a SwiGLU reading of d_ff would give ~28B params, not 20B).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite20-smoke", family="dense", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=256, vocab_size=256,
        mlp_type="gelu", attn_q_chunk=32, attn_kv_chunk=32, loss_chunk=32,
    )

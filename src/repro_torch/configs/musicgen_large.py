"""musicgen-large [audio]: 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens (4 codebooks, delay pattern).
[arXiv:2306.05284; hf]

The frontend is a stub: callers pass precomputed frame embeddings
(``{"embeds"}``, the EnCodec + codebook-embedding sum); the model owns the
transformer backbone + 4 parallel codebook heads.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="dense",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_type="gelu",
    frontend="frames",
    n_codebooks=4,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=64,
        mlp_type="gelu", frontend="frames", n_codebooks=4,
        attn_q_chunk=32, attn_kv_chunk=32, loss_chunk=32,
    )

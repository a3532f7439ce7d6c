"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT + InternLM2. [arXiv:2404.16821; hf]

The InternViT frontend is a stub: callers pass precomputed patch embeddings
(``{"patch_embeds"}``, 256 tokens) that go ahead of the text stream; the
model owns the InternLM2-style decoder backbone.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    mlp_type="swiglu",
    frontend="patch",
    n_frontend_tokens=256,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        mlp_type="swiglu", frontend="patch", n_frontend_tokens=8,
        attn_q_chunk=32, attn_kv_chunk=32, loss_chunk=32,
    )

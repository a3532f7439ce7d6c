"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427; hf]

26 layers = 8 x (rec, rec, attn) + 2 trailing recurrent layers. Local
attention window 2048. Sub-quadratic: the RG-LRU state and the bounded
attention window keep decode's state constant in the sequence length.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="griffin",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mlp_type="swiglu",
    tie_embeddings=True,
    rnn_width=2560,
    conv_width=4,
    local_window=2048,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rgemma-smoke", family="griffin", n_layers=8, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
        mlp_type="swiglu", rnn_width=64, conv_width=4, local_window=32,
        attn_q_chunk=32, attn_kv_chunk=32, loss_chunk=32,
    )

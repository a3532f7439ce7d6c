"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks at 7:1 (one sLSTM per 8 blocks; xLSTM[7:1]). [arXiv:2405.04517;
unverified]

d_ff=0: blocks carry their own expansion (no separate MLP). Sub-quadratic:
constant-size matrix and scalar memory states. Trained data-parallel
(``sharding_profile="dp"``: at 1.3 B parameters tensor shards would cost
more in collectives than they save).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="xlstm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    slstm_ratio=8,
    sharding_profile="dp",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="xlstm", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=0, vocab_size=256,
        slstm_ratio=2, attn_q_chunk=32, attn_kv_chunk=32, loss_chunk=32,
    )

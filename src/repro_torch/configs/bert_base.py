"""bert-base (the paper's own NLP model, §VI Table IV): 12L d_model=768
12H d_ff=3072 vocab=30522, GELU. The reference's paper-validation model
(shot-noise analog inference + Eq.-14 calibration); its registry lists it
under ``EXTRA_ARCHS``. The port runs it as the reference does: the dense
family's causal stack."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="bert-base",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=30522,
    mlp_type="gelu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="bert-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, mlp_type="gelu",
        attn_q_chunk=32, attn_kv_chunk=32, loss_chunk=32,
    )

"""Model configuration; port of ``repro/models/config.py`` (the fields the
dense family reads, with the reference's defaults)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # only "dense" is ported so far
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    mlp_type: str = "swiglu"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family != "dense" or self.mlp_type != "swiglu":
            raise ValueError(
                f"{self.name}: only the dense SwiGLU family is ported "
                f"(got family={self.family!r}, mlp_type={self.mlp_type!r})"
            )

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def padded_vocab(self) -> int:
        """Embedding/LM-head rows padded to a multiple of 16 (pad logits are
        sliced off before argmax)."""
        return -(-self.vocab_size // 16) * 16

    def param_count(self) -> int:
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        qh, kh = self.n_heads, self.n_kv_heads
        attn = d * qh * hd + 2 * d * kh * hd + qh * hd * d
        per_layer = attn + 3 * d * ff + 2 * d
        return int(2 * self.vocab_size * d + self.n_layers * per_layer)

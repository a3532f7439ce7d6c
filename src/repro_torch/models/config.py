"""Model configuration; port of ``repro/models/config.py`` (the fields the
dense and griffin families read, with the reference's defaults)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
#: families the port serves; moe and xlstm are not ported yet
FAMILIES = ("dense", "griffin")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "griffin"
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
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- griffin (RecurrentGemma) -------------------------------------------
    rnn_width: Optional[int] = None  # RG-LRU width; default d_model
    conv_width: int = 4
    local_window: int = 2048
    #: layers per group: (recurrent, recurrent, attention)
    griffin_pattern: Tuple[str, ...] = ("rec", "rec", "attn")

    #: window of the dense family's attention (a ring cache of this many
    #: slots); None is global causal attention
    sliding_window: Optional[int] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "griffin" and self.rnn_width is None:
            object.__setattr__(self, "rnn_width", self.d_model)
        if self.family not in FAMILIES or self.mlp_type != "swiglu":
            raise ValueError(
                f"{self.name}: only the dense and griffin families with a SwiGLU MLP "
                f"are ported (got family={self.family!r}, mlp_type={self.mlp_type!r})"
            )
        if self.family == "griffin" and set(self.griffin_pattern) - {"rec", "attn"}:
            raise ValueError(f"{self.name}: bad griffin_pattern {self.griffin_pattern!r}")

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def padded_vocab(self) -> int:
        """Embedding/LM-head rows padded to a multiple of 16 (pad logits are
        sliced off before argmax)."""
        return -(-self.vocab_size // 16) * 16

    def param_count(self) -> int:
        """The reference's count (it leaves out the final norm and the
        vocabulary padding)."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        qh, kh = self.n_heads, self.n_kv_heads
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size  # lm head
        attn = d * qh * hd + 2 * d * kh * hd + qh * hd * d
        mlp = 3 * d * ff
        if self.family == "dense":
            return int(n + self.n_layers * (attn + mlp + 2 * d))
        rw = self.rnn_width
        # branch projections + RG-LRU gate matrices + conv + out proj
        rec = 2 * d * rw + 2 * rw * rw + rw * d + 3 * rw + self.conv_width * rw + rw
        n_attn = self.n_layers // len(self.griffin_pattern)
        n_rec = self.n_layers - n_attn
        return int(n + n_rec * (rec + mlp + 2 * d) + n_attn * (attn + mlp + 2 * d))

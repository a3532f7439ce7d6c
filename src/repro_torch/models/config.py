"""Model configuration; port of ``repro/models/config.py`` (the fields the
dense and griffin families read, with the reference's defaults)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
#: families the port serves; moe and xlstm are not ported yet
FAMILIES = ("dense", "griffin")
FRONTENDS = ("none", "patch", "frames")


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
    mlp_type: str = "swiglu"  # "swiglu" | "gelu" (dense only)
    qkv_bias: bool = False
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

    # --- frontends (dense only) ---------------------------------------------
    frontend: str = "none"  # "none" | "patch" (image prefix) | "frames" (audio)
    n_frontend_tokens: int = 256  # prefix length for "patch"
    n_codebooks: int = 1  # output heads (musicgen: 4)

    # --- attention ------------------------------------------------------------
    #: prefill attention's block sizes (the largest divisors of T and S not
    #: above them are taken)
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    #: the reference's triangular block scan; the port always skips the
    #: blocks the masks empty, which leaves the numbers unchanged
    causal_skip: bool = False
    #: window of the dense family's attention (a ring cache of this many
    #: slots); None is global causal attention
    sliding_window: Optional[int] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "griffin" and self.rnn_width is None:
            object.__setattr__(self, "rnn_width", self.d_model)
        mlps = ("swiglu", "gelu") if self.family == "dense" else ("swiglu",)
        if self.family not in FAMILIES or self.mlp_type not in mlps:
            raise ValueError(
                f"{self.name}: only the dense family (SwiGLU or GELU MLP) and griffin "
                f"(SwiGLU) are ported (got family={self.family!r}, mlp_type={self.mlp_type!r})"
            )
        if self.frontend not in FRONTENDS:
            raise ValueError(f"{self.name}: bad frontend {self.frontend!r}")
        if self.family != "dense" and (self.qkv_bias or self.frontend != "none"
                                       or self.n_codebooks != 1):
            raise ValueError(f"{self.name}: QKV bias, frontends and codebook heads are ported "
                             "for the dense family only")
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
            n += d * self.vocab_size * self.n_codebooks  # lm head(s)
        attn = d * qh * hd + 2 * d * kh * hd + qh * hd * d
        if self.family == "dense":
            if self.qkv_bias:
                attn += (qh + 2 * kh) * hd
            mlp_mats = 3 if self.mlp_type == "swiglu" else 2
            return int(n + self.n_layers * (attn + mlp_mats * d * ff + 2 * d))
        mlp = 3 * d * ff
        rw = self.rnn_width
        # branch projections + RG-LRU gate matrices + conv + out proj
        rec = 2 * d * rw + 2 * rw * rw + rw * d + 3 * rw + self.conv_width * rw + rw
        n_attn = self.n_layers // len(self.griffin_pattern)
        n_rec = self.n_layers - n_attn
        return int(n + n_rec * (rec + mlp + 2 * d) + n_attn * (attn + mlp + 2 * d))

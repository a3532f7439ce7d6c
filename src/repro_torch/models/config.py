"""Model configuration; port of ``repro/models/config.py`` (the fields the
dense, griffin, xlstm and moe families read, with the reference's
defaults)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
#: families the port serves: every family of the reference
FAMILIES = ("dense", "griffin", "xlstm", "moe")
FRONTENDS = ("none", "patch", "frames")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "griffin" | "xlstm" | "moe"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    mlp_type: str = "swiglu"  # "swiglu" | "gelu" (dense and moe)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 1
    moe_every: int = 1  # 2: dense and MoE layers interleaved (llama4)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    #: tokens a routing group (the largest divisor of B*T not above it)
    moe_group_size: int = 256
    #: each expert's FF dim split into this many "virtual experts"; their
    #: down-projection partial sums are added by the combine (grok: 8 -> 16)
    moe_ff_split: int = 1

    # --- griffin (RecurrentGemma) -------------------------------------------
    rnn_width: Optional[int] = None  # RG-LRU width; default d_model
    conv_width: int = 4
    local_window: int = 2048
    #: layers per group: (recurrent, recurrent, attention)
    griffin_pattern: Tuple[str, ...] = ("rec", "rec", "attn")

    # --- xlstm ---------------------------------------------------------------
    slstm_ratio: int = 8  # one sLSTM block per `slstm_ratio` blocks (7:1 -> 8)

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
        mlps = ("swiglu", "gelu") if self.family in ("dense", "moe") else ("swiglu",)
        if self.family not in FAMILIES or self.mlp_type not in mlps:
            raise ValueError(
                f"{self.name}: the ported families are dense and moe (SwiGLU or GELU MLP), "
                f"griffin and xlstm (got family={self.family!r}, mlp_type={self.mlp_type!r})"
            )
        if self.frontend not in FRONTENDS:
            raise ValueError(f"{self.name}: bad frontend {self.frontend!r}")
        if self.family != "dense" and (self.qkv_bias or self.frontend != "none"
                                       or self.n_codebooks != 1):
            raise ValueError(f"{self.name}: QKV bias, frontends and codebook heads are ported "
                             "for the dense family only")
        if self.family == "griffin" and set(self.griffin_pattern) - {"rec", "attn"}:
            raise ValueError(f"{self.name}: bad griffin_pattern {self.griffin_pattern!r}")
        if self.family == "moe":
            self._check_moe()
        if self.family == "xlstm" and (self.slstm_ratio < 1 or self.n_layers < self.slstm_ratio
                                       or self.n_layers % self.slstm_ratio
                                       or self.d_model % self.n_heads):
            raise ValueError(f"{self.name}: xlstm needs whole groups of slstm_ratio="
                             f"{self.slstm_ratio} layers and heads that divide d_model")

    def _check_moe(self):
        """The reference's layout needs whole groups of ``moe_every`` layers
        and FF splits that divide d_ff; its shared-expert sites are named
        for a gated MLP (``moe_shared_gate/up/out``)."""
        bad = []
        if not 1 <= self.top_k <= self.n_experts:
            bad.append(f"top_k={self.top_k} of n_experts={self.n_experts}")
        if self.moe_every < 1 or self.n_layers < self.moe_every or self.n_layers % self.moe_every:
            bad.append(f"n_layers={self.n_layers} in groups of moe_every={self.moe_every}")
        if self.moe_ff_split < 1 or self.d_ff % self.moe_ff_split:
            bad.append(f"d_ff={self.d_ff} in moe_ff_split={self.moe_ff_split} parts")
        if self.n_shared_experts and self.mlp_type != "swiglu":
            bad.append("shared experts with a GELU MLP")
        if bad:
            raise ValueError(f"{self.name}: bad moe config: {'; '.join(bad)}")

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def padded_vocab(self) -> int:
        """Embedding/LM-head rows padded to a multiple of 16 (pad logits are
        sliced off before argmax)."""
        return -(-self.vocab_size // 16) * 16

    @property
    def sub_quadratic(self) -> bool:
        """Whether decode's state stays constant in the context length
        (the recurrent families)."""
        return self.family in ("xlstm", "griffin")

    def param_count(self) -> int:
        """The reference's count (it leaves out the final norm and the
        vocabulary padding)."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        qh, kh = self.n_heads, self.n_kv_heads
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size * self.n_codebooks  # lm head(s)
        attn = d * qh * hd + 2 * d * kh * hd + qh * hd * d
        if self.qkv_bias:
            attn += (qh + 2 * kh) * hd
        mlp_mats = 3 if self.mlp_type == "swiglu" else 2
        if self.family == "dense":
            return int(n + self.n_layers * (attn + mlp_mats * d * ff + 2 * d))
        if self.family == "moe":
            n_moe = self.n_layers // self.moe_every
            moe = (self.n_experts + self.n_shared_experts) * mlp_mats * d * ff + d * self.n_experts
            return int(n + self.n_layers * (attn + 2 * d) + (self.n_layers - n_moe) * mlp_mats * d
                       * ff + n_moe * moe)
        if self.family == "xlstm":
            # mLSTM: z/q/k/v/o projections and per-head gates; sLSTM: W (d, 4d),
            # the block-diagonal R (4, H, hd, hd) and the out projection
            hd_m = d // self.n_heads
            mlstm = 5 * d * d + 2 * d * self.n_heads + 2 * d
            slstm = 4 * d * d + 4 * self.n_heads * hd_m * hd_m + d * d + 2 * d
            n_s = self.n_layers // self.slstm_ratio
            return int(n + (self.n_layers - n_s) * mlstm + n_s * slstm)
        mlp = 3 * d * ff
        rw = self.rnn_width
        # branch projections + RG-LRU gate matrices + conv + out proj
        rec = 2 * d * rw + 2 * rw * rw + rw * d + 3 * rw + self.conv_width * rw + rw
        n_attn = self.n_layers // len(self.griffin_pattern)
        n_rec = self.n_layers - n_attn
        return int(n + n_rec * (rec + mlp + 2 * d) + n_attn * (attn + mlp + 2 * d))

    def active_param_count(self) -> int:
        """Parameters a token runs through (MoE: its top_k experts and the
        shared ones, not the others)."""
        if self.family != "moe":
            return self.param_count()
        mlp_mats = 3 if self.mlp_type == "swiglu" else 2
        n_moe = self.n_layers // self.moe_every
        inactive = n_moe * (self.n_experts - self.top_k) * mlp_mats * self.d_model * self.d_ff
        return int(self.param_count() - inactive)

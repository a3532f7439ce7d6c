"""Execution tiers; port of ``repro/serving/tiers.py`` for uniform K.

A tier is one servable execution configuration: how a batch's prefill and
decode steps run (``analog_spec``: the noise model of the forward, or
None for digital execution). ``UniformKTier`` is the paper's uniform
dynamic-precision dial (every analog site runs K repeats averaged in the
kernel); its decode steps fold each row's position into the row's key, so
every generated token draws fresh noise. ``DigitalTier`` is the base tier
of a digital engine. The ``TierRegistry`` maps tier ids to tiers.

PyTorch runs eagerly, so a tier executes directly; there is no compiled
executable cache as in the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.analog import fold_key
from repro_torch.models import lm


class ExecutionTier:
    """One servable execution configuration of one engine."""

    def __init__(self, engine, tier_id):
        self.engine = engine
        self.tier_id = tier_id

    def analog_spec(self, keys: np.ndarray, pos=None):
        """AnalogSpec of this tier's forwards (None: digital). ``keys`` are
        the batch's stacked raw keys, ``pos`` the decode positions (B,)."""
        return None

    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor, keys: np.ndarray, cache_len: int):
        """Prefill a bucket batch -> (cache, last-token logits (B, V) f32)."""
        eng = self.engine
        cache, h_last = lm.prefill(
            eng.params, tokens, eng.model_cfg, analog=self.analog_spec(keys),
            cache_len=cache_len, lengths=lengths,
        )
        logits = lm.logits_last(eng.params, h_last, eng.model_cfg)
        return cache, logits[:, 0, 0].to(torch.float32)

    def decode(self, cache, tok: torch.Tensor, pos: np.ndarray, keys: np.ndarray):
        """One decode step at per-row positions -> (logits (B, V) f32, cache)."""
        eng = self.engine
        pos_dev = torch.as_tensor(pos, dtype=torch.int64).to(eng.device, non_blocking=True)
        logits, cache = lm.decode_step(
            eng.params, cache, tok[:, None], pos_dev, eng.model_cfg,
            analog=self.analog_spec(keys, pos=pos),
        )
        return logits[:, 0, 0].to(torch.float32), cache


class UniformKTier(ExecutionTier):
    """Every analog matmul runs K repeats averaged (noise/sqrt(K) at K x
    energy). The id is the bare int K."""

    def __init__(self, engine, k: int):
        if k < 1:
            raise ValueError(f"n_repeats must be >= 1, got {k}")
        super().__init__(engine, int(k))
        self.k = int(k)

    def analog_spec(self, keys, pos=None):
        eng = self.engine
        k = keys if pos is None else fold_key(keys, np.asarray(pos))
        return lm.AnalogSpec(cfg=eng.analog_cfg, energies=eng.energies, key=k, n_repeats=self.k)


class DigitalTier(ExecutionTier):
    """Noiseless digital execution: the base tier of a digital engine."""


class TierRegistry:
    """Engine-owned map from tier ids to tiers. Uniform-K tiers materialize
    lazily on analog engines; on a digital engine every K resolves to the
    one digital base tier (K is a no-op without noise)."""

    def __init__(self, engine):
        self._engine = engine
        self._tiers: Dict[object, ExecutionTier] = {}
        self.base_id = 1
        if engine.analog_cfg is None:
            self._tiers[self.base_id] = DigitalTier(engine, self.base_id)

    def get(self, tier_id) -> ExecutionTier:
        tier = self._tiers.get(tier_id)
        if tier is not None:
            return tier
        if isinstance(tier_id, int) and not isinstance(tier_id, bool):
            eng = self._engine
            if eng.analog_cfg is None:
                return self._tiers[self.base_id]
            tier = UniformKTier(eng, tier_id)
            self._tiers[tier_id] = tier
            return tier
        raise ValueError(f"unknown tier {tier_id!r}")

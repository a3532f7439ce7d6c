"""Execution tiers; port of ``repro/serving/tiers.py`` (uniform K, per-layer
profiles and the digital base tier).

A tier is one servable execution configuration: how a batch's prefill and
decode steps run (``analog_spec``: the noise model of the forward, or
None for digital execution) and what a generated token costs
(``energy_per_token``). ``UniformKTier`` is the paper's uniform
dynamic-precision dial (every analog site runs K repeats averaged in the
kernel); ``AnalogProfileTier`` is its per-layer form, a registered
``PrecisionProfile`` whose layer l runs at K_l. Their decode steps fold
each row's position into the row's key, so every generated token draws
fresh noise. Analog tiers price a token through the engine's energy tree
(``sum_l K_l * E_l * MACs_l``); ``DigitalTier`` through a per-MAC digital
constant. The ``TierRegistry`` maps tier ids (K ints, profile names) to
tiers.

PyTorch runs eagerly, so a tier executes directly; there is no compiled
executable cache as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.analog import fold_key
from repro_torch.core.energy import DIGITAL_BF16_AJ_PER_MAC, total_macs
from repro_torch.core.profile import PrecisionProfile
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

    def energy_per_token(self) -> float:
        """Modelled energy of one generated token (aJ)."""
        raise NotImplementedError

    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor, keys: np.ndarray, cache_len: int):
        """Prefill a bucket batch -> (cache, last-token logits (B, V) f32)."""
        eng = self.engine
        cache, h_last = lm.prefill(
            eng.params, tokens, eng.model_cfg, analog=self.analog_spec(keys),
            cache_len=cache_len, lengths=lengths,
        )
        logits = lm.logits_last(eng.params, h_last, eng.model_cfg)
        return cache, logits[:, 0, 0].to(torch.float32)

    def decode(self, cache, tok: torch.Tensor, pos: np.ndarray, keys: np.ndarray,
               lengths: Optional[np.ndarray] = None):
        """One decode step at per-row positions -> (logits (B, V) f32, cache).
        ``lengths``: the rows' prompt lengths, 0 for a batch-padding row
        (which MoE leaves out of expert capacity and its expert noise key,
        and whose xlstm state stays as it was); None: every row is real."""
        eng = self.engine
        pos_dev = torch.as_tensor(pos, dtype=torch.int64).to(eng.device, non_blocking=True)
        logits, cache = lm.decode_step(
            eng.params, cache, tok[:, None], pos_dev, eng.model_cfg,
            analog=self.analog_spec(keys, pos=pos),
            lengths=None if lengths is None else torch.as_tensor(lengths, dtype=torch.int64),
        )
        return logits[:, 0, 0].to(torch.float32), cache


def _step_keys(keys, pos):
    return keys if pos is None else fold_key(keys, np.asarray(pos))


def _analog_energies(engine):
    if engine.energies is None:
        raise ValueError("digital engine: no energy tree to account")
    return engine.energies


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
        return lm.AnalogSpec(cfg=eng.analog_cfg, energies=eng.energies,
                             key=_step_keys(keys, pos), n_repeats=self.k)

    def energy_per_token(self) -> float:
        eng = self.engine
        profile = PrecisionProfile.uniform(self.k, eng.model_cfg.n_layers)
        return lm.profile_token_energy(eng.model_cfg, _analog_energies(eng), profile)


class AnalogProfileTier(ExecutionTier):
    """A registered per-layer repeat schedule; the id is the profile's name.
    Registered on a digital engine it is never served (submissions there
    go to the digital base tier)."""

    def __init__(self, engine, profile: PrecisionProfile):
        super().__init__(engine, profile.name)
        self.profile = profile

    def analog_spec(self, keys, pos=None):
        eng = self.engine
        if eng.analog_cfg is None:
            return None
        return lm.AnalogSpec(cfg=eng.analog_cfg, energies=eng.energies,
                             key=_step_keys(keys, pos), profile=self.profile)

    def energy_per_token(self) -> float:
        eng = self.engine
        return lm.profile_token_energy(eng.model_cfg, _analog_energies(eng), self.profile)


class DigitalTier(ExecutionTier):
    """Noiseless digital execution: the base tier of a digital engine.
    A token is priced at ``aj_per_mac`` times the model's MACs a token;
    without a constant there is nothing to price and the tier raises."""

    def __init__(self, engine, tier_id, *, aj_per_mac: Optional[float] = DIGITAL_BF16_AJ_PER_MAC):
        super().__init__(engine, tier_id)
        self.aj_per_mac = None if aj_per_mac is None else float(aj_per_mac)

    def energy_per_token(self) -> float:
        if self.aj_per_mac is None:
            raise ValueError("digital engine: no energy tree to account")
        macs = float(total_macs(lm.energy_macs(self.engine.model_cfg, 1)))
        return self.aj_per_mac * macs


class TierRegistry:
    """Engine-owned map from tier ids to tiers. Uniform-K tiers materialize
    lazily on analog engines; on a digital engine every K resolves to the
    one digital base tier (K is a no-op without noise). Profiles register
    by name and are add-only: a name stays bound to its schedule."""

    def __init__(self, engine):
        self._engine = engine
        self._tiers: Dict[object, ExecutionTier] = {}
        self._profiles: Dict[str, PrecisionProfile] = {}
        self.base_id = 1
        if engine.analog_cfg is None:
            self._tiers[self.base_id] = DigitalTier(engine, self.base_id, aj_per_mac=None)

    def register_profile(self, profile: PrecisionProfile) -> str:
        """Register a profile under its name after checking it against the
        model; idempotent for the same schedule, an error for another."""
        eng = self._engine
        lm.profile_rows(eng.model_cfg, profile)  # layer-count validation
        prev = self._profiles.get(profile.name)
        if prev is not None:
            if prev.cache_key() != profile.cache_key():
                raise ValueError(
                    f"profile name {profile.name!r} is frozen to a different "
                    "repeat schedule; profiles are add-only"
                )
            return profile.name
        if profile.name in self._tiers:
            raise ValueError(
                f"tier id {profile.name!r} is frozen to an already-registered "
                "non-profile tier; pick a new profile name"
            )
        self._profiles[profile.name] = profile
        self._tiers[profile.name] = AnalogProfileTier(eng, profile)
        return profile.name

    def get(self, tier_id) -> ExecutionTier:
        """The tier serving ``tier_id``; materializes uniform-K tiers on
        analog engines and raises for an unregistered name."""
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
        raise ValueError(f"unknown profile {tier_id!r}; register_profile() it first")

    def resolve_profile(self, profile) -> object:
        """A submit-time ``profile=`` argument (a ``PrecisionProfile``,
        registered here if new, or a registered name) -> its tier id. A
        uniform coalesced profile resolves to its bare K, so it shares
        batches and pools with ``n_repeats=K`` traffic."""
        if isinstance(profile, PrecisionProfile):
            pid = self.register_profile(profile)
        else:
            pid = str(profile)
            if pid not in self._profiles:
                raise ValueError(
                    f"unknown profile {pid!r}; register_profile() it first "
                    "(or pass the PrecisionProfile itself)"
                )
        p = self._profiles[pid]
        if p.is_uniform and p.coalesce:
            return int(p.repeats[0])
        return pid

    @property
    def profiles(self) -> Dict[str, PrecisionProfile]:
        """Registered profiles by name (a copy; the registry is add-only)."""
        return dict(self._profiles)

"""Execution tiers; port of ``repro/serving/tiers.py`` (uniform K, per-layer
profiles, digital tiers and the weight-only int8 digital tier).

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
constant; ``Int8DigitalTier`` serves a quantized copy of the engine's
weights (``quant/weights.py``) at the int8 constant. The
``TierRegistry`` maps tier ids (K ints, profile names, registered custom
ids) to tiers.

Each tier also carries its place on the degradation ladder: ``accuracy``
(the precision governor's coordinate), ``promote()`` (the tier a fault
retry moves to: one rung up the engine's ``k_ladder`` for uniform K, a
registered more accurate tier or a per-layer re-trim for a profile, the
same tier for digital), ``drift_promote()`` (the tier new traffic serves
at while the engine's drift response is on) and ``drift_exempt``
(digital tiers do not drift with the analog array).

A tier also builds the engine's cached steps (``build_prefill``,
``build_decode``, ``build_insert``: the reference's AOT executables) and
names them (``cache_key``, the identity suffix of every cache key;
``TierRegistry.exe_key`` composes the key). A step runs over static
tensors the engine refills before each call: the tokens, positions,
lengths and seed words (``HostInputs``, one host-to-device copy a call),
the noise scale, the decode token and the cache it updates in place. On
the card with the ``"cuda"`` backend it is captured as a CUDA graph and
replayed (``serving/cache.py``); elsewhere it runs eagerly. ``prefill``
and ``decode`` are the eager steps themselves, from host keys.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.analog import fold_key
from repro_torch.core.energy import DIGITAL_BF16_AJ_PER_MAC, DIGITAL_INT8_AJ_PER_MAC, total_macs
from repro_torch.core.profile import PrecisionProfile
from repro_torch.models import lm
from repro_torch.models.hooks import ServingMatmulHook
from repro_torch.quant.weights import quantize_params
from repro_torch.serving.cache import HostInputs

I64 = torch.int64


#: the matmul hook of every served digital forward: a request's tokens do
#: not depend on its batch
SERVED_DIGITAL = ServingMatmulHook()


def _next_rung(k: int, ladder: Tuple[int, ...]) -> int:
    """The smallest ladder rung above ``k`` (``k`` itself at the top: a
    promotion never goes past the calibrated ladder)."""
    for rung in ladder:
        if rung > k:
            return rung
    return k


class ExecutionTier:
    """One servable execution configuration of one engine."""

    #: digital tiers do not share the analog array's drift: the watchdog's
    #: response leaves them where they are
    drift_exempt = False

    def __init__(self, engine, tier_id, *, accuracy: Optional[float] = None):
        self.engine = engine
        self.tier_id = tier_id
        self.accuracy = None if accuracy is None else float(accuracy)

    @property
    def params(self):
        """The parameter tree this tier's forwards read: the engine's."""
        return self.engine.params

    def cache_key(self) -> tuple:
        """The identity suffix of every cache key of this tier's steps:
        everything that changes the step (repeat schedule, backend, noise
        kind, number format) and nothing else; two tiers with equal keys
        share steps."""
        raise NotImplementedError

    def analog_spec(self, keys: Optional[np.ndarray], pos=None, noise_scale=None, seeds=None):
        """AnalogSpec of this tier's forwards (None: digital). ``keys`` are
        the batch's stacked raw keys, ``pos`` the decode positions (B,),
        ``noise_scale`` the engine's 0-d drift tensor; ``seeds`` the
        forward's seed tables on the device in place of ``keys``."""
        return None

    def seed_words(self, keys: np.ndarray, pos=None, lengths=None) -> Dict[str, np.ndarray]:
        """The host seed words of one forward of this tier (``lm.seed_tables``
        of its keys, folded with ``pos`` at a decode step; rows of
        ``lengths`` 0 left out of MoE's batch key); empty for a digital tier."""
        spec = self.analog_spec(keys, pos=pos)
        if spec is None:
            return {}
        valid = None if lengths is None else np.asarray(lengths) > 0
        return lm.seed_tables(self.engine.model_cfg, spec.key, valid)

    def _inputs(self, bb: int, **fields) -> HostInputs:
        """The step's host inputs: ``fields`` and this tier's seed words for
        ``bb`` rows, on the engine's device."""
        for name, words in self.seed_words(np.zeros((bb, 2), np.uint32)).items():
            fields[f"seed_{name}"] = (words.shape, torch.int32)
        return HostInputs(fields, self.engine.device)

    def _spec(self, inputs: HostInputs):
        seeds = {name[5:]: inputs[name] for name in inputs.names if name.startswith("seed_")}
        return self.analog_spec(None, noise_scale=self.engine._scale_t, seeds=seeds)

    def fill(self, step, keys: np.ndarray, fold=None, **fields) -> None:
        """Refill ``step``'s host inputs: ``fields`` and the seed words of
        ``keys``, folded with the decode positions ``fold`` (MoE's batch
        key leaves out the rows of ``fields["lengths"]`` 0)."""
        seeds = self.seed_words(keys, pos=fold, lengths=fields.get("lengths"))
        step.inputs.fill(**fields, **{f"seed_{k}": v for k, v in seeds.items()})

    def build_prefill(self, bb: int, sb: int, cache_len: int):
        """The cached prefill of a (bb, sb) bucket at ``cache_len``: fills
        the engine's static cache of (bb, cache_len) in place; returns
        (logits (bb, V) f32, first tokens (bb,)). Host inputs: ``tokens``,
        ``lengths`` and the seed words of the batch keys."""
        eng = self.engine
        cfg = eng.model_cfg
        inputs = self._inputs(bb, tokens=((bb, sb), I64), lengths=((bb,), I64))

        def fn(cache):
            params = self.params
            with eng._mesh_ctx():
                _, h_last = lm.prefill(params, inputs["tokens"], cfg, analog=self._spec(inputs),
                                       lengths=inputs["lengths"], hook=SERVED_DIGITAL,
                                       cache=cache)
            logits = lm.logits_last(params, h_last, cfg)[:, 0, 0].to(torch.float32)
            return logits, torch.argmax(logits, dim=-1)

        return eng._make_step(self, fn, inputs, ("prefill", bb, sb, cache_len))

    def build_decode(self, bb: int, cache_len: int):
        """The cached decode step of ``bb`` rows at ``cache_len`` over a
        cache it updates in place (the engine's static batch cache or a
        pool's): returns (logits (bb, V) f32, next tokens (bb,)). Host
        inputs: ``pos``, ``lengths`` and the seed words of the keys folded
        with ``pos``; ``static["tok"]`` (bb,): this step's tokens, refilled
        on the device."""
        eng = self.engine
        cfg = eng.model_cfg
        inputs = self._inputs(bb, pos=((bb,), I64), lengths=((bb,), I64))
        tok = torch.zeros((bb,), dtype=I64, device=eng.device)

        def fn(cache):
            with eng._mesh_ctx():
                logits, _ = lm.decode_step(self.params, cache, tok[:, None], inputs["pos"], cfg,
                                           analog=self._spec(inputs), lengths=inputs["lengths"],
                                           hook=SERVED_DIGITAL)
            logits = logits[:, 0, 0].to(torch.float32)
            return logits, torch.argmax(logits, dim=-1)

        return eng._make_step(self, fn, inputs, ("decode", bb, cache_len), tok=tok)

    def build_insert(self, slots: int, cache_len: int, bb: int):
        """The cached admission insert: the engine's static prefill cache of
        (bb, cache_len) copied into a pool cache of ``slots`` rows at the
        host input ``slot_ids`` (bb,); ids ``slots`` (batch padding) are
        dropped. Parameter- and noise-free: the registry keys it without a
        tier suffix, one insert for every tier."""
        eng = self.engine
        cfg = eng.model_cfg
        inputs = HostInputs({"slot_ids": ((bb,), I64)}, eng.device)
        src = eng._batch_cache(bb, cache_len)

        def fn(pool_cache):
            lm.scatter_cache_rows(cfg, pool_cache, src, inputs["slot_ids"])
            return ()

        return eng._make_step(self, fn, inputs, ("insert", slots, cache_len, bb), params=False)

    def energy_per_token(self) -> float:
        """Modelled energy of one generated token (aJ)."""
        raise NotImplementedError

    def promote(self):
        """The tier id a fault retry of this tier's requests serves at (this
        tier: repeats buy nothing without noise)."""
        return self.tier_id

    def drift_promote(self):
        """The tier id new submissions serve at under the drift response."""
        return self.tier_id

    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor, keys: np.ndarray, cache_len: int,
                noise_scale=None):
        """Prefill a bucket batch -> (cache, last-token logits (B, V) f32)."""
        eng = self.engine
        params = self.params
        with eng._mesh_ctx():
            cache, h_last = lm.prefill(
                params, tokens, eng.model_cfg,
                analog=self.analog_spec(keys, noise_scale=noise_scale),
                cache_len=cache_len, lengths=lengths, hook=SERVED_DIGITAL,
            )
        logits = lm.logits_last(params, h_last, eng.model_cfg)
        return cache, logits[:, 0, 0].to(torch.float32)

    def decode(self, cache, tok: torch.Tensor, pos: np.ndarray, keys: np.ndarray,
               lengths: Optional[np.ndarray] = None, noise_scale=None):
        """One decode step at per-row positions -> (logits (B, V) f32, cache).
        ``lengths``: the rows' prompt lengths, 0 for a batch-padding row
        (which MoE leaves out of expert capacity and its expert noise key,
        and whose xlstm state stays as it was); None: every row is real."""
        eng = self.engine
        pos_dev = torch.as_tensor(pos, dtype=torch.int64).to(eng.device, non_blocking=True)
        with eng._mesh_ctx():
            logits, cache = lm.decode_step(
                self.params, cache, tok[:, None], pos_dev, eng.model_cfg,
                analog=self.analog_spec(keys, pos=pos, noise_scale=noise_scale),
                lengths=None if lengths is None else torch.as_tensor(lengths, dtype=torch.int64),
                hook=SERVED_DIGITAL,
            )
        return logits[:, 0, 0].to(torch.float32), cache


def _step_keys(keys, pos):
    return keys if pos is None or keys is None else fold_key(keys, np.asarray(pos))


def _analog_energies(engine):
    if engine.energies is None:
        raise ValueError("digital engine: no energy tree to account")
    return engine.energies


class UniformKTier(ExecutionTier):
    """Every analog matmul runs K repeats averaged (noise/sqrt(K) at K x
    energy). The id is the bare int K."""

    def __init__(self, engine, k: int, *, accuracy: Optional[float] = None):
        if k < 1:
            raise ValueError(f"n_repeats must be >= 1, got {k}")
        super().__init__(engine, int(k), accuracy=accuracy)
        self.k = int(k)

    def cache_key(self) -> tuple:
        cfg = self.engine.analog_cfg
        return (self.k, cfg.backend, cfg.noise.kind)

    def analog_spec(self, keys, pos=None, noise_scale=None, seeds=None):
        eng = self.engine
        return lm.AnalogSpec(cfg=eng.analog_cfg, energies=eng.energies,
                             key=_step_keys(keys, pos), n_repeats=self.k,
                             noise_scale=noise_scale, seeds=seeds)

    def energy_per_token(self) -> float:
        eng = self.engine
        profile = PrecisionProfile.uniform(self.k, eng.model_cfg.n_layers)
        return lm.profile_token_energy(eng.model_cfg, _analog_energies(eng), profile)

    def promote(self):
        return _next_rung(self.k, self.engine.k_ladder)

    # the drift response climbs the same calibrated ladder as a retry
    drift_promote = promote


class AnalogProfileTier(ExecutionTier):
    """A registered per-layer repeat schedule; the id is the profile's name.
    Registered on a digital engine it is never served (submissions there
    go to the digital base tier)."""

    def __init__(self, engine, profile: PrecisionProfile):
        super().__init__(engine, profile.name, accuracy=profile.accuracy)
        self.profile = profile

    def cache_key(self) -> tuple:
        cfg = self.engine.analog_cfg
        if cfg is None:
            # registrable on a digital engine, never served there
            return ("digital", "bf16")
        # a uniform coalesced profile shares the bare-K element with
        # UniformKTier: an equal schedule shares steps
        return (self.profile.cache_key(), cfg.backend, cfg.noise.kind)

    def analog_spec(self, keys, pos=None, noise_scale=None, seeds=None):
        eng = self.engine
        if eng.analog_cfg is None:
            return None
        return lm.AnalogSpec(cfg=eng.analog_cfg, energies=eng.energies,
                             key=_step_keys(keys, pos), profile=self.profile,
                             noise_scale=noise_scale, seeds=seeds)

    def energy_per_token(self) -> float:
        eng = self.engine
        return lm.profile_token_energy(eng.model_cfg, _analog_energies(eng), self.profile)

    def promote(self):
        """The smallest registered tier more accurate than this one, else
        the profile re-trimmed one ladder rung up in every layer (registered
        as ``<name>+retrim``), else this tier (at the ladder's top)."""
        eng = self.engine
        if self.accuracy is not None:
            best = None
            for cand in eng.tiers.registered():
                if cand is self or cand.accuracy is None:
                    continue
                if cand.accuracy > self.accuracy and (best is None or cand.accuracy < best.accuracy):
                    best = cand
            if best is not None:
                return best.tier_id
        reps = tuple(_next_rung(k, eng.k_ladder) for k in self.profile.repeats)
        if reps == self.profile.repeats:
            return self.tier_id
        return eng.tiers.register_profile(PrecisionProfile(reps, name=f"{self.profile.name}+retrim"))


class DigitalTier(ExecutionTier):
    """Noiseless digital execution: the base tier of a digital engine, or a
    tier registered on an analog engine (``register``), exact and so of
    accuracy 1.0 by default. A token is priced at ``aj_per_mac`` times the
    model's MACs a token; without a constant there is nothing to price and
    the tier raises."""

    drift_exempt = True

    def __init__(self, engine, tier_id="bf16", *,
                 aj_per_mac: Optional[float] = DIGITAL_BF16_AJ_PER_MAC,
                 accuracy: Optional[float] = 1.0):
        super().__init__(engine, tier_id, accuracy=accuracy)
        self.aj_per_mac = None if aj_per_mac is None else float(aj_per_mac)

    def cache_key(self) -> tuple:
        return ("digital", "bf16")

    def energy_per_token(self) -> float:
        if self.aj_per_mac is None:
            raise ValueError("digital engine: no energy tree to account")
        macs = float(total_macs(lm.energy_macs(self.engine.model_cfg, 1)))
        return self.aj_per_mac * macs


class Int8DigitalTier(DigitalTier):
    """Weight-only int8 digital execution (``quant/weights.py``): the
    forwards read a quantized copy of the engine's parameter tree (int8
    codes and f32 per-output-channel scales, dequantized a layer slice at
    a time in ``lm._run_stack``), made at first use and made again
    whenever ``engine.params`` is swapped. Priced at the int8 per-MAC
    constant, never the analog energy tree; accuracy 1.0 by default."""

    def __init__(self, engine, tier_id="int8", *,
                 aj_per_mac: Optional[float] = DIGITAL_INT8_AJ_PER_MAC,
                 accuracy: Optional[float] = 1.0):
        super().__init__(engine, tier_id, aj_per_mac=aj_per_mac, accuracy=accuracy)
        self._src = None
        self._qparams = None

    def cache_key(self) -> tuple:
        return ("digital", "int8")

    @property
    def params(self):
        src = self.engine.params
        if self._qparams is None or self._src is not src:
            self._qparams = None  # the old copy goes before the new one is made
            self._qparams = quantize_params(src)
            self._src = src
        return self._qparams


class TierRegistry:
    """Engine-owned map from tier ids to tiers. Uniform-K tiers materialize
    lazily on analog engines; on a digital engine every K resolves to the
    one digital base tier (K is a no-op without noise). Profiles and custom
    tiers register by name and are add-only: a name stays bound to its
    tier."""

    def __init__(self, engine):
        self._engine = engine
        self._tiers: Dict[object, ExecutionTier] = {}
        self._profiles: Dict[str, PrecisionProfile] = {}
        self.base_id = 1
        if engine.analog_cfg is None:
            self._tiers[self.base_id] = DigitalTier(engine, self.base_id, aj_per_mac=None)

    def register(self, tier: ExecutionTier):
        """Register a custom tier of this engine under its ``tier_id``
        (idempotent for the same object, an error for a taken id)."""
        if not isinstance(tier, ExecutionTier):
            raise TypeError(f"expected an ExecutionTier, got {type(tier)!r}")
        if tier.engine is not self._engine:
            raise ValueError(f"tier {tier.tier_id!r} belongs to another engine")
        prev = self._tiers.get(tier.tier_id)
        if prev is tier:
            return tier.tier_id
        if prev is not None:
            raise ValueError(f"tier id {tier.tier_id!r} is frozen to an already-registered tier; "
                             "pick a new id")
        self._tiers[tier.tier_id] = tier
        return tier.tier_id

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

    def resolve(self, tier):
        """A submit-time ``tier=`` argument (a registered id, a uniform K, a
        ``PrecisionProfile`` or an ``ExecutionTier``, registered here if
        new) -> its tier id."""
        if isinstance(tier, ExecutionTier):
            if self._tiers.get(tier.tier_id) is not tier:
                self.register(tier)
            return tier.tier_id
        if isinstance(tier, PrecisionProfile):
            return self.resolve_profile(tier)
        self.get(tier)  # existence check (materializes a uniform K)
        return tier

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

    def exe_key(self, phase: str, tier_id, *shape) -> tuple:
        """The full cache key of one step: phase + static shape + the
        engine's mesh fingerprint + the tier's ``cache_key()``.
        ``tier_id=None`` builds a tier-free key (the admission insert,
        shared by every tier). The fingerprint is ``()`` unmeshed; on a
        mesh it makes a reshard build fresh steps, while a reshard back to
        a previous mesh hits that mesh's entries."""
        base = (phase,) + tuple(shape) + self._engine.mesh_key
        if tier_id is None:
            return base
        return base + self.get(tier_id).cache_key()

    @property
    def profiles(self) -> Dict[str, PrecisionProfile]:
        """Registered profiles by name (a copy; the registry is add-only)."""
        return dict(self._profiles)

    def registered(self) -> List[ExecutionTier]:
        """Every known tier, in registration order."""
        return list(self._tiers.values())

    def ladder(self) -> List[ExecutionTier]:
        """Registered tiers with an accuracy, least accurate first: the
        governor's demotion ladder over analog and digital tiers."""
        tiers = [t for t in self._tiers.values() if t.accuracy is not None]
        return sorted(tiers, key=lambda t: (t.accuracy, str(t.tier_id)))

    def drift_exempt_ids(self) -> List[object]:
        return [t.tier_id for t in self._tiers.values() if t.drift_exempt]

    def drift_promote(self, tier_id):
        """The tier id a new submission serves at under the drift response
        (digital tiers and profiles stay where they are)."""
        return self.get(tier_id).drift_promote()

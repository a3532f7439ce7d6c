"""Core: the paper's contribution as PyTorch modules (port of ``repro/core``).

  noise      - analog noise models (Eqs. 9-11)
  precision  - noise-bits analysis (Eqs. 6-8)
  analog     - the analog_dot execution primitive + AnalogConfig
  energy     - energy accounting + Eq.-14 log-penalty
  redundant  - K-repeat redundant coding (Fig. 3): fused path + oracles
  calibrate  - Eq.-14 energy learning (frozen weights)
  search     - min-energy binary search (<2% degradation) + the greedy
               per-layer repeat-profile searches
  profile    - frozen per-layer K-repeat schedules (learn -> freeze -> serve)
"""
from repro_torch.core.analog import (
    PER_CHANNEL,
    PER_LAYER,
    AnalogConfig,
    SiteQuant,
    analog_conv2d,
    analog_dot,
    fold_key,
    key_batch,
    raw_key,
    site_key,
)
from repro_torch.core.calibrate import (
    CalibConfig,
    eval_accuracy,
    eval_profile_accuracy,
    learn_energies,
    noise_rms,
    softmax_xent,
)
from repro_torch.core.energy import (
    DIGITAL_BF16_AJ_PER_MAC,
    DIGITAL_INT8_AJ_PER_MAC,
    apply_repeats,
    avg_energy_per_mac,
    dense_site_macs,
    log_energy_penalty,
    repeat_total_energy,
    to_energy,
    total_energy,
    total_macs,
    uniform_log_energies,
)
from repro_torch.core.noise import PHOTON_ENERGY_AJ, SHOT, THERMAL, WEIGHT, NoiseSpec
from repro_torch.core.precision import noise_bits, noise_var_from_bits, thermal_noise_bits
from repro_torch.core.profile import DEFAULT_K_LEVELS, PrecisionProfile, coalesce_runs
from repro_torch.core.search import (
    ProfileSearchResult,
    SearchResult,
    min_energy_search,
    online_repeat_profile_search,
    repeat_profile_search,
)

__all__ = [
    "AnalogConfig",
    "CalibConfig",
    "NoiseSpec",
    "PER_CHANNEL",
    "PER_LAYER",
    "PHOTON_ENERGY_AJ",
    "SHOT",
    "THERMAL",
    "WEIGHT",
    "DEFAULT_K_LEVELS",
    "DIGITAL_BF16_AJ_PER_MAC",
    "DIGITAL_INT8_AJ_PER_MAC",
    "PrecisionProfile",
    "ProfileSearchResult",
    "SearchResult",
    "SiteQuant",
    "analog_conv2d",
    "apply_repeats",
    "coalesce_runs",
    "analog_dot",
    "fold_key",
    "key_batch",
    "raw_key",
    "avg_energy_per_mac",
    "dense_site_macs",
    "eval_accuracy",
    "eval_profile_accuracy",
    "learn_energies",
    "log_energy_penalty",
    "min_energy_search",
    "noise_rms",
    "online_repeat_profile_search",
    "repeat_profile_search",
    "repeat_total_energy",
    "noise_bits",
    "noise_var_from_bits",
    "site_key",
    "softmax_xent",
    "thermal_noise_bits",
    "to_energy",
    "total_energy",
    "total_macs",
    "uniform_log_energies",
]

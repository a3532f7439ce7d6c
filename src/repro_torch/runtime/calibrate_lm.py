"""Eq.-14 calibration at LM scale: learn the per-site energies of a frozen
transformer LM with the calibrate step; the port's counterpart of
``examples/calibrate_lm.py``. Shows the energy-NLL trade-off and the
learned per-layer allocations. On the card unless ``--device cpu``; the
gradient runs on the ``"torch"`` backend (the reference's ``"jnp"``: the
kernel has no backward).

Run:  PYTHONPATH=src python -m repro_torch.runtime.calibrate_lm [--target 2.0] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.energy import avg_energy_per_mac, to_energy, uniform_log_energies
from repro_torch.data.pipeline import TokenTaskConfig, markov_batch
from repro_torch.kernels import prng
from repro_torch.launch.steps import make_calibrate_step
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adam import AdamConfig, adam_init

CFG = ModelConfig(
    name="calib-demo", family="dense", n_layers=4, d_model=256, n_heads=8,
    n_kv_heads=4, d_ff=1024, vocab_size=4096, attn_q_chunk=128,
    attn_kv_chunk=128, loss_chunk=128, dtype="float32", remat=False,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--target", type=float, default=2.0, help="aJ/MAC budget")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    key = prng.PRNGKey(0)
    seq = 128
    data = TokenTaskConfig(vocab_size=CFG.vocab_size, seq_len=seq, global_batch=8, seed=7)
    params = lm.init_params(CFG, seed=0, device=args.device)
    step = make_calibrate_step(
        CFG, analog_cfg=AnalogConfig.shot(backend="torch"), seq_len=seq,
        target_e_per_mac=args.target, lam=20.0, lr=0.05,
    )
    macs = step.macs
    log_e = uniform_log_energies(macs, 4.0 * args.target)
    opt = adam_init(log_e, AdamConfig(lr=0.05))
    for i in range(args.steps):
        log_e, opt, m = step(log_e, opt, params, markov_batch(data, i), prng.fold_in(key, i))
        if i % 10 == 0 or i == args.steps - 1:
            with torch.no_grad():
                avg = float(avg_energy_per_mac(to_energy(log_e), macs))
            print(f"step {i:>3}: nll {float(m['nll']):.4f}  avg E/MAC {avg:.3f} aJ")

    with torch.no_grad():
        e = to_energy(log_e)
    print("\nlearned per-group allocations (aJ/MAC), group 0:")
    for site, v in sorted(e["groups"].items()):
        print(f"  {site:<12} {[round(float(x), 2) for x in v.reshape(-1)[:4]]}")
    print(f"  lm_head      {float(e['lm_head']):.2f}")


if __name__ == "__main__":
    main()

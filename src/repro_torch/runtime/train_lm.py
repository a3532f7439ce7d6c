"""Train a transformer LM on the deterministic synthetic Markov task
through the fault-tolerant driver (atomic async checkpoints, straggler
monitoring); the port's counterpart of ``examples/train_lm.py``.

The default is a ~10M-parameter model; ``--model 100m`` selects the
~100M-parameter config. On the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.runtime.train_lm [--steps 200] [--model 10m]
          [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.data.pipeline import TokenTaskConfig
from repro_torch.launch.steps import TrainConfig
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.driver import DriverConfig, TrainDriver

MODELS = {
    "10m": ModelConfig(
        name="demo-10m", family="dense", n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=4, d_ff=1024, vocab_size=4096, attn_q_chunk=128,
        attn_kv_chunk=128, loss_chunk=128,
    ),
    "100m": ModelConfig(
        name="demo-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=3072, vocab_size=32768, attn_q_chunk=256,
        attn_kv_chunk=256, loss_chunk=256,
    ),
}
#: the example's optimizer: f32 moments
TRAIN_CFG = TrainConfig(lr=3e-4, opt_state_dtype="float32")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="10m", choices=sorted(MODELS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = MODELS[args.model]
    print(f"model {cfg.name}: {cfg.param_count() / 1e6:.1f}M params on {args.device}")
    data = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                           global_batch=args.batch, seed=7)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), f"repro_torch_{cfg.name}")
    driver = TrainDriver(
        cfg, data, ckpt_dir=ckpt_dir, train_cfg=TRAIN_CFG,
        driver_cfg=DriverConfig(max_steps=args.steps, ckpt_every=50, ckpt_async=True,
                                log_every=10),
        device=args.device,
    )
    out = driver.run()
    print("step  loss    step_time")
    for m in out["metrics"]:
        print(f"{m['step']:>5} {m['loss']:.4f}  {m['dt'] * 1e3:.0f} ms")
    print(f"checkpoints in {ckpt_dir}; straggler flags: {len(driver.monitor.flags)}")


if __name__ == "__main__":
    main()

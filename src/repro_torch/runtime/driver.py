"""Fault-tolerant training driver; port of ``repro/runtime/driver.py``.

The control loop of a training job:

  restore the latest valid checkpoint (else initialise) -> loop:
      batch(step)      (deterministic in the step: a restart replays it)
      run the step
      watch its time   (straggler monitor: EWMA and outlier flags)
      periodic async checkpoint
  on failure: restore and continue (a bounded number of restarts)

Failures are injected through ``failure_hook`` (raise ``SimulatedFailure``
at chosen steps). The contract: a run with failures ends in the same
parameters, bit for bit, as one without. Initial parameters come from
``lm.init_params(cfg, seed)`` (the reference's ``jax.random`` draws are
not reproduced).

The mesh is None or a mesh of data x tensor shards (``launch/steps.py``:
Megatron's shards of the weights, ZeRO-1 moments). A checkpoint holds the
whole state whatever the mesh: in the distributed form the moments'
regions and the tensor shards are gathered and rank 0 writes; every rank
restores the whole state and takes its tensor shard and its regions. So a
checkpoint restores on any mesh, and ``resize`` moves a run to another
one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.data.pipeline import TokenTaskConfig, markov_batch
from repro_torch.device import resolve_device
from repro_torch.launch import collectives
from repro_torch.launch.steps import (
    TrainConfig,
    gather_opt_state,
    gather_params,
    make_opt_init,
    make_train_step,
    shard_opt_state,
    shard_params,
)
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adam import adam_init
from repro_torch.serving.cache import mesh_fingerprint
from repro_torch.tree import map_leaves


class SimulatedFailure(RuntimeError):
    """Raised by failure_hook to simulate a node crash."""


class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than ``threshold`` x EWMA.

    ``persistent`` trips after ``patience`` consecutive flags: the driver's
    cue to mitigate (re-mesh without the slow host, or rebalance).
    """

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0, patience: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.ewma: Optional[float] = None
        self.consecutive = 0
        self.flags: list = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.threshold * self.ewma
        if slow:
            self.flags.append((step, dt, self.ewma))
            self.consecutive += 1
        else:
            self.consecutive = 0
            # only fold non-outlier samples into the baseline
            self.ewma = dt if self.ewma is None else (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow

    @property
    def persistent(self) -> bool:
        return self.consecutive >= self.patience


@dataclasses.dataclass
class DriverConfig:
    max_steps: int = 100
    ckpt_every: int = 20
    ckpt_async: bool = True
    max_restarts: int = 5
    log_every: int = 10


class TrainDriver:
    """Trains ``model_cfg`` on ``data_cfg``'s Markov task on ``device``
    (the card unless the caller asks for the CPU), checkpointing under
    ``ckpt_dir``. ``mesh``: None or a mesh of data x tensor shards; in the
    distributed form every rank runs a driver on the same directory and
    rank 0 writes."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        data_cfg: TokenTaskConfig,
        mesh=None,
        *,
        ckpt_dir: str,
        train_cfg: TrainConfig = TrainConfig(),
        driver_cfg: DriverConfig = DriverConfig(),
        failure_hook: Optional[Callable[[int], None]] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.mesh = mesh
        self.train_cfg = train_cfg
        self.cfg = driver_cfg
        self.failure_hook = failure_hook
        self.seed = seed
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir)
        self.monitor = StragglerMonitor()
        self.metrics_log: list = []
        self.restarts = 0
        self._build()

    # -- construction / recovery ------------------------------------------

    def _build(self):
        self._step = make_train_step(self.model_cfg, self.mesh, self.train_cfg)
        self._opt_init = make_opt_init(self.model_cfg, self.mesh, self.train_cfg)

    @property
    def _writer(self) -> bool:
        """Whether this process writes checkpoints (rank 0 of a distributed
        mesh, else always)."""
        return (self.mesh is None or not self.mesh.distributed
                or collectives.rank(self.mesh.group) == 0)

    def _init_state(self) -> Dict[str, Any]:
        params = shard_params(lm.init_params(self.model_cfg, self.seed, device=self.device),
                              self.model_cfg, self.mesh)
        return {"params": params, "opt": self._opt_init(params)}

    def _template(self) -> Dict[str, Any]:
        """The whole state's structure, shapes and dtypes with no storage."""
        dtype = self.model_cfg.compute_dtype
        params = map_leaves(lambda _p, leaf: torch.empty(leaf.shape, dtype=dtype, device="meta"),
                            lm.param_leaves(self.model_cfg))
        return {"params": params, "opt": adam_init(params, self.train_cfg.adam())}

    def _restore_or_init(self):
        restored = self.ckpt.restore_latest(self._template())
        if restored is None:
            return 0, self._init_state()
        step, host = restored
        params = shard_params(host["params"], self.model_cfg, self.mesh)
        opt = shard_opt_state(host["opt"], self.model_cfg, self.mesh)
        return step, {"params": map_leaves(lambda _p, t: t.to(self.device), params),
                      "opt": _to_device(opt, self.device)}

    def _save(self, step: int, state, blocking: bool) -> None:
        """The whole state (tensor shards and moments gathered: collectives
        on a distributed mesh), written by the writer."""
        whole = {"params": gather_params(state["params"], self.model_cfg, self.mesh),
                 "opt": gather_opt_state(state["opt"], self.model_cfg, self.mesh)}
        if self._writer:
            self.ckpt.save(step, whole, blocking=blocking)
        if self.mesh is not None and self.mesh.distributed:
            import torch.distributed as dist

            self.ckpt.wait()  # the others restore only what rank 0 has written
            dist.barrier(group=self.mesh.group)

    # -- main loop ----------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        while True:
            try:
                return self._run_once()
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()

    def _run_once(self) -> Dict[str, Any]:
        step, state = self._restore_or_init()
        while step < self.cfg.max_steps:
            if self.failure_hook is not None:
                self.failure_hook(step)
            batch = markov_batch(self.data_cfg, step)
            t0 = time.monotonic()
            state["params"], state["opt"], metrics = self._step(state["params"], state["opt"],
                                                                batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.monotonic() - t0
            self.monitor.observe(step, dt)
            step += 1
            if step % self.cfg.log_every == 0 or step == self.cfg.max_steps:
                self.metrics_log.append({"step": step, "loss": loss, "dt": dt})
            if step % self.cfg.ckpt_every == 0 or step == self.cfg.max_steps:
                self._save(step, state, blocking=not self.cfg.ckpt_async)
        self.ckpt.wait()
        return {"step": step, "state": state, "metrics": self.metrics_log}

    # -- elastic ------------------------------------------------------------

    def resize(self, new_mesh) -> None:
        """Elastic re-mesh, the reference's: restore the live state, rebuild
        the step for ``new_mesh``, reshard the state onto it (each rank
        takes its tensor shard and its moments' regions), make a blocking save, and log
        ``{"step", "event": "resize", "mesh_from", "mesh_to"}`` with both
        meshes' ``mesh_fingerprint``. A later ``run()`` resumes on the new
        mesh."""
        step, state = self._restore_or_init()
        params = gather_params(state["params"], self.model_cfg, self.mesh)
        whole = gather_opt_state(state["opt"], self.model_cfg, self.mesh)
        old_fp = mesh_fingerprint(self.mesh)
        self.mesh = new_mesh
        self._build()
        state = {"params": shard_params(params, self.model_cfg, self.mesh),
                 "opt": shard_opt_state(whole, self.model_cfg, self.mesh)}
        self._save(step, state, blocking=True)
        self.metrics_log.append({"step": step, "event": "resize", "mesh_from": old_fp,
                                 "mesh_to": mesh_fingerprint(self.mesh)})


def _to_device(opt, device):
    """An ``AdamState`` restored on the host, its moments on ``device`` (the
    step counter stays on the host, as ``adam_init`` makes it)."""
    return dataclasses.replace(opt, mu=map_leaves(lambda _p, t: t.to(device), opt.mu),
                               nu=map_leaves(lambda _p, t: t.to(device), opt.nu))

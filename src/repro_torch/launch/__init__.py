"""Launch helpers of the port (``repro/launch``): the tensor-parallel mesh
(``mesh.py``) and the train and calibrate steps (``steps.py``). The
reference's dry-run, HLO and roofline tools are specific to XLA and the
TPU; their torch-profiler counterparts are queued (ROADMAP A)."""
from repro_torch.launch.mesh import Mesh, make_mesh_for_devices
from repro_torch.launch.steps import (
    TrainConfig,
    make_calibrate_step,
    make_opt_init,
    make_train_step,
)

__all__ = ["Mesh", "TrainConfig", "make_calibrate_step", "make_mesh_for_devices",
           "make_opt_init", "make_train_step"]

"""Launch helpers of the port (``repro/launch``): meshes (``mesh.py``),
collectives (``collectives.py``), the train, serving and calibrate steps
(``steps.py``), and the dry run's tools: ``roofline.py`` (H100 spec
terms), ``trace_analysis.py`` (a step reckoned on the meta device, the
counterpart of ``hlo_analysis.py``), ``dryrun.py`` and ``diagnose.py``."""
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_mesh_for_devices, make_production_mesh
from repro_torch.launch.steps import (
    TrainConfig,
    make_calibrate_step,
    make_decode_step,
    make_opt_init,
    make_prefill_step,
    make_train_step,
)

__all__ = ["Mesh", "TrainConfig", "make_calibrate_step", "make_decode_step", "make_local_mesh",
           "make_mesh_for_devices", "make_opt_init", "make_prefill_step", "make_production_mesh",
           "make_train_step"]

"""Launch helpers of the port (``repro/launch``): the tensor-parallel mesh
(``mesh.py``). The reference's dry-run, HLO and roofline tools are
specific to XLA and the TPU and wait for the training slice."""
from repro_torch.launch.mesh import Mesh, make_mesh_for_devices

__all__ = ["Mesh", "make_mesh_for_devices"]

"""The ambient tensor-parallel mesh; the serving part of
``repro/models/sharding.py``.

``use_mesh`` makes a ``launch.mesh.Mesh`` the ambient mesh of the calls
inside it (per thread); ``kernels.dispatch.active_mesh`` reads it, and
``core.analog.analog_dot`` runs column-parallel under it. Serving places
nothing else: as under the reference's ``SERVING_RULES``, every tensor
outside ``analog_dot`` (activations, caches, tokens, keys) is whole on
every shard. The reference's training placement (``spec``,
``tree_shardings``, ``zero1_axes`` and its rule tables) waits for the
training slice.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def set_mesh(mesh) -> None:
    _state.mesh = mesh


def get_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` (a ``Mesh`` or None) as the ambient mesh inside the block."""
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)

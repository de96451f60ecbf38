"""The multi-process layer: the process mesh, the collectives and the
frame-parallel decomposition forwards (``mesh.py``, ``comm.py``,
``decomp.py``)."""

from mimo_tpu_torch.parallel.mesh import (  # noqa: F401
    ProcessMesh, get_mesh, get_mesh_2d, init)

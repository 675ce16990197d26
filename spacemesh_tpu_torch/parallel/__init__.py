"""Device-mesh striping for the POST compute plane.

Port of ``spacemesh_tpu/parallel/``. The reference scales by running many
identities on one machine and by per-device providers; the JAX package by
SPMD over a ``jax.sharding.Mesh`` whose data axis is the label lanes. The
port stripes those lanes over a list of local devices in one process,
each stripe on its own device and CUDA stream, and combines the few
cross-lane results itself (``mesh.py``; the meshes and streams are built
once, in ``topology.py``).
"""

from . import topology  # noqa: F401
from .mesh import (  # noqa: F401
    data_mesh,
    init_step_sharded,
    labels_with_min_sharded,
    replicate,
    scrypt_labels_sharded,
)

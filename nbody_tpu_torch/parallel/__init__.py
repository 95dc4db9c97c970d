"""The particle decomposition of ``nbody_tpu.parallel``, single-controller:
one process drives a mesh of K shard slots (``mesh.py``), the comm modes
compose the force kernels over the shards (``decompose.py``), and the fused
ring runs the whole K-hop exchange in one kernel (``ring_kernel.py``)."""

from .mesh import AXIS, Mesh, make_mesh

__all__ = ["AXIS", "Mesh", "make_mesh"]

"""nbody_tpu_torch -- the PyTorch/CUDA port of nbody_tpu for one NVIDIA H100.

It runs the reference N-body main path (bit-exact initial conditions,
zero-mass padding, the force-kernel registry, the Euler and leapfrog sample
blocks, the kinetic energy and the reference's table) in PyTorch, with
hand-written CUDA kernels for the two force sweeps of that path
(csrc/tiled.cu, csrc/sym.cu) and for the fused sample block, a whole block
of steps in one launch (csrc/fused.cu, ``SimConfig(fused=True)``).  It
imports torch and never JAX; the JAX package ``nbody_tpu`` stays beside it
as the reference it is held against.
"""

from .config import SimConfig
from .init import make_state, reference_init_arrays
from .models.gravity import euler_step, kinetic_energy, make_block_fn
from .simulation import RunResult, Simulation, run
from .state import ParticleState

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "Simulation",
    "RunResult",
    "run",
    "ParticleState",
    "make_state",
    "reference_init_arrays",
    "euler_step",
    "kinetic_energy",
    "make_block_fn",
    "__version__",
]

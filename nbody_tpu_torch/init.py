"""Initial conditions, bit-compatible with the reference.

The reference draws every field from a freshly re-seeded ``std::mt19937(42)``
(ver0/GSimulation.cpp:44-93): positions ~ U(0, 1), velocities ~ U(-1, 1) *
1e-3, masses = N * U(0, 1) reusing the position draws.  The draws are made
on the host in numpy (utils/mt19937.py, a copy of the JAX package's) and
then moved to the device, exactly as ``nbody_tpu.init`` does.
"""

from __future__ import annotations

import numpy as np

from .models.distributions import make_arrays
from .state import ParticleState, pad_state, round_up
from .utils.mt19937 import MT19937, generate_canonical_f32, uniform_real_f32


def reference_init_arrays(n: int, seed: int = 42
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side (pos (3,n), vel (3,n), mass (n,)) fp32, exactly as the
    reference initializes them.  Another ``seed`` keeps the same draw
    structure (``nbody_tpu.models.distributions.reference``)."""
    if seed != 42:
        u01 = uniform_real_f32(seed, 3 * n, 0.0, 1.0)
        u11 = uniform_real_f32(seed, 3 * n, -1.0, 1.0)
        pos = u01.reshape(n, 3).T.copy()
        vel = (u11 * np.float32(1e-3)).reshape(n, 3).T.copy()
        return pos, vel, (np.float32(n) * u01[:n]).astype(np.float32)
    u01 = generate_canonical_f32(MT19937(42).raw(3 * n))  # U(0,1) canonicals
    u11 = generate_canonical_f32(MT19937(42).raw(3 * n))
    # uniform_real_distribution(a, b): canonical * (b - a) + a, in fp32.
    pos = u01.reshape(n, 3).T.copy()  # (b-a)=1, a=0: identity
    vel_draw = (u11 * np.float32(2.0) + np.float32(-1.0)).astype(np.float32)
    vel = (vel_draw * np.float32(1.0e-3)).astype(np.float32).reshape(n, 3).T.copy()
    mass = (np.float32(n) * u01[:n]).astype(np.float32)
    return pos, vel, mass


def make_state(n: int, pad_multiple: int = 1, distribution: str = "reference",
               seed: int = 42, device=None) -> ParticleState:
    """A state on ``device`` (None: the card, raising without one, as the
    JAX package puts it on the accelerator) padded with zero-mass particles
    to a multiple of ``pad_multiple``.  ``distribution``: 'reference'
    (bit-exact reference ICs, the default), 'plummer' or 'cold_sphere'
    (models/distributions.py); an unknown name raises ``KeyError``."""
    pos, vel, mass = make_arrays(distribution, n, seed=seed)
    return pad_state(pos, vel, mass, round_up(n, max(1, pad_multiple)), device)

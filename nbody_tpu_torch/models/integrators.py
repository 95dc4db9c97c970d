"""Integrators.

The reference has one: semi-implicit Euler (ver0/GSimulation.cpp:153-161),
the default for parity.  The kick-drift-kick leapfrog is the JAX package's
extension: symplectic at the same one force evaluation per step, with the
acceleration carried through the block.

A block is a Python loop of ``block_steps`` steps that never syncs with
the host (the counterpart of the JAX package's jitted ``lax.fori_loop``).
It builds new tensors rather than updating the input state in place, so a
warm-up block leaves the state it was given untouched.
"""

from __future__ import annotations

import numpy as np

from ..state import ParticleState
from .gravity import AccelFn, kinetic_energy

INTEGRATORS = ("euler", "leapfrog")


def make_block_fn(accel_fn: AccelFn, dt: float, block_steps: int,
                  integrator: str = "euler"):
    """Sample block: advances block_steps steps on the device and returns
    (state, kinetic_energy) with the energy as a 0-d device tensor."""
    # The fp32 step sizes the JAX package uses (jnp.float32(dt) and
    # 0.5 * that, both in fp32), held as Python floats that are exact in fp32.
    dtf = float(np.float32(dt))
    half = float(np.float32(0.5) * np.float32(dt))

    if integrator == "euler":

        def block(state: ParticleState):
            pos, vel, mass = state.pos, state.vel, state.mass
            for _ in range(block_steps):
                acc = accel_fn(pos, mass)
                vel = vel + acc * dtf
                pos = pos + vel * dtf
            new = ParticleState(pos=pos, vel=vel, mass=mass, n=state.n)
            return new, kinetic_energy(new)

        return block

    if integrator == "leapfrog":

        def block(state: ParticleState):
            pos, vel, mass = state.pos, state.vel, state.mass
            # One extra force evaluation per block re-seeds the carried
            # acceleration (state holds no acc between blocks).
            acc = accel_fn(pos, mass)
            for _ in range(block_steps):
                vel_h = vel + acc * half  # kick
                pos = pos + vel_h * dtf  # drift
                acc = accel_fn(pos, mass)
                vel = vel_h + acc * half  # kick
            new = ParticleState(pos=pos, vel=vel, mass=mass, n=state.n)
            return new, kinetic_energy(new)

        return block

    raise ValueError(f"unknown integrator {integrator!r}; options: {INTEGRATORS}")

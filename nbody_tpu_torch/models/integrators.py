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

import functools

import numpy as np
import torch

from ..state import ParticleState
from ..utils import spans
from .gravity import AccelFn, kinetic_energy

INTEGRATORS = ("euler", "leapfrog")


def step_sizes(dt: float) -> tuple[float, float]:
    """The fp32 step sizes the JAX package uses (jnp.float32(dt) and 0.5 *
    that, both in fp32), as Python floats that are exact in fp32."""
    return float(np.float32(dt)), float(np.float32(0.5) * np.float32(dt))


def advance(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor,
            accel_fn: AccelFn, dt: float, steps: int,
            integrator: str = "euler", env=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``steps`` steps from (pos, vel), returned as new tensors.  With an
    ``env``, every force evaluation is ``accel_fn(pos, mass, mesh_env=env)``."""
    dtf, half = step_sizes(dt)
    force = functools.partial(accel_fn, mesh_env=env) if env is not None \
        else accel_fn

    def accel(pos):
        with spans.span("accel"):
            return force(pos, mass)

    if integrator == "euler":
        for _ in range(steps):
            acc = accel(pos)
            vel = vel + acc * dtf
            pos = pos + vel * dtf
        return pos, vel
    if integrator == "leapfrog":
        # One extra force evaluation per block re-seeds the carried
        # acceleration (state holds no acc between blocks).
        acc = accel(pos)
        for _ in range(steps):
            vel_h = vel + acc * half  # kick
            pos = pos + vel_h * dtf  # drift
            acc = accel(pos)
            vel = vel_h + acc * half  # kick
        return pos, vel
    raise ValueError(f"unknown integrator {integrator!r}; options: {INTEGRATORS}")


def make_block_fn(accel_fn: AccelFn, dt: float, block_steps: int,
                  integrator: str = "euler", env_fn=None):
    """Sample block: advances block_steps steps on the device and returns
    (state, kinetic_energy) with the energy as a 0-d device tensor.

    ``env_fn(pos, mass)`` builds a per-block environment once at block
    entry, passed to every step (and the leapfrog re-seed) as
    ``accel_fn(pos, mass, mesh_env=env)``: the mesh solvers freeze their
    box and kernel spectra across the block with it (ops/pm.make_mesh_env)."""
    if integrator not in INTEGRATORS:
        raise ValueError(
            f"unknown integrator {integrator!r}; options: {INTEGRATORS}")

    def block(state: ParticleState):
        env = None
        if env_fn:
            with spans.span("mesh.env"):
                env = env_fn(state.pos, state.mass)
        pos, vel = advance(state.pos, state.vel, state.mass, accel_fn, dt,
                           block_steps, integrator, env=env)
        new = ParticleState(pos=pos, vel=vel, mass=state.mass, n=state.n)
        return new, kinetic_energy(new)

    return block

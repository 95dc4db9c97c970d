"""The gravity model: semi-implicit Euler stepping and the kinetic-energy
diagnostic, with a whole sample block run on the device.

Reference semantics (ver0/GSimulation.cpp:153-173):
  vel += acc * dt;  pos += vel_new * dt;  KE = 0.5 * sum(m * |v|^2)

The port of ``nbody_tpu.models.gravity`` without the TPU watchdog
host-chunking (ROADMAP.md "What is not ported"): PyTorch launches eagerly,
so a sample block is a Python loop of kernel launches with no host sync,
or one launch of the fused block, and the kinetic energy stays on the
device until the engine reads it.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from ..state import ParticleState

AccelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    """KE = 0.5 * sum_i m_i |v_i|^2 (ver0/GSimulation.cpp:167-173), as a
    0-d device tensor.  Zero-mass padding particles contribute exactly 0."""
    v = state.vel
    v2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    return 0.5 * torch.sum(state.mass * v2)


def euler_step(state: ParticleState, accel_fn: AccelFn,
               dt: float) -> ParticleState:
    """One semi-implicit Euler step (ver0/GSimulation.cpp:153-161)."""
    acc = accel_fn(state.pos, state.mass)
    vel = state.vel + acc * dt
    pos = state.pos + vel * dt
    return ParticleState(pos=pos, vel=vel, mass=state.mass, n=state.n)


def make_block_fn(accel_fn: AccelFn, dt: float, block_steps: int,
                  integrator: str = "euler"):
    """A function advancing ``block_steps`` steps on the device and
    returning (new_state, kinetic_energy_after_last_step)."""
    from .integrators import make_block_fn as _mk

    return _mk(accel_fn, dt, block_steps, integrator=integrator)


def make_fused_block_fn(dt: float, block_steps: int, tile_i: int = 0,
                        tile_j: int = 0, integrator: str = "euler"):
    """A sample block run in one kernel launch (ops/fused_block.py), with
    the same (state) -> (state, kinetic_energy) contract as make_block_fn;
    the energy is computed after the kernel.  Fused leapfrog re-seeds the
    carried acceleration each block, as the unfused leapfrog does."""
    from ..ops import fused_block as fb

    def block(state: ParticleState):
        pos, vel = fb.fused_block(state.pos, state.vel, state.mass, dt,
                                  block_steps, tile_i=tile_i, tile_j=tile_j,
                                  integrator=integrator)
        new = ParticleState(pos=pos, vel=vel, mass=state.mass, n=state.n)
        return new, kinetic_energy(new)

    return block


def make_accel_fn(kernel_name: str, **opts) -> AccelFn:
    """Bind a registry kernel with its options into the AccelFn signature."""
    from ..ops import registry

    fn = registry.get(kernel_name)
    return functools.partial(fn, **opts) if opts else fn

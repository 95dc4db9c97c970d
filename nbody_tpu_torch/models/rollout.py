"""Differentiable rollouts, the port of ``nbody_tpu.models.rollout``.

Differentiating a trajectory (fitting initial conditions, control, system
identification) needs reverse mode through many steps; plain autograd
keeps every intermediate state.  ``make_rollout_fn`` builds the rollout as
a Python loop of (optionally rematerialized) steps:

* ``remat=True`` wraps each step in ``torch.utils.checkpoint`` so the
  backward pass recomputes each step's forward instead of keeping its
  residuals: O(1) states per step at 2x the forward force sweeps.

Each step is one step of the simulation engine's semi-implicit Euler or
leapfrog (``integrators.advance``), so a rollout without remat gives the
engine's bits.  The acceleration function should carry the
analytic VJP (``make_accel_fn(..., differentiable=True)``): the CUDA
kernels refuse inputs that require grad.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..state import ParticleState
from .gravity import AccelFn
from .integrators import INTEGRATORS, advance


def make_rollout_fn(accel_fn: AccelFn, dt: float, steps: int,
                    integrator: str = "euler", remat: bool = True):
    """Returns ``rollout(pos, vel, mass) -> (pos, vel)`` advancing
    ``steps`` steps, differentiable end to end."""
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")

    def step(p, v, mass):
        return advance(p, v, mass, accel_fn, dt, 1, integrator)

    def rollout(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor):
        p, v = pos, vel
        for _ in range(steps):
            if remat:
                p, v = checkpoint(step, p, v, mass, use_reentrant=False)
            else:
                p, v = step(p, v, mass)
        return p, v

    return rollout


def rollout_state(rollout, state: ParticleState) -> ParticleState:
    """Apply a rollout to a ParticleState."""
    pos, vel = rollout(state.pos, state.vel, state.mass)
    return ParticleState(pos=pos, vel=vel, mass=state.mass, n=state.n)

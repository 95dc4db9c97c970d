"""The gravity model: semi-implicit Euler stepping, the kinetic- and
potential-energy diagnostics, with a whole sample block run on the device.

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
from ..types import G_NEWTON, SOFTENING_SQUARED
from ..utils import spans

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
                  integrator: str = "euler", env_fn=None):
    """A function advancing ``block_steps`` steps on the device and
    returning (new_state, kinetic_energy_after_last_step); ``env_fn`` as
    in ``integrators.make_block_fn``."""
    from .integrators import make_block_fn as _mk

    return _mk(accel_fn, dt, block_steps, integrator=integrator,
               env_fn=env_fn)


def make_fused_block_fn(dt: float, block_steps: int, tile_i: int = 0,
                        tile_j: int = 0, integrator: str = "euler"):
    """A sample block run in one kernel launch (ops/fused_block.py), with
    the same (state) -> (state, kinetic_energy) contract as make_block_fn;
    the energy is computed after the kernel.  Fused leapfrog re-seeds the
    carried acceleration each block, as the unfused leapfrog does.  The
    ``fused`` span opens around the call of ``fused_block``, not inside it,
    so that a range a caller wraps around that function keeps its kernel
    (the profiler credits a kernel to the innermost range)."""
    from ..ops import fused_block as fb

    def block(state: ParticleState):
        with spans.span("fused"):
            pos, vel = fb.fused_block(state.pos, state.vel, state.mass, dt,
                                      block_steps, tile_i=tile_i,
                                      tile_j=tile_j, integrator=integrator)
        new = ParticleState(pos=pos, vel=vel, mass=state.mass, n=state.n)
        return new, kinetic_energy(new)

    return block


def potential_energy(state: ParticleState, chunk: int = 1024) -> torch.Tensor:
    """Softened potential energy, consistent with the force law, as a 0-d
    device tensor: PE = -(G/2) sum_i sum_j m_i m_j (|r_ij|^2 + eps)^(-1/2).

    Includes the i==j self term, a constant (-G m^2 / (2 sqrt(eps)) per
    particle) that is irrelevant to conservation diagnostics; the reference
    likewise never masks the diagonal.  KE + PE is the conserved energy of
    the softened system.  A plain chunked sweep, as in the JAX package
    (``nbody_tpu.models.gravity.potential_energy``), which computes it
    outside any kernel."""
    pos, mass = state.pos, state.mass
    total = torch.zeros((), dtype=pos.dtype, device=pos.device)
    for c0 in range(0, pos.shape[1], chunk):
        d = pos[:, None, :] - pos[:, c0:c0 + chunk, None]  # (3, c, N)
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + SOFTENING_SQUARED
        inv = 1.0 / torch.sqrt(d2)
        total = total + torch.sum((mass[c0:c0 + chunk, None] * mass[None, :]) * inv)
    return (-0.5 * G_NEWTON) * total


def make_accel_fn(kernel_name: str, differentiable: bool = False,
                  backward_opts: dict | None = None, **opts) -> AccelFn:
    """Bind a registry kernel with its options into the AccelFn signature.

    ``differentiable=True`` attaches the analytic VJP (ops/grad.py), the
    only way to differentiate through the CUDA kernels, which autograd
    cannot see.  ``backward_opts`` flow to ``grad.differentiable``
    (``backward``: 'jnp', 'pallas' or 'auto'; ``chunk``; the kernel's
    ``tile_i``/``tile_j``).

    The mesh tiers take no exact-pair VJP, which would return all-pairs
    cotangents for a mesh forward: they differentiate natively, plain
    ``pm`` through autograd, and ``p3m`` (or ``pm`` with a cutoff) through
    ``differentiable=True`` in the mesh options, whose short-range sweep
    carries its own VJP (ops/pm.py)."""
    from ..ops import registry

    fn = registry.get(kernel_name)
    if kernel_name in ("pm", "p3m"):
        if backward_opts:
            raise ValueError(
                "backward_opts tune the exact-pair analytic VJP and do not "
                f"apply to the native-AD mesh tier '{kernel_name}'")
        if differentiable:
            opts = dict(opts, differentiable=True)
        return functools.partial(fn, **opts) if opts else fn
    if opts:
        fn = functools.partial(fn, **opts)
    if differentiable:
        from ..ops.grad import differentiable as _diff

        fn = _diff(fn, **(backward_opts or {}))
    return fn

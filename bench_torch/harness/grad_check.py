"""Whether a rollout gradient is correct (the ``rollout_grad`` job): the
program's gradients held against the plain reference's at the timed
sizes.

The reference rebuilds the initial state from the seed, runs the same
``block_steps``-step semi-implicit Euler rollout with the solver's force
of ``references/<solver>_grad.py`` (box, cutoff and spectra made on every
force call, as the program's differentiable path makes them), each step
checkpointed, and takes the gradient of the same loss by autograd, in
float64.  The numbers compared, each against the limit in
``checks/<workload>.json``:

* ``loss``: the widest relative gap of the loss the host read, over every
  gradient of the window;
* ``gx``, ``gv``: the relative L2 gaps of the gradients with respect to
  the initial positions and velocities, over all bodies;
* ``x``: the relative L2 gap of the final positions against the distance
  moved;

each of ``gx``, ``gv`` and ``x`` for the window's first gradient and its
last, the larger.  Besides, ``overflow``, limit 0: the largest share of
bodies past their cell's capacity, or count of worklist entries dropped,
in any step of those two gradients, since the reference bins every body.
A number the window gave no reading for (NaN) fails.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import ics, reference
from .check import rel_l2

NUMBERS = ("loss", "gx", "gv", "x")
# The number the host reads a block: failed_blocks counts against it.
HOST_READ = "loss"


def limits(check: dict) -> dict:
    """The check file's limits, and no overflow at all."""
    return dict(check["limits"], overflow={"limit": 0.0})


def rollout_loss(x0, v0, force, dt: float, steps: int, target):
    """(L, x(steps)): ``steps`` steps of v += a dt, x += v dt from (x0, v0)
    under ``force`` (positions -> accelerations), each step checkpointed,
    and L = sum_i |x_i(steps) - target_i|^2 in float64."""
    def step(x, v):
        v = v + force(x) * dt
        return x + v * dt, v

    x, v = x0, v0
    for _ in range(steps):
        x, v = checkpoint(step, x, v, use_reentrant=False)
    d = x.double() - target
    return (d * d).sum(), x


def rollout_gradient(pos, vel, mass, config: dict, dt: float, steps: int,
                     dtype=torch.float64, control: bool = False) -> dict:
    """The loss, L = sum_i |x_i(steps) - c_i|^2 with c = x(0) + steps dt
    v(0) (a constant, in float64), and its gradients with respect to x(0)
    and v(0), of ``steps`` steps from the initial state (host or device
    float32 tensors) under the solver's force for a gradient, in
    ``dtype``.  Returns the loss and the final positions and both
    gradients on the host in float64."""
    reference.check_constants(config)
    force = reference.solver(config["solver"] + "_grad").force(
        config, mass.to(dtype), dtype, control)
    # The program steps in float32: the same step, rounded.
    dt = float(np.float32(dt))
    target = pos.double() + (steps * dt) * vel.double()
    x0 = pos.to(dtype).requires_grad_(True)
    v0 = vel.to(dtype).requires_grad_(True)
    loss, x = rollout_loss(x0, v0, force, dt, steps, target)
    gx, gv = torch.autograd.grad(loss, (x0, v0))
    return dict(loss=float(loss.detach()), x=x.detach().double().cpu(),
                gx=gx.double().cpu(), gv=gv.double().cpu())


def reference_run(config: dict, traffic: dict, check: dict, seed: int,
                  device, control: bool = False):
    """(initial pos, vel, mass as float64 host tensors, the reference's
    gradient) for this cell and seed."""
    pos, vel, mass = (torch.from_numpy(a).to(device) for a in ics.make(
        traffic["distribution"], int(traffic["n"]), int(seed)))
    ref = rollout_gradient(
        pos, vel, mass, config, float(traffic["dt"]),
        int(traffic["block_steps"]),
        dtype=torch.float32 if control else torch.float64, control=control)
    return tuple(t.double().cpu() for t in (pos, vel, mass)), ref


def numbers(initial, ref: dict, losses, first: dict, last: dict) -> dict:
    """The compared numbers.  ``losses``: (block in segment, loss) of every
    gradient; ``first``/``last``: block -> the kept gradient on the host
    (``RolloutGrad.host``) of the window's first and last."""
    x0 = initial[0]
    gaps = [abs(loss - ref["loss"]) / abs(ref["loss"]) for _, loss in losses]
    out = {"loss": max(gaps) if gaps else math.nan}
    kept = [seg[0] for seg in (first, last) if 0 in seg]
    for name, scale in (("gx", ref["gx"]), ("gv", ref["gv"]),
                        ("x", ref["x"] - x0)):
        out[name] = max((rel_l2(g[name], ref[name], scale) for g in kept),
                        default=math.nan)
    out["overflow"] = max((g["overflow"] for g in kept), default=math.nan)
    # NaN compares false: a reading that is NaN fails.
    return out


def failed_blocks(ref: dict, losses, limit: float) -> int:
    """The window's gradients whose loss is off by more than ``limit``."""
    return sum(1 for _, loss in losses
               if not abs(loss - ref["loss"]) <= limit * abs(ref["loss"]))


def control_outputs(cell, seed: int, device):
    """The reference control's answers, shaped as the window's: its loss,
    and its gradient kept as the window's first and last."""
    _, ref = reference_run(cell.config, cell.traffic, cell.check, seed,
                           device, control=True)
    kept = {0: dict(ref, overflow=0.0)}
    return [(0, ref["loss"])], kept, kept

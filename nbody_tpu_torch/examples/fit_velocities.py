"""Differentiable simulation demo: recover initial velocities by gradient
descent through the rollout.

The port of ``examples/fit_velocities.py``: the whole force + integrate
trajectory is differentiable (the analytic force VJP, ops/grad.py), so
fitting initial conditions to hit a target state is a few lines of
optimization.  On the card the forward sweeps run through the registry's
kernel and the backward through the force VJP kernel (csrc/vjp.cu).

    python -m nbody_tpu_torch.examples.fit_velocities [N] [steps] [iters]
        [kernel] [--platform {cuda,cpu}]

``kernel`` is a registry name (default ``auto``: Kernel B on the card,
``naive`` on the CPU).  ``p3m`` fits through the differentiable O(N log N)
mesh tier instead (ops/pm.py, ``differentiable=True``): the short-range
sweep runs its kernel forward (csrc/sr.cu) and its VJP kernel backward
(csrc/sr_vjp.cu) on the card; ``pm`` and ``p3m`` take the JAX example's
mesh options, grid 32 and capacity 64.  Exits 0 when the recovered
velocities are within 5% of the true ones.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..config import KERNELS, PLATFORMS, SimConfig
from ..init import reference_init_arrays
from ..models.gravity import make_accel_fn
from ..models.rollout import make_rollout_fn
from ..state import from_numpy


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nbody_tpu_torch.examples.fit_velocities",
                                description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=128)
    p.add_argument("steps", nargs="?", type=int, default=10)
    p.add_argument("iters", nargs="?", type=int, default=60)
    p.add_argument("kernel", nargs="?", default="auto", choices=KERNELS)
    p.add_argument("--platform", default="cuda", choices=PLATFORMS)
    args = p.parse_args(argv)
    device = SimConfig(n=args.n, platform=args.platform).device()

    st = from_numpy(*reference_init_arrays(args.n), args.n, device=device)
    pos0, vel_true, mass = st.pos, st.vel, st.mass
    opts = dict(grid=32, capacity=64) if args.kernel in ("pm", "p3m") else {}
    accel = make_accel_fn(args.kernel, differentiable=True, **opts)
    rollout = make_rollout_fn(accel, 0.1, args.steps, remat=False)
    with torch.no_grad():
        target = rollout(pos0, vel_true, mass)[0]  # "observed" final positions

    vel = torch.zeros_like(vel_true)
    # d(final pos)/d(vel) ~ steps*dt to leading order, so this step size
    # contracts the velocity error by ~0.6 per iteration.
    lr = 0.4 / (args.steps * 0.1) ** 2
    t0 = time.perf_counter()
    for it in range(args.iters):
        vel.requires_grad_(True)
        d = rollout(pos0, vel, mass)[0] - target
        loss = torch.sum(d * d)
        loss.backward()
        with torch.no_grad():
            vel = vel - lr * vel.grad
        if it % 10 == 0 or it == args.iters - 1:
            err = float(torch.linalg.norm(vel - vel_true)
                        / torch.linalg.norm(vel_true))
            print(f" iter {it:4d}: loss={float(loss.detach()):.3e}  vel rel err={err:.3e}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = (time.perf_counter() - t0) / max(args.iters, 1)

    final_err = float(torch.linalg.norm(vel - vel_true)
                      / torch.linalg.norm(vel_true))
    print(f" recovered initial velocities to {final_err:.2%} relative error")
    print(f" {secs:.6f} s per iteration on {device}")
    return 0 if final_err < 0.05 else 1


if __name__ == "__main__":
    sys.exit(main())

"""The plain reference: softened gravity with semi-implicit Euler, in plain
PyTorch.

It imports nothing of the program and takes nothing the program made: the
check rebuilds the initial state from the seed (``ics.py``) and this module
follows the segment's first blocks.  The force of each solver is a module
of its own, ``references/<solver>.py`` for the configuration's ``solver``,
found by name: its ``forces(config, mass, dtype, control)`` returns, for a
block's entry positions, that block's force function (positions ->
accelerations).  It runs in float64 for the check; ``control`` asks the
solver for its control (the reference in the precision below the
configuration's), where the configuration has no program path for one.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

G_NEWTON = 6.67259e-11
SOFTENING_SQUARED = 1e-3

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return torch.complex(round_bf16(x.real), round_bf16(x.imag))
    return x.to(torch.bfloat16).to(x.dtype)


def kinetic_energy(vel: torch.Tensor, mass: torch.Tensor) -> float:
    v = vel.double()
    return float(0.5 * (mass.double() * (v * v).sum(0)).sum())


def solver(name: str):
    """The module ``references/<name>.py``."""
    path = os.path.join(HERE, "references", name + ".py")
    if not os.path.exists(path):
        raise ValueError(f"no reference for solver {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "bench_reference_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_constants(config: dict) -> None:
    """The reference's constants are the upstream's; a configuration with
    others is refused."""
    if (config["G"], config["softening_squared"]) != (G_NEWTON,
                                                      SOFTENING_SQUARED):
        raise ValueError("the reference's constants are the upstream's: "
                         f"G {G_NEWTON}, eps^2 {SOFTENING_SQUARED}")


def follow(pos, vel, mass, config: dict, dt: float, block_steps: int,
           blocks: int, dtype=torch.float64, control: bool = False) -> list:
    """Advance the initial state (host or device tensors) by ``blocks``
    sample blocks of ``block_steps`` steps of v += a dt, x += v dt.
    Returns, after each block, (kinetic energy, pos, vel) with pos and vel
    on the host in float64."""
    check_constants(config)
    pos, vel, mass = (t.to(dtype) for t in (pos, vel, mass))
    # The program steps in float32: the same step, rounded.
    dt = float(np.float32(dt))
    block_forces = solver(config["solver"]).forces(config, mass, dtype,
                                                   control)
    out = []
    for _ in range(blocks):
        accel = block_forces(pos)
        for _ in range(block_steps):
            vel = vel + accel(pos) * dt
            pos = pos + vel * dt
        out.append((kinetic_energy(vel, mass), pos.double().cpu(),
                    vel.double().cpu()))
    return out

"""Whether what the window produced is correct: the program's answers held
against the plain reference (``reference.py``) at the timed sizes.  This
is the check of the block loop; ``grad_check.py`` is the rollout
gradient's, with the same functions.

The reference rebuilds the initial state from the seed and follows the
segment's first ``reference_blocks`` blocks in float64.  The numbers
compared, each against the limit in ``checks/<workload>.json``:

* ``ke``: the widest relative gap of a block's kinetic energy, as the host
  loop read it, over every block of the window that the reference follows;
* ``dv``: the relative L2 gap of the velocity change over the segment's
  first block, over all particles (the force layer, one block);
* ``x``: the relative L2 gap of the positions after the last block the
  reference follows, against the distance the particles moved (the
  integrator over that run), for the window's first and last segments.

A number the window gave no reading for (NaN) fails.
"""

from __future__ import annotations

import math

import torch

from . import ics, reference

NUMBERS = ("ke", "dv", "x")
# The number the host reads a block: failed_blocks counts against it.
HOST_READ = "ke"


def limits(check: dict) -> dict:
    """The check file's limits."""
    return check["limits"]


def keep_blocks(check: dict) -> tuple:
    """The blocks of a segment whose end state the check reads."""
    return tuple(sorted({0, int(check["reference_blocks"]) - 1}))


def reference_run(config: dict, traffic: dict, check: dict, seed: int,
                  device, control: bool = False):
    """(initial pos, vel, mass as float64 host tensors, the reference's
    blocks) for this cell and seed."""
    pos, vel, mass = (torch.from_numpy(a) for a in ics.make(
        traffic["distribution"], int(traffic["n"]), int(seed)))
    dtype = torch.float32 if control else torch.float64
    with torch.no_grad():
        blocks = reference.follow(
            pos.to(device), vel.to(device), mass.to(device), config,
            float(traffic["dt"]), int(traffic["block_steps"]),
            int(check["reference_blocks"]), dtype=dtype, control=control)
    return (pos.double(), vel.double(), mass.double()), blocks


def rel_l2(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> float:
    den = float(scale.norm())
    return float((a - b).norm()) / den if den > 0 else math.inf


def numbers(initial, ref_blocks, kes, first: dict, last: dict) -> dict:
    """The compared numbers.  ``kes``: (block in segment, kinetic energy)
    of every block; ``first``/``last``: block -> (pos, vel) host float64
    (3, N) of the window's first and last whole segments."""
    x0, v0, _ = initial
    nb = len(ref_blocks)
    gaps = [abs(ke - ref_blocks[k][0]) / abs(ref_blocks[k][0])
            for k, ke in kes if k < nb]
    out = {"ke": max(gaps) if gaps else math.nan}
    if 0 in first:
        dv_ref = ref_blocks[0][2] - v0
        out["dv"] = rel_l2(first[0][1] - v0, dv_ref, dv_ref)
    else:
        out["dv"] = math.nan
    xs = []
    x_ref = ref_blocks[nb - 1][1]
    for seg in (first, last):
        if nb - 1 in seg:
            xs.append(rel_l2(seg[nb - 1][0], x_ref, x_ref - x0))
    out["x"] = max(xs) if xs else math.nan
    # NaN compares false: a reading that is NaN fails below.
    return out


def failed_blocks(ref_blocks, kes, limit: float) -> int:
    """The window's blocks whose kinetic energy is off by more than
    ``limit``, among those the reference follows."""
    nb = len(ref_blocks)
    return sum(1 for k, ke in kes if k < nb and not abs(
        ke - ref_blocks[k][0]) <= limit * abs(ref_blocks[k][0]))


def control_outputs(cell, seed: int, device):
    """The reference control's answers, shaped as the window's: every
    block's kinetic energy, and the kept states of one segment."""
    _, blocks = reference_run(cell.config, cell.traffic, cell.check, seed,
                              device, control=True)
    kes = [(k, b[0]) for k, b in enumerate(blocks)]
    states = {k: (b[1], b[2]) for k, b in enumerate(blocks)}
    return kes, states, states


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers with a limit."""
    shown, ok = {}, True
    for name, spec in limits.items():
        v = values.get(name, math.nan)
        passed = v <= spec["limit"]  # False for NaN
        ok = ok and passed
        # No reading prints as null: the result line stays strict JSON.
        shown[name] = {"value": v if math.isfinite(v) else None,
                       "limit": spec["limit"]}
    return ok, shown


"""The yardstick: the card's published peaks, the upstream's FLOP model and
the least work of each kernel, counted from the inputs.

Copied here, not imported, so that a change to the program cannot move it:
the FLOP model of the upstream (``nbody_tpu_torch/utils/flops.py``, from
``ver0/GSimulation.cpp:122``) and the rates and per-pair operation counts of
``chip_smoke.py`` (``FP32_RATE``, ``HBM_RATE``, ``OPS_SYM``, ``OPS_SR``,
``OPS_SR_REACTION``).  The VJP's count is worked out here from its
mathematics (``OPS_SR_VJP``).
"""

from __future__ import annotations

import torch

from . import neighbours

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit: fp32 outside the
# tensor cores, and HBM3.
FP32_RATE = 67e12
HBM_RATE = 3.35e12

# fp32 operations a pair evaluation (sqrt, divide and rsqrt count one, an
# FMA two).  An unordered pair of the exact sweep, both sides: 3 sub, 6 for
# |d|^2 + eps^2, sqrt, divide, 2 cube, 2 mass, 3 FMA each side.
OPS_SYM = 27
# A pair of the short-range sweep: 3 sub, 5 |d|^2, eps, rsqrt, 3 clamp,
# 7 taper, 4 weight, 1 mass, 3 FMA; the reaction on the source: target
# mass, 3 products, 3 adds.
OPS_SR = 31
OPS_SR_REACTION = 7
# Bytes a particle of a force call: position and mass read, acceleration
# written, each once.
BYTES_PER_BODY = 28
# An unordered pair of the short-range sum's VJP for the positions'
# cotangent (the masses take none in a gradient with respect to the
# state), from the pair's terms: with d = x_j - x_i, q = |d|^2 / r_c^2 < 1
# inside the cutoff, w = (1 - S(q)) u^3 and the cotangents g_i, g_j of both
# sides' accelerations, h = m_j g_i - m_i g_j (the reaction's side
# included), V = w h + 2 w' (h . d) d adds to gp_j and from gp_i, and
# k (h . d) to r_c^2's.  3 sub, 5 |d|^2, eps, rsqrt, u^2, u^3, q 1, the
# taper 8 (S 7 and 1 - S), w 1, S'(q) 4, w' 5, k 2; h 9, h . d 5,
# 2 w' (h . d) 2, V 9, gp both sides 6, r_c^2's 2.
OPS_SR_VJP = 66
# Bytes a body of the VJP: position, mass and cotangent read, the
# position's cotangent written, each once.
BYTES_PER_BODY_VJP = 40


def step_flops(n: int) -> float:
    """The upstream's FLOP model of one step: (11 + 18) N^2 + 19 N."""
    nd = float(n)
    return 29.0 * nd * nd + 19.0 * nd


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the fp32 rate and the bytes at the memory rate."""
    return max(ops / FP32_RATE, nbytes / HBM_RATE)


def direct_step_seconds(n: int) -> float:
    """One all-pairs force evaluation: every unordered pair once."""
    return least_seconds(OPS_SYM * n * n / 2.0, BYTES_PER_BODY * n)


def sr_step_seconds(pairs: float, bodies: float) -> float:
    """One short-range sum: each unordered pair inside the cutoff once,
    with its reaction."""
    return least_seconds((OPS_SR + OPS_SR_REACTION) * pairs,
                         BYTES_PER_BODY * bodies)


def sr_vjp_step_seconds(pairs: float, bodies: float) -> float:
    """One short-range sum's VJP: each unordered pair inside the cutoff
    once, both sides' cotangents with it; pairs beyond the cutoff, which a
    layout may evaluate, are not counted."""
    return least_seconds(OPS_SR_VJP * pairs, BYTES_PER_BODY_VJP * bodies)


def sr_pairs(pos: torch.Tensor, mass: torch.Tensor, grid: int,
             cutoff_cells: int) -> tuple[int, int]:
    """(unordered pairs inside the cutoff radius, bodies) of the short-range
    sum on this state: the bodies are those it takes (massive, inside the
    mesh box), the radius the box's (the plain reference's geometry).
    pos (3, N), mass (N,) float32."""
    lo, hi = neighbours.robust_box(pos, mass)
    span = hi - lo
    nc, sub = neighbours.cell_grid(grid, cutoff_cells)
    rc2 = float(neighbours.cutoff_squared(span, nc, sub))
    members = neighbours.in_box(pos, mass, lo, hi)
    count = sum(int(i.shape[0]) for i, _, _, _ in neighbours.near_pairs(
        pos, members, lo, span, nc, sub, rc2))
    return count, int(members.sum())


def mean_sr_pairs(states, grid: int, cutoff_cells: int) -> tuple:
    """(pairs, bodies) of ``sr_pairs``, each the mean over the (pos, mass)
    ``states``."""
    counts = [sr_pairs(pos, mass, grid, cutoff_cells) for pos, mass in states]
    return (sum(c[0] for c in counts) / len(counts),
            sum(c[1] for c in counts) / len(counts))

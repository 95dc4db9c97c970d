"""The yardstick's counts: the FLOP model, the least times, and the pairs
inside the cutoff against a brute-force count."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import ics, neighbours, yardstick  # noqa: E402


def test_step_flops_is_the_upstream_model():
    assert yardstick.step_flops(2000) == 29 * 2000 ** 2 + 19 * 2000
    assert yardstick.step_flops(16384) == 29.0 * 16384 ** 2 + 19.0 * 16384


def test_direct_least_time_compute_and_memory_bound():
    n = 16384
    ops = 27 * n * n / 2
    assert yardstick.direct_step_seconds(n) == pytest.approx(ops / 67e12)
    # One body: 28 bytes outweigh 13.5 operations.
    assert yardstick.direct_step_seconds(1) == pytest.approx(28 / 3.35e12)


def test_sr_least_time():
    assert yardstick.sr_step_seconds(1e8, 1e6) == pytest.approx(
        38 * 1e8 / 67e12)
    assert yardstick.sr_step_seconds(1, 1e6) == pytest.approx(
        28 * 1e6 / 3.35e12)


def test_sr_vjp_pair_count():
    """The VJP's count a pair, as ``chip_smoke.py`` counts the kernel's
    work (OPS_SR_VJP 68 an evaluation inside the cutoff with its distance
    test, OPS_SR_VJP_REACTION 13 for the reaction's side), less what the
    mathematics of a pair inside the cutoff does not need: the distance
    test's compare, and both masses' cotangents (7 each), since the masses
    take none."""
    assert yardstick.OPS_SR_VJP == 68 + 13 - 1 - 2 * 7


def test_sr_vjp_least_time_compute_and_memory_bound():
    assert yardstick.sr_vjp_step_seconds(1e8, 1e6) == pytest.approx(
        66 * 1e8 / 67e12)
    # Few pairs: 40 bytes a body read and written outweigh them.
    assert yardstick.sr_vjp_step_seconds(1, 1e6) == pytest.approx(
        40 * 1e6 / 3.35e12)


def brute_pairs(pos, mass, grid, cutoff):
    """Every unordered pair of the bodies the short-range sum takes, by
    all pairs at once."""
    lo, hi = neighbours.robust_box(pos, mass)
    span = hi - lo
    nc, sub = neighbours.cell_grid(grid, cutoff)
    rc2 = float((span[:, 0].min() * sub / nc) ** 2)
    inside = ((pos >= lo) & (pos <= hi)).all(0) & (mass > 0)
    p = pos[:, inside].double().numpy()
    d = p[:, :, None] - p[:, None, :]
    r2 = (d * d).sum(0)
    iu = np.triu_indices(p.shape[1], 1)
    return int((r2[iu] < rc2).sum()), p.shape[1]


@pytest.mark.parametrize("dist,n,grid,cutoff", [
    ("plummer", 3000, 16, 2),     # sub 2
    ("plummer", 3000, 128, 4),    # sub 1, bodies outside the box
    ("reference", 2500, 64, 4),
])
def test_sr_pairs_against_brute_force(dist, n, grid, cutoff):
    pos, _, mass = (torch.from_numpy(a) for a in ics.make(dist, n, 11))
    got = yardstick.sr_pairs(pos, mass, grid, cutoff)
    assert got == brute_pairs(pos, mass, grid, cutoff)
    assert got[0] > 0


def test_neighbour_pairs_cover_each_unordered_pair_once():
    pos, _, mass = (torch.from_numpy(a) for a in ics.make("plummer", 800, 3))
    lo, hi = neighbours.robust_box(pos, mass)
    nc, reach = 16, 2
    cid = neighbours.cell_ids(pos, lo, hi - lo, nc)
    members = torch.ones(800, dtype=torch.bool)
    members[::7] = False
    got = torch.cat([torch.stack(p) for p in neighbours.neighbour_pairs(
        cid, members, nc, reach, chunk=5000)], 1)
    a, b = torch.minimum(got[0], got[1]), torch.maximum(got[0], got[1])
    assert bool((a != b).all())
    keys = a * 800 + b
    assert keys.unique().numel() == keys.numel()
    c = torch.stack([cid // (nc * nc), (cid // nc) % nc, cid % nc])
    near = ((c[:, :, None] - c[:, None, :]).abs() <= reach).all(0)
    near &= members[:, None] & members[None, :]
    near &= torch.triu(torch.ones(800, 800, dtype=torch.bool), 1)
    assert keys.numel() == int(near.sum())
    assert bool(near[a, b].all())

"""The P3M short-range sweep's schedule (``csrc/sr.cu``), emulated in plain
PyTorch on the CPU, against the plain sweep and the JAX package's.

The kernel runs only on a card; what it computes beyond the plain sweep's
arithmetic is its schedule, which these tests model step by step:

* units of ``kUnit`` worklist entries (read from ``csrc/sr.cu``), one
  group each, cut into segments at run ends; a segment that is a whole run
  stores its sum, the others leave a head or tail partial that the
  finalize pass adds in unit order;
* each slab's targets split into two compact warps
  (``sr_kernel.split_order``, checked against the kernel's rank rule);
* the two warp-uniform skips, a source beyond the warp's bounding box and
  a (warp, source) step with q >= 1 on every lane: both drop only weights
  that are exactly 0;
* the sub-cell order of the packed tables (``pm._subcell_key``): each
  cell's slots in key order, the particles binned as the JAX package bins
  them, and fewer (warp, source) steps kept than in input order on a
  clustered state;
* the reaction summed over a warp's targets for each source.

Tolerances: the emulated schedule equals the plain sweep within 2e-5 of
the largest occupied slot (``SR_TOL``, as ``chip_smoke.py`` holds the
kernel), fp32 sums in other orders; every entry in ``[bounds[0],
bounds[1])`` is visited exactly once under a 4-way split of the bounds,
and every partial written is read exactly once.  Inputs are Plummer
spheres from a seed (bit-equal to the JAX package's) at N <= 4096.
"""

import bisect
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import pm as jax_pm
from nbody_tpu_torch.models import distributions
from nbody_tpu_torch.ops import pm, sr_kernel
from nbody_tpu_torch.types import SOFTENING_SQUARED
from tests.torch_pack_util import subcell_key_np

torch.set_num_threads(2)

SR_TOL = 2e-5
SR_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "nbody_tpu_torch", "csrc", "sr.cu")


def _unit() -> int:
    """The kernel's entries a unit, as csrc/sr.cu declares it."""
    with open(SR_CU) as f:
        return int(re.search(r"constexpr int kUnit = (\d+);", f.read())[1])


def _pack(n, ng, seed, layout):
    pos, _, mass = distributions.plummer(n, seed=seed)
    p, m = torch.tensor(pos), torch.tensor(mass)
    sym, paired = pm.SR_LAYOUTS[layout]
    plan = pm.suggest_sr_plan(p, m, ng, 4, layout=layout)
    pk = pm.sr_pack_inputs(p, m, grid=ng, cutoff_cells=4, symmetric=sym,
                           paired=paired, **plan)
    assert int(pk["n_e"]) <= pk["e_max"]
    return pk, sym, paired


def _dist(dx, dy, dz, inv_rc2, eps_q):
    """The kernel's sr_dist in f32 ops: d2 = ((dx^2 + eps) + dy^2) + dz^2,
    q = d2 / rc2 - eps / rc2."""
    d2 = ((dx * dx + SOFTENING_SQUARED) + dy * dy) + dz * dz
    return d2, d2 * inv_rc2 + eps_q


def _keep(q):
    """The kernel's sr_keep: 1 - S(q) as 1 + q^3 (-10 + q (15 - 6 q))."""
    qc = torch.clamp(q, max=1.0)
    return (qc * qc * qc) * ((-6.0 * qc + 15.0) * qc - 10.0) + 1.0


def _schedule_sweep(ptab, mtab, wl_t, wl_s, bounds, rc2, symmetric, paired,
                    unit):
    """csrc/sr.cu's sweep, schedule and skips, in plain PyTorch.

    Returns (out (3, nslots), visits (e_max,), skipped steps, steps)."""
    width = 2 * pm.SLAB if paired else pm.SLAB
    nslots = ptab.shape[1]
    nslab = nslots // pm.SLAB
    tab = sr_kernel.packed_table(ptab, mtab)
    order = sr_kernel.split_order(tab[:nslab * pm.SLAB].view(nslab, pm.SLAB,
                                                             4))
    inv_rc2 = 1.0 / rc2
    eps_q = -SOFTENING_SQUARED * inv_rc2
    fwd, react = torch.zeros_like(ptab), torch.zeros_like(ptab)
    e_max = wl_t.shape[0]
    b0, b1 = max(int(bounds[0]), 0), min(int(bounds[1]), e_max)
    t_l, s_l = wl_t.tolist(), wl_s.tolist()
    visits = torch.zeros(e_max, dtype=torch.int64)
    part, skipped, steps = {}, 0, 0
    lane_hi = torch.arange(width) >= pm.SLAB
    for u in range(b0 // unit, -(-b1 // unit)):
        e0, e1 = max(u * unit, b0), min(u * unit + unit, b1)
        e = e0
        while e < e1:
            t = t_l[e]
            end = e + 1
            while end < e1 and t_l[end] == t:
                end += 1
            starts = e == b0 or t_l[e - 1] != t
            ends = end == b1 or t_l[end] != t
            visits[e:end] += 1
            slots = t * pm.SLAB + order[t]  # thread k -> its target slot
            tg = tab[slots]  # (64, 4), warp w = rows 32 w .. 32 w + 31
            se = torch.tensor(s_l[e:end])
            src = tab.view(-1, width, 4)[se]  # (n, width, 4)
            d = src[:, None, :, :3] - tg[None, :, None, :3]
            d2, q = _dist(d[..., 0], d[..., 1], d[..., 2], inv_rc2, eps_q)
            w = _keep(q) * torch.rsqrt(d2) ** 3  # (n, 64, width)
            # The box skip: a source beyond a warp's box is beyond for
            # every lane, and the vote: every lane beyond, weight exactly 0.
            box = tg[:, :3].view(2, 32, 3)
            lo, hi = box.amin(1), box.amax(1)  # (warp, 3)
            gap = torch.clamp(torch.maximum(lo[None, :, None] - src[:, None, :, :3],
                                            src[:, None, :, :3] - hi[None, :, None]),
                              min=0.0)  # (n, warp, width, 3)
            _, qb = _dist(gap[..., 0], gap[..., 1], gap[..., 2], inv_rc2,
                          eps_q)
            qw = q.view(-1, 2, 32, width)
            assert bool((qw.amin(2) >= qb).all()), "the box test is not a bound"
            vote = (qw >= 1.0).all(dim=2)  # (n, warp, width)
            assert bool((w.view(-1, 2, 32, width)[vote[:, :, None, :].expand(
                -1, -1, 32, -1)] == 0).all()), "a skipped weight is not 0"
            skipped += int(vote.sum())
            steps += vote.numel()
            wf = w * src[:, None, :, 3]
            if symmetric:
                lane_slab = 2 * se[:, None] + lane_hi if paired else se[:, None]
                fwd_on = lane_slab >= t if paired else torch.ones_like(lane_slab,
                                                                       dtype=torch.bool)
                react_on = lane_slab > t if paired else lane_slab != t
                wf = wf * fwd_on[:, None, :]
                # Each warp's reaction on each source: a sum over its 32
                # targets, then the two warps (the atomics), then slots.
                wr = -(w * tg[None, :, 3, None]) * react_on[:, None, :]
                rw = (wr[..., None] * d).view(-1, 2, 32, width, 3).sum(dim=2)
                r_src = (rw[:, 0] + rw[:, 1]).reshape(-1, 3)  # (n * width, 3)
                r_slot = (se[:, None] * width + torch.arange(width)).reshape(-1)
                keep = r_slot < nslots
                react.index_add_(1, r_slot[keep], r_src[keep].t())
            a = (wf[..., None] * d).sum(dim=(0, 2))  # (64, 3)
            if starts and ends:
                fwd[:, slots] = a.t()
            else:
                part[(u, 1 if starts else 0)] = (slots, a)
            e = end
    used = set()
    for t in range(nslab):  # the finalize pass
        r0 = bisect.bisect_left(t_l, t, b0, b1)
        r1 = bisect.bisect_left(t_l, t + 1, r0, b1)
        c0, c1 = r0 // unit, (r1 - 1) // unit
        if r0 >= r1 or c0 == c1:
            continue
        slots, acc = part[(c0, 1)]
        used.add((c0, 1))
        for c in range(c0 + 1, c1 + 1):
            s2, a2 = part[(c, 0)]
            assert torch.equal(s2, slots)
            used.add((c, 0))
            acc = acc + a2
        fwd[:, slots] = acc.t()
    assert used == set(part), "a partial is written and never read"
    out = fwd + react if symmetric else fwd
    out[:, nslots - pm.SLAB:] = 0.0
    return out, visits, skipped, steps


def _close(got, want, mtab):
    occ = mtab > 0
    scale = float(want[:, occ].abs().max())
    return float((got - want)[:, occ].abs().max()) <= SR_TOL * scale


@pytest.mark.parametrize("layout", sorted(pm.SR_LAYOUTS))
def test_schedule_matches_plain_sweep(layout):
    pk, sym, paired = _pack(4096, 64, 3, layout)
    tabs = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"])
    bounds = torch.stack([torch.zeros_like(pk["n_e"]), pk["n_e"]])
    got, visits, skipped, steps = _schedule_sweep(
        *tabs, bounds, pk["rc2"], sym, paired, _unit())
    want = sr_kernel.sweep_plain(*tabs, bounds, pk["rc2"], symmetric=sym,
                                 paired=paired)
    assert _close(got, want, pk["mtab"])
    assert bool((visits[:int(pk["n_e"])] == 1).all())
    assert 0 < skipped < steps


@pytest.mark.parametrize("layout", ["pallas_paired", "pallas_paired_sym",
                                    "pallas_sym"])
def test_schedule_bounds_split_visits_each_entry_once(layout):
    """Four bounds that cut runs and units anywhere: each entry in
    [bounds[0], bounds[1]) is visited once in all, and the parts sum to the
    full sweep."""
    pk, sym, paired = _pack(2048, 32, 5, layout)
    tabs = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"])
    n_e = int(pk["n_e"])
    per = -(-n_e // 4) + 3  # not a multiple of a unit
    visits = torch.zeros(pk["e_max"], dtype=torch.int64)
    total = torch.zeros_like(pk["ptab"])
    for i in range(4):
        b = torch.tensor([i * per, min((i + 1) * per, n_e)], dtype=torch.int32)
        out, v, _, _ = _schedule_sweep(*tabs, b, pk["rc2"], sym, paired,
                                       _unit())
        visits += v
        total += out
    assert bool((visits[:n_e] == 1).all()) and int(visits[n_e:].sum()) == 0
    full = sr_kernel.sweep_plain(*tabs, torch.tensor([0, n_e], dtype=torch.int32),
                                 pk["rc2"], symmetric=sym, paired=paired)
    assert _close(total, full, pk["mtab"])


@pytest.mark.parametrize("layout", ["pallas", "pallas_paired_sym"])
def test_schedule_matches_jax_sweep(layout):
    """The emulated schedule against the JAX package's sweep on the same
    tables: ``_sr_sweep`` unpaired, ``_sr_sweep_pallas`` in interpret mode
    paired."""
    pk, sym, paired = _pack(1024, 32, 11, layout)
    tabs = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"])
    bounds = torch.stack([torch.zeros_like(pk["n_e"]), pk["n_e"]])
    got, _, _, _ = _schedule_sweep(*tabs, bounds, pk["rc2"], sym, paired,
                                   _unit())
    args = [jnp.asarray(t.numpy()) for t in tabs]
    rc2 = jnp.asarray(pk["rc2"].numpy())
    if paired:
        want = jax_pm._sr_sweep_pallas(*args, (0, int(pk["n_e"])), rc2,
                                       chunk=128, interpret=True,
                                       symmetric=sym, paired=True)
    else:
        want = jax_pm._sr_sweep(*args, jnp.asarray(pk["n_e"].numpy()), rc2,
                                symmetric=sym)
    assert _close(got, torch.tensor(np.asarray(want)), pk["mtab"])


def test_weight_is_exactly_zero_beyond_the_cutoff():
    """Every pair with q = r2 * inv_rc2 >= 1 in f32 has weight exactly 0,
    in the plain taper and in the kernel's Horner form, and so does every
    pair whose q the kernel takes from d2; the plain sweep's own q = r2 /
    rc2 differs from these only on the cutoff, where 1 - S is below 1e-12."""
    pk, _, paired = _pack(2048, 32, 7, "pallas_paired")
    tab = sr_kernel.packed_table(pk["ptab"], pk["mtab"])
    n_e = int(pk["n_e"])
    te, se = pk["wl_t"][:n_e].long(), pk["wl_s"][:n_e].long()
    d = (tab.view(-1, 2 * pm.SLAB, 4)[se][:, None, :, :3]
         - tab.view(-1, pm.SLAB, 4)[te][:, :, None, :3])
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    inv_rc2 = 1.0 / pk["rc2"]
    q = r2 * inv_rc2
    beyond = q >= 1.0
    assert 0 < int(beyond.sum()) < beyond.numel()
    assert bool(((1.0 - pm._taper(q))[beyond] == 0).all())
    assert bool((_keep(q)[beyond] == 0).all())
    _, qk = _dist(d[..., 0], d[..., 1], d[..., 2], inv_rc2,
                  -SOFTENING_SQUARED * inv_rc2)
    assert bool((_keep(qk)[qk >= 1.0] == 0).all())
    edge = (qk >= 1.0) | beyond
    assert float((1.0 - pm._taper(r2 / pk["rc2"]))[edge].abs().max()) < 1e-12
    # Below the cutoff the Horner form is the plain taper to f32 rounding.
    inside = ~beyond
    assert float((_keep(q) - (1.0 - pm._taper(q)))[inside].abs().max()) < 1e-6


def test_split_order_is_the_kernels_rank():
    """split_order against the kernel's rule written out: the longest axis
    of the slab's box (the first of equal extents), then each target's rank
    along it, ties by slot; with repeated coordinates and equal extents."""
    rng = np.random.default_rng(0)
    slabs = torch.tensor(rng.integers(0, 4, size=(50, pm.SLAB, 4)),
                         dtype=torch.float32)
    slabs[3, :, :3] = 1.0  # every extent 0: axis 0, slot order
    got = sr_kernel.split_order(slabs)
    for i, slab in enumerate(slabs):
        ext = (slab[:, :3].amax(0) - slab[:, :3].amin(0)).tolist()
        axis = (0 if ext[0] >= ext[2] else 2) if ext[0] >= ext[1] else (
            1 if ext[1] >= ext[2] else 2)
        key = slab[:, axis].tolist()
        order = [0] * pm.SLAB
        for k in range(pm.SLAB):
            rank = sum(key[j] < key[k] or (key[j] == key[k] and j < k)
                       for j in range(pm.SLAB))
            order[rank] = k
        assert got[i].tolist() == order, i
    assert got[3].tolist() == list(range(pm.SLAB))


def test_skip_counts_match_the_schedule():
    """sr_kernel.skip_counts (which chip_smoke.py and the stats script
    print) counts the forward layouts' skipped steps as the emulated
    schedule does, and the reaction's rotation skips fewer."""
    for layout in ("pallas_paired", "pallas_paired_sym"):
        pk, sym, paired = _pack(2048, 32, 9, layout)
        args = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"],
                torch.stack([torch.zeros_like(pk["n_e"]), pk["n_e"]]),
                pk["rc2"])
        fwd = sr_kernel.skip_counts(*args, paired=paired)
        _, _, skipped, steps = _schedule_sweep(*args, False, paired, _unit())
        assert fwd["steps"] == steps
        assert abs(fwd["skipped"] - skipped) <= 1e-3 * steps
        if sym:
            both = sr_kernel.skip_counts(*args, symmetric=True, paired=paired)
            assert both["skipped"] / both["steps"] < skipped / steps


def _gate_tables():
    """The default layout's tables of a clustered Plummer sphere (N=16384,
    seed 7, grid 128, cutoff 4, capacity 2048)."""
    pos, _, mass = distributions.plummer(16384, seed=7)
    p, m = torch.tensor(pos), torch.tensor(mass)
    plan = dict(pm.suggest_sr_plan(p, m, 128, 4, layout="pallas_paired"),
                capacity=2048)
    return pm.sr_pack_inputs(p, m, grid=128, cutoff_cells=4, paired=True,
                             **plan)


def _zero_key(pos, *_):
    return torch.zeros(pos.shape[1], dtype=torch.int32, device=pos.device)


def test_subcell_order_keeps_fewer_steps(monkeypatch):
    """In dense cells the sub-cell order makes each warp and each run of
    sources compact, so the kernel's exact skips keep at least 15% fewer
    (warp, source) steps on the same worklist and pairs than the same pack
    under a zero key, which leaves each cell in input order."""
    tabs = {True: _gate_tables()}
    monkeypatch.setattr(pm, "_subcell_key", _zero_key)
    tabs[False] = _gate_tables()
    for k in ("wl_t", "wl_s", "n_e"):
        assert torch.equal(tabs[True][k], tabs[False][k])
    kept = {}
    for order, pk in tabs.items():
        bounds = torch.stack([torch.zeros_like(pk["n_e"]), pk["n_e"]])
        c = sr_kernel.skip_counts(pk["ptab"], pk["mtab"], pk["wl_t"],
                                  pk["wl_s"], bounds, pk["rc2"], paired=True)
        kept[order] = (c["steps"] - c["skipped"]) / c["steps"]
    assert kept[True] <= 0.85 * kept[False], kept


def test_subcell_order_bins_what_jax_bins():
    """Under a capacity that overflows the core, the keyed pack bins the
    same particles, and gives the same slab bounds, as the JAX package's
    pack in input order."""
    pos, _, mass = distributions.plummer(4096, seed=2)
    p, m = torch.tensor(pos), torch.tensor(mass)
    nc, _ = pm._cell_grid_params(64, 4)
    lo, hi = pm._robust_box(p, m)
    inc = (m * pm._inside(p, lo, hi)) > 0
    cid = pm._bin_cids(p, lo, hi - lo, nc, inc)
    key = pm._subcell_key(p, lo, hi - lo, nc)
    got = pm._sr_pack(cid, p, m, nc ** 3, 16, 80, key)
    jp, jm = jnp.asarray(pos), jnp.asarray(mass)
    jlo, jhi = jax_pm._robust_box(jp, jm)
    jinc = (jm * jax_pm._inside(jp, jlo, jhi)) > 0
    jcid = jax_pm._bin_cids(jp, jlo, jhi - jlo, nc, jinc)
    want = jax_pm._sr_pack(jcid, jp, jm, nc ** 3, 16, 80)
    np.testing.assert_array_equal(cid.numpy(), np.asarray(jcid))
    assert 0 < int(got[5].sum()) < int(inc.sum())  # cells overflow
    for i in (2, 3, 5):  # slab_lo, slab_hi, binned
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))


def test_slabs_are_in_cell_then_key_order():
    """Along the filled slots of the packed tables, (cell id, sub-cell key)
    never decreases, and within a cell the key orders the slots."""
    pk = _gate_tables()
    pos, _, mass = distributions.plummer(16384, seed=7)
    lo, hi = pm._robust_box(torch.tensor(pos), torch.tensor(mass))
    nc, _ = pm._cell_grid_params(128, 4)
    filled = pk["mtab"] > 0
    assert bool(filled[:int(filled.sum())].all())  # filled slots lead
    slots = pk["ptab"][:, filled]
    cid = pm._bin_cids(slots, lo, hi - lo, nc,
                       torch.ones_like(filled[filled])).numpy()
    key = subcell_key_np(slots.numpy(), lo.numpy(), (hi - lo).numpy(), nc)
    order = cid.astype(np.int64) * (1 << 9) + key
    assert np.all(np.diff(order) >= 0)
    assert np.unique(cid).size < cid.size  # cells of more than one slot

"""The port's periodic boundary (``nbody_tpu_torch.ops.pm`` with
``boundary="periodic"``: periodic PM, and periodic P3M over ghost images
through the sweep of ``ops/sr_kernel.py``) against the JAX package's, on the
CPU, where the sweep wrapper runs its plain version.

Inputs come from numpy seeds and go through both packages.  Tolerances:

* ``_xk1``: 1e-7 against JAX (transcendentals of two libraries), and
  tests/test_pm.py's 2e-6 + 1e-5 |x| against scipy's float64 Bessel.
* the spectra, as the real-space force grids they give on a deposit: 1e-5
  relative norm at ng 16 and 32.  The port's half spectra zero k_j's
  Nyquist entry on its own axis; without it the grids miss by > 1e-3.
* deposit and gather: cell ids and fractions bit-equal, values 1e-6.
* ghost images: equal multisets and ``n_ghost``; under truncation a
  sub-multiset with every slot filled and the same ``n_ghost``.
* the pack and worklist on the ghost-extended grid: bit for bit, the
  tables against the JAX package's reordered within each cell by a numpy
  sub-cell key.
* accelerations: 1e-4 relative norm (``rfftn`` here, ``fftn`` in JAX);
  against the fp64 k-space sum, tests/test_pm.py's and tests/test_p3m.py's
  bounds; the potential energy 1e-5; the native gradient of plain PM 1e-4.
* plans, overflow counts and the health check: equal; the engine's
  kinetic-energy traces: 1e-4.

``python tests/test_torch_periodic.py --make-fixture`` writes
``tests/golden/torch_periodic_n16384.npz``: the JAX package's periodic
``pm`` and ``p3m`` accelerations at N=16384, ng=128, cutoff 4, L=1 for the
reference initial conditions and for a Gaussian blob wrapped round a
corner, computed on the CPU; ``chip_smoke.py`` holds the port against it
on the card, where JAX is not installed.
"""

import functools
import hashlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from chip_smoke import corner_blob, kspace_sum  # noqa: E402
from nbody_tpu.ops import pm as jax_pm  # noqa: E402
from nbody_tpu_torch import SimConfig  # noqa: E402
from nbody_tpu_torch.models import distributions  # noqa: E402
from nbody_tpu_torch.models.gravity import make_accel_fn  # noqa: E402
from nbody_tpu_torch.ops import pm  # noqa: E402
from nbody_tpu_torch.utils import spans  # noqa: E402
from tests.torch_pack_util import reorder_pack_np, subcell_key_np  # noqa: E402

torch.set_num_threads(2)

FIXTURE = os.path.join(ROOT, "tests", "golden", "torch_periodic_n16384.npz")
FIXTURE_CFG = dict(n=16384, grid=128, cutoff=4, box=1.0, blob_seed=5)
PERIODIC = ("grid", "cutoff_cells", "capacity", "sr_slabs", "sr_entries",
            "sr_ghosts", "boundary", "box_size")
_jax_acc = jax.jit(jax_pm.accelerations, static_argnames=PERIODIC)
# The JAX package's helpers, jitted: one compile instead of many eager ops.
_jax_force_grids = jax.jit(jax_pm._pm_force_grids_periodic,
                           static_argnums=(1, 2))
_jax_p3m_spectra = jax.jit(jax_pm._periodic_p3m_spectra,
                           static_argnums=(0, 1))
_jax_ghosts = jax.jit(jax_pm._ghost_images, static_argnums=(2, 4))


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _uniform(n, seed, box=1.0):
    rng = np.random.default_rng(seed)
    return (np.asarray(rng.random((3, n)) * box, np.float32),
            np.asarray(1.0 + rng.random(n), np.float32))


def test_xk1_matches_jax_and_scipy():
    import scipy.special as sp

    x = np.concatenate([[0.0, 1e-6, 1e-3], np.linspace(0.01, 30.0, 400)]
                       ).astype(np.float32)
    got = pm._xk1(_t(x)).numpy()
    assert np.abs(got - np.asarray(jax_pm._xk1(x))).max() <= 1e-7
    xd = x.astype(np.float64)
    want = np.where(xd > 0, xd * sp.k1(np.maximum(xd, 1e-300)), 1.0)
    assert np.all(np.abs(got - want) <= 2e-6 + 1e-5 * np.abs(want))


@pytest.mark.parametrize("ng", [16, 32])
def test_spectra_as_force_grids_match_jax(ng):
    """The half spectra against JAX's full ones through the grids they give
    on one deposit: plain PM (i k_j phi), the P3M combined and complement
    spectra, at L = 1 and 0.7 (even ng: the Nyquist rule is live)."""
    for box in (1.0, 0.7):
        pos, mass = _uniform(500, 1, box)
        rho = pm._deposit_periodic(_t(pos), _t(mass), box, ng)
        rho_j = jax_pm._deposit_periodic(jnp.asarray(pos), jnp.asarray(mass),
                                         box, ng)
        rho_hat, rho_hat_j = torch.fft.rfftn(rho), jnp.fft.fftn(rho_j)
        got = pm._pm_force_grids_periodic(rho_hat, box, ng).numpy()
        want = np.asarray(_jax_force_grids(rho_hat_j, box, ng))
        assert _rel(got, want) <= 1e-5
        # i k_j kept raw at its Nyquist entry: the ifft axes miss.
        phi = pm._periodic_phi_spectrum(box, ng, "cpu")
        raw = [pm._i_times(kc * phi) for kc in pm._periodic_axes(box, ng,
                                                                 "cpu")]
        bad = pm._pm_force_grids_periodic(rho_hat, box, ng, raw).numpy()
        assert min(_rel(bad[c], want[c]) for c in (0, 1)) > 1e-3
        rc = pm._periodic_geom(ng, 4, box, "cpu")[2]
        rc_j = jax_pm._periodic_geom(ng, 4, box)[2]
        assert float(rc) == float(rc_j)
        for spec, spec_j in zip(pm._periodic_p3m_spectra(box, ng, rc * rc),
                                _jax_p3m_spectra(box, ng, rc_j * rc_j)):
            got = pm._periodic_inverse([rho_hat * s for s in spec], ng)
            want = np.stack([np.asarray(jnp.fft.ifftn(rho_hat_j * s).real)
                             for s in spec_j])
            assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("box", [1.0, 0.7])
def test_deposit_and_gather_match_jax(box):
    rng = np.random.default_rng(2)
    pos = np.asarray(rng.random((3, 3000)) * 3 * box - box, np.float32)
    mass = np.asarray(rng.random(3000), np.float32)
    for ng in (16, 32):
        i0, fr = pm._cic_weights_periodic(_t(pos), box, ng)
        j0, jf = jax_pm._cic_weights_periodic(jnp.asarray(pos), box, ng)
        np.testing.assert_array_equal(i0.numpy(), np.asarray(j0))
        np.testing.assert_array_equal(fr.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(
            pm._wrap_box(_t(pos), box).numpy(),
            np.asarray(jax_pm._wrap_box(jnp.asarray(pos), box)))
        rho = pm._deposit_periodic(_t(pos), _t(mass), box, ng)
        want = jax_pm._deposit_periodic(jnp.asarray(pos), jnp.asarray(mass),
                                        box, ng)
        assert _rel(rho.numpy(), want) <= 1e-6
        grids = rng.standard_normal((3, ng, ng, ng)).astype(np.float32)
        got = pm._gather_periodic(_t(grids), _t(pos), box, ng)
        want = jax_pm._gather_periodic(jnp.asarray(grids), jnp.asarray(pos),
                                       box, ng)
        assert _rel(got.numpy(), want) <= 1e-6


def _rows(gpos, gmass):
    live = np.asarray(gmass) > 0
    rows = np.concatenate([np.asarray(gpos)[:, live],
                           np.asarray(gmass)[None, live]]).T
    return sorted(map(tuple, rows))


@pytest.mark.parametrize("box,rc", [(1.0, 0.2), (0.7, 0.1)])
def test_ghost_images_multiset_matches_jax(box, rc):
    pos, mass = _uniform(256, 13, box)
    mass[::9] = 0.0  # zero-mass padding never ghosts
    args = (box, np.float32(rc))
    got = pm._ghost_images(_t(pos), _t(mass), box,
                           torch.tensor(args[1]), 7 * 256)
    want = _jax_ghosts(jnp.asarray(pos), jnp.asarray(mass), box,
                       jnp.float32(rc), 7 * 256)
    assert int(got[2]) == int(want[2]) > 0
    assert _rows(*got[:2]) == _rows(*want[:2])
    assert len(_rows(*got[:2])) == int(got[2])
    gcap = int(want[2]) // 2  # truncation: every slot packed, the count exact
    cut = pm._ghost_images(_t(pos), _t(mass), box, torch.tensor(args[1]),
                           gcap)
    assert int(cut[2]) == int(want[2])
    rows = _rows(*cut[:2])
    assert len(rows) == gcap and set(rows) <= set(_rows(*want[:2]))


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8, 9))
def _jax_tables(pos_src, mass_src, ng, box, cap, s_max, e_max, gcap,
                symmetric=False, paired=False, pos_tgt=None):
    """The JAX package's periodic binning, pack and worklist, step by step
    as its _periodic_p3m_between builds them."""
    nc, sub, rc, nc_tot, lo_cell, span_tot = jax_pm._periodic_geom(ng, 4, box)
    src_w = jax_pm._wrap_box(pos_src, box)
    tgt_w = None if pos_tgt is None else jax_pm._wrap_box(pos_tgt, box)
    pos_bin, m_bin, cid, n_ghost = jax_pm._periodic_ghost_bin(
        src_w, mass_src, box, rc, nc_tot, lo_cell, span_tot, gcap,
        tgt_w=tgt_w)
    packed = jax_pm._sr_pack(cid, pos_bin, m_bin, nc_tot ** 3, cap, s_max)
    wl = jax_pm._sr_ranges(packed[2], packed[3], nc_tot, sub, e_max,
                           symmetric=symmetric, paired=paired)
    return packed, wl, n_ghost, (pos_bin, cid, lo_cell, span_tot)


@pytest.mark.parametrize("state,between", [("uniform", False),
                                           ("blob", False), ("blob", True)])
def test_periodic_pack_bit_equal(state, between):
    """The pack and worklist on the ghost-extended grid equal the JAX
    package's bit for bit, same-set and with distinct targets, the tables
    once each cell is put in sub-cell key order; the blob's capacity 16
    overflows its cells."""
    box, ng = (0.7, 32) if state == "uniform" else (1.0, 32)
    pos, mass = _uniform(1024, 4, box) if state == "uniform" else \
        corner_blob(512, 3)
    cap = 64 if state == "uniform" else 16
    tgt = _uniform(100, 8, box)[0] if between else None
    n_bin = pos.shape[1] + 2048 + (100 if between else 0)
    s_max, e_max = n_bin // 64 + 2, 4096
    for sym, paired in ((False, False), (True, False), (False, True)):
        tabs = pm.sr_pack_inputs(
            _t(pos), _t(mass), ng, 4, capacity=cap, sr_slabs=s_max,
            sr_entries=e_max, symmetric=sym, paired=paired,
            boundary="periodic", box_size=box, sr_ghosts=2048,
            pos_tgt=None if tgt is None else _t(tgt))
        packed, wl, n_ghost, (pos_bin, cid, lo, span) = _jax_tables(
            jnp.asarray(pos), jnp.asarray(mass), ng, box, cap, s_max, e_max,
            2048, sym, paired, None if tgt is None else jnp.asarray(tgt))
        nc_tot = jax_pm._periodic_geom(ng, 4, box)[3]
        key = subcell_key_np(pos_bin, lo, span, nc_tot)
        packed = [np.asarray(w) for w in packed]
        keyed = reorder_pack_np(*packed, np.asarray(cid), key)
        assert not np.array_equal(keyed[4], packed[4])
        got = [tabs[k] for k in ("ptab", "mtab")] + [None, None] + [
            tabs[k] for k in ("pslot", "binned")]
        for g, w in zip(got, keyed):
            if g is not None:
                np.testing.assert_array_equal(g.numpy(), w)
        for k, w in zip(("wl_t", "wl_s", "n_e"), wl):
            np.testing.assert_array_equal(tabs[k].numpy(), np.asarray(w))
        assert int(tabs["n_ghost"]) == int(n_ghost)
    assert 0 < int(tabs["n_e"]) <= e_max


# One plan that covers every state of the acceleration cases (the largest
# suggested one), so that the JAX package compiles its solve once a box.
PLAN = dict(capacity=128, sr_slabs=512, sr_entries=16384, sr_ghosts=14336)


@pytest.mark.parametrize("kind", ["uniform", "blob"])
@pytest.mark.parametrize("box", [1.0, 0.7])
def test_periodic_accelerations_match_jax(kind, box):
    pos, mass = _uniform(2048, 3, box) if kind == "uniform" else \
        corner_blob(2048, 5, box)
    p, m = _t(pos), _t(mass)
    kw = dict(boundary="periodic", box_size=box)
    got = pm.accelerations(p, m, grid=32, **kw)
    want = _jax_acc(jnp.asarray(pos), jnp.asarray(mass), grid=32, **kw)
    assert _rel(got.numpy(), want) <= 1e-4
    plan = pm.suggest_sr_plan(p, m, 32, 4, **kw)
    assert all(plan[k] <= PLAN[k] for k in PLAN)
    assert float(pm.cell_overflow_fraction(p, m, 32, 4, PLAN["capacity"],
                                           **kw)) == 0.0
    got = pm.p3m_accelerations(p, m, grid=32, **PLAN, **kw)
    want = _jax_acc(jnp.asarray(pos), jnp.asarray(mass), grid=32,
                    cutoff_cells=4, **PLAN, **kw)
    assert _rel(got.numpy(), want) <= 1e-4


def test_periodic_overflow_branch_matches_jax():
    """Capacity 8 on the blob: real sources overflow, the complement branch
    runs (one overflow sync a solve, counted at its site), and distinct
    targets take the between form."""
    pos, mass = corner_blob(1024, 7)
    p, m = _t(pos), _t(mass)
    kw = dict(grid=32, cutoff_cells=4, capacity=8, boundary="periodic",
              box_size=1.0)
    assert float(pm.cell_overflow_fraction(p, m, 32, 4, 8,
                                           boundary="periodic",
                                           box_size=1.0)) > 0.1
    syncs = spans.counts["sync.p3m_overflow"]
    got = pm.accelerations(p, m, **kw)
    assert spans.counts["sync.p3m_overflow"] == syncs + 1
    want = _jax_acc(jnp.asarray(pos), jnp.asarray(mass), **kw)
    assert _rel(got.numpy(), want) <= 1e-4
    tgt = _uniform(200, 9)[0]
    got = pm.accelerations_between(_t(tgt), p, m, **kw)
    want = jax.jit(jax_pm.accelerations_between, static_argnames=PERIODIC)(
        jnp.asarray(tgt), jnp.asarray(pos), jnp.asarray(mass), **kw)
    assert _rel(got.numpy(), want) <= 1e-4


def test_periodic_pm_vs_kspace_sum_and_wrap():
    """tests/test_pm.py's bounds against the fp64 k-space sum; whole-box
    image shifts change little; zero-mass padding far outside the box
    leaves the real forces bit for bit; momentum closes."""
    rng = np.random.default_rng(11)
    pos = np.asarray(rng.random((3, 16)), np.float32)
    mass = np.asarray(1.0 + rng.random(16), np.float32)
    ref = kspace_sum(pos, mass, 1.0)
    errs = {ng: _rel(pm.accelerations(_t(pos), _t(mass), grid=ng,
                                      boundary="periodic", box_size=1.0), ref)
            for ng in (32, 64)}
    assert errs[32] < 7e-2 and errs[64] < 1.5e-2 and errs[64] < errs[32]
    pos, mass = _uniform(512, 12)
    kw = dict(grid=32, boundary="periodic", box_size=1.0)
    acc = pm.accelerations(_t(pos), _t(mass), **kw).numpy()
    p_dot = (mass * acc).sum(axis=1)
    assert np.all(np.abs(p_dot) < 1e-4 * np.abs(mass * acc).sum(axis=1))
    shift = np.asarray(rng.integers(-3, 4, (3, 512)), np.float32)
    assert _rel(pm.accelerations(_t(pos + shift), _t(mass), **kw), acc) < 1e-3
    pad = 1e6 + np.tile(np.arange(64, dtype=np.float32), (3, 1))
    acc2 = pm.accelerations(
        _t(np.concatenate([pos, pad], 1)),
        _t(np.concatenate([mass, np.zeros(64, np.float32)])), **kw).numpy()
    np.testing.assert_array_equal(acc2[:, :512], acc)


def test_periodic_p3m_vskspace_sum():
    """tests/test_p3m.py's bounds on the corner blob: periodic P3M near its
    mesh floor, three times below plain periodic PM."""
    pos, mass = corner_blob(96, 5)
    ref = kspace_sum(pos, mass, 1.0)
    kw = dict(boundary="periodic", box_size=1.0)
    for ng, bound in ((32, 2.5e-2), (64, 1.5e-2)):
        plan = pm.suggest_sr_plan(_t(pos), _t(mass), ng, 4, **kw)
        e_p3m = _rel(pm.accelerations(_t(pos), _t(mass), grid=ng,
                                      cutoff_cells=4, **plan, **kw), ref)
        e_pm = _rel(pm.accelerations(_t(pos), _t(mass), grid=ng, **kw), ref)
        assert e_p3m < bound and e_p3m < e_pm / 3, (ng, e_p3m, e_pm)


def test_periodic_p3m_boundary_pair_and_momentum():
    """A close pair across a face gets the exact min-image force within 5%
    (plain PM misses it by more than 30%); momentum closes to 1e-4 on the
    corner blob."""
    pos = np.array([[0.01, 0.99], [0.5, 0.5], [0.5, 0.5]], np.float32)
    mass = np.array([2.0, 3.0], np.float32)
    d = -0.02
    exact = 6.67259e-11 * mass[1] * d * (d * d + 1e-3) ** -1.5
    kw = dict(grid=32, boundary="periodic", box_size=1.0)
    a = pm.accelerations(_t(pos), _t(mass), cutoff_cells=4, **kw).numpy()
    a_pm = pm.accelerations(_t(pos), _t(mass), **kw).numpy()
    assert abs(a[0, 0] - exact) < 0.05 * abs(exact)
    assert abs(a_pm[0, 0] - exact) > 0.3 * abs(exact)
    pos, mass = corner_blob(96, 9)
    plan = pm.suggest_sr_plan(_t(pos), _t(mass), 32, 4, boundary="periodic",
                              box_size=1.0)
    a = pm.accelerations(_t(pos), _t(mass), cutoff_cells=4, **plan,
                         **kw).numpy()
    p_dot = (mass * a).sum(axis=1)
    assert np.all(np.abs(p_dot) < 1e-4 * (np.abs(mass * a).sum(axis=1)
                                          + 1e-30))


def test_periodic_potential_energy_and_gradient_match_jax():
    pos, mass = _uniform(512, 14, 0.7)
    got = float(pm.periodic_potential_energy(_t(pos), _t(mass), 0.7, 32))
    want = float(jax_pm.periodic_potential_energy(pos, mass, 0.7, 32))
    assert got == pytest.approx(want, rel=1e-5)
    pos, mass = _uniform(128, 15)
    fn = make_accel_fn("pm", differentiable=True, grid=16,
                       boundary="periodic", box_size=1.0)
    p = _t(pos).requires_grad_(True)
    torch.sum(fn(p, _t(mass)) ** 2).backward()
    g = jax.jit(jax.grad(lambda q: jnp.sum(jax_pm.accelerations(
        q, jnp.asarray(mass), grid=16, boundary="periodic",
        box_size=1.0) ** 2)))(jnp.asarray(pos))
    assert float(p.grad.abs().max()) > 0
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-4,
                               atol=1e-6 * float(np.abs(g).max()))


def test_periodic_linear_response_analytic():
    """tests/test_p3m.py's Zel'dovich check: a cold lattice displaced by
    A sin(k q_x) at the fundamental mode feels a_x = 4 pi G rho (k eps)
    K1(k eps) xi, within 1.5e-2, for PM and P3M; the transverse components
    carry no coherent mode."""
    from nbody_tpu_torch.types import G_NEWTON, SOFTENING_SQUARED

    nl = 24
    q1 = (np.arange(nl) + 0.5) / nl
    q = np.stack([a.ravel() for a in np.meshgrid(q1, q1, q1, indexing="ij")]
                 ).astype(np.float32)
    m = np.full(nl ** 3, 1.0 / nl ** 3, np.float32)
    k, amp = np.float32(2 * np.pi), np.float32(0.002)
    pos = q.copy()
    pos[0] += amp * np.sin(k * q[0])
    soft = float(pm._xk1(torch.tensor(k * np.sqrt(SOFTENING_SQUARED),
                                      dtype=torch.float32)))
    pred = 4 * np.pi * G_NEWTON * soft * amp
    for cutoff in (0, 4):
        acc = pm.accelerations(_t(pos), _t(m), grid=32, cutoff_cells=cutoff,
                               boundary="periodic", box_size=1.0).numpy()
        proj = 2.0 / nl ** 3 * np.sum(acc * np.sin(k * q[0]), axis=1)
        assert abs(proj[0] / pred - 1.0) < 1.5e-2, (cutoff, proj, pred)
        assert np.all(np.abs(proj[1:]) < 0.02 * abs(proj[0]))


@pytest.mark.parametrize("kind", ["uniform", "blob"])
def test_periodic_plan_functions_equal_jax(kind):
    pos, mass = _uniform(4096, 6) if kind == "uniform" else \
        corner_blob(1024, 11)
    p, m = _t(pos), _t(mass)
    kw = dict(boundary="periodic", box_size=1.0)
    assert pm.suggest_capacity(p, m, 32, 4, **kw) == jax_pm.suggest_capacity(
        pos, mass, 32, 4, **kw)
    for cap in (0, 8, 64):
        assert float(pm.cell_overflow_fraction(p, m, 32, 4, cap, **kw)) == \
            float(jax_pm.cell_overflow_fraction(pos, mass, 32, 4, cap, **kw))
    for layout in (None, "full", "pallas_sym"):
        plan = pm.suggest_sr_plan(p, m, 32, 4, layout=layout, **kw)
        assert plan == jax_pm.suggest_sr_plan(pos, mass, 32, 4,
                                              layout=layout, **kw)
    assert 64 <= plan["sr_ghosts"] <= 7 * pos.shape[1]
    for gcap in (plan["sr_ghosts"], 8, 0):
        got = pm.ghost_overflow_count(p, m, 32, 4, sr_ghosts=gcap,
                                      box_size=1.0)
        assert got == jax_pm.ghost_overflow_count(pos, mass, 32, 4,
                                                  sr_ghosts=gcap,
                                                  box_size=1.0)
        if gcap:  # the default 2N cap drops some of the blob's images
            assert (got > 0) == (gcap == 8)
    for entries in (plan["sr_entries"], 64):
        got = pm.sr_entry_overflow(p, m, 32, 4, plan["capacity"], 0, entries,
                                   **kw)
        assert got == jax_pm.sr_entry_overflow(pos, mass, 32, 4,
                                               plan["capacity"], 0, entries,
                                               **kw)
        assert (got > 0) == (entries == 64)


def test_sr_entry_overflow_sizes_the_solvers_tables():
    """By design (ROADMAP.md queue 3): the port's guard sizes the periodic
    tables from the slots the solver bins, sources plus ghost cap, where
    the JAX package's sizes them from the sources alone.  With the slabs
    left to the default the two sizings differ; the port's is the
    solver's.  The entry counts agree: on the port the layout, the one
    thing the JAX package's sizing feeds, follows the device."""
    pos, mass = corner_blob(1024, 11)
    p, m = _t(pos), _t(mass)
    plan = pm.suggest_sr_plan(p, m, 32, 4, boundary="periodic", box_size=1.0)
    tabs = pm.sr_pack_inputs(p, m, 32, 4, capacity=plan["capacity"],
                             sr_entries=64, boundary="periodic", box_size=1.0,
                             sr_ghosts=plan["sr_ghosts"])
    guard = pm._sr_sizing(pm._PeriodicMesh(32, 1.0).geom(4, "cpu"), 1024,
                          plan["sr_ghosts"], plan["capacity"], 0, 64)
    jax_sizing = jax_pm._sr_sizing(1024, 1024, 20 ** 3, plan["capacity"], 0,
                                   64)
    assert guard[1] == tabs["s_max"] == (1024 + plan["sr_ghosts"]) // 64 + 1
    assert jax_sizing[1] == 1024 // 64 + 1 < guard[1]
    assert guard[0] == jax_sizing[0] and guard[2] == jax_sizing[2] == 64
    kw = dict(capacity=plan["capacity"], sr_entries=64, boundary="periodic",
              box_size=1.0)
    got = pm.sr_entry_overflow(p, m, 32, 4, sr_ghosts=plan["sr_ghosts"], **kw)
    assert got > 0 and got == jax_pm.sr_entry_overflow(pos, mass, 32, 4, **kw)


@pytest.mark.parametrize("cutoff", [0, 4])
def test_env_and_no_env_forces_bit_equal(cutoff):
    """The periodic env holds the spectra a solve would build itself, by the
    same operations: with it and without it the forces are equal bit for
    bit (on one CPU thread: the CPU's threads split the deposit's
    accumulating ``index_put_`` and the transforms, whose sums then come in
    another order).  A mismatched env is refused."""
    pos, mass = corner_blob(2048, 11)
    kw = dict(grid=32, cutoff_cells=cutoff, boundary="periodic", box_size=1.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        env = pm.make_mesh_env(_t(pos), _t(mass), **kw)
        assert torch.equal(
            pm.accelerations(_t(pos), _t(mass), mesh_env=env, **kw),
            pm.accelerations(_t(pos), _t(mass), **kw))
    finally:
        torch.set_num_threads(threads)
    leaf = env["spectra"][0][0] if cutoff else env["spectra"][0]
    assert tuple(leaf.shape) == (32, 32, 17)
    env_open = pm.make_mesh_env(_t(pos), _t(mass), grid=32,
                                cutoff_cells=cutoff)
    with pytest.raises(ValueError, match="different solver config"):
        pm.accelerations(_t(pos), _t(mass), mesh_env=env_open, **kw)
    with pytest.raises(ValueError, match="different solver config"):
        pm.accelerations(_t(pos), _t(mass), grid=32, cutoff_cells=cutoff,
                         mesh_env=env)


def test_periodic_config_and_refusals():
    cfg = SimConfig(kernel="p3m", pm_boundary="periodic", pm_box=2.0,
                    pm_grid=64, pm_sr_ghosts=512, platform="cpu")
    assert cfg.kernel_opts() == {"grid": 64, "sr_ghosts": 512,
                                 "boundary": "periodic", "box_size": 2.0}
    assert "boundary" not in SimConfig(kernel="pm").kernel_opts()
    for kw, match in ((dict(kernel="naive"), "requires --kernel pm or p3m"),
                      (dict(kernel="pm", pm_box=0.0), "requires --pm-box"),
                      (dict(kernel="pm", pm_box=-1.0), "requires --pm-box")):
        with pytest.raises(ValueError, match=match):
            SimConfig(pm_boundary="periodic", **{"pm_box": 1.0, **kw})
    with pytest.raises(ValueError, match="only applies"):
        SimConfig(kernel="pm", pm_box=1.0)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        SimConfig(kernel="p3m", pm_boundary="periodic", pm_box=1.0, shards=2)
    # Differentiable periodic P3M runs (tests/test_torch_p3m_grad.py holds
    # its gradient against the JAX package's).
    pos, mass = corner_blob(64, 3)
    fn = make_accel_fn("p3m", differentiable=True, grid=32, boundary="periodic",
                       box_size=1.0)
    a = pm.accelerations(_t(pos), _t(mass), grid=32, cutoff_cells=4,
                         differentiable=True, boundary="periodic",
                         box_size=1.0)
    assert torch.equal(fn(_t(pos), _t(mass)), a)
    with pytest.raises(ValueError, match="box/2"):
        pm.accelerations(_t(pos), _t(mass), grid=8, cutoff_cells=4,
                         boundary="periodic", box_size=1.0)
    with pytest.raises(ValueError, match="box_size > 0"):
        pm.accelerations(_t(pos), _t(mass), grid=16, boundary="periodic")


def test_periodic_engine_pm_energy_check_matches_jax():
    """tests/test_pm.py's energy-check run: the periodic PE, drift below
    5e-2; the kinetic-energy trace within 1e-4 of the JAX package's.  One
    env serves the whole run."""
    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.simulation import run as jax_run
    from nbody_tpu_torch.simulation import _DeviceRunner, run

    kw = dict(n=512, nsteps=100, kernel="pm", pm_grid=32,
              pm_boundary="periodic", pm_box=8.0, energy_check=True)
    res = run(SimConfig(platform="cpu", **kw), quiet=True)
    want = jax_run(JaxConfig(platform="cpu", **kw), quiet=True)
    np.testing.assert_allclose([ke for _, ke in res.kenergy_trace],
                               [ke for _, ke in want.kenergy_trace],
                               rtol=1e-4)
    assert np.isfinite(res.energy_drift) and abs(res.energy_drift) < 5e-2
    runner = _DeviceRunner(SimConfig(platform="cpu", **kw))
    runner.prepare()
    env_fn = runner._mesh_env_fn()
    first = env_fn(runner.state.pos, runner.state.mass)
    runner.run_block(50)
    assert runner._mesh_env_fn()(runner.state.pos, runner.state.mass) is first


def test_periodic_p3m_engine_run_matches_jax():
    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.simulation import run as jax_run
    from nbody_tpu_torch.simulation import run

    kw = dict(n=512, nsteps=20, sfreq=10, kernel="p3m", pm_grid=32,
              pm_boundary="periodic", pm_box=1.0, dt=0.01)
    cfg, jcfg = SimConfig(platform="cpu", **kw), JaxConfig(platform="cpu",
                                                            **kw)
    got = [ke for _, ke in run(cfg, quiet=True).kenergy_trace]
    want = [ke for _, ke in jax_run(jcfg, quiet=True).kenergy_trace]
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    plan = ("pm_capacity", "pm_sr_slabs", "pm_sr_entries", "pm_sr_ghosts")
    assert [getattr(cfg, k) for k in plan] == [getattr(jcfg, k) for k in plan]


def test_periodic_health_check_matches_jax(capsys):
    """Eight ghost slots drop images at once.  After one sample block the
    port's health check warns once naming the dropped ghosts, or under
    pm_replan grows the ghost slots; the JAX package's check, on the same
    state, does the same to its config."""
    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.simulation import _DeviceRunner as JaxRunner
    from nbody_tpu.state import ParticleState as JaxState
    from nbody_tpu_torch.simulation import _DeviceRunner

    plan = ("pm_capacity", "pm_sr_slabs", "pm_sr_entries", "pm_sr_ghosts")
    for replan in (False, True):
        kw = dict(n=512, nsteps=10, sfreq=10, kernel="p3m", pm_grid=16,
                  pm_boundary="periodic", pm_box=1.0, pm_sr_ghosts=8,
                  pm_replan=replan, dt=0.01, platform="cpu")
        cfg = SimConfig(**kw)
        runner = _DeviceRunner(cfg)
        runner.prepare()
        assert np.isfinite(runner.run_block(10))
        st = runner.state
        jcfg = JaxConfig(**kw, **{k: getattr(cfg, k) for k in plan[:3]})
        jrunner = JaxRunner(jcfg)
        jrunner.state = JaxState(pos=jnp.asarray(st.pos.numpy()),
                                 vel=jnp.asarray(st.vel.numpy()),
                                 mass=jnp.asarray(st.mass.numpy()), n=st.n)
        jrunner._sr_health = True
        for first in (True, False):
            runner.check_sr_health()
            err = capsys.readouterr().err
            jrunner._check_sr_health()
            jerr = capsys.readouterr().err
            assert [getattr(cfg, k) for k in plan] == [getattr(jcfg, k)
                                                       for k in plan]
            assert ("ghost images dropped" in err) == (
                "ghost images dropped" in jerr) == first
            said = "replanned" if replan else "dropped ghosts lose"
            assert (said in err) == (said in jerr) == first
        assert cfg.pm_sr_ghosts > 8 if replan else cfg.pm_sr_ghosts == 8
        runner.finish()


def test_cli_periodic_runs(capsys):
    from nbody_tpu_torch.__main__ import main

    assert main(["512", "100", "--kernel", "pm", "--pm-grid", "32",
                 "--pm-boundary", "periodic", "--pm-box", "8",
                 "--energy-check", "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = [line.split() for line in out.splitlines()
            if line.split() and line.split()[0] in ("50", "100")]
    assert len(rows) == 2 and all(float(r[2]) > 0 for r in rows)
    assert "Energy drift" in out
    with pytest.raises(SystemExit) as e:
        main(["64", "10", "--kernel", "pm", "--pm-box", "1", "--platform",
              "cpu"])
    assert e.value.code == 2
    assert "--pm-box only applies" in capsys.readouterr().err


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _fixture_states():
    """The fixture's two states from the port's generators: the reference
    initial conditions and the corner blob, N=16384."""
    n = FIXTURE_CFG["n"]
    ref_pos, _, ref_mass = distributions.reference(n)
    blob = corner_blob(n, FIXTURE_CFG["blob_seed"], FIXTURE_CFG["box"])
    return {"reference": (ref_pos, ref_mass), "blob": blob}


def test_fixture_config_matches_the_port():
    """The card's fixture was made from the JAX package's states; the
    port's are the same bit for bit, and so are its CPU plans."""
    fx = np.load(FIXTURE)
    assert {k: float(fx[k]) for k in FIXTURE_CFG} == FIXTURE_CFG
    assert os.path.getsize(FIXTURE) < 1_000_000
    for name, (pos, mass) in _fixture_states().items():
        assert str(fx[f"{name}_digest"]) == _digest(pos, mass)
        assert fx[f"{name}_pm"].shape == fx[f"{name}_p3m"].shape == pos.shape
        plan = pm.suggest_sr_plan(_t(pos), _t(mass), FIXTURE_CFG["grid"],
                                  FIXTURE_CFG["cutoff"], boundary="periodic",
                                  box_size=FIXTURE_CFG["box"])
        assert plan == {k: int(fx[f"{name}_{k}"]) for k in plan}


def make_fixture() -> None:
    """Write FIXTURE from the JAX package on the CPU."""
    from nbody_tpu.models.distributions import reference as jax_reference

    n, ng, cutoff, box = (FIXTURE_CFG[k] for k in ("n", "grid", "cutoff",
                                                     "box"))
    ref_pos, _, ref_mass = jax_reference(n)
    states = {"reference": (np.asarray(ref_pos, np.float32),
                            np.asarray(ref_mass, np.float32)),
              "blob": corner_blob(n, FIXTURE_CFG["blob_seed"], box)}
    out = dict(FIXTURE_CFG)
    kw = dict(boundary="periodic", box_size=box)
    for name, (pos, mass) in states.items():
        plan = jax_pm.suggest_sr_plan(pos, mass, ng, cutoff, **kw)
        a_pm = _jax_acc(jnp.asarray(pos), jnp.asarray(mass), grid=ng, **kw)
        a_p3m = _jax_acc(jnp.asarray(pos), jnp.asarray(mass), grid=ng,
                         cutoff_cells=cutoff, **plan, **kw)
        out[f"{name}_pm"] = np.asarray(a_pm, np.float32)
        out[f"{name}_p3m"] = np.asarray(a_p3m, np.float32)
        out[f"{name}_digest"] = _digest(pos, mass)
        out.update({f"{name}_{k}": v for k, v in plan.items()})
        print(f"{name}: plan {plan}")
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")


if __name__ == "__main__":
    if sys.argv[1:] != ["--make-fixture"]:
        sys.exit("usage: python tests/test_torch_periodic.py --make-fixture")
    from nbody_tpu.utils.platform import force_cpu

    force_cpu(1)
    make_fixture()

"""The port's P3M tier (``nbody_tpu_torch.ops.pm`` with the short-range sweep
of ``ops/sr_kernel.py``, open boundary) against the JAX package's, on the
CPU, where the sweep wrapper runs its plain version.

Inputs are the bit-equal Plummer spheres of both packages.  Tolerances:

* ``_sr_pack`` (all six outputs, on the same cell ids) and ``_sr_ranges``
  (``wl_t``, ``wl_s``, ``n_e`` in all four layouts, on the same slab
  bounds): bit for bit, since both are integer index work and gathers;
  with the sub-cell key, ``ptab``, ``mtab`` and ``pslot`` bit for bit
  against the JAX package's reordered within each cell by a numpy key.
* the plain sweep against JAX's ``_sr_sweep`` (unpaired layouts) and
  ``_sr_sweep_pallas(interpret=True)`` (paired layouts): occupied slots
  within 2e-5 of the largest value, as tests/test_p3m.py holds the Pallas
  sweep against ``_sr_sweep`` (fp32 sums in other orders); a 4-way split
  of the entry bounds sums to the full sweep within rtol 1e-6.
* P3M accelerations: 1e-4 relative norm (the transforms differ: ``rfftn``
  here, full-complex ``fftn`` in JAX).
* the plan functions: equal; the engine's kinetic-energy trace: 1e-4.

``python tests/test_torch_p3m.py --make-fixture`` writes
``tests/golden/torch_p3m_plummer_n16384.npz``: the JAX package's ``pm`` and
``p3m`` accelerations and plan for Plummer N=16384, seed 7, ng=128,
cutoff 4, computed on the CPU, which ``chip_smoke.py`` holds the port
against on the card, where JAX is not installed.
"""

import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from nbody_tpu.ops import pm as jax_pm  # noqa: E402
from nbody_tpu_torch.init import make_state  # noqa: E402
from nbody_tpu_torch.models import distributions  # noqa: E402
from nbody_tpu_torch.ops import pm, sr_kernel  # noqa: E402
from tests.torch_health_util import CASES as HEALTH_CASES  # noqa: E402
from tests.torch_health_util import (  # noqa: E402
    check_health_equals_the_plan_functions,
)
from tests.torch_pack_util import reorder_pack_np, subcell_key_np  # noqa: E402

torch.set_num_threads(2)

FIXTURE = os.path.join(ROOT, "tests", "golden",
                       "torch_p3m_plummer_n16384.npz")
FIXTURE_CFG = dict(n=16384, seed=7, grid=128, cutoff=4)

_jax_pack = jax.jit(jax_pm._sr_pack, static_argnums=(3, 4, 5))
_jax_ranges = jax.jit(jax_pm._sr_ranges, static_argnums=(2, 3, 4),
                      static_argnames=("symmetric", "paired"))
_jax_sweep = jax.jit(jax_pm._sr_sweep, static_argnames=("symmetric",))
_jax_acc = jax.jit(jax_pm.accelerations,
                   static_argnames=("grid", "cutoff_cells", "capacity"))


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _plummer(n, seed):
    pos, _, mass = distributions.plummer(n, seed=seed)
    return pos, mass


def _cids(pos, mass, ng, cutoff=4):
    """The solver's cell ids of a self-solve, from the JAX package, and
    its mesh box (lo, span)."""
    p, m = jnp.asarray(pos), jnp.asarray(mass)
    nc, sub = jax_pm._cell_grid_params(ng, cutoff)
    lo, hi = jax_pm._robust_box(p, m)
    inc = (m * jax_pm._inside(p, lo, hi)) > 0
    return (np.asarray(jax_pm._bin_cids(p, lo, hi - lo, nc, inc)), nc, sub,
            np.asarray(lo), np.asarray(hi - lo))


@pytest.mark.parametrize("n,ng,cap,s_max,n_tgt", [
    pytest.param(2048, 64, 128, 40, 0, id="2048-64-128-40"),
    pytest.param(1024, 32, 8, 24, 0, id="1024-32-8-24"),
    pytest.param(700, 16, 64, 6, 0, id="700-16-64-6"),
    pytest.param(1024, 32, 16, 24, 300, id="1024-32-16-24-targets")])
def test_sr_pack_bit_equal(n, ng, cap, s_max, n_tgt):
    """Under a zero key the pack is the JAX package's; with the sub-cell key
    the slab bounds and the binned set still are, and the tables are its
    tables with each cell reordered by the key.  With distinct targets the
    candidates are the JAX package's open solver's (the in-box sources,
    then the targets, massless, where inside the box), and sr_pack_inputs'
    tables and worklist are its own."""
    # (1024, 32, cap 8): cells overflow; (700, 16, s_max 6): slabs overflow;
    # (1024, 32, cap 16, 300 targets): the core's cells overflow.
    pos, mass = _plummer(n, 3)
    cid, nc, sub, lo, span = _cids(pos, mass, ng)
    pos_bin, m_bin = pos, mass
    if n_tgt:
        tgt = _plummer(n_tgt, 4)[0]
        jp, jt = jnp.asarray(pos), jnp.asarray(tgt)
        jlo, jhi = jax_pm._robust_box(jp, jnp.asarray(mass))
        t_in = jax_pm._inside(jt, jlo, jhi) > 0
        pos_bin = np.concatenate([pos, tgt], axis=1)
        in_src = np.asarray(jax_pm._inside(jp, jlo, jhi))
        m_bin = np.concatenate([mass * in_src, np.zeros(n_tgt, np.float32)])
        cid = np.concatenate([cid, np.asarray(jax_pm._bin_cids(
            jt, jlo, jhi - jlo, nc, t_in))])
        assert 0 < int(t_in.sum()) < n_tgt  # targets inside and outside
    want = [np.asarray(w) for w in _jax_pack(
        jnp.asarray(cid), jnp.asarray(pos_bin), jnp.asarray(m_bin), nc ** 3,
        cap, s_max)]
    key = pm._subcell_key(_t(pos_bin), _t(lo), _t(span), nc)
    want_key = subcell_key_np(pos_bin, lo, span, nc)
    np.testing.assert_array_equal(key.numpy(), want_key)
    keyed = reorder_pack_np(*want, cid, want_key)
    assert not np.array_equal(keyed[4], want[4])  # the key moves slots
    for k, w in ((torch.zeros_like(key), want), (key, keyed)):
        got = pm._sr_pack(_t(cid), _t(pos_bin), _t(m_bin), nc ** 3, cap,
                          s_max, k)
        for g, w_i in zip(got, w):
            assert g.dtype in (torch.int32, torch.float32, torch.bool)
            np.testing.assert_array_equal(g.numpy(), w_i)
    if n_tgt:
        pk = pm.sr_pack_inputs(_t(pos), _t(mass), ng, 4, capacity=cap,
                               sr_slabs=s_max, sr_entries=4096,
                               pos_tgt=_t(tgt))
        names = ("ptab", "mtab", "slab_lo", "slab_hi", "pslot", "binned")
        for name, w in zip(names, keyed):
            np.testing.assert_array_equal(pk[name].numpy(), w)
        assert not keyed[5][n:].all()  # some targets take no slot
        for name, w in zip(("wl_t", "wl_s", "n_e"), _jax_ranges(
                want[2], want[3], nc, sub, 4096)):
            np.testing.assert_array_equal(pk[name].numpy(), np.asarray(w))


@pytest.mark.parametrize("sym,paired", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_sr_ranges_bit_equal(sym, paired):
    pos, mass = _plummer(2048, 5)
    cid, nc, sub = _cids(pos, mass, 64)[:3]
    slab_lo, slab_hi = _jax_pack(jnp.asarray(cid), jnp.asarray(pos),
                                 jnp.asarray(mass), nc ** 3, 256, 34)[2:4]
    for e_max in (4096, 100):  # the second drops entries past e_max
        got = pm._sr_ranges(_t(slab_lo), _t(slab_hi), nc, sub, e_max,
                            symmetric=sym, paired=paired)
        want = _jax_ranges(slab_lo, slab_hi, nc, sub, e_max, symmetric=sym,
                           paired=paired)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2]) > 100


def _pack(n, ng, seed, sym, paired):
    pos, mass = _plummer(n, seed)
    cap = pm.suggest_capacity(_t(pos), _t(mass), ng, 4)
    return pm.sr_pack_inputs(_t(pos), _t(mass), grid=ng, cutoff_cells=4,
                             capacity=cap, symmetric=sym, paired=paired)


@pytest.mark.parametrize("sym,paired", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_sweep_plain_matches_jax(sym, paired):
    pk = _pack(1024, 32, 11, sym, paired)
    args = [jnp.asarray(pk[k].numpy()) for k in ("ptab", "mtab", "wl_t",
                                                 "wl_s", "n_e", "rc2")]
    bounds = torch.stack([torch.zeros_like(pk["n_e"]), pk["n_e"]])
    got = sr_kernel.sweep(pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"],
                          bounds, pk["rc2"], symmetric=sym, paired=paired)
    if paired:
        want = jax_pm._sr_sweep_pallas(*args[:4], (0, int(pk["n_e"])),
                                       args[5], chunk=128, interpret=True,
                                       symmetric=sym, paired=True)
    else:
        want = _jax_sweep(*args, symmetric=sym)
    occ = pk["mtab"].numpy() > 0
    got, want = got.numpy()[:, occ], np.asarray(want)[:, occ]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("sym,paired", [(False, False), (True, True)])
def test_sweep_plain_bounds_split(sym, paired):
    pk = _pack(1024, 32, 12, sym, paired)
    args = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"])
    n_e = int(pk["n_e"])
    full = sr_kernel.sweep_plain(*args, torch.tensor([0, n_e], dtype=torch.int32),
                                 pk["rc2"], symmetric=sym, paired=paired)
    per = -(-n_e // 4)
    parts = sum(sr_kernel.sweep_plain(
        *args, torch.tensor([i * per, min((i + 1) * per, n_e)],
                            dtype=torch.int32),
        pk["rc2"], symmetric=sym, paired=paired) for i in range(4))
    np.testing.assert_allclose(parts.numpy(), full.numpy(), rtol=1e-6,
                               atol=2e-6 * float(full.abs().max()))


def test_sweep_wrapper_checks_and_dispatch():
    pk = _pack(512, 16, 2, True, False)
    bounds = torch.stack([torch.zeros_like(pk["n_e"]), pk["n_e"]])
    args = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"], bounds, pk["rc2"])
    before = sr_kernel.launches
    out = sr_kernel.sweep(*args, symmetric=True)
    assert sr_kernel.launches == before  # the CPU runs the plain version
    assert torch.equal(out, sr_kernel.sweep_plain(*args, symmetric=True))
    assert bool((out[:, -pm.SLAB:] == 0).all())  # the sentinel slab
    with pytest.raises(TypeError, match="wl_t must be int32"):
        sr_kernel.sweep(args[0], args[1], args[2].long(), *args[3:])
    with pytest.raises(ValueError, match="mtab must have shape"):
        sr_kernel.sweep(args[0], args[1][:-1], *args[2:])


@pytest.mark.parametrize("cap,env", [(0, False), (0, True), (8, False)])
def test_p3m_accelerations_match_jax(cap, env):
    # Capacity 8 overflows the Plummer core: the complement-mesh branch.
    pos, mass = _plummer(2048, 9)
    cap = cap or pm.suggest_capacity(_t(pos), _t(mass), 64, 4)
    if cap == 8:
        assert float(pm.cell_overflow_fraction(_t(pos), _t(mass), 64, 4, 8)) > 0.1
    mesh_env = pm.make_mesh_env(_t(pos), _t(mass), grid=64,
                                cutoff_cells=4) if env else None
    got = pm.p3m_accelerations(_t(pos), _t(mass), grid=64, capacity=cap,
                               mesh_env=mesh_env)
    want = _jax_acc(jnp.asarray(pos), jnp.asarray(mass), grid=64,
                    cutoff_cells=4, capacity=cap)
    assert _rel(got.numpy(), want) <= 1e-4


def test_p3m_between_equals_self_and_padding():
    pos, _, mass = distributions.cold_sphere(512, seed=6)
    p, m = _t(pos), _t(mass)
    a_self = pm.p3m_accelerations(p, m, grid=32, capacity=64)
    a_btwn = pm.p3m_accelerations_between(p, p, m, grid=32, capacity=64)
    assert torch.equal(a_self, a_btwn)
    # Distinct targets join the tables massless: close to the self-solve.
    a_copy = pm.p3m_accelerations_between(p.clone(), p, m, grid=32,
                                          capacity=64)
    assert _rel(a_copy.numpy(), a_self.numpy()) <= 1e-4
    st = make_state(1000, pad_multiple=256, device="cpu")  # padded to 1024
    full = pm.p3m_accelerations(st.pos, st.mass, grid=32, capacity=64)
    real = pm.p3m_accelerations(st.pos[:, :1000].contiguous(),
                                st.mass[:1000].contiguous(), grid=32,
                                capacity=64)
    np.testing.assert_allclose(full[:, :1000].numpy(), real.numpy(),
                               rtol=2e-5, atol=1e-8)


def test_p3m_momentum_conserved_without_overflow():
    pos, _, mass = distributions.cold_sphere(1024, seed=4)
    p, m = _t(pos), _t(mass)
    cap = pm.suggest_capacity(p, m, 64, 4)
    assert float(pm.cell_overflow_fraction(p, m, 64, 4, cap)) == 0.0
    a = pm.accelerations(p, m, grid=64, cutoff_cells=4, capacity=cap).numpy()
    flux = np.abs((mass[None, :] * a).sum(axis=1))
    assert np.all(flux < 2e-6 * np.abs(mass[None, :] * a).sum())


@pytest.mark.parametrize("n,ng,seed", [(4096, 64, 6), (2048, 128, 1)])
def test_plan_functions_equal_jax(n, ng, seed):
    pos, mass = _plummer(n, seed)
    p, m = _t(pos), _t(mass)
    assert pm.suggest_capacity(p, m, ng, 4) == jax_pm.suggest_capacity(
        pos, mass, ng, 4)
    for cap in (8, 64):
        assert float(pm.cell_overflow_fraction(p, m, ng, 4, cap)) == float(
            jax_pm.cell_overflow_fraction(pos, mass, ng, 4, cap))
    for layout in (None, "full", "pallas_sym"):
        plan = pm.suggest_sr_plan(p, m, ng, 4, layout=layout)
        assert plan == jax_pm.suggest_sr_plan(pos, mass, ng, 4, layout=layout)
    starved = dict(plan, sr_entries=64)
    assert pm.sr_entry_overflow(p, m, ng, 4, **plan) == 0
    over = pm.sr_entry_overflow(p, m, ng, 4, **starved)
    assert over > 0 and over == jax_pm.sr_entry_overflow(pos, mass, ng, 4,
                                                         **starved)


@pytest.mark.parametrize("name", sorted(HEALTH_CASES))
def test_sr_plan_health_equals_the_plan_functions(name):
    """The health check's one-binning triple equals the three public plan
    functions' on the CPU's layout; the ghost cap of 8 takes the 7N
    fallback.  tests/test_torch_cuda.py holds the card's paired layout."""
    frac, ghosts, entries = check_health_equals_the_plan_functions(name,
                                                                   "cpu")
    assert (frac > 0.005) == name.endswith("capacity-8")
    assert (ghosts > 0) == name.endswith("ghosts-8")
    assert (entries > 0) == name.endswith("entries-64")


def test_active_layout_follows_the_device():
    # By default the reaction runs on the CPU (as the JAX package's sweep
    # does there) and not on the card; paired rows only on the card.
    assert pm._active_sr_layout(False) == (True, False)
    assert pm._active_sr_layout(True) == (False, True)
    assert pm._active_sr_layout(True, differentiable=True) == (False, False)
    for name, on_card in (("xla", (False, False)),
                          ("pallas_paired_sym", (True, True))):
        prev = pm.set_sr_layout(name)
        try:
            assert pm._active_sr_layout(True) == on_card
        finally:
            pm.set_sr_layout(prev)
    assert pm.sr_layout_state() == (None, True)
    with pytest.raises(ValueError, match="unknown SR layout"):
        pm.set_sr_layout("bogus")


def test_p3m_engine_run_matches_jax():
    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.simulation import run as jax_run
    from nbody_tpu_torch import SimConfig, run

    kw = dict(n=512, nsteps=20, sfreq=10, kernel="p3m", pm_grid=32,
              distribution="plummer", dt=0.01, platform="cpu")
    cfg, jcfg = SimConfig(**kw), JaxConfig(**kw)
    got = [ke for _, ke in run(cfg, quiet=True).kenergy_trace]
    want = [ke for _, ke in jax_run(jcfg, quiet=True).kenergy_trace]
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    plan = ("pm_capacity", "pm_sr_slabs", "pm_sr_entries")
    assert [getattr(cfg, k) for k in plan] == [getattr(jcfg, k) for k in plan]
    assert cfg.pm_capacity >= 64


def test_p3m_health_check_replans_as_jax(capsys):
    """A pinned capacity of 1 overflows at once.  After one sample block the
    port's health check warns once, or under pm_replan grows the plan; the
    JAX package's health check, run on the same evolved state, does the
    same to its config."""
    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.simulation import _DeviceRunner as JaxRunner
    from nbody_tpu.state import ParticleState as JaxState
    from nbody_tpu_torch import SimConfig
    from nbody_tpu_torch.simulation import _DeviceRunner

    plan = ("pm_capacity", "pm_sr_slabs", "pm_sr_entries")
    for replan in (False, True):
        kw = dict(n=512, nsteps=10, sfreq=10, kernel="p3m", pm_grid=16,
                  pm_capacity=1, pm_replan=replan, platform="cpu")
        cfg = SimConfig(**kw)
        runner = _DeviceRunner(cfg)
        runner.prepare()
        assert np.isfinite(runner.run_block(10))
        st = runner.state
        jcfg = JaxConfig(**kw, **{k: getattr(cfg, k) for k in plan[1:]})
        jrunner = JaxRunner(jcfg)
        jrunner.state = JaxState(pos=jnp.asarray(st.pos.numpy()),
                                 vel=jnp.asarray(st.vel.numpy()),
                                 mass=jnp.asarray(st.mass.numpy()), n=st.n)
        jrunner._sr_health = True
        for first in (True, False):  # a second check repeats no warning
            runner.check_sr_health()
            err = capsys.readouterr().err
            jrunner._check_sr_health()
            jerr = capsys.readouterr().err
            assert [getattr(cfg, k) for k in plan] == [getattr(jcfg, k)
                                                       for k in plan]
            said = "replanned" if replan else "--pm-replan"
            assert (said in err) == (said in jerr) == first
        assert cfg.pm_capacity > 1 if replan else cfg.pm_capacity == 1
        runner.finish()


def test_p3m_config_validation():
    from nbody_tpu_torch import SimConfig

    cfg = SimConfig(kernel="p3m", pm_grid=32, pm_sr_layout="xla",
                    platform="cpu")
    assert cfg.kernel_opts() == {"grid": 32}
    with pytest.raises(ValueError, match="requires --kernel p3m"):
        SimConfig(kernel="pm", pm_replan=True)
    with pytest.raises(ValueError, match="requires --kernel p3m"):
        SimConfig(kernel="pallas", pm_sr_layout="xla")
    with pytest.raises(ValueError, match="unknown --pm-sr-layout"):
        SimConfig(kernel="p3m", pm_sr_layout="bogus")
    with pytest.raises(ValueError, match="requires --pm-box"):
        SimConfig(kernel="p3m", pm_boundary="periodic")
    SimConfig(kernel="pm", pm_cutoff=4, pm_replan=True)


def test_cli_p3m_prints_a_finite_table():
    proc = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch", "256", "20", "--kernel",
         "p3m", "--pm-grid", "32", "--distribution", "plummer", "--dt",
         "0.01", "--sfreq", "10", "--platform", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = [line.split() for line in proc.stdout.splitlines()
            if line.split() and line.split()[0] in ("10", "20")]
    assert len(rows) == 2
    assert all(np.isfinite(float(r[2])) and float(r[2]) > 0 for r in rows)


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def test_fixture_config_matches_the_port():
    """The card's fixture was made from the JAX package's Plummer N=16384,
    seed 7; the port's bit-equal state, and its CPU plan, are the same."""
    fx = np.load(FIXTURE)
    assert {k: int(fx[k]) for k in FIXTURE_CFG} == FIXTURE_CFG
    pos, mass = _plummer(FIXTURE_CFG["n"], FIXTURE_CFG["seed"])
    assert str(fx["digest"]) == _digest(pos, mass)
    assert fx["pm"].shape == fx["p3m"].shape == (3, FIXTURE_CFG["n"])
    assert os.path.getsize(FIXTURE) < 500_000
    plan = pm.suggest_sr_plan(_t(pos), _t(mass), FIXTURE_CFG["grid"],
                              FIXTURE_CFG["cutoff"])
    assert plan == {k: int(fx[k]) for k in plan}


def make_fixture() -> None:
    """Write FIXTURE from the JAX package on the CPU."""
    from nbody_tpu.models.distributions import plummer as jax_plummer

    n, seed, ng, cutoff = (FIXTURE_CFG[k] for k in ("n", "seed", "grid",
                                                    "cutoff"))
    pos, _, mass = jax_plummer(n, seed=seed)
    plan = jax_pm.suggest_sr_plan(pos, mass, ng, cutoff)
    a_pm = _jax_acc(jnp.asarray(pos), jnp.asarray(mass), grid=ng)
    a_p3m = jax.jit(jax_pm.p3m_accelerations, static_argnames=(
        "grid", "capacity", "sr_slabs", "sr_entries"))(
        jnp.asarray(pos), jnp.asarray(mass), grid=ng, **plan)
    np.savez_compressed(
        FIXTURE, pm=np.asarray(a_pm, np.float32),
        p3m=np.asarray(a_p3m, np.float32), digest=_digest(pos, mass),
        **FIXTURE_CFG, **plan)
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes), plan {plan}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--make-fixture"]:
        sys.exit("usage: python tests/test_torch_p3m.py --make-fixture")
    from nbody_tpu.utils.platform import force_cpu

    force_cpu(1)
    make_fixture()

"""The port's differentiable P3M (``differentiable=True``, open and periodic:
the short-range sweep with its VJP, ``ops/sr_kernel.sweep_ad``) against the
JAX package's ``jax.grad``, on the CPU, where the sweep and its VJP run their
plain versions.

Inputs are made by numpy from a seed (the bit-equal Plummer spheres and
corner blobs of both packages) and handed to both.  Tolerances:

* ``sweep_vjp_plain`` against autograd through a dense, loop-free sweep
  (tests/test_p3m.py:452-470's check): gp, gm and grc2 within 1e-5 of each
  one's largest magnitude, in both unpaired layouts; the VJP kernel's
  schedule (per-entry partials, bands, each side's fixed order), emulated
  here, within the same bound.
* the differentiable forward equals the non-differentiable one bit for bit
  (tests/test_p3m.py:444, :1425): the same sweep runs.
* full-solve gradients of mean(|a|^2) against ``jax.grad``: 1e-4 of the
  largest (the force bar between the packages: their sums and transforms
  differ), the pinned layouts of tests/test_p3m.py:485 at 2e-5; without
  the rc2 cotangent the open gradient misses by more than 1e-4.
* a rollout gradient with remat equals the one without bit for bit.
* the N=16384 fixture: see ``test_fixture_matches_the_port``.

The JAX gradients are computed once each, in module-scoped fixtures (JAX
compiles its differentiable P3M slowly).

``python tests/test_torch_p3m_grad.py --make-fixture`` writes
``tests/golden/torch_p3m_grad_n16384.npz``: the JAX package's gradient of
mean(|a|^2) with respect to the positions, open (Plummer N=16384, seed 7,
ng=64, cutoff 4) and periodic (the reference initial conditions at N=16384
boxed at L = 1, ng=64), computed on the CPU, which ``chip_smoke.py`` holds
the port's kernel backward against on the card, where JAX is not installed.
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

from chip_smoke import corner_blob  # noqa: E402
from nbody_tpu.ops import pm as jax_pm  # noqa: E402
from nbody_tpu_torch.examples import fit_velocities  # noqa: E402
from nbody_tpu_torch.init import make_state  # noqa: E402
from nbody_tpu_torch.models import distributions  # noqa: E402
from nbody_tpu_torch.models.gravity import make_accel_fn  # noqa: E402
from nbody_tpu_torch.models.rollout import make_rollout_fn  # noqa: E402
from nbody_tpu_torch.ops import pm, sr_kernel  # noqa: E402
from nbody_tpu_torch.types import SOFTENING_SQUARED  # noqa: E402

torch.set_num_threads(2)

SLAB = pm.SLAB
TOL = 1e-4
FIXTURE = os.path.join(ROOT, "tests", "golden", "torch_p3m_grad_n16384.npz")
FIXTURE_CFG = dict(n=16384, seed=7, grid=64, cutoff=4, box=1.0)
# tests/test_p3m.py:426 (open), :485 (the pinned layouts), :1412 (periodic).
OPEN = dict(grid=16, cutoff_cells=4, capacity=64)
PERIODIC = dict(grid=32, cutoff_cells=4, capacity=256, sr_ghosts=512,
                boundary="periodic", box_size=1.0)


def _t(a):
    return torch.tensor(np.asarray(a))


def _plummer(n, seed):
    pos, _, mass = distributions.plummer(n, seed=seed)
    return pos, mass


def _digest(pos, mass):
    return hashlib.sha256(np.asarray(pos, np.float32).tobytes()
                          + np.asarray(mass, np.float32).tobytes()).hexdigest()


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(items):
    """jax.grad of mean(|a|^2) in the positions, jitted once a config."""
    kw = dict(items)

    def loss(p, m):
        return jnp.mean(jax_pm.accelerations(p, m, differentiable=True,
                                             **kw) ** 2)

    return jax.jit(jax.grad(loss))


def _jax_grad(pos, mass, **kw):
    fn = _jax_grad_fn(tuple(sorted(kw.items())))
    return np.asarray(fn(jnp.asarray(pos), jnp.asarray(mass)))


def _grad(pos, mass, fn=None, **kw):
    """The port's gradient of mean(|a|^2) in the positions."""
    p = _t(pos).requires_grad_(True)
    acc = fn(p, _t(mass)) if fn else pm.accelerations(
        p, _t(mass), differentiable=True, **kw)
    torch.mean(acc ** 2).backward()
    return p.grad.numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _max_err(got, want):
    """Largest difference as a share of the largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def open_case():
    pos, mass = _plummer(256, 15)
    return pos, mass, _jax_grad(pos, mass, **OPEN)


@pytest.fixture(scope="module")
def periodic_case():
    pos, mass = corner_blob(64, 15)
    return pos, mass, _jax_grad(pos, mass, **PERIODIC)


@pytest.fixture(scope="module")
def layout_case():
    """tests/test_p3m.py:485: Plummer 1024, seed 22, ng=32, the JAX
    package's gradient in its plain unpaired layout."""
    pos, mass = _plummer(1024, 22)
    kw = dict(grid=32, cutoff_cells=4,
              capacity=int(jax_pm.suggest_capacity(pos, mass, 32, 4)))
    prev = jax_pm.set_sr_layout(("xla", False, False))
    try:
        want = _jax_grad(pos, mass, **kw)
    finally:
        jax_pm.set_sr_layout(prev)
    return pos, mass, kw, want


# ---------------------------------------------------------------------------
# The sweep's VJP


def _sweep_inputs(n=256, ng=16, seed=15, symmetric=False):
    pos, mass = _plummer(n, seed)
    pk = pm.sr_pack_inputs(_t(pos), _t(mass), grid=ng, cutoff_cells=4,
                           symmetric=symmetric)
    n_e = int(pk["n_e"])
    assert 0 < n_e <= pk["e_max"]
    return pk, n_e


def _dense_sweep(ptab, mtab, wl_t, wl_s, n_e, rc2, symmetric):
    """The unpaired sweep over its n_e entries as one dense block, with no
    loop: autograd's oracle for the VJP."""
    p = ptab.reshape(3, -1, SLAB)
    m = mtab.reshape(-1, SLAB)
    te, se = wl_t[:n_e].long(), wl_s[:n_e].long()
    d = p[:, se][:, :, None, :] - p[:, te][:, :, :, None]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    u = torch.rsqrt(r2 + SOFTENING_SQUARED)
    w0 = (1.0 - pm._taper(r2 / rc2)) * (u * u * u)
    out = torch.zeros_like(p).index_add(1, te, (m[se][:, None, :] * w0
                                                * d).sum(dim=3))
    if symmetric:
        off = (se != te).to(w0.dtype)[:, None, None]
        out = out.index_add(1, se, -(m[te][:, :, None] * off * w0
                                     * d).sum(dim=2))
    out = out.reshape(3, -1)
    return torch.cat([out[:, :-SLAB], torch.zeros_like(out[:, -SLAB:])], 1)


@pytest.mark.parametrize("layout", ["pallas", "pallas_sym"])
def test_vjp_plain_matches_autograd(layout):
    sym = pm.SR_LAYOUTS[layout][0]
    pk, n_e = _sweep_inputs(symmetric=sym)
    ptab = pk["ptab"].clone().requires_grad_(True)
    mtab = pk["mtab"].clone().requires_grad_(True)
    rc2 = pk["rc2"].clone().requires_grad_(True)
    g = _t(np.random.default_rng(3).standard_normal(ptab.shape)
           .astype(np.float32))
    out = _dense_sweep(ptab, mtab, pk["wl_t"], pk["wl_s"], n_e, rc2, sym)
    want = torch.autograd.grad((out * g).sum(), (ptab, mtab, rc2))
    bounds = torch.tensor([0, n_e], dtype=torch.int32)
    with torch.no_grad():
        plain = sr_kernel.sweep_plain(pk["ptab"], pk["mtab"], pk["wl_t"],
                                      pk["wl_s"], bounds, pk["rc2"],
                                      symmetric=sym)
    torch.testing.assert_close(plain, out.detach(), rtol=0,
                               atol=1e-6 * float(plain.abs().max()))
    got = sr_kernel.sweep_vjp_plain(pk["ptab"], pk["mtab"], pk["wl_t"],
                                    pk["wl_s"], bounds, pk["rc2"], g,
                                    symmetric=sym)
    for name, a, b in zip(("gp", "gm", "grc2"), got, want):
        assert float(b.abs().max()) > 0, name
        assert _max_err(a, b) <= 1e-5, name


def _emulate_vjp_kernel(ptab, mtab, wl_t, wl_s, bounds, rc2, g, symmetric,
                        band):
    """csrc/sr_vjp.cu's schedule in plain PyTorch: per-entry partials of
    the target side (gp, gm, grc2's term) and the source side (gp, gm), a
    NaN for every entry outside the bounds, each side's partials added per
    slab in sr_kernel.band_order's order, band by band."""
    nslots = ptab.shape[1]
    nslab = nslots // SLAB
    g = g.clone()
    g[:, -SLAB:] = 0.0
    tab = torch.cat([ptab, mtab[None]]).reshape(4, nslab, SLAB)
    gt = g.reshape(3, nslab, SLAB)
    acc_t = torch.zeros(5, nslab, SLAB)
    acc_s = torch.zeros(4, nslab, SLAB)
    e_max = wl_t.shape[0]
    for e0 in range(0, e_max, band):
        e1 = min(e0 + band, e_max)
        te, se = wl_t[e0:e1].long(), wl_s[e0:e1].long()
        pi, pj = tab[:, te][:, :, :, None], tab[:, se][:, :, None, :]
        gi, gj = gt[:, te][:, :, :, None], gt[:, se][:, :, None, :]
        d = pj[:3] - pi[:3]  # (3, entry, i, j)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        q = r2 * (1.0 / rc2)
        inside = (q < 1.0).to(r2.dtype)
        u = torch.rsqrt(r2 + SOFTENING_SQUARED)
        u3 = u * u * u
        qc = q.clamp(max=1.0)
        ds = 30.0 * (qc * (1.0 - qc)) ** 2
        w = inside * (1.0 - pm._taper(qc)) * u3
        dw = inside * (-1.5 * w * u * u - u3 * ds / rc2)
        k = inside * u3 * ds * qc / rc2
        off = ((se != te) & symmetric).to(r2.dtype)[:, None, None]
        h = pj[3] * gi - off * pi[3] * gj
        hd = (h * d).sum(dim=0)
        v = w * h + 2.0 * dw * hd * d
        part = torch.cat([
            -v.sum(dim=3), (-off * w * (gj * d).sum(dim=0)).sum(dim=2)[None],
            (k * hd).sum(dim=2)[None],  # the target side, (5, entry, 64)
            v.sum(dim=2), (w * (gi * d).sum(dim=0)).sum(dim=1)[None]])
        idx = torch.arange(e0, e1)
        live = (idx >= bounds[0]) & (idx < bounds[1])
        part[:, ~live] = float("nan")
        for acc, wl, rows in ((acc_t, wl_t, slice(0, 5)),
                              (acc_s, wl_s, slice(5, 9))):
            perm, start = sr_kernel.band_order(wl, bounds, e0, e1, nslab)
            for slab in range(nslab):
                for r in range(int(start[slab]), int(start[slab + 1])):
                    acc[:, slab] += part[rows, perm[r]]
    gp = (acc_t[:3] + acc_s[:3]).reshape(3, -1)
    gm = (acc_t[3] + acc_s[3]).reshape(-1)
    return gp, gm, acc_t[4].sum()


@pytest.mark.parametrize("layout", ["pallas", "pallas_sym"])
@pytest.mark.parametrize("band", [7, 1 << 20])
def test_vjp_kernel_schedule_emulated(layout, band):
    """The kernel's partials, bands and fixed-order reduces, emulated with
    bounds that cut the worklist at both ends, give the plain VJP."""
    sym = pm.SR_LAYOUTS[layout][0]
    pk, n_e = _sweep_inputs(n=512, ng=16, seed=4, symmetric=sym)
    g = _t(np.random.default_rng(5).standard_normal(pk["ptab"].shape)
           .astype(np.float32))
    bounds = torch.tensor([3, n_e - 5], dtype=torch.int32)
    args = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"], bounds,
            pk["rc2"], g)
    want = sr_kernel.sweep_vjp_plain(*args, symmetric=sym)
    got = _emulate_vjp_kernel(*args, symmetric=sym, band=band)
    for name, a, b in zip(("gp", "gm", "grc2"), got, want):
        assert bool(torch.isfinite(a).all()), name
        assert _max_err(a, b) <= 1e-5, name


def test_band_order_is_stable_and_drops_dead_entries():
    wl = torch.tensor([2, 0, 2, 1, 0, 2, 1], dtype=torch.int32)
    bounds = torch.tensor([1, 6], dtype=torch.int32)
    perm, start = sr_kernel.band_order(wl, bounds, 1, 7, 3)
    assert perm.dtype == start.dtype == torch.int32
    # Band entries 1..6 hold slabs 0, 2, 1, 0, 2, 6 is dead: slab 0 at band
    # positions 0 and 3, slab 1 at 2, slab 2 at 1 and 4.
    assert start.tolist() == [0, 2, 3, 5]
    assert perm[:5].tolist() == [0, 3, 2, 1, 4]


def test_sweep_ad_forward_and_backward_on_the_cpu():
    pk, n_e = _sweep_inputs(symmetric=True)
    bounds = torch.tensor([0, n_e], dtype=torch.int32)
    ptab = pk["ptab"].clone().requires_grad_(True)
    out = sr_kernel.sweep_ad(ptab, pk["mtab"], pk["wl_t"], pk["wl_s"], bounds,
                             pk["rc2"], symmetric=True)
    with torch.no_grad():
        ref = sr_kernel.sweep(pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"],
                              bounds, pk["rc2"], symmetric=True)
    assert torch.equal(out.detach(), ref)
    g = torch.ones_like(out)
    (out * g).sum().backward()
    want = sr_kernel.sweep_vjp_plain(pk["ptab"], pk["mtab"], pk["wl_t"],
                                     pk["wl_s"], bounds, pk["rc2"], g,
                                     symmetric=True)[0]
    assert torch.equal(ptab.grad, want)


# ---------------------------------------------------------------------------
# The full solve


@pytest.mark.parametrize("case", ["open", "periodic"])
def test_differentiable_forward_equals_nondifferentiable(case):
    pos, mass = _plummer(256, 15) if case == "open" else corner_blob(64, 15)
    kw = OPEN if case == "open" else PERIODIC
    a0 = pm.accelerations(_t(pos), _t(mass), **kw)
    a1 = pm.accelerations(_t(pos), _t(mass), differentiable=True, **kw)
    assert torch.equal(a0, a1)


def test_open_grad_matches_jax(open_case):
    pos, mass, want = open_case
    assert np.abs(want).max() > 0
    assert _max_err(_grad(pos, mass, **OPEN), want) <= TOL


def test_grad_without_the_rc2_term_misses_jax(open_case, monkeypatch):
    """rc2 comes from the robust box of the positions: leaving its
    cotangent out moves the gradient by more than the tolerance."""
    pos, mass, want = open_case
    plain = sr_kernel.sweep_vjp_plain

    def no_rc2(*args, **kw):
        gp, gm, grc2 = plain(*args, **kw)
        return gp, gm, torch.zeros_like(grc2)

    monkeypatch.setattr(sr_kernel, "sweep_vjp_plain", no_rc2)
    assert _max_err(_grad(pos, mass, **OPEN), want) > TOL


@pytest.mark.parametrize("layout", ["pallas", "pallas_sym"])
def test_pinned_layout_grads_match_jax(layout_case, layout):
    pos, mass, kw, want = layout_case
    prev = pm.set_sr_layout(layout)
    try:
        got = _grad(pos, mass, **kw)
    finally:
        pm.set_sr_layout(prev)
    assert _max_err(got, want) <= 2e-5


def test_make_accel_fn_grad_matches_jax():
    """tests/test_p3m.py:864: make_accel_fn's p3m differentiates natively,
    through the sweep's VJP, not the exact-pair VJP."""
    pos, mass = _plummer(256, 18)
    fn = make_accel_fn("p3m", differentiable=True, grid=16, capacity=64)
    want = _jax_grad(pos, mass, **OPEN)
    assert _max_err(_grad(pos, mass, fn=fn), want) <= TOL


def test_periodic_grad_matches_jax(periodic_case):
    """Gradients reach each ghost image's parent; tests/test_p3m.py:1412
    asks only for a finite, non-zero one."""
    pos, mass, want = periodic_case
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    assert _max_err(_grad(pos, mass, **PERIODIC), want) <= TOL


def test_plan_sizes_the_differentiable_worklist(monkeypatch):
    """A plan for the card's default layout (paired rows) is too short for
    the unpaired worklist a differentiable call runs: the solver would drop
    entries.  suggest_sr_plan(differentiable=True) sizes the one that runs.
    The card's dispatch is emulated on the CPU state."""
    on_card = pm._active_sr_layout
    assert on_card(True) == (False, True)
    assert on_card(True, differentiable=True) == (False, False)
    assert on_card(False, differentiable=True) == on_card(False) == (True,
                                                                      False)
    monkeypatch.setattr(pm, "_active_sr_layout",
                        lambda on_cuda, differentiable=False:
                        on_card(True, differentiable))
    pos, mass = _plummer(4096, 7)
    p, m = _t(pos), _t(mass)
    kw = dict(grid=32, cutoff_cells=4)
    plan = pm.suggest_sr_plan(p, m, headroom=1.0, **kw)
    dplan = pm.suggest_sr_plan(p, m, headroom=1.0, differentiable=True, **kw)
    assert dplan["sr_entries"] > plan["sr_entries"]
    assert pm.sr_entry_overflow(p, m, differentiable=True, **kw, **plan) > 0
    assert pm.sr_entry_overflow(p, m, differentiable=True, **kw, **dplan) == 0
    named = pm.suggest_sr_plan(p, m, headroom=1.0, layout="pallas_paired",
                               differentiable=True, **kw)
    assert named == dplan


def test_rollout_grad_remat_equals_no_remat():
    """A 3-step p3m rollout gradient: each checkpointed step runs its
    forward again (the overflow branch the same) and adds in one order."""
    pos, mass = _plummer(256, 9)
    vel = np.asarray(np.random.default_rng(2).standard_normal((3, 256)) * 0.1,
                     np.float32)
    fn = make_accel_fn("p3m", differentiable=True, **OPEN)
    grads = []
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for remat in (True, False):
            v = _t(vel).requires_grad_(True)
            m = _t(mass).requires_grad_(True)
            p_end, _ = make_rollout_fn(fn, 0.01, 3, remat=remat)(_t(pos), v,
                                                                  m)
            torch.sum(p_end ** 2).backward()
            grads.append((v.grad, m.grad))
    finally:
        torch.set_num_threads(prev)
    assert float(grads[0][0].abs().max()) > 0
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


def test_fit_velocities_p3m_on_the_cpu(capsys):
    assert fit_velocities.main(["64", "4", "12", "p3m", "--platform",
                                "cpu"]) == 0
    assert "recovered initial velocities" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The card's fixture


def _fixture_states():
    n, seed = FIXTURE_CFG["n"], FIXTURE_CFG["seed"]
    pos, mass = _plummer(n, seed)
    ref = make_state(n, device="cpu")
    return {"open": (pos, mass, {}),
            "periodic": (ref.pos.numpy(), ref.mass.numpy(),
                         dict(boundary="periodic",
                              box_size=FIXTURE_CFG["box"]))}


def test_fixture_matches_the_port():
    """The fixture's states and capacities are the port's, and the port's
    CPU gradient agrees with it, as the card's must: periodic within 1e-4
    of the largest component; open within 1e-4 relative norm.  Under the
    open boundary the few particles at the robust box's quantiles carry the
    box's gradient, a sum over every particle's force, in which fp32 noise
    reaches 4e-4 (the port) and 9e-4 (the JAX package) of the largest
    component against the port run in float64."""
    fx = np.load(FIXTURE)
    assert os.path.getsize(FIXTURE) < 1_000_000
    for name, (pos, mass, bkw) in _fixture_states().items():
        assert str(fx[f"{name}_digest"]) == _digest(pos, mass)
        plan = pm.suggest_sr_plan(_t(pos), _t(mass), FIXTURE_CFG["grid"],
                                  FIXTURE_CFG["cutoff"], differentiable=True,
                                  capacity=int(fx[f"{name}_capacity"]),
                                  **bkw)
        got = _grad(pos, mass, grid=FIXTURE_CFG["grid"],
                    cutoff_cells=FIXTURE_CFG["cutoff"], **plan, **bkw)
        err = _rel if name == "open" else _max_err
        assert err(got, fx[f"{name}_grad"]) <= TOL, name


def make_fixture() -> None:
    """Write FIXTURE from the JAX package on the CPU."""
    out = dict(FIXTURE_CFG)
    ng, cutoff = FIXTURE_CFG["grid"], FIXTURE_CFG["cutoff"]
    for name, (pos, mass, bkw) in _fixture_states().items():
        plan = jax_pm.suggest_sr_plan(pos, mass, ng, cutoff, **bkw)
        out[f"{name}_grad"] = _jax_grad(pos, mass, grid=ng,
                                        cutoff_cells=cutoff, **plan, **bkw)
        out[f"{name}_digest"] = _digest(pos, mass)
        out[f"{name}_capacity"] = plan["capacity"]
        print(f"{name}: plan {plan}")
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")


if __name__ == "__main__":
    if sys.argv[1:] != ["--make-fixture"]:
        sys.exit("usage: python tests/test_torch_p3m_grad.py --make-fixture")
    from nbody_tpu.utils.platform import force_cpu

    force_cpu(1)
    make_fixture()

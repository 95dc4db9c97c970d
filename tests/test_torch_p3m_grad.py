"""The port's differentiable P3M (``differentiable=True``, open and periodic:
the short-range sweep with its VJP, ``ops/sr_kernel.sweep_ad``) against the
JAX package's ``jax.grad``, on the CPU, where the sweep and its VJP run their
plain versions.

Inputs are made by numpy from a seed (the bit-equal Plummer spheres and
corner blobs of both packages) and handed to both.  Tolerances:

* ``sweep_vjp_plain`` against autograd through a dense, loop-free sweep
  (tests/test_p3m.py:452-470's check): gp, gm and grc2 within 1e-5 of each
  one's largest magnitude, in both unpaired layouts; the VJP kernel's
  schedule (a target and a source pass, units, head and tail partials, the
  warp split, both skips), emulated here, within the same bound; every
  step a skip drops has terms exactly 0.
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
import re
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
SR_VJP_CU = os.path.join(ROOT, "nbody_tpu_torch", "csrc", "sr_vjp.cu")
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


def _vjp_unit() -> int:
    """The kernel's positions a unit, as csrc/sr_vjp.cu declares it."""
    with open(SR_VJP_CU) as f:
        return int(re.search(r"constexpr int kUnit = (\d+);", f.read())[1])


def _long_runs(pk, n_e):
    """The tables of ``pk`` under a made-up t-major worklist whose runs span
    many units on both sides: slab 0 takes every slab three times as its
    sources, and every other slab takes slab 0 five times, then itself;
    dead entries follow up to the plan's e_max."""
    nslab = pk["ptab"].shape[1] // SLAB
    pairs = [(0, s) for s in range(nslab) for _ in range(3)]
    pairs += [(t, s) for t in range(1, nslab) for s in [0] * 5 + [t]]
    e_max = max(len(pairs), pk["e_max"])
    wl = torch.zeros((2, e_max), dtype=torch.int32)
    wl[:, :len(pairs)] = torch.tensor(pairs, dtype=torch.int32).t()
    return dict(pk, wl_t=wl[0].contiguous(), wl_s=wl[1].contiguous()), \
        len(pairs)


def _keep(q):
    """The kernels' sr_keep: 1 - S(q) as 1 + q^3 (-10 + q (15 - 6 q)),
    q clamped to 1."""
    qc = torch.clamp(q, max=1.0)
    return (qc * qc * qc) * ((-6.0 * qc + 15.0) * qc - 10.0) + 1.0


def _emulate_pass(tab, gtab, own_of, other_of, react_of, lo, hi, unit,
                  source, inv_rc2, stats):
    """One pass of csrc/sr_vjp.cu over positions [lo, hi) (position r: its
    owner slab, other slab and whether it takes the reaction), as the kernel
    schedules it: units of ``unit`` positions cut into segments at run ends,
    each owner slab split into two compact warps (sr_kernel.split_order),
    per (warp, other) step the box ballot then the vote, both checked to
    drop only terms that are exactly 0, the lane's factored sums, and a
    whole run's sums stored or a head or tail partial left for the
    finalize.  Returns (sums (rows, nslab, 64), visits per position);
    ``stats`` counts steps and each skip's drops."""
    nslab = tab.shape[0]
    rows = 4 if source else 5
    eps_q = -SOFTENING_SQUARED * inv_rc2
    split = sr_kernel.split_order(tab)
    acc = torch.zeros(rows, nslab, SLAB)
    visits = torch.zeros(max(hi, 0), dtype=torch.int64)
    part = {}
    for u in range(lo // unit, -(-hi // unit)):
        e0, e1 = max(u * unit, lo), min(u * unit + unit, hi)
        r = e0
        while r < e1:
            own = own_of[r]
            end = r + 1
            while end < e1 and own_of[end] == own:
                end += 1
            starts = r == lo or own_of[r - 1] != own
            ends = end == hi or own_of[end] != own
            visits[r:end] += 1
            slots = split[own]  # thread k -> its slot
            me, gme = tab[own, slots], gtab[own, slots]  # (64, 4), (64, 3)
            box = me[:, :3].view(2, 32, 3)
            blo, bhi = box.amin(1), box.amax(1)  # (warp, 3)
            wm, m, r_sum = (torch.zeros(SLAB) for _ in range(3))
            g_sum, d_sum = torch.zeros(SLAB, 3), torch.zeros(SLAB, 3)
            for k in range(r, end):
                o, go = tab[other_of[k]], gtab[other_of[k]]  # slot order
                d = (me[:, None, :3] - o[None, :, :3] if source
                     else o[None, :, :3] - me[:, None, :3])  # (lane, other)
                d2 = ((d[..., 0] * d[..., 0] + SOFTENING_SQUARED)
                      + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
                q = d2 * inv_rc2 + eps_q
                gap = torch.clamp(torch.maximum(blo[:, None] - o[None, :, :3],
                                                o[None, :, :3] - bhi[:, None]),
                                  min=0.0)  # (warp, other, 3)
                by_box = sr_kernel.kernel_q(gap, inv_rc2) >= 1.0
                beyond = (q >= 1.0).view(2, 32, SLAB).all(dim=1)
                assert bool((beyond | ~by_box).all()), "the box is no bound"
                u_ = torch.rsqrt(d2)
                u2, u3 = u_ * u_, u_ * u_ * u_
                qc = q.clamp(max=1.0)
                qq = qc * (1.0 - qc)
                a2 = u3 * (qq * qq) * (60.0 * inv_rc2)
                w = _keep(q) * u3
                c2 = -3.0 * w * u2 - a2
                k2 = a2 * qc
                drop = beyond[:, None, :].expand(2, 32, SLAB).reshape(SLAB,
                                                                      SLAB)
                for t_ in (w, c2, k2):
                    stats["dropped_max"] = max(stats["dropped_max"],
                                               float(t_[drop].abs().max())
                                               if bool(drop.any()) else 0.0)
                keep = (~drop).to(w.dtype)
                w, c2, k2 = w * keep, c2 * keep, k2 * keep
                stats["steps"] += 2 * SLAB
                stats["box"] += int(by_box.sum())
                stats["vote"] += int((beyond & ~by_box).sum())
                if source:  # d = p_j - p_i, j the lane's, i the other
                    gid = (go[None] * d).sum(-1)
                    hd = me[:, 3, None] * gid
                    if react_of[k]:
                        hd = hd - o[None, :, 3] * (gme[:, None] * d).sum(-1)
                        wm += (w * o[None, :, 3]).sum(1)
                    g_sum += (w[..., None] * go[None]).sum(1)
                    m += (w * gid).sum(1)
                else:
                    hd = o[None, :, 3] * (gme[:, None] * d).sum(-1)
                    if react_of[k]:
                        gjd = (go[None] * d).sum(-1)
                        hd = hd - me[:, 3, None] * gjd
                        g_sum += (w[..., None] * go[None]).sum(1)
                        m += (w * gjd).sum(1)
                    wm += (w * o[None, :, 3]).sum(1)
                    r_sum += (k2 * hd).sum(1)
                d_sum += ((c2 * hd)[..., None] * d).sum(1)
            if source:
                out = torch.cat([(me[:, 3, None] * g_sum - gme * wm[:, None]
                                  + d_sum).t(), m[None]])
            else:
                out = torch.cat([-(gme * wm[:, None] - me[:, 3, None] * g_sum
                                   + d_sum).t(), -m[None], 0.5 * r_sum[None]])
            if starts and ends:
                acc[:, own, slots] = out
            else:
                part[(u, 1 if starts else 0)] = (own, slots, out)
            r = end
    # The finalize: a run's partials in unit order, each read once.
    used = set()
    runs = {}
    for r in range(lo, hi):
        runs.setdefault(own_of[r], []).append(r)
    for own, pos in runs.items():
        c0, c1 = pos[0] // unit, pos[-1] // unit
        assert pos == list(range(pos[0], pos[-1] + 1)), "a run is cut"
        if c0 == c1:
            continue
        _, slots, total = part[(c0, 1)]
        used.add((c0, 1))
        for c in range(c0 + 1, c1 + 1):
            total = total + part[(c, 0)][2]
            used.add((c, 0))
        acc[:, own, slots] = total
    assert used == set(part), "a partial is written and never read"
    return acc, visits


def _emulate_vjp_kernel(ptab, mtab, wl_t, wl_s, bounds, rc2, g, symmetric,
                        unit, stats=None):
    """csrc/sr_vjp.cu in plain PyTorch: the target pass over the bounds in
    worklist order, the source pass over sr_kernel.band_order's transposed
    order, each with its units, split, skips and finalize
    (``_emulate_pass``), then the two sides added a slot and grc2's terms
    summed.  Checks that each pass visits every live entry once."""
    stats = {} if stats is None else stats
    nslots = ptab.shape[1]
    nslab = nslots // SLAB
    g = g.clone()
    g[:, -SLAB:] = 0.0
    tab = torch.cat([ptab, mtab[None]]).t().reshape(nslab, SLAB, 4)
    gtab = g.t().reshape(nslab, SLAB, 3)
    inv_rc2 = 1.0 / rc2
    t_l, s_l = wl_t.tolist(), wl_s.tolist()
    e_max = len(t_l)
    b0, b1 = max(int(bounds[0]), 0), min(int(bounds[1]), e_max)
    react = [symmetric and t != s for t, s in zip(t_l, s_l)]
    perm, start = sr_kernel.band_order(wl_s, bounds, nslab)
    live = int(start[nslab])
    p_l = perm.tolist()
    sums = []
    for side in ("target", "source"):
        st = stats.setdefault(side, dict(steps=0, box=0, vote=0,
                                         dropped_max=0.0))
        if side == "target":
            acc, visits = _emulate_pass(tab, gtab, t_l, s_l, react, b0, b1,
                                        unit, False, inv_rc2, st)
            assert bool((visits[b0:b1] == 1).all())
        else:
            acc, visits = _emulate_pass(
                tab, gtab, [s_l[e] for e in p_l], [t_l[e] for e in p_l],
                [react[e] for e in p_l], 0, live, unit, True, inv_rc2, st)
            seen = torch.zeros(e_max, dtype=torch.int64)
            seen[perm[:live].long()] += visits[:live]
            assert bool((seen[b0:b1] == 1).all())
            assert int(seen.sum()) == b1 - b0
        sums.append(acc.reshape(acc.shape[0], -1))
    acc_t, acc_s = sums
    return acc_t[:3] + acc_s[:3], acc_t[3] + acc_s[3], acc_t[4].sum()


def _vjp_case(layout, kind):
    sym = pm.SR_LAYOUTS[layout][0]
    pk, n_e = _sweep_inputs(n=512, ng=16, seed=4, symmetric=sym)
    if kind == "long runs":
        pk, n_e = _long_runs(pk, n_e)
    g = _t(np.random.default_rng(5).standard_normal(pk["ptab"].shape)
           .astype(np.float32))
    bounds = torch.tensor([3, n_e - 5], dtype=torch.int32)
    return (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"], bounds,
            pk["rc2"], g), sym


@pytest.mark.parametrize("kind", ["plan", "long runs"])
@pytest.mark.parametrize("layout", ["pallas", "pallas_sym"])
@pytest.mark.parametrize("unit", [3, "kernel"])
def test_vjp_kernel_schedule_emulated(layout, unit, kind):
    """The kernel's two passes, units, head and tail partials, finalize,
    transposed order, split and skips, emulated with bounds that cut the
    worklist at both ends, give the plain VJP; on the plan's worklist and on
    one whose runs span many units on both sides."""
    args, sym = _vjp_case(layout, kind)
    unit = _vjp_unit() if unit == "kernel" else unit
    want = sr_kernel.sweep_vjp_plain(*args, symmetric=sym)
    got = _emulate_vjp_kernel(*args, symmetric=sym, unit=unit)
    for name, a, b in zip(("gp", "gm", "grc2"), got, want):
        assert bool(torch.isfinite(a).all()), name
        assert _max_err(a, b) <= 1e-5, name


@pytest.mark.parametrize("layout", ["pallas", "pallas_sym"])
def test_vjp_skipped_steps_have_zero_terms(layout):
    """Every (warp, other) step that the box ballot or the vote drops has
    w, w' and k exactly 0 on every lane, in both passes, with the kernel's
    q; each skip drops some steps of each pass."""
    args, sym = _vjp_case(layout, "long runs")
    stats = {}
    _emulate_vjp_kernel(*args, symmetric=sym, unit=_vjp_unit(), stats=stats)
    for side in ("target", "source"):
        st = stats[side]
        assert st["dropped_max"] == 0.0, side
        assert st["box"] > 0 and st["vote"] > 0, (side, st)
        assert st["box"] + st["vote"] < st["steps"], side


def test_vjp_skip_counts_match_the_emulation():
    """sr_kernel.vjp_skip_counts (which chip_smoke.py and
    scripts/sr_launch_shapes.py --stats print) counts each pass's steps and
    dropped steps as the emulated kernel takes them."""
    for layout in ("pallas", "pallas_sym"):
        args, sym = _vjp_case(layout, "plan")
        stats = {}
        _emulate_vjp_kernel(*args, symmetric=sym, unit=_vjp_unit(),
                            stats=stats)
        got = sr_kernel.vjp_skip_counts(*args[:6])
        for side in ("target", "source"):
            st = stats[side]
            assert got["steps"] == st["steps"], side
            assert got[side] == st["box"] + st["vote"], side
        assert 0 < got["inside"] < got["pairs"] == got["steps"] * 32


def test_band_order_is_stable_and_drops_dead_entries():
    wl = torch.tensor([2, 0, 2, 1, 0, 2, 1], dtype=torch.int32)
    bounds = torch.tensor([1, 6], dtype=torch.int32)
    perm, start = sr_kernel.band_order(wl, bounds, 3)
    assert perm.dtype == start.dtype == torch.int32
    # Entries 1..5 hold slabs 0, 2, 1, 0, 2; 0 and 6 are dead: slab 0 at
    # entries 1 and 4, slab 1 at 3, slab 2 at 2 and 5.
    assert start.tolist() == [0, 2, 3, 5]
    assert perm[:5].tolist() == [1, 4, 3, 2, 5]


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

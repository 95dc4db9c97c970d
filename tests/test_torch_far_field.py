"""The open boundary's far field (``nbody_tpu_torch.ops.far_field_kernel``)
on the CPU: its plain version, which the card's kernels
(``csrc/far_field.cu``) follow (tests/test_torch_cuda.py), against the
solver's nine-call chain (``pm._outlier_moments``, then ``pm._monopoles``),
and the solver's choice between them.

* ``far_field_plain`` against the chain: bit for bit where every body lies
  inside the box (the octants are empty and the in-box monopole goes
  unused), same-set and with distinct targets; within ``MOMENT_TOL`` of
  the largest far field where bodies lie outside it: the chain sums its
  moments in float32, the plain version (and the kernel) in float64.
* The moments table against a numpy float64 sum; zero-mass padding, every
  body outside the box, bodies exactly on the octants' centre and on the
  box's faces (with sums that are exact in float32, so the chain's moments
  and the table must agree bit for bit), non-finite inputs.
* The dispatch: CPU tensors and inputs that require grad keep the chain;
  the kernel branch of the solver, forced on the CPU (where the wrappers
  run the plain versions), equals the chain bit for bit with every body
  inside the box.  The wrappers refuse bad inputs.
"""

import math

import numpy as np
import pytest
import torch

from nbody_tpu_torch.init import make_state
from nbody_tpu_torch.models import distributions
from nbody_tpu_torch.ops import far_field_kernel as ffk
from nbody_tpu_torch.ops import pm

torch.set_num_threads(2)

# The plain far field (float64 moments) against the chain's (float32 sums
# of float32 products), relative to the largest far-field component: the
# chain's sums of ~4096 terms carry a few 2^-24 of their magnitude, and
# an octant's centre of mass, a ratio of two such sums, moves by that much
# of the spread of its bodies.  The readings sit at 1.0e-8 to 3.7e-7.
MOMENT_TOL = 2e-6


def _state(kind, n=4096, seed=0):
    """(pos, mass, lo_box, hi_box) float32 on the CPU: the reference cube
    (every body inside its robust box) or a Plummer sphere (outliers)."""
    if kind == "uniform":
        st = make_state(n, device="cpu")
        pos, mass = st.pos, st.mass
    else:
        p, _, m = distributions.plummer(n, seed=seed)
        pos, mass = torch.tensor(p), torch.tensor(m)
    return (pos, mass, *pm._robust_box(pos, mass))


def _targets(pos, n_t, seed):
    """Distinct targets: a random subset of the sources' span, spread past
    it by a quarter on each side (so some lie outside the box)."""
    rng = np.random.default_rng(seed)
    lo, hi = pos.amin(dim=1).numpy(), pos.amax(dim=1).numpy()
    span = hi - lo
    t = rng.uniform(lo - 0.25 * span, hi + 0.25 * span, (n_t, 3)).T
    return torch.tensor(t, dtype=torch.float32).contiguous()


def _chain(pos, mass, lo_box, hi_box, tgt, acc):
    """The solver's far field as the chain computes it on the CPU."""
    m_in = mass * pm._inside(pos, lo_box, hi_box)
    in_tgt = pm._inside(tgt, lo_box, hi_box)
    moments = pm._outlier_moments(pos, mass, m_in, lo_box, hi_box)
    assert moments.table is None
    return pm._monopoles(acc, tgt, in_tgt, moments), m_in, in_tgt


@pytest.mark.parametrize("targets", ["same set", "distinct 1500",
                                     "distinct 6000"])
@pytest.mark.parametrize("kind", ["uniform", "plummer"])
def test_far_field_plain_against_the_chain(kind, targets):
    pos, mass, lo_box, hi_box = _state(kind)
    tgt = pos if targets == "same set" else _targets(
        pos, int(targets.split()[1]), 3)
    acc = torch.randn(tgt.shape, generator=torch.Generator().manual_seed(5))
    want, m_in, in_tgt = _chain(pos, mass, lo_box, hi_box, tgt, acc)
    got = ffk.far_field_plain(pos, mass, m_in, lo_box, hi_box, tgt, in_tgt,
                              acc)
    inside = bool((m_in == mass).all())
    assert inside == (kind == "uniform")
    if inside and targets == "same set":
        # Empty octants add exact zeros; no target takes the in-box mass's
        # monopole: the far field leaves acc as it is.
        assert torch.equal(got, want)
        assert torch.equal(got, acc)
    elif inside:
        # The octants are empty in both; the targets outside the box take
        # the in-box monopole, whose float32 moments differ in rounding.
        out = in_tgt == 0
        assert bool(out.any()) and bool((~out).any())
        assert torch.equal(got[:, ~out], want[:, ~out])
        scale = float(want[:, out].abs().max())
        assert float((got - want).abs().max()) <= MOMENT_TOL * scale
    else:
        far = want - torch.where(in_tgt > 0, acc, 0.0)
        scale = float(far.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= MOMENT_TOL * scale


def _moments64(pos, mass, m_in, lo_box, hi_box):
    """The moments table in numpy float64, for comparison."""
    p = pos.double().numpy()
    m, mi = mass.double().numpy(), m_in.double().numpy()
    ctr = (0.5 * (lo_box + hi_box)).numpy()
    side = (pos.numpy() > ctr).astype(int)
    octant = side[0] * 4 + side[1] * 2 + side[2]
    rows = []
    for k in range(9):
        w = mi if k == 0 else np.where(octant == k - 1, m - mi, 0.0)
        big_m = w.sum()
        rows.append([big_m, *((p * w).sum(axis=1) / max(big_m, 1e-30))])
    return np.array(rows)


@pytest.mark.parametrize("kind", ["uniform", "plummer"])
def test_moments_plain_is_the_float64_sum(kind):
    pos, mass, lo_box, hi_box = _state(kind, seed=4)
    m_in = mass * pm._inside(pos, lo_box, hi_box)
    table = ffk.moments_plain(pos, mass, m_in, lo_box, hi_box)
    ref = _moments64(pos, mass, m_in, lo_box, hi_box)
    # One float32 rounding of a float64 sum (and a last-bit difference of
    # the sums' orders): within one ulp.
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    assert bool((np.abs(table.double().numpy() - ref) <= ulp).all())
    if kind == "uniform":
        assert bool((table[1:] == 0).all())
    else:
        assert float(table[1:, 0].sum()) > 0  # mass outside the box


@pytest.mark.parametrize("case", ["zero-mass padding", "all outside",
                                  "on the centre and faces"])
def test_far_field_edge_cases(case):
    if case == "on the centre and faces":
        # Positions on a grid of eighths, masses small integers: every sum
        # of either path is exact, so the table equals the chain's moments
        # bit for bit and puts each body in the chain's octant.
        rng = np.random.default_rng(7)
        pos = torch.tensor(rng.integers(-8, 9, (3, 600)) / 8.0,
                           dtype=torch.float32)
        mass = torch.tensor(rng.integers(1, 5, 600), dtype=torch.float32)
        lo_box = torch.full((3, 1), -0.5)
        hi_box = torch.full((3, 1), 0.75)  # centre 0.125, a grid point
        ctr = 0.5 * (lo_box + hi_box)
        for a in range(3):  # on the centre, on each face
            assert bool((pos[a] == ctr[a, 0]).any())
            assert bool((pos[a] == lo_box[a, 0]).any())
            assert bool((pos[a] == hi_box[a, 0]).any())
    else:
        pos, mass, lo_box, hi_box = _state("plummer", n=2000, seed=2)
        if case == "zero-mass padding":
            far = 1.0e6 + torch.arange(96, dtype=torch.float32)
            pos = torch.cat([pos, far.expand(3, -1)], dim=1).contiguous()
            mass = torch.cat([mass, torch.zeros(96)])
        else:  # a box that holds no body
            lo_box, hi_box = lo_box - 100.0, lo_box - 99.0
    m_in = mass * pm._inside(pos, lo_box, hi_box)
    moments = pm._outlier_moments(pos, mass, m_in, lo_box, hi_box)
    table = ffk.moments_plain(pos, mass, m_in, lo_box, hi_box)
    chain = torch.stack([torch.cat([moments.M_in[None], moments.com_in[:, 0]]),
                         *(torch.cat([m[None], c[:, 0]])
                           for m, c in moments.octs)])
    acc = torch.randn(pos.shape, generator=torch.Generator().manual_seed(1))
    in_tgt = pm._inside(pos, lo_box, hi_box)
    got = ffk.far_field_plain(pos, mass, m_in, lo_box, hi_box, pos, in_tgt,
                              acc)
    want = pm._monopoles(acc, pos, in_tgt, moments)
    assert bool(torch.isfinite(got).all())
    if case == "on the centre and faces":
        assert torch.equal(table, chain)
        assert torch.equal(got, want)
        assert bool((table[1:, 0] > 0).sum() >= 4)  # several octants hold mass
    elif case == "all outside":
        assert float(m_in.abs().sum()) == 0 and bool((in_tgt == 0).all())
        assert torch.equal(table[0], torch.zeros(4))
        # The in-box monopole is zero: every target takes 0, then the
        # octants' fields.
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= MOMENT_TOL * scale
    else:
        # Padding adds nothing to any sum.
        n = pos.shape[1] - 96
        assert torch.equal(table, ffk.moments_plain(
            pos[:, :n].contiguous(), mass[:n], m_in[:n], lo_box, hi_box))
        scale = float((want - torch.where(in_tgt > 0, acc, 0.0)).abs().max())
        assert float((got - want).abs().max()) <= MOMENT_TOL * scale


@pytest.mark.parametrize("fault", ["nan position", "inf position",
                                   "nan mass", "inf in-box mass"])
def test_far_field_non_finite(fault):
    pos, mass, lo_box, hi_box = _state("plummer", n=1000, seed=6)
    m_in = mass * pm._inside(pos, lo_box, hi_box)
    if fault == "nan position":
        pos[1, 17] = math.nan
    elif fault == "inf position":
        pos[0, 3] = math.inf
    elif fault == "nan mass":
        mass[5] = math.nan
    else:
        m_in[9] = math.inf
    acc = torch.zeros_like(pos)
    in_tgt = pm._inside(pos, lo_box, hi_box)
    table = ffk.moments_plain(pos, mass, m_in, lo_box, hi_box)
    assert bool(table.isnan().all())
    got = ffk.far_field_plain(pos, mass, m_in, lo_box, hi_box, pos, in_tgt,
                              acc)
    want = pm._monopoles(acc, pos, in_tgt,
                         pm._outlier_moments(pos, mass, m_in, lo_box, hi_box))
    assert not bool(torch.isfinite(want).any())
    assert not bool(torch.isfinite(got).any())


@pytest.mark.parametrize("grad", [False, True], ids=["cpu", "requires grad"])
@pytest.mark.parametrize("cutoff", [0, 4], ids=["pm", "p3m"])
def test_dispatch_keeps_the_chain(grad, cutoff):
    """On the CPU, and wherever an input requires grad, the solver runs
    the chain: the kernels' launch counter does not move, the moments are
    no table, and the result carries autograd's graph."""
    pos, mass, _, _ = _state("plummer", n=1024, seed=8)
    p = pos.clone().requires_grad_(grad)
    before = ffk.launches
    seen = []
    moments = pm._outlier_moments

    def spy(*args):
        seen.append(moments(*args))
        return seen[-1]

    pm._outlier_moments = spy
    try:
        acc = pm.accelerations(p, mass, 16, cutoff,
                               differentiable=bool(cutoff and grad))
    finally:
        pm._outlier_moments = moments
    assert ffk.launches == before
    assert len(seen) == 1 and seen[0].table is None
    assert acc.requires_grad == grad
    assert not pm._hand_far_field(p, mass)
    if grad:
        g = torch.autograd.grad(acc.square().sum(), p)[0]
        assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("call", ["pm", "p3m", "pm distinct"])
def test_kernel_branch_equals_the_chain(monkeypatch, call):
    """The solver's kernel branch (``_outlier_moments`` returning the
    table's views, one ``_monopole`` call on the table), forced on the CPU
    where the wrappers run the plain versions: bit for bit the chain's
    accelerations with every body inside the box."""
    pos, mass, _, _ = _state("uniform", n=2048)
    tgt = _targets(pos, 700, 9) if call == "pm distinct" else pos
    cutoff = 4 if call == "p3m" else 0

    def solve():
        return pm.accelerations_between(tgt, pos, mass, 16, cutoff,
                                        capacity=2048)

    want = solve()
    calls = []
    monopole = pm._monopole

    def spy(*args, **kw):
        calls.append(args[1].shape)
        return monopole(*args, **kw)

    monkeypatch.setattr(pm, "_hand_far_field", lambda *t: True)
    monkeypatch.setattr(pm, "_monopole", spy)
    got = solve()
    # One call on the table, then the plain target pass's nine.
    assert calls[0] == (9, 4) and len(calls) == 10
    if call == "pm distinct":
        # Targets outside the box take the in-box monopole: float64 moments.
        in_tgt = pm._inside(tgt, *pm._robust_box(pos, mass)) > 0
        assert torch.equal(got[:, in_tgt], want[:, in_tgt])
        scale = float(want[:, ~in_tgt].abs().max())
        assert float((got - want).abs().max()) <= MOMENT_TOL * scale
    else:
        assert torch.equal(got, want)


def test_wrappers_on_the_cpu_are_the_plain_versions():
    pos, mass, lo_box, hi_box = _state("plummer", n=800, seed=9)
    m_in = mass * pm._inside(pos, lo_box, hi_box)
    in_tgt = pm._inside(pos, lo_box, hi_box)
    acc = torch.randn(pos.shape, generator=torch.Generator().manual_seed(2))
    before = ffk.launches
    table = ffk.moments(pos, mass, m_in, lo_box, hi_box)
    assert torch.equal(table, ffk.moments_plain(pos, mass, m_in, lo_box,
                                                hi_box))
    assert torch.equal(ffk.monopoles(pos, table, acc, in_tgt),
                       ffk.monopoles_plain(pos, table, acc, in_tgt))
    assert ffk.launches == before


@pytest.mark.parametrize("bad", ["float64 pos", "short mass", "strided pos",
                                 "flat box", "m_in on meta", "short acc",
                                 "table 8 rows", "int mask"])
def test_wrappers_check_their_inputs(bad):
    pos, mass, lo_box, hi_box = _state("plummer", n=300, seed=1)
    m_in = mass * pm._inside(pos, lo_box, hi_box)
    in_tgt = pm._inside(pos, lo_box, hi_box)
    acc = torch.zeros_like(pos)
    table = ffk.moments_plain(pos, mass, m_in, lo_box, hi_box)
    if bad == "float64 pos":
        pos = pos.double()
    elif bad == "short mass":
        mass = mass[:-1]
    elif bad == "strided pos":
        pos = torch.cat([pos, pos], dim=1)[:, ::2]
    elif bad == "flat box":
        lo_box = lo_box[:, 0]
    elif bad == "m_in on meta":
        m_in = m_in.to("meta")
    elif bad == "short acc":
        acc = acc[:, :-1]
    elif bad == "table 8 rows":
        table = table[:8]
    else:
        in_tgt = in_tgt.int()
    with pytest.raises((TypeError, ValueError)):
        if bad in ("short acc", "table 8 rows", "int mask"):
            ffk.monopoles(pos, table, acc, in_tgt)
        else:
            ffk.moments(pos, mass, m_in, lo_box, hi_box)

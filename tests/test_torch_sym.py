"""The pair-symmetric tile body of the CUDA kernels, modelled in numpy.

Kernel B (``csrc/sym.cu``), the two-sided sweep (``csrc/two_sided.cu``)
and the fused rows block (``csrc/fused.cu``) run one tile body,
``nbt::sym_tile_cross`` / ``nbt::sym_tile_pair_at`` in
``csrc/common.cuh``: a CTA of B / R threads sweeps one B x B tile pair,
thread t = 32 w + l owns targets t + r B / R (r < R), and at step k of the
32-wide j subtile s lane l reads j = 32 s + (l + k) mod 32 once, evaluates
it against its R targets and hands its j-side sums one lane on.  A diagonal
tile takes a one-sided sum, each target reading j = 0 .. B - 1 in order.
The card is not here, so this file models that map and its fp32
arithmetic (d2 and both sides as FMAs, ``rsqrt_cube_emulated``) for R = 1
and 2, which the launchers pick (``nbt::sym_targets``: 2 where B is a
multiple of 64, else 1), and R = 4, which only the ``--sym-targets``
builds of ``scripts/sweep_shapes.py`` take, holds it against the plain
PyTorch version (``sym_kernel.pair_terms``, the sums the
kernels' partials hold) and, over a whole sweep, against the JAX package's
``pallas_sym.accelerations(interpret=True)``.  The CUDA kernels are held
against the plain versions on a card by tests/test_torch_cuda.py and
chip_smoke.py at each R.  The 64-bit tile-pair index of Kernel B's 1-D
grid and of the fused rows block's queue (``nbt::tile_pair``) is modelled
too, at tile counts past 32-bit arithmetic.

Tolerances: the model sums in the kernel's order and the plain version in
PyTorch's, with an inverse cube within an ulp or two of IEEE, so a tile's
partials agree to 1e-6 relative norm (fp32 summation error over 128
terms); the N=2000 reference-IC forces with the inverse cube at the SFU's
documented worst error (2 ulp) stay within 1e-6 of the IEEE plain sweep;
the whole-sweep model within 5e-6 of JAX's interpret-mode kernel, the
bound tests/test_torch_kernels.py holds the plain sweep to.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import pallas_sym as jax_sym
from nbody_tpu_torch.init import make_state
from nbody_tpu_torch.ops import sym_kernel
from nbody_tpu_torch.types import G_NEWTON, SOFTENING_SQUARED
from nbody_tpu_torch.utils import build

from .test_torch_kernels import rsqrt_cube_emulated

F32 = np.float32
EPS2 = F32(SOFTENING_SQUARED)
G = F32(G_NEWTON)

# (B, R): the launched R = 2 at B = 64 and 128; R = 1, launched at B = 32
# and 96, modelled at B = 64 and 128 (the same map, more warps); R = 4 for
# the --sym-targets builds.
TILE_TARGETS = [(128, 1), (128, 2), (128, 4), (64, 1), (64, 2)]
INT32_MAX = 2**31 - 1


def fmaf(a, b, c):
    """fp32 fused multiply-add: the exact product of two fp32 values fits
    in float64, so one rounding of the float64 sum models it."""
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)
            ).astype(F32)


def tile_bodies(b, seed, zero=()):
    """(4, B) fp32 bodies (x, y, z, G m) in the unit cube, reference-scale
    masses; the bodies ``zero`` are zero-mass padding far away."""
    rng = np.random.default_rng(seed)
    body = np.empty((4, b), F32)
    body[:3] = rng.random((3, b), dtype=F32)
    body[3] = (F32(2000) * rng.random(b, dtype=F32)) * G
    for i in zero:
        body[:, i] = (F32(1e6 + i),) * 3 + (F32(0),)
    return body


def pair(bi, p):
    """The body's pair arithmetic for targets bi (4, M) against bodies p
    (4, M): the deltas, d2 = |d|^2 + eps^2 as three FMAs, and w, each fp32
    operation rounded."""
    d = p[:3] - bi[:3]
    d2 = fmaf(d[2], d[2], fmaf(d[1], d[1], fmaf(d[0], d[0], EPS2)))
    w = (bi[3] * p[3]) * rsqrt_cube_emulated(d2, 0)
    return d, w


def model_cross(bi, bj, r_targets, count=None):
    """(pi, pj), each (3, B): the i-side sums of tile ``bi`` and the j-side
    sums of tile ``bj`` as a CTA of B / R threads forms them; ``count``
    (B, B) records how often each (i, j) is evaluated."""
    b = bi.shape[1]
    nt = b // r_targets
    nwarps = nt // 32
    lanes = np.arange(32)
    a = np.zeros((3, b), F32)  # by target
    red = np.zeros((nwarps, 3, b), F32)
    for w in range(nwarps):
        for s in range(b // 32):
            acc = np.zeros((3, 32), F32)  # lane l: j = 32 s + (l + k) % 32
            for k in range(32):
                j = 32 * s + (lanes + k) % 32
                for r in range(r_targets):
                    i = 32 * w + lanes + r * nt
                    d, wt = pair(bi[:, i], bj[:, j])
                    a[:, i] = fmaf(wt, d, a[:, i])
                    acc = fmaf(-wt, d, acc)
                    if count is not None:
                        count[i, j] += 1
                acc = np.roll(acc, -1, axis=1)  # lane l takes lane l + 1's
            red[w, :, 32 * s:32 * s + 32] = acc
    pj = np.zeros((3, b), F32)
    for w in range(nwarps):  # warp order
        pj = pj + red[w]
    return a, pj


def model_diagonal(bi, r_targets, count=None):
    """The i-side sums of a diagonal tile: each thread's R targets read
    j = 0 .. B - 1 in order (a broadcast a step)."""
    b = bi.shape[1]
    nt = b // r_targets
    a = np.zeros((3, b), F32)
    for j in range(b):
        for r in range(r_targets):
            i = np.arange(nt) + r * nt  # target r of every thread
            d, wt = pair(bi[:, i], bi[:, [j]])
            a[:, i] = fmaf(wt, d, a[:, i])
            if count is not None:
                count[i, j] += 1
    return a


def plain_partials(bi, bj):
    """The plain version's partials of one tile pair: sum_j w d and
    -sum_i w d (``sym_kernel.pair_terms``)."""
    p = sym_kernel.pair_terms(*(torch.from_numpy(x) for x in
                                (bi[:3], bi[3], bj[:3], bj[3])))
    return p.sum(dim=2).numpy(), (-p.sum(dim=1)).numpy()


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("b,r", TILE_TARGETS)
def test_cross_tile_model_matches_plain(b, r):
    """One off-diagonal tile pair: each (i, j) once, both sides within
    1e-6 of the plain partials, zero-mass padding exactly 0 on both."""
    pad_i, pad_j = (b - 1, b - 7), (3, b - 2)
    bi = tile_bodies(b, 10 + b + r, zero=pad_i)
    bj = tile_bodies(b, 20 + b + r, zero=pad_j)
    count = np.zeros((b, b), int)
    pi, pj = model_cross(bi, bj, r, count)
    assert np.array_equal(count, np.ones((b, b), int))
    want_i, want_j = plain_partials(bi, bj)
    assert _rel(pi, want_i) <= 1e-6 and _rel(pj, want_j) <= 1e-6
    assert np.all(pi[:, list(pad_i)] == 0) and np.all(pj[:, list(pad_j)] == 0)
    # Each target adds its j in the same order whatever R: the i side is
    # the R = 1 body's bit for bit.
    if r > 1:
        assert np.array_equal(pi, model_cross(bi, bj, 1)[0])


@pytest.mark.parametrize("b,r", TILE_TARGETS)
def test_diagonal_tile_model_matches_plain(b, r):
    """A diagonal tile: every ordered pair once on its target's side (the
    self pair unmasked, d = 0 giving exactly 0), within 1e-6 of the plain
    partial, zero-mass padding exactly 0."""
    pad = (0, b // 2 + 1)
    bi = tile_bodies(b, 30 + b + r, zero=pad)
    count = np.zeros((b, b), int)
    pi = model_diagonal(bi, r, count)
    assert np.array_equal(count, np.ones((b, b), int))
    assert _rel(pi, plain_partials(bi, bi)[0]) <= 1e-6
    assert np.all(pi[:, list(pad)] == 0)


@pytest.mark.parametrize("n,b,r", [(256, 64, 2), (256, 128, 4)])
def test_sweep_model_matches_plain_and_jax(n, b, r):
    """The model's tiles in Kernel B's layout: P[it][jt] from the i side of
    (it, jt), P[jt][it] from its j side, each row added in column order and
    divided by G m.  Every unordered pair is evaluated once, and the forces
    agree with the plain sweep and with JAX's interpret-mode kernel."""
    st = make_state(n - 20, pad_multiple=b, device="cpu")
    pos, mass = st.pos.numpy(), st.mass.numpy()
    body = np.concatenate([pos, (mass * G)[None]]).astype(F32)
    t_count = n // b
    part = np.zeros((t_count, t_count, 3, b), F32)
    count = np.zeros((n, n), int)
    for it in range(t_count):
        bi = body[:, it * b:(it + 1) * b]
        ci = count[it * b:(it + 1) * b]
        part[it, it] = model_diagonal(bi, r, ci[:, it * b:(it + 1) * b])
        for jt in range(it + 1, t_count):
            c = np.zeros((b, b), int)
            part[it, jt], part[jt, it] = model_cross(
                bi, body[:, jt * b:(jt + 1) * b], r, c)
            ci[:, jt * b:(jt + 1) * b] += c
    assert np.array_equal(np.triu(count) + np.triu(count, 1).T,
                          np.ones((n, n), int))
    s = np.zeros((t_count, 3, b), F32)
    for u in range(t_count):
        s = s + part[:, u]
    s = s.transpose(1, 0, 2).reshape(3, n)
    gm = mass * G
    acc = np.where(gm > 0, s / np.where(gm > 0, gm, F32(1)), F32(0))
    plain = sym_kernel.accelerations_plain(st.pos, st.mass, b).numpy()
    assert _rel(acc, plain) <= 1e-6
    assert np.all(acc[:, n - 20:] == 0)
    ref = jax_sym.accelerations(jnp.asarray(pos), jnp.asarray(mass), block=b,
                                interpret=True)
    assert _rel(acc, ref) <= 5e-6


@pytest.mark.parametrize("ulps", [-2, 2])
def test_mass_folded_rsqrt_sweep_matches_ieee(ulps):
    """Kernels B, the two-sided sweep and the fused rows block take d2^{-3/2}
    as rsqrt and one Newton step in the mass-folded weight (G m_i)(G m_j)
    d2^{-3/2}: at the approximation's worst error the N=2000 reference-IC
    forces, a = sum_j w d / (G m_i), stay within 1e-6 of the IEEE plain
    sweep, and the padding to 2048 gets exactly 0."""
    st = make_state(2000, pad_multiple=128, device="cpu")
    pos, mass = st.pos.numpy(), st.mass.numpy()
    gm = mass * G
    d = pos[:, None, :] - pos[:, :, None]  # (3, targets, bodies)
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + EPS2
    w = (gm[:, None] * gm[None, :]) * rsqrt_cube_emulated(d2, ulps)
    s = (d * w).sum(axis=2)
    got = np.where(gm > 0, s / np.where(gm > 0, gm, F32(1)), F32(0))
    plain = sym_kernel.accelerations_plain(st.pos, st.mass).numpy()
    assert _rel(got[:, :2000], plain[:, :2000]) <= 1e-6
    assert np.all(got[:, 2000:] == 0) and np.all(plain[:, 2000:] == 0)


def tile_pair(q, t):
    """``nbt::tile_pair``: unordered tile pair q of T (T + 1) / 2 as
    (it, jt), it <= jt, in the kernel's 64-bit integers (Python's are
    exact here) and its float64 square root."""
    r = t * (t + 1) // 2 - 1 - q
    k = int((math.sqrt(8.0 * r + 1.0) - 1.0) * 0.5)
    while (k + 1) * (k + 2) // 2 <= r:
        k += 1
    while k * (k + 1) // 2 > r:
        k -= 1
    it = t - 1 - k
    return it, it + (r - k * (k + 1) // 2)


def row_start(it, t):
    """The first pair of tile row it, as Kernel B's band offset forms it:
    it T - it (it - 1) / 2."""
    return it * t - it * (it - 1) // 2


@pytest.mark.parametrize("t", [16, 46340, 46341, 65536, 200000])
def test_tile_pair_is_exact_past_32_bits(t):
    """Every row's first and last pair map back to (it, T - 1) and
    (it, it) at tile counts where T (T + 1) / 2 or its intermediates
    pass 2^31 (T >= 46341), and at a small T every pair maps once."""
    rows = sorted({0, 1, 2, t // 3, t // 2, t - 2, t - 1})
    for it in rows:
        assert tile_pair(row_start(it, t), t) == (it, t - 1)
        assert tile_pair(row_start(it, t) + t - 1 - it, t) == (it, it)
    if t >= 46341:
        assert t * (t + 1) > INT32_MAX  # 32-bit arithmetic would wrap
    if t == 16:
        pairs = [tile_pair(q, t) for q in range(t * (t + 1) // 2)]
        assert pairs == [(i, j) for i in range(t)
                         for j in range(t - 1, i - 1, -1)]


@pytest.mark.parametrize("n,block", [(46341 * 128, 128), (70000 * 32, 32)])
def test_sym_band_keeps_a_band_within_the_grid(n, block):
    """A Kernel B band's tile pairs are its 1-D grid's x extent: sym_band
    keeps them within 2^31 - 1 whatever the budget."""
    t = n // block
    band = sym_kernel.sym_band(n, block, 1 << 62)
    assert band == min(t, sym_kernel.MAX_GRID // t)
    first = band * t - (band - 1) * band // 2  # the first band has the most
    assert first <= INT32_MAX


def test_lane_targets_is_the_kernels_rule():
    """sym_kernel.lane_targets names the R that nbt::sym_targets launches:
    kMaxSymTargets as csrc/common.cuh declares it, 2 at every block of the
    wrappers that is a multiple of 64 and 1 at the others."""
    common = (build.CSRC_DIR / "common.cuh").read_text()
    cap = re.search(r"constexpr int kMaxSymTargets = (\d+);", common)
    assert cap and int(cap.group(1)) == sym_kernel.MAX_TARGETS
    assert [sym_kernel.lane_targets(b) for b in range(32, 257, 32)] == [
        1, 2, 1, 2, 1, 2, 1, 2]
    assert [sym_kernel.lane_targets(b, 4) for b in (32, 64, 96, 128, 256)] == [
        1, 2, 1, 4, 4]

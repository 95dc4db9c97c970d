"""The port's ``--kernel pallas_mxu`` against the JAX package's.

On the CPU the mxu wrapper runs its plain version, so these tests hold the
plain |r|^2-expansion sweep against ``pallas_mxu.accelerations(interpret=
True)``, against naive and against a float64 sweep; the sharded ``ring``
block through the mxu between form against JAX's on the 8-device CPU mesh
(``tests/test_cli_matrix.py:74-92``); the bf16 refusal; the tiles reaching
``kernel_opts``; and ``make_accel_fn("pallas_mxu", differentiable=True)``
gradients against JAX's.  Inputs are made by numpy from a seed and fed to
both packages.  The CUDA kernel itself is held against the plain version on
a card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: the expansion's epilogue a = m[0:3] - r m[3] cancels, so the
rounding of the fp32 sums m shows in a.  JAX's interpret-mode kernel is
itself more than 1e-5 (relative norm) from float64 at N = 256-512 (the
first test asserts it), so two fp32 implementations that round
differently agree to 5e-5, not to fp32 summation error; the field against naive and float64 is held to the JAX
package's bound for this kernel, 1e-4 (tests/test_kernels.py:133-143).
The sharded block takes tests/test_cli_matrix.py's tolerances (pos rtol
1e-4, atol 1e-7; kinetic energy 1e-3); the gradients 1e-4, JAX's bound
between the analytic VJP and autograd (tests/test_torch_grad.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models.gravity import make_accel_fn as jax_accel
from nbody_tpu.ops import pallas_mxu as jax_mxu
from nbody_tpu.parallel.decompose import make_sharded_block_fn as jax_block_fn
from nbody_tpu.parallel.decompose import shard_state as jax_shard_state
from nbody_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nbody_tpu.state import ParticleState as JaxState
from nbody_tpu_torch import SimConfig, run
from nbody_tpu_torch.init import make_state
from nbody_tpu_torch.models.gravity import make_accel_fn, make_block_fn
from nbody_tpu_torch.ops import mxu_kernel, naive, registry
from nbody_tpu_torch.parallel import make_mesh
from nbody_tpu_torch.parallel.decompose import (
    make_sharded_block_fn,
    shard_state,
    unshard_state,
)
from nbody_tpu_torch.state import from_numpy
from nbody_tpu_torch.types import G_NEWTON, SOFTENING_SQUARED

from .test_torch_kernels import rsqrt_cube_emulated

torch.set_num_threads(2)

CPU = torch.device("cpu")
SCALE = 1e20  # brings a^2 of reference-scale masses into fp32 range


def _system(n, seed):
    """Positions in the unit cube and reference-scale masses, numpy fp32."""
    rng = np.random.default_rng(seed)
    pos = rng.random((3, n), dtype=np.float32)
    mass = (np.float32(n) * rng.random(n, dtype=np.float32)).astype(np.float32)
    return pos, mass


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind,n", [("random", 512), ("reference", 512),
                                    ("random", 256)])
def test_plain_mxu_matches_pallas_mxu_interpret(kind, n):
    if kind == "random":
        pos, mass = _system(n, n)
    else:
        st = make_state(n, device="cpu")
        pos, mass = st.pos.numpy(), st.mass.numpy()
    ref = jax_mxu.accelerations(jnp.asarray(pos), jnp.asarray(mass),
                                tile_i=128, tile_j=128, interpret=True)
    plain = mxu_kernel.accelerations_between_plain(_t(pos), _t(pos), _t(mass))
    # The wrapper on CPU tensors is the plain version, and launches nothing.
    before = mxu_kernel.launches
    wrapped = mxu_kernel.accelerations(_t(pos), _t(mass), tile_i=64,
                                       tile_j=256)
    assert mxu_kernel.launches == before
    assert torch.equal(wrapped, plain)
    assert plain.shape == (3, n) and plain.dtype == torch.float32
    assert _rel(plain.numpy(), ref) <= 5e-5
    f64 = naive.accelerations(_t(pos).double(), _t(mass).double())
    assert _rel(plain.numpy(), naive.accelerations(_t(pos), _t(mass))) < 1e-4
    assert _rel(plain.numpy(), f64) < 1e-4
    # Why the bound above is not fp32 summation error: JAX's kernel is
    # itself this far from float64 on these inputs.
    assert 1e-5 < _rel(ref, f64) < 1e-4


def _tf32(x):
    """fp32 rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 and csrc/mxu.cu's tf32_rna."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _cut(x):
    """fp32 cut to tf32 (the low 13 bits dropped): how the tensor core
    reads an fp32 operand, and csrc/mxu.cu's w_hi."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _chop(x):
    """float64 to fp32 toward zero: a model of one mma's sum (exact
    products, no round-to-nearest on the adds)."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _split3(x):
    """x as three tf32 parts that sum to it exactly."""
    hi = _tf32(x)
    mid = _tf32(x - hi)
    return [p.astype(np.float64) for p in (hi, mid, _tf32(x - hi - mid))]


def _rsqrt_approx_emulated(d2, ulps: int) -> np.ndarray:
    """``nbt::rsqrt_approx`` (csrc/common.cuh) on the CPU: the correctly
    rounded 1/sqrt taken ``ulps`` units in the last place off (CUDA
    documents at most 2)."""
    y = (1.0 / np.sqrt(np.asarray(d2, np.float64))).astype(np.float32)
    return (y.view(np.int32) + np.int32(ulps)).view(np.float32)


def _mxu_emulated(pt, ps, mass, first="fp32", newton=False, ulps=2):
    """csrc/mxu.cu's arithmetic on the CPU.  ``first``: where d2 comes from:
    "fp32" as the kernel takes it (the five nonzero augmented terms in k
    order, each fp32 operation rounded, as the plain version); "tf32x3" the
    first product as one 3xTF32 tensor-core sum (a_hi b_hi + a_hi b_lo +
    a_lo b_hi); "tf32x3way" a three-way split in three chained mmas, d2
    within an ulp of exact.  Then the clamp, w = G m y^3 with y the SFU's
    rsqrt ``ulps`` off (``newton``: refined as Kernel A's rsqrt_cube), and
    m = w P as the kernel sums it: w_hi = w cut to tf32, w_lo = w - w_hi (of
    which the tensor core reads the cut), per k-step of 8 sources the mmas
    w_lo [P_hi | P_lo] and w_hi [P_hi | P_lo] into an accumulator each,
    which every 64 sources go, added, into a sum of 16 chunks, and that
    into the running m; then a = m[0:3] - r m[3]."""
    f32 = np.float32
    r2s = (ps[0] * ps[0] + ps[1] * ps[1]) + ps[2] * ps[2]
    r2t = (pt[0] * pt[0] + pt[1] * pt[1]) + pt[2] * pt[2]
    b = [f32(-2) * pt[0], f32(-2) * pt[1], f32(-2) * pt[2],
         np.ones_like(r2t), r2t + f32(SOFTENING_SQUARED)]
    a = [ps[0], ps[1], ps[2], r2s, np.ones_like(r2s)]
    if first == "fp32":
        d2 = b[0][:, None] * a[0][None, :]
        for k in range(1, 5):
            d2 = d2 + b[k][:, None] * a[k][None, :]
    elif first == "tf32x3":
        hi_b, hi_a = [_tf32(v) for v in b], [_tf32(v) for v in a]
        lo_b = [_tf32(v - h) for v, h in zip(b, hi_b)]
        lo_a = [_tf32(v - h) for v, h in zip(a, hi_a)]

        def dot(u, v):
            return sum(np.outer(x.astype(np.float64), y.astype(np.float64))
                       for x, y in zip(u, v))

        d2 = _chop(dot(hi_b, lo_a))
        d2 = _chop(d2 + dot(lo_b, hi_a))
        d2 = _chop(d2 + dot(hi_b, hi_a))
    else:
        sb, sa = [_split3(v) for v in b[:3]], [_split3(v) for v in a[:3]]
        r2, b4 = _split3(r2s), _split3(b[4])
        terms = []
        for q, pairs in ((2, ((0, 2), (2, 0))),
                         (1, ((0, 1), (1, 0), (1, 1))),
                         (0, ((0, 0),))):
            terms.append(sum(np.outer(sb[k][i], sa[k][j]) for k in range(3)
                             for i, j in pairs) + r2[q][None, :]
                         + b4[q][:, None])
        d2 = _chop(terms[0])
        d2 = _chop(d2 + terms[1])
        d2 = _chop(d2 + terms[2])
    d2 = np.maximum(d2, f32(SOFTENING_SQUARED))
    if newton:
        cube = rsqrt_cube_emulated(d2, ulps)
    else:
        y = _rsqrt_approx_emulated(d2, ulps)
        cube = (y * y) * y
    w = (mass * f32(G_NEWTON))[None, :] * cube
    p = np.stack([ps[0], ps[1], ps[2], np.ones_like(r2s)], axis=1)
    p_hi = _tf32(p)
    bmat = np.concatenate([p_hi, _tf32(p - p_hi)], axis=1).astype(np.float64)
    w_hi = _cut(w)
    w_lo = _cut(w - w_hi).astype(np.float64)
    w_hi = w_hi.astype(np.float64)
    ns, nt = ps.shape[1], pt.shape[1]
    run = np.zeros((nt, 8), f32)
    group = np.zeros((nt, 8), f32)
    for chunk, j0 in enumerate(range(0, ns, 64)):
        c_lo = np.zeros((nt, 8), f32)
        c_hi = np.zeros((nt, 8), f32)
        for k0 in range(j0, min(j0 + 64, ns), 8):
            ks = slice(k0, min(k0 + 8, ns))
            c_lo = _chop(c_lo + w_lo[:, ks] @ bmat[ks])
            c_hi = _chop(c_hi + w_hi[:, ks] @ bmat[ks])
        group += c_lo + c_hi
        if chunk % 16 == 15:
            run += group
            group[:] = 0
    run += group
    m = (run[:, :4] + run[:, 4:]).T
    return m[0:3] - pt * m[3:4]


def _mxu_case(case):
    """(targets, sources, masses) of a named shape, numpy fp32."""
    if case.startswith("random"):
        pos, mass = _system(int(case.split()[1]), 5)
        return pos, pos, mass
    st = make_state(2048 if case == "reference 2048" else 2000, device="cpu")
    pos, mass = st.pos.numpy(), st.mass.numpy()
    if case == "500 x 2000":
        return pos[:, 1000:1500], pos, mass
    if case == "500 x 500":
        return pos[:, 1000:1500], pos[:, :500], mass[:500]
    return pos, pos, mass


@pytest.mark.parametrize("case", ["reference 2048", "random 2048",
                                  "reference 2000", "500 x 2000",
                                  "500 x 500"])
def test_tensor_core_split_matches_plain(case):
    """The kernel's split (d2 in fp32, m = w P as 3xTF32 mmas) within 1e-5
    of the fp32 plain version, and within 1e-4 of float64 and of the JAX
    package's interpret-mode kernel."""
    pt, ps, mass = (np.ascontiguousarray(a) for a in _mxu_case(case))
    got = _mxu_emulated(pt, ps, mass)
    plain = mxu_kernel.accelerations_between_plain(_t(pt), _t(ps), _t(mass))
    f64 = naive.accelerations_between(_t(pt).double(), _t(ps).double(),
                                      _t(mass).double())
    assert got.dtype == np.float32 and got.shape == (3, pt.shape[1])
    assert _rel(got, plain.numpy()) <= 1e-5
    assert _rel(got, f64) < 1e-4
    if pt is ps:
        ref = jax_mxu.accelerations(jnp.asarray(pt), jnp.asarray(mass),
                                    tile_i=2048, tile_j=2048, interpret=True)
        assert _rel(got, ref) < 1e-4


@pytest.mark.parametrize("first,case", [("tf32x3", "reference 2000"),
                                        ("tf32x3way", "500 x 500")])
def test_first_product_on_tensor_cores_misses_the_gate(first, case):
    """Why csrc/mxu.cu keeps d2 on the FP32 pipes: the plain version's d2
    rounds |r|^2-sized terms, so a d2 that rounds otherwise, even one within
    an ulp of exact, is more than 1e-5 from the plain version at a shape
    the card's gates hold, though closer to float64."""
    pt, ps, mass = (np.ascontiguousarray(a) for a in _mxu_case(case))
    got = _mxu_emulated(pt, ps, mass, first=first)
    plain = mxu_kernel.accelerations_between_plain(_t(pt), _t(ps), _t(mass))
    f64 = naive.accelerations_between(_t(pt).double(), _t(ps).double(),
                                      _t(mass).double())
    assert _rel(got, plain.numpy()) > 1e-5
    assert _rel(got, f64) < 1e-4


@pytest.mark.parametrize("ulps", [-2, 2])
def test_mxu_rsqrt_needs_no_newton_step(ulps):
    """The mxu kernel takes the SFU's rsqrt without Kernel A's Newton step:
    at the approximation's worst error its forces move by under 5e-6
    (relative norm; the epilogue's cancellation magnifies w's few ulp) from
    those with the step, and stay within 1e-5 of the plain version."""
    pt, ps, mass = _mxu_case("reference 2000")
    raw = _mxu_emulated(pt, ps, mass, ulps=ulps)
    refined = _mxu_emulated(pt, ps, mass, newton=True, ulps=ulps)
    plain = mxu_kernel.accelerations_between_plain(_t(pt), _t(ps), _t(mass))
    assert 0 < _rel(raw, refined) < 5e-6
    assert _rel(raw, plain.numpy()) <= 1e-5


def test_plain_mxu_ragged_and_padding():
    # Targets x sources of other counts, and zero-mass padding far away:
    # padded sources have w = 0 (the plain sums may group the terms
    # otherwise, so the real targets agree to fp32 summation error; on the
    # card the kernel's are equal bit for bit), and a padded target's
    # (meaningless) acceleration stays finite, as in the JAX package.
    pos, mass = _system(200, 3)
    far = np.tile(1.0e6 + np.arange(56, dtype=np.float32), (3, 1))
    pos_p = np.concatenate([pos, far], axis=1)
    mass_p = np.concatenate([mass, np.zeros(56, np.float32)])
    a = mxu_kernel.accelerations(_t(pos_p), _t(mass_p))
    unpadded = mxu_kernel.accelerations(_t(pos), _t(mass))
    assert _rel(a[:, :200].numpy(), unpadded.numpy()) <= 1e-6
    assert torch.isfinite(a).all()
    pt, _ = _system(77, 4)
    between = mxu_kernel.accelerations_between(_t(pt), _t(pos), _t(mass))
    ref = naive.accelerations_between(_t(pt).double(), _t(pos).double(),
                                      _t(mass).double())
    assert between.shape == (3, 77) and _rel(between.numpy(), ref) < 1e-4


def test_mxu_refuses_bf16():
    # tests/test_cli.py:101-110, in the kernel and in the configuration.
    pos = torch.zeros(3, 128)
    mass = torch.ones(128)
    with pytest.raises(ValueError, match="fp32 distances"):
        mxu_kernel.accelerations(pos, mass, dist_dtype="bfloat16")
    with pytest.raises(ValueError, match="fp32 distances"):
        SimConfig(kernel="pallas_mxu", precision="bf16")


def test_mxu_tiles_reach_kernel_opts_and_registry():
    # tests/test_cli.py:65-66: tiles reach every pallas-family kernel.
    assert SimConfig(kernel="pallas_mxu", tile_i=128).kernel_opts() == {
        "tile_i": 128}
    assert SimConfig(kernel="pallas_mxu", tile_i=64,
                     tile_j=512).kernel_opts() == {"tile_i": 64, "tile_j": 512}
    # The kernel's rule: 16 targets a warp of 8, k-steps of 8 sources.
    assert mxu_kernel.check_tiles(0, 0) == (mxu_kernel.DEFAULT_TILE_I,
                                            mxu_kernel.DEFAULT_TILE_J)
    assert mxu_kernel.check_tiles(128, 8) == (128, 8)
    assert mxu_kernel.check_tiles(16, 64) == (16, 64)
    for tiles, what in (((256, 8), "tile_i"), ((48, 512), "tile_i"),
                        ((16, 32), "tile_j"), ((64, 4096), "tile_j")):
        with pytest.raises(ValueError, match=what):
            mxu_kernel.check_tiles(*tiles)
    # The kernel masks its ragged tiles, so no padding, unlike the JAX
    # package's lcm of the tiles.
    assert SimConfig(n=2000, kernel="pallas_mxu").pad_multiple() == 1
    assert SimConfig(kernel="pallas_mxu", shards=4).pad_multiple() == 4
    assert registry.get("pallas_mxu") is mxu_kernel.accelerations
    assert registry.get_between("pallas_mxu") is mxu_kernel.accelerations_between
    assert registry.resolve("auto", "cuda") != "pallas_mxu"


def test_mxu_run_on_cpu_is_finite_and_near_naive():
    res = run(SimConfig(n=256, nsteps=100, kernel="pallas_mxu",
                        platform="cpu"), quiet=True)
    ref = run(SimConfig(n=256, nsteps=100, kernel="naive", platform="cpu"),
              quiet=True)
    for (s, ke), (s2, ke2) in zip(res.kenergy_trace, ref.kenergy_trace):
        assert s == s2 and abs(ke - ke2) <= 1e-4 * abs(ke2)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_sharded_ring_mxu_matches_jax(integrator):
    """The mxu between form through the sharded ring, as
    tests/test_cli_matrix.py:74-92 runs JAX's."""
    k, n, steps = 8, 256, 3
    rng = np.random.default_rng(21)
    pos = rng.random((3, n), dtype=np.float32)
    vel = ((rng.random((3, n), dtype=np.float32) - 0.5) * 2e-3).astype(np.float32)
    mass = (np.float32(n) * rng.random(n, dtype=np.float32)).astype(np.float32)
    jst = JaxState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                   mass=jnp.asarray(mass), n=n)
    jsharded, jmesh = jax_shard_state(jst, k, mesh=jax_make_mesh(k))
    jopts = dict(tile_i=16, tile_j=32, interpret=True)
    j_out, j_ke = jax_block_fn("pallas_mxu", jopts, 0.1, steps, jmesh,
                               comm="ring", integrator=integrator)(jsharded)
    st = from_numpy(pos, vel, mass, n, device="cpu")
    sharded, mesh = shard_state(st, k, make_mesh(k, [CPU] * k))
    out, ke = make_sharded_block_fn("pallas_mxu", {}, 0.1, steps, mesh,
                                    comm="ring", integrator=integrator)(sharded)
    whole = unshard_state(out)
    np.testing.assert_allclose(whole.pos.numpy(), np.asarray(j_out.pos),
                               rtol=1e-4, atol=1e-7)
    assert float(ke) == pytest.approx(float(j_ke), rel=1e-3)
    ref, ke_ref = make_block_fn(make_accel_fn("naive"), 0.1, steps,
                                integrator=integrator)(st)
    np.testing.assert_allclose(whole.pos.numpy(), ref.pos.numpy(),
                               rtol=1e-4, atol=1e-7)
    assert float(ke) == pytest.approx(float(ke_ref), rel=1e-3)


def test_differentiable_mxu_matches_jax():
    pos, mass = _system(256, 9)
    p, m = _t(pos).requires_grad_(True), _t(mass).requires_grad_(True)
    accel = make_accel_fn("pallas_mxu", differentiable=True)
    a = accel(p, m)
    ((a * a).sum() * SCALE).backward()
    assert torch.equal(a.detach(), mxu_kernel.accelerations(_t(pos), _t(mass)))

    def jloss(pos, mass):
        acc = jax_accel("pallas_mxu", differentiable=True, tile_i=128,
                        tile_j=128, interpret=True)(pos, mass)
        return jnp.sum(acc * acc) * jnp.float32(SCALE)

    jax_g = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(pos), jnp.asarray(mass))
    for ours, theirs in zip((p.grad, m.grad), jax_g):
        assert _rel(ours.numpy(), theirs) <= 1e-4

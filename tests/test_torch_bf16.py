"""The port's bf16 distance mode (``--precision bf16``) against the JAX
package's.

Each pair delta is subtracted in f32, rounded to nearest even through bf16,
and the rounded delta feeds both |d|^2 and the force sum, in f32.  On the
CPU the wrappers run their plain versions, so these tests hold naive and the
plain tiled, pair-symmetric and two-sided sweeps in bf16 against JAX's
naive and its ``interpret=True`` kernels, check that the rounded deltas
equal JAX's bit for bit, that momentum is conserved, that a bf16 run stays
near the f32 run, that the sharded modes pass the mode to their kernels,
and that every configuration without a bf16 kernel refuses the mode.
Inputs are made by numpy from a seed and fed to both packages.  The CUDA
kernels in bf16 are held against these plain versions on
a card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances (tests/test_kernels.py:76-130): against float64, 5e-3 relative
norm (bf16 deltas keep about 2.4 decimal digits); between two sweeps with
the same rounded per-pair geometry, the fp32 summation bound of the f32
tests, 5e-6 for the kernels and 1e-6 for naive.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models.gravity import make_accel_fn as jax_accel
from nbody_tpu.models.gravity import make_block_fn as jax_block
from nbody_tpu.ops import naive as jax_naive
from nbody_tpu.ops import pallas_kernel as jax_pallas
from nbody_tpu.ops import pallas_sym as jax_sym
from nbody_tpu.state import ParticleState as JaxState
from nbody_tpu_torch import SimConfig, run
from nbody_tpu_torch.models.gravity import make_accel_fn, make_block_fn
from nbody_tpu_torch.ops import naive, registry, sym_kernel, tiled_kernel
from nbody_tpu_torch.parallel import make_mesh
from nbody_tpu_torch.parallel.decompose import (
    make_sharded_block_fn,
    shard_state,
    unshard_state,
)
from nbody_tpu_torch.state import from_numpy

torch.set_num_threads(2)

BF16 = "bfloat16"
CPU = torch.device("cpu")


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


def _f64(pos, mass):
    return naive.accelerations(_t(pos).double(), _t(mass).double()).numpy()


def test_rounded_deltas_equal_jax_bit_for_bit():
    pos, _ = _system(512, 0)
    d = pos[:, None, :] - pos[:, :64, None]  # f32 deltas, ties included
    ties = np.float32(1.0) + np.float32(2.0 ** -8) * np.arange(8, dtype=np.float32)
    for x in (d.ravel(), ties, -ties):
        ours = tiled_kernel.round_deltas(_t(x), True).numpy()
        theirs = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        assert np.array_equal(ours.view(np.uint32), theirs.view(np.uint32))
    assert torch.equal(tiled_kernel.round_deltas(_t(d), False), _t(d))


@pytest.mark.parametrize("nt,ns,seed", [(256, 256, 1), (200, 333, 2)])
def test_naive_bf16_matches_jax(nt, ns, seed):
    pt, _ = _system(nt, seed)
    ps, ms = _system(ns, seed + 100)
    ours = naive.accelerations_between(_t(pt), _t(ps), _t(ms), chunk=64,
                                       dist_dtype=BF16)
    ref = jax_naive.accelerations_between(jnp.asarray(pt), jnp.asarray(ps),
                                          jnp.asarray(ms), dist_dtype=BF16)
    assert _rel(ours.numpy(), ref) <= 1e-6
    # bf16 changes the field: the f32 result is not the bf16 one.
    assert not torch.equal(ours, naive.accelerations_between(
        _t(pt), _t(ps), _t(ms), chunk=64))


def test_tiled_bf16_matches_pallas_interpret():
    pos, mass = _system(512, 3)
    ref = jax_pallas.accelerations(jnp.asarray(pos), jnp.asarray(mass),
                                   tile_i=128, tile_j=128, dist_dtype=BF16,
                                   interpret=True)
    plain = tiled_kernel.accelerations_between_plain(
        _t(pos), _t(pos), _t(mass), dist_dtype=BF16)
    wrapped = tiled_kernel.accelerations(_t(pos), _t(mass), dist_dtype=BF16)
    assert torch.equal(wrapped, plain)
    assert _rel(plain.numpy(), ref) <= 5e-6
    assert _rel(plain.numpy(), _f64(pos, mass)) < 5e-3


@pytest.mark.parametrize("n", [256, 512])
def test_sym_bf16_matches_pallas_sym_interpret(n):
    pos, mass = _system(n, 10 + n)
    ref = jax_sym.accelerations(jnp.asarray(pos), jnp.asarray(mass),
                                block=128, dist_dtype=BF16, interpret=True)
    plain = sym_kernel.accelerations_plain(_t(pos), _t(mass), block=128,
                                           dist_dtype=BF16)
    wrapped = sym_kernel.accelerations(_t(pos), _t(mass), block=128,
                                       dist_dtype=BF16)
    assert torch.equal(wrapped, plain)
    assert _rel(plain.numpy(), ref) <= 5e-6
    assert _rel(plain.numpy(), _f64(pos, mass)) < 5e-3
    # Momentum conservation survives the rounding (tests/test_kernels.py:
    # 110-114): rounding commutes with negation, so F_ji = -F_ij exactly.
    acc = plain.numpy().astype(np.float64) * mass.astype(np.float64)
    assert np.abs(acc.sum(1)).max() < 1e-3 * np.abs(acc).sum(1).max()


def test_two_sided_bf16_matches_pallas_interpret():
    pos, mass = _system(512, 4)
    pt, mt, ps, ms = pos[:, :256], mass[:256], pos[:, 256:], mass[256:]
    ref_t, ref_s = jax_sym.accelerations_two_sided(
        *(jnp.asarray(a) for a in (pt, mt, ps, ms)), block=128,
        dist_dtype=BF16, interpret=True)
    got_t, got_s = sym_kernel.accelerations_two_sided(
        *(_t(a) for a in (pt, mt, ps, ms)), block=128, dist_dtype=BF16)
    assert _rel(got_t.numpy(), ref_t) <= 5e-6
    assert _rel(got_s.numpy(), ref_s) <= 5e-6
    # Both sides carry the streaming sweep's bf16 geometry.
    want_t = naive.accelerations_between(_t(pt), _t(ps), _t(ms), dist_dtype=BF16)
    want_s = naive.accelerations_between(_t(ps), _t(pt), _t(mt), dist_dtype=BF16)
    assert _rel(got_t.numpy(), want_t.numpy()) <= 5e-6
    assert _rel(got_s.numpy(), want_s.numpy()) <= 5e-6


@pytest.mark.parametrize("kernel", ["naive", "pallas", "pallas_sym", "auto"])
def test_bf16_block_matches_jax(kernel):
    """A 5-step Euler block in bf16 against JAX's naive bf16 block."""
    rng = np.random.default_rng(7)
    n = 256
    pos = rng.random((3, n), dtype=np.float32)
    vel = ((rng.random((3, n), dtype=np.float32) - 0.5) * 2e-3).astype(np.float32)
    mass = (np.float32(n) * rng.random(n, dtype=np.float32)).astype(np.float32)
    jst = JaxState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                   mass=jnp.asarray(mass), n=n)
    j_new, j_ke = jax_block(jax_accel("naive", dist_dtype=BF16), 0.1, 5)(jst)
    opts = dict(dist_dtype=BF16, **({"tile_i": 128} if kernel == "pallas_sym"
                                    else {}))
    st = from_numpy(pos, vel, mass, n, device="cpu")
    new, ke = make_block_fn(make_accel_fn(kernel, **opts), 0.1, 5)(st)
    np.testing.assert_allclose(new.pos.numpy(), np.asarray(j_new.pos),
                               rtol=1e-5, atol=1e-7)
    assert float(ke) == pytest.approx(float(j_ke), rel=1e-5)


@pytest.mark.parametrize("kernel", ["pallas", "pallas_sym"])
def test_bf16_run_stays_near_f32(kernel):
    # BASELINE.md's gate for the mode: every KE row within 1e-4 of fp32.
    kw = dict(n=256, nsteps=100, kernel=kernel, tile_i=128, platform="cpu")
    res = run(SimConfig(precision="bf16", **kw), quiet=True)
    ref = run(SimConfig(**kw), quiet=True)
    assert [s for s, _ in res.kenergy_trace] == [50, 100]
    for (_, ke), (_, ke32) in zip(res.kenergy_trace, ref.kenergy_trace):
        assert ke != ke32 and abs(ke - ke32) <= 1e-4 * abs(ke32)


@pytest.mark.parametrize("comm", ["allgather", "ring", "ring_sym"])
def test_bf16_sharded_between_modes_pass_the_mode(comm):
    # allgather and ring pass the mode to the between form; ring_sym to
    # Kernel B on each shard and to the two-sided sweep of each shard pair.
    pos, mass = _system(256, 8)
    vel = np.zeros_like(pos)
    st = from_numpy(pos, vel, mass, 256, device="cpu")
    sharded, mesh = shard_state(st, 4, make_mesh(4, [CPU] * 4))
    out, _ = make_sharded_block_fn("pallas", {"dist_dtype": BF16}, 0.1, 1,
                                   mesh, comm=comm)(sharded)
    want, _ = make_block_fn(make_accel_fn("naive", dist_dtype=BF16), 0.1, 1)(st)
    np.testing.assert_allclose(unshard_state(out).vel.numpy(),
                               want.vel.numpy(), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("kw,match", [
    (dict(fused=True), "f32"),
    (dict(kernel="pm"), "fp32-only"),
    (dict(kernel="p3m"), "fp32-only"),
    (dict(kernel="pallas_mxu"), "fp32 distances"),
    (dict(shards=3, comm="rdma"), "--comm rdma runs fp32"),
    (dict(shards=4, comm="rdma"), "--comm rdma runs fp32"),
])
def test_bf16_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        SimConfig(precision="bf16", **kw)


@pytest.mark.parametrize("kernel", ["pallas_sym", "pallas"])
def test_bf16_refused_by_the_sharded_pair_kernels(kernel):
    # The JAX package's rdma drops dist_dtype and runs fp32; the port's
    # ring kernel has no bf16 mode, and rdma refuses it where the block is
    # built, too, whatever the kernel name.
    mesh = make_mesh(4, [CPU] * 4)
    with pytest.raises(ValueError, match="--comm rdma runs fp32"):
        make_sharded_block_fn(kernel, {"dist_dtype": BF16}, 0.1, 1,
                              mesh, comm="rdma")


def test_bf16_ring_sym_runs_both_kernels_in_the_mode():
    # ring_sym in bf16 launches Kernel B and the two-sided sweep with the
    # rounded deltas (their plain versions here): a step differs from the
    # f32 step and equals the bf16 pair-symmetric sweep on the whole state
    # to the fp32 summation bound.
    pos, mass = _system(512, 9)
    st = from_numpy(pos, np.zeros_like(pos), mass, 512, device="cpu")
    sharded, mesh = shard_state(st, 4, make_mesh(4, [CPU] * 4))
    vel = {}
    for dist in ("float32", BF16):
        out, _ = make_sharded_block_fn("pallas_sym", {"dist_dtype": dist,
                                                      "tile_i": 64},
                                       1.0, 1, mesh, comm="ring_sym")(sharded)
        vel[dist] = unshard_state(out).vel
    want = sym_kernel.accelerations(_t(pos), _t(mass), block=64,
                                    dist_dtype=BF16)
    assert not torch.equal(vel[BF16], vel["float32"])
    assert _rel(vel[BF16].numpy(), want.numpy()) <= 5e-6


def test_bf16_accepted_where_a_kernel_takes_it():
    for kw in (dict(), dict(kernel="pallas"), dict(kernel="pallas_sym"),
               dict(kernel="naive"), dict(shards=4, comm="allgather"),
               dict(shards=4, comm="ring"), dict(shards=4, comm="ring_sym")):
        cfg = SimConfig(precision="bf16", **kw)
        assert cfg.kernel_opts()["dist_dtype"] == BF16
    assert "dist_dtype" not in SimConfig().kernel_opts()
    with pytest.raises(ValueError, match="unknown dist_dtype"):
        registry.get("pallas")(torch.zeros(3, 8), torch.ones(8),
                               dist_dtype="float16")

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

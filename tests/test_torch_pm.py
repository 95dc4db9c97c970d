"""The port's particle-mesh tier (``nbody_tpu_torch.ops.pm``, open boundary)
against the JAX package's (``nbody_tpu.ops.pm``), on the CPU.

Inputs are the bit-equal distributions of both packages (or numpy from a
seed) and go through both functions.  Tolerances:

* ``_taper`` and ``_cic_weights``: exact (the same fp32 operations).
* ``_robust_box``: ``torch.nanquantile`` and JAX's ``nanpercentile`` round
  their interpolation differently, by at most one ulp.
* deposit and gather: 1e-6 relative norm (fp32 sums in other orders).
* PM accelerations: 1e-4 relative norm; the port transforms with
  ``rfftn``/``irfftn`` where JAX uses full-complex ``fftn``/``ifftn``.
* the native gradient of plain PM: rtol 1e-4 against ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import pm as jax_pm
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.init import make_state
from nbody_tpu_torch.models import distributions
from nbody_tpu_torch.models.gravity import make_accel_fn
from nbody_tpu_torch.ops import pm, registry

torch.set_num_threads(2)

# The JAX solves, jitted: one compile instead of hundreds of eager ones.
_jax_acc = jax.jit(jax_pm.accelerations, static_argnames=("grid",))


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _plummer(n, seed):
    pos, _, mass = distributions.plummer(n, seed=seed)
    return pos, mass


def test_taper_and_cic_weights_exact():
    q = np.linspace(-0.5, 1.5, 1001, dtype=np.float32)
    np.testing.assert_array_equal(pm._taper(_t(q)).numpy(),
                                  np.asarray(jax_pm._taper(jnp.asarray(q))))
    rng = np.random.default_rng(0)
    pos = (rng.random((3, 777), dtype=np.float32) * 3 - 1).astype(np.float32)
    pos[:, :5] = 1e6  # far padding: clipped in float before the cast
    lo = np.array([[-0.9], [-1.0], [-0.8]], np.float32)
    inv_h = np.array([[9.5], [10.0], [11.25]], np.float32)
    for ng in (16, 32):
        i0, fr = pm._cic_weights(_t(pos), _t(lo), _t(inv_h), ng)
        j0, jf = jax_pm._cic_weights(jnp.asarray(pos), jnp.asarray(lo),
                                     jnp.asarray(inv_h), ng)
        np.testing.assert_array_equal(i0.numpy(), np.asarray(j0))
        np.testing.assert_array_equal(fr.numpy(), np.asarray(jf))


@pytest.mark.parametrize("n,seed,pad", [(2048, 1, 0), (300, 4, 84),
                                        (70000, 2, 0)])
def test_robust_box_within_one_ulp(n, seed, pad):
    pos, mass = _plummer(n, seed)
    if pad:  # zero-mass padding on the far diagonal is left out of the box
        pos = np.concatenate([pos, np.full((3, pad), 1e6, np.float32)], 1)
        mass = np.concatenate([mass, np.zeros(pad, np.float32)])
    lo, hi = pm._robust_box(_t(pos), _t(mass))
    jlo, jhi = jax_pm._robust_box(jnp.asarray(pos), jnp.asarray(mass))
    for got, want in ((lo, jlo), (hi, jhi)):
        got = got.numpy().view(np.int32).astype(np.int64)
        want = np.asarray(want).view(np.int32).astype(np.int64)
        assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("ng", [16, 64])
def test_deposit_and_gather_match_jax(ng):
    pos, mass = _plummer(1500, 3)
    lo = pos.min(axis=1, keepdims=True) - 0.1
    span = pos.max(axis=1, keepdims=True) + 0.1 - lo
    inv_h = ((ng - 3) / span).astype(np.float32)
    args = (lo.astype(np.float32), inv_h)
    rho = pm._deposit(_t(pos), _t(mass), *map(_t, args), ng)
    jrho = jax_pm._deposit(jnp.asarray(pos), jnp.asarray(mass),
                           *map(jnp.asarray, args), ng)
    assert _rel(rho.numpy(), jrho) <= 1e-6
    assert float(rho.sum()) == pytest.approx(float(mass.sum()), rel=1e-5)
    grids = np.random.default_rng(1).standard_normal((3, ng, ng, ng)).astype(
        np.float32)
    got = pm._gather(_t(grids), _t(pos), *map(_t, args), ng)
    want = jax_pm._gather(jnp.asarray(grids), jnp.asarray(pos),
                          *map(jnp.asarray, args), ng)
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("dist,n,ng", [("plummer", 1024, 32),
                                       ("cold_sphere", 2048, 64),
                                       ("reference", 512, 16)])
def test_pm_accelerations_match_jax(dist, n, ng):
    pos, _, mass = distributions.make_arrays(dist, n, seed=5)
    got = pm.accelerations(_t(pos), _t(mass), grid=ng)
    want = _jax_acc(jnp.asarray(pos), jnp.asarray(mass), grid=ng)
    assert _rel(got.numpy(), want) <= 1e-4
    # The registry entry and the frozen env give the same solve.
    env = pm.make_mesh_env(_t(pos), _t(mass), grid=ng)
    assert torch.equal(registry.get("pm")(_t(pos), _t(mass), grid=ng), got)
    assert _rel(pm.accelerations(_t(pos), _t(mass), grid=ng,
                                 mesh_env=env).numpy(), want) <= 1e-4


def test_pm_outliers_and_between_match_jax():
    # A heavy tail outside the robust box exercises the octant monopoles;
    # distinct targets exercise the between form.
    pos, mass = _plummer(1024, 8)
    pos[:, :4] *= 40.0
    tgt = np.random.default_rng(2).standard_normal((3, 200)).astype(np.float32)
    got = pm.accelerations_between(_t(tgt), _t(pos), _t(mass), grid=32)
    want = jax.jit(jax_pm.accelerations_between, static_argnames=("grid",))(
        jnp.asarray(tgt), jnp.asarray(pos), jnp.asarray(mass), grid=32)
    assert _rel(got.numpy(), want) <= 1e-4
    got = pm.accelerations(_t(pos), _t(mass), grid=32)
    want = _jax_acc(jnp.asarray(pos), jnp.asarray(mass), grid=32)
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("cutoff", [0, 4])
def test_force_error_vs_exact_matches_jax(cutoff):
    pos, mass = _plummer(1024, 2)
    got = float(pm.force_error_vs_exact(_t(pos), _t(mass), grid=32,
                                        cutoff_cells=cutoff, capacity=64))
    want = float(jax_pm.force_error_vs_exact(pos, mass, 32, cutoff, 64))
    assert 0 < got < 1 and got == pytest.approx(want, rel=1e-3)


def test_pm_momentum_and_padding():
    # All particles inside the box: deposit and gather share the CIC
    # weights and the kernel is antisymmetric, so the momentum flux closes.
    pos, _, mass = distributions.cold_sphere(1024, seed=4)
    a = pm.accelerations(_t(pos), _t(mass), grid=32).numpy()
    flux = np.abs((mass[None, :] * a).sum(axis=1))
    assert np.all(flux < 2e-6 * np.abs(mass[None, :] * a).sum())
    st = make_state(1000, pad_multiple=256, device="cpu")  # padded to 1024
    full = pm.accelerations(st.pos, st.mass, grid=32)
    real = pm.accelerations(st.pos[:, :1000].contiguous(),
                            st.mass[:1000].contiguous(), grid=32)
    np.testing.assert_allclose(full[:, :1000].numpy(), real.numpy(),
                               rtol=2e-5, atol=1e-8)


def test_pm_native_gradient_matches_jax_grad():
    pos, mass = _plummer(256, 18)
    fn = make_accel_fn("pm", differentiable=True, grid=16)
    p = _t(pos).requires_grad_(True)
    torch.mean(fn(p, _t(mass)) ** 2).backward()
    want = jax.jit(jax.grad(lambda q: jnp.mean(jax_pm.accelerations(
        q, jnp.asarray(mass), grid=16) ** 2)))(jnp.asarray(pos))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6 * float(np.abs(want).max()))


def test_mesh_tier_refusals():
    # Differentiable P3M runs (tests/test_torch_p3m_grad.py holds it against
    # the JAX package): make_accel_fn hands the flag to the mesh solver.
    for kernel, opts in (("p3m", {}), ("pm", dict(cutoff_cells=4))):
        fn = make_accel_fn(kernel, differentiable=True, **opts)
        assert fn.keywords == dict(opts, differentiable=True)
    with pytest.raises(ValueError, match="backward_opts"):
        make_accel_fn("pm", backward_opts={"backward": "jnp"})
    pos, mass = _plummer(64, 1)
    # The periodic boundary runs (tests/test_torch_periodic.py); what it
    # refuses is a box it cannot have.
    with pytest.raises(ValueError, match="box_size > 0"):
        pm.accelerations(_t(pos), _t(mass), grid=16, boundary="periodic")
    with pytest.raises(ValueError, match="requires --pm-box"):
        SimConfig(kernel="pm", pm_boundary="periodic")
    with pytest.raises(ValueError, match="grid must be >= 8"):
        pm.accelerations(_t(pos), _t(mass), grid=4)
    env = pm.make_mesh_env(_t(pos), _t(mass), grid=16)
    with pytest.raises(ValueError, match="different solver config"):
        pm.accelerations(_t(pos), _t(mass), grid=32, mesh_env=env)


def test_pm_config_and_engine_run_match_jax():
    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.simulation import run as jax_run
    from nbody_tpu_torch.simulation import run

    kw = dict(n=512, nsteps=20, sfreq=10, kernel="pm", pm_grid=32,
              distribution="plummer", dt=0.01)
    cfg = SimConfig(platform="cpu", **kw)
    assert cfg.kernel_opts() == {"grid": 32} and cfg.pad_multiple() == 1
    assert cfg.resolve_sr_plan(None, None) is False  # no short-range pass
    got = [ke for _, ke in run(cfg, quiet=True).kenergy_trace]
    want = [ke for _, ke in jax_run(JaxConfig(platform="cpu", **kw),
                                    quiet=True).kenergy_trace]
    np.testing.assert_allclose(got, want, rtol=1e-4)

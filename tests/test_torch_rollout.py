"""The port's differentiable rollout against the JAX package's.

Inputs are made by numpy from a seed and fed to both packages.  On the CPU
``make_accel_fn("naive", differentiable=True)`` runs the plain force and
the plain force VJP in both, so the rollouts differ only by fp32 rounding.

Tolerances (relative norm): 1e-6 for the states after a few steps, the
fp32 rounding of the same sums in other orders; 1e-4 for the gradients
with respect to the initial velocities and the masses, the JAX package's
bound between the analytic VJP and autodiff (tests/test_grad.py).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models.gravity import make_accel_fn as jax_accel
from nbody_tpu.models.rollout import make_rollout_fn as jax_rollout
from nbody_tpu_torch.examples import fit_velocities
from nbody_tpu_torch.init import make_state
from nbody_tpu_torch.models.gravity import make_accel_fn
from nbody_tpu_torch.models.integrators import advance
from nbody_tpu_torch.models.rollout import make_rollout_fn, rollout_state

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
DT = 0.1


def _system(n, seed):
    """Positions in the unit cube, small velocities, reference-scale masses
    and a target for the final positions, numpy fp32."""
    rng = np.random.default_rng(seed)
    pos = rng.random((3, n), dtype=np.float32)
    vel = ((rng.random((3, n), dtype=np.float32) - 0.5) * 2e-3).astype(np.float32)
    mass = (np.float32(n) * rng.random(n, dtype=np.float32)).astype(np.float32)
    target = (pos + rng.random((3, n), dtype=np.float32) * 1e-3).astype(np.float32)
    return pos, vel, mass, target


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _torch_loss_grads(pos, vel, mass, target, integrator, remat):
    ro = make_rollout_fn(make_accel_fn("naive", differentiable=True), DT,
                         STEPS, integrator, remat)
    v = torch.from_numpy(vel).requires_grad_(True)
    m = torch.from_numpy(mass).requires_grad_(True)
    p_out, v_out = ro(torch.from_numpy(pos), v, m)
    d = p_out - torch.from_numpy(target)
    torch.sum(d * d).backward()
    return p_out.detach(), v_out.detach(), v.grad, m.grad


def _jax_loss_grads(pos, vel, mass, target, integrator, remat):
    ro = jax_rollout(jax_accel("naive", differentiable=True), DT, STEPS,
                     integrator, remat)

    def loss(v, m):
        d = ro(jnp.asarray(pos), v, m)[0] - jnp.asarray(target)
        return jnp.sum(d * d)

    p_out, v_out = ro(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass))
    d_vel, d_mass = jax.grad(loss, argnums=(0, 1))(jnp.asarray(vel),
                                                   jnp.asarray(mass))
    return p_out, v_out, d_vel, d_mass


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_rollout_matches_jax(integrator, remat):
    args = (*_system(128, 0), integrator, remat)
    ours = _torch_loss_grads(*args)
    theirs = _jax_loss_grads(*args)
    assert _rel(ours[0], theirs[0]) <= 1e-6  # positions
    assert _rel(ours[1], theirs[1]) <= 1e-6  # velocities
    assert _rel(ours[2], theirs[2]) <= 1e-4  # d loss / d vel
    assert _rel(ours[3], theirs[3]) <= 1e-4  # d loss / d mass


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_remat_changes_no_bit(integrator):
    # The recomputed forward runs the same ops on the same inputs.
    args = _system(96, 1)
    with_remat = _torch_loss_grads(*args, integrator, True)
    without = _torch_loss_grads(*args, integrator, False)
    for a, b in zip(with_remat, without):
        assert torch.equal(a, b)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_rollout_is_the_engine_step(integrator):
    # The same step as the simulation's block, so the same bits.
    st = make_state(100, device="cpu")
    accel = make_accel_fn("naive")
    out = rollout_state(make_rollout_fn(accel, DT, 7, integrator, remat=False),
                        st)
    pos, vel = advance(st.pos, st.vel, st.mass, accel, DT, 7, integrator)
    assert torch.equal(out.pos, pos) and torch.equal(out.vel, vel)
    assert out.mass is st.mass and out.n == st.n


def test_rollout_refuses_unknown_integrator():
    with pytest.raises(ValueError, match="unknown integrator"):
        make_rollout_fn(make_accel_fn("naive"), DT, 3, "rk4")


def test_first_order_velocity_gradient():
    # d p_x / d v_x after k Euler steps is k*dt to leading order in the
    # weak-force regime (tests/test_grad.py::test_grad_through_trajectory).
    st = make_state(256, device="cpu")
    ro = make_rollout_fn(make_accel_fn("naive", differentiable=True), DT, 5)
    vel = torch.zeros_like(st.vel, requires_grad=True)
    ro(st.pos, vel, st.mass)[0][0].sum().backward()
    assert torch.isfinite(vel.grad).all()
    assert torch.allclose(vel.grad[0], torch.tensor(0.5), atol=0.01)
    assert torch.allclose(vel.grad[1], torch.tensor(0.0), atol=0.01)


def test_fit_velocities_in_process(capsys):
    assert fit_velocities.main(["96", "6", "40", "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "recovered initial velocities to" in out
    assert "s per iteration on cpu" in out


def test_fit_velocities_module_exit_code():
    proc = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch.examples.fit_velocities",
         "96", "6", "40", "--platform", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr

"""The port's differentiable force against the JAX package's.

On the CPU the VJP kernel's wrapper runs its plain version, ``grad.force_
vjp``, so these tests hold the plain sweep against JAX ``force_vjp`` and
against the JAX kernel ``force_vjp_pallas(interpret=True)``, and the
autograd wrapper ``differentiable`` against torch autograd of the plain
``naive`` force and against ``jax.grad`` of JAX's ``differentiable``.
Inputs are made by numpy from a seed and fed to both packages.  The CUDA
kernel itself is held against the plain sweep on a card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances (relative norm): 2e-5 between two fp32 force VJPs that sum in
other orders, JAX's own bound between its kernel and its plain sweep
(tests/test_grad.py); 1e-4 between the analytic VJP and autograd of the
forward, JAX's bound for the same comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import grad as jax_grad
from nbody_tpu.ops import naive as jax_naive
from nbody_tpu_torch.models.gravity import make_accel_fn
from nbody_tpu_torch.ops import (
    fused_block,
    grad,
    naive,
    sym_kernel,
    tiled_kernel,
    vjp_kernel,
)
from nbody_tpu_torch.ops.tiled_kernel import refuse_autograd

torch.set_num_threads(2)

SCALE = 1e20  # brings a^2 of reference-scale masses into fp32 range


def _system(n, seed):
    """Positions in the unit cube and reference-scale masses, numpy fp32."""
    rng = np.random.default_rng(seed)
    pos = rng.random((3, n), dtype=np.float32)
    mass = (np.float32(n) * rng.random(n, dtype=np.float32)).astype(np.float32)
    return pos, mass


def _cotangent(pos, mass, kind, seed):
    """g = naive accelerations * 1e20 (tests/test_grad.py:82), or uniform
    noise from the seed."""
    if kind == "accel":
        a = jax_naive.accelerations(jnp.asarray(pos), jnp.asarray(mass))
        return np.array(a * jnp.float32(SCALE))
    rng = np.random.default_rng(seed + 100)
    return (rng.random(pos.shape, dtype=np.float32) - 0.5).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind", ["accel", "noise"])
def test_force_vjp_matches_jax(kind):
    pos, mass = _system(256, 0)
    g = _cotangent(pos, mass, kind, 0)
    got = grad.force_vjp(_t(pos), _t(mass), _t(g))
    want = jax_grad.force_vjp(jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(g))
    kern = jax_grad.force_vjp_pallas(jnp.asarray(pos), jnp.asarray(mass),
                                     jnp.asarray(g), tile_i=128, tile_j=128,
                                     interpret=True)
    for ours, theirs, pallas in zip(got, want, kern):
        assert ours.dtype == torch.float32
        assert _rel(ours, theirs) <= 2e-5
        assert _rel(ours, pallas) <= 2e-5


def test_force_vjp_chunks_and_ragged_n():
    # A ragged last chunk changes nothing: each target's sums are the same
    # broadcast reductions whatever chunk it falls in.
    pos, mass = _system(300, 1)
    g = _cotangent(pos, mass, "noise", 1)
    whole = grad.force_vjp(_t(pos), _t(mass), _t(g), chunk=1024)
    for chunk in (64, 7):
        parts = grad.force_vjp(_t(pos), _t(mass), _t(g), chunk=chunk)
        for a, b in zip(parts, whole):
            assert torch.equal(a, b)
    want = jax_grad.force_vjp(jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(g))
    for ours, theirs in zip(whole, want):
        assert _rel(ours, theirs) <= 2e-5


def _vjp_body(pos, mass, g, tile_i=64, tile_j=512, chunk=256):
    """csrc/vjp.cu's body in f32 ops: the inverse powers as rsqrt plus one
    Newton step (inv, s = inv^3, q = 3 s inv^2), the pair terms in the
    kernel's fused form, each thread row's share of every source tile summed
    apart (R targets a thread: R = 2 at tile_i 64), the rows then added in
    row order, and the kernel's epilogue."""
    from nbody_tpu_torch.types import G_NEWTON, SOFTENING_SQUARED

    n = pos.shape[1]
    r_t = 2 if tile_i % 64 == 0 and tile_j % (512 // tile_i) == 0 else 1
    rows = 256 // (tile_i // r_t)
    per = tile_j // rows
    onehot = torch.nn.functional.one_hot(
        (torch.arange(n) % tile_j) // per, rows).float()  # source -> row
    gm = mass * G_NEWTON
    sums = torch.zeros(7, n, rows)
    for c0 in range(0, n, chunk):
        k = slice(c0, c0 + chunk)
        rx, ry, rz = (pos[c][None, :] - pos[c][k, None] for c in range(3))
        u = ((rx * rx + SOFTENING_SQUARED) + ry * ry) + rz * rz
        y = torch.rsqrt(u)
        inv = y * ((-(0.5 * u) * y) * y + 1.5)
        inv2 = inv * inv
        s = inv2 * inv
        q = (3.0 * s) * inv2
        gj = [g[c][None, :] for c in range(3)]
        gk = [g[c][k, None] for c in range(3)]
        rgj = (rx * gj[0] + ry * gj[1]) + rz * gj[2]
        rgk = (rx * gk[0] + ry * gk[1]) + rz * gk[2]
        cj = q * rgj
        ms, mck = gm[None, :] * s, gm[None, :] * (q * rgk)
        terms = [s * gj[c] - cj * r for c, r in enumerate((rx, ry, rz))]
        terms += [ms * gk[c] - mck * r for c, r in enumerate((rx, ry, rz))]
        terms.append(rgj * s)
        for v, term in enumerate(terms):
            sums[v, k] = term @ onehot
    tot = sums[..., 0]
    for row in range(1, rows):  # fixed order
        tot = tot + sums[..., row]
    gmk = mass * G_NEWTON
    d_pos = torch.stack([gmk * tot[c] - tot[3 + c] for c in range(3)])
    return d_pos, -G_NEWTON * tot[6]


@pytest.mark.parametrize("n", [2000, 300])
def test_vjp_kernel_body_emulated(n):
    """The kernel's f32 arithmetic (rsqrt and one Newton step, fused pair
    terms, R = 2 row sums) stays within 2e-5 of the plain sweep's IEEE 1 /
    sqrt, at N=2000 and at a ragged N."""
    pos, mass = _system(n, 8)
    g = _cotangent(pos, mass, "accel", 8)
    got = _vjp_body(_t(pos), _t(mass), _t(g))
    want = grad.force_vjp(_t(pos), _t(mass), _t(g))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert _rel(a, b) <= 2e-5


def test_vjp_wrapper_on_cpu_is_the_plain_sweep():
    pos, mass = _system(200, 2)
    g = _cotangent(pos, mass, "accel", 2)
    before = vjp_kernel.launches
    got = vjp_kernel.force_vjp(_t(pos), _t(mass), _t(g), tile_i=32, tile_j=64)
    want = grad.force_vjp(_t(pos), _t(mass), _t(g))
    assert vjp_kernel.launches == before  # counts kernel launches only
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    alias = grad.force_vjp_pallas(_t(pos), _t(mass), _t(g))
    for a, b in zip(alias, want):
        assert torch.equal(a, b)


def test_vjp_wrapper_checks_inputs():
    pos, mass = _system(64, 3)
    g = _cotangent(pos, mass, "noise", 3)
    with pytest.raises(ValueError, match="shape"):
        vjp_kernel.force_vjp(_t(pos), _t(mass), _t(g[:, :32]))
    with pytest.raises(ValueError, match="contiguous"):
        vjp_kernel.force_vjp(_t(pos), _t(mass), _t(g.T.copy()).T)
    with pytest.raises(TypeError, match="float32"):
        vjp_kernel.force_vjp(_t(pos), _t(mass), _t(g).double())


def test_vjp_zero_cotangent():
    pos, mass = _system(256, 4)
    d_pos, d_mass = grad.force_vjp(_t(pos), _t(mass), torch.zeros(3, 256))
    assert torch.all(d_pos == 0) and torch.all(d_mass == 0)


def _loss(accel):
    def loss(pos, mass):
        a = accel(pos, mass)
        return (a * a).sum() * SCALE

    return loss


@pytest.mark.parametrize("backward", ["jnp", "pallas", "auto"])
def test_differentiable_matches_autograd_and_jax(backward):
    pos, mass = _system(256, 5)
    p, m = _t(pos).requires_grad_(True), _t(mass).requires_grad_(True)
    _loss(grad.differentiable(naive.accelerations, backward=backward))(p, m).backward()
    got = (p.grad, m.grad)

    p2, m2 = _t(pos).requires_grad_(True), _t(mass).requires_grad_(True)
    _loss(naive.accelerations)(p2, m2).backward()  # autograd of the plain force

    def jloss(pos, mass):
        a = jax_grad.differentiable(jax_naive.accelerations)(pos, mass)
        return jnp.sum(a * a) * jnp.float32(SCALE)

    jax_g = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(pos), jnp.asarray(mass))
    for ours, auto, theirs in zip(got, (p2.grad, m2.grad), jax_g):
        assert _rel(ours, auto) <= 1e-4
        assert _rel(ours, theirs) <= 1e-4


def test_differentiable_forward_and_needs_input_grad():
    pos, mass = _system(128, 6)
    accel = make_accel_fn("naive", differentiable=True,
                          backward_opts={"backward": "jnp", "chunk": 32})
    p = _t(pos).requires_grad_(True)
    m = _t(mass)  # no gradient asked for the masses
    a = accel(p, m)
    assert torch.equal(a.detach(), naive.accelerations(_t(pos), m))
    assert a.grad_fn is not None
    (a * a).sum().mul(SCALE).backward()
    assert p.grad is not None and p.grad.shape == (3, 128)
    assert m.grad is None


def test_plain_backward_is_twice_differentiable():
    # The plain backward is built of torch ops, so a gradient of a gradient
    # falls out of autograd, as in the JAX package.
    pos, mass = _system(64, 7)
    v = _t(_cotangent(pos, mass, "noise", 7))
    got = []
    for accel in (grad.differentiable(naive.accelerations, backward="jnp"),
                  naive.accelerations):
        p = _t(pos).requires_grad_(True)
        (gp,) = torch.autograd.grad(_loss(accel)(p, _t(mass)), p,
                                    create_graph=True)
        (hv,) = torch.autograd.grad((gp * v).sum(), p)
        got.append(hv)
    assert _rel(got[0], got[1]) <= 1e-3


def test_differentiable_refuses_unknown_backward():
    with pytest.raises(ValueError, match="unknown backward"):
        grad.differentiable(naive.accelerations, backward="xla")


def test_refuse_autograd():
    """The check shared by the CUDA branches of the three forward kernels
    and the VJP kernel: a ctypes launch is invisible to autograd."""
    x = torch.zeros(3, 8, requires_grad=True)
    y = torch.zeros(8)
    with pytest.raises(RuntimeError,
                       match=r"make_accel_fn\(\.\.\., differentiable=True\)"):
        refuse_autograd("tiled kernel", y, x)
    refuse_autograd("tiled kernel", y, y)  # nothing requires grad
    with torch.no_grad():
        refuse_autograd("tiled kernel", x, y)  # inside the analytic VJP
    # On the CPU the wrappers run their plain versions, which autograd
    # traces, so gradients flow there.
    pos, mass = _system(128, 8)
    for fn in (lambda p, m: tiled_kernel.accelerations(p, m),
               lambda p, m: sym_kernel.accelerations(p, m, block=64),
               lambda p, m: fused_block.fused_block(p, torch.zeros_like(p),
                                                    m, 0.1, 2)[0]):
        p = _t(pos).requires_grad_(True)
        assert fn(p, _t(mass)).grad_fn is not None

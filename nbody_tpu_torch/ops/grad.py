"""The analytic VJP of the all-pairs force, which makes the CUDA kernels
differentiable (autograd cannot see a kernel launched through ctypes).

The port of ``nbody_tpu.ops.grad``.  With a_i = sum_j G m_j f(p_j - p_i),
f(r) = r (|r|^2 + eps)^(-3/2):

  J(r) = df/dr = s I - 3 u^(-5/2) r r^T,   u = |r|^2 + eps,  s = u^(-3/2)

  dL/dp_k = G m_k sum_i J(r_ik) g_i  -  sum_j G m_j J(r_kj) g_k
  dL/dm_k = G sum_i g_i . f(p_k - p_i)

where g is the output cotangent.  The i==k diagonal appears in both
position terms and cancels in exact arithmetic, so it is left unmasked,
as the forward kernels leave theirs (ver0/GSimulation.cpp:132-147).

Two backward implementations share the math:

* ``force_vjp``        -- the plain chunked sweep in PyTorch, with the
                          forward kernels' ``1 / sqrt`` (IEEE) form; itself
                          differentiable, so higher-order derivatives fall
                          out of autograd.  It is the kernel's oracle.
* ``force_vjp_pallas`` -- the CUDA kernel (``ops/vjp_kernel.py``,
                          ``csrc/vjp.cu``); the JAX name is kept so that
                          ``backward_opts`` carry over.

``differentiable(accel_fn, backward=...)`` wraps a forward kernel in a
``torch.autograd.Function`` whose backward is one of the two.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..types import G_NEWTON, SOFTENING_SQUARED

BACKWARDS = ("jnp", "pallas", "auto")


def force_vjp(pos: torch.Tensor, mass: torch.Tensor, g: torch.Tensor,
              chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Cotangents (d_pos, d_mass) of the self-acceleration kernel.

    pos (3,N), mass (N,), g (3,N) cotangent of acc -> ((3,N), (N,)), in the
    inputs' dtype (fp32, or fp64 for a reference sweep).  The targets are
    swept in chunks, so the temporaries are O(chunk * N)."""
    gm = mass * G_NEWTON
    d_pos, d_mass = [], []
    for c0 in range(0, pos.shape[1], chunk):
        pos_k, g_k, gm_k = pos[:, c0:c0 + chunk], g[:, c0:c0 + chunk], gm[c0:c0 + chunk]
        r = pos[:, None, :] - pos_k[:, :, None]  # (3, c, N): p_j - p_k
        u = r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + SOFTENING_SQUARED
        inv = 1.0 / torch.sqrt(u)
        s = inv * inv * inv  # u^-3/2
        q = 3.0 * s * (inv * inv)  # 3 u^-5/2

        # A: sum_j J(r_kj) g_j (uses J's symmetry in r)
        rg = r[0] * g[0][None, :] + r[1] * g[1][None, :] + r[2] * g[2][None, :]
        a = (s * g[:, None, :] - (q * rg) * r).sum(dim=2)  # (3, c)
        # B: sum_j G m_j J(r_kj) g_k
        rgk = r[0] * g_k[0][:, None] + r[1] * g_k[1][:, None] + r[2] * g_k[2][:, None]
        b = (gm * (s * g_k[:, :, None] - (q * rgk) * r)).sum(dim=2)
        d_pos.append(gm_k * a - b)
        # G sum_i g_i . f(p_k - p_i), where f(p_k - p_i) = -r s
        d_mass.append(-(rg * s).sum(dim=1) * G_NEWTON)
    return torch.cat(d_pos, dim=1), torch.cat(d_mass)


def force_vjp_pallas(pos: torch.Tensor, mass: torch.Tensor, g: torch.Tensor,
                     tile_i: int = 0, tile_j: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel backward (``ops/vjp_kernel.force_vjp``); same contract as
    ``force_vjp``.  On a CPU tensor the wrapper runs ``force_vjp``."""
    from . import vjp_kernel  # vjp_kernel imports this module

    return vjp_kernel.force_vjp(pos, mass, g, tile_i=tile_i, tile_j=tile_j)


def _grads(ctx, d_pos, d_mass):
    return (d_pos if ctx.needs_input_grad[0] else None,
            d_mass if ctx.needs_input_grad[1] else None, None, None)


class _PlainVJP(torch.autograd.Function):
    """acc = accel_fn(pos, mass) with the plain sweep as its backward; the
    backward is itself differentiable."""

    @staticmethod
    def forward(ctx, pos, mass, accel_fn, opts):
        ctx.save_for_backward(pos, mass)  # only the inputs, as JAX's fwd
        ctx.opts = opts
        with torch.no_grad():
            return accel_fn(pos, mass)

    @staticmethod
    def backward(ctx, g):
        pos, mass = ctx.saved_tensors
        return _grads(ctx, *force_vjp(pos, mass, g.contiguous(),
                                      chunk=ctx.opts["chunk"]))


class _KernelVJP(_PlainVJP):
    """The same forward with the CUDA kernel as its backward, which, like a
    ``pallas_call`` in JAX, cannot itself be differentiated."""

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        pos, mass = ctx.saved_tensors
        return _grads(ctx, *force_vjp_pallas(pos, mass, g.contiguous(),
                                             ctx.opts["tile_i"],
                                             ctx.opts["tile_j"]))


def differentiable(accel_fn, chunk: int = 1024, backward: str = "auto",
                   tile_i: int = 0, tile_j: int = 0):
    """Wrap a (pos, mass) -> acc kernel with the analytic VJP.

    backward: 'jnp' (the plain sweep), 'pallas' (the CUDA kernel), or
    'auto' (the kernel on a CUDA tensor, the plain sweep on the CPU).
    ``chunk`` sizes the plain sweep, ``tile_i``/``tile_j`` the kernel
    (0: its defaults).  The forward runs ``accel_fn`` under
    ``torch.no_grad()``, so the CUDA forward kernels may run inside it."""
    if backward not in BACKWARDS:
        raise ValueError(f"unknown backward {backward!r}; options: {BACKWARDS}")
    opts = dict(chunk=chunk, tile_i=tile_i, tile_j=tile_j)

    def accel(pos: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
        kernel = backward == "pallas" or (
            backward == "auto" and pos.device.type == "cuda")
        fn = _KernelVJP if kernel else _PlainVJP
        return fn.apply(pos, mass, accel_fn, opts)

    return accel

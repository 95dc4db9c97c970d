"""Force-kernel registry.

The names mean the same algorithm as in ``nbody_tpu.ops.registry``, so CLI
values carry over.  Every kernel has the signature
``fn(pos (3,N) f32, mass (N,) f32, **opts) -> acc (3,N) f32``:

* ``naive``      -- broadcast tensor ops, the oracle (ops/naive.py)
* ``pallas``     -- Kernel A, the tiled sweep (ops/tiled_kernel.py)
* ``pallas_sym`` -- Kernel B, the pair-symmetric sweep (ops/sym_kernel.py)
* ``pallas_mxu`` -- the |r|^2-expansion sweep (ops/mxu_kernel.py; opt-in,
  never chosen by ``auto``; fp32 distances only)
* ``pm``         -- the particle-mesh solver, O(N log N) and approximate
  (ops/pm.py; opt-in, never chosen by ``auto``)
* ``p3m``        -- the mesh solver with the exact short-range correction
  (ops/pm.py with the sweep of ops/sr_kernel.py; opt-in)
* ``auto``       -- on CUDA, ``pallas_sym`` when the padded N is a multiple
  of its block and its partials fit (sym_kernel.fits), else ``pallas``; on
  the CPU, ``naive``, as the JAX package's ``auto`` off the TPU
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from . import mxu_kernel, naive, pm, sym_kernel, tiled_kernel

KernelFn = Callable[..., torch.Tensor]

# name -> (self_accelerations, accelerations_between)
_REGISTRY: Dict[str, tuple[KernelFn, KernelFn]] = {
    "naive": (naive.accelerations, naive.accelerations_between),
    "pallas": (tiled_kernel.accelerations, tiled_kernel.accelerations_between),
    # Targets x sources have no symmetry to exploit: the between form is
    # the tiled kernel, as in the JAX package.
    "pallas_sym": (sym_kernel.accelerations, tiled_kernel.accelerations_between),
    "pallas_mxu": (mxu_kernel.accelerations, mxu_kernel.accelerations_between),
    "pm": (pm.accelerations, pm.accelerations_between),
    "p3m": (pm.p3m_accelerations, pm.p3m_accelerations_between),
}


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY)) + ("auto",)


def resolve(name: str, platform: str = "cuda") -> str:
    """Resolve ``auto`` to a concrete kernel name at the platform level,
    which sets the padding.  On CUDA the exact choice, per padded N, is
    ``_auto_self``'s: ``pallas`` where the pair-symmetric partials do not
    fit."""
    if name != "auto":
        return name
    return "naive" if platform == "cpu" else "pallas_sym"


def get(name: str) -> KernelFn:
    """Self-acceleration kernel: fn(pos (3,N), mass (N,), **opts) -> (3,N)."""
    if name == "auto":
        return _auto_self
    return _lookup(name)[0]


def get_between(name: str) -> KernelFn:
    """Target/source kernel: fn(pos_tgt, pos_src, mass_src, **opts).
    ``auto`` takes the tiled kernel's, as ``pallas_sym`` does."""
    return _lookup(name)[1]


def _lookup(name: str):
    name = resolve(name)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; available: {available()}"
        ) from None


def _auto_self(pos, mass, **opts):
    """``auto`` self-kernel, dispatched on the tensor's device and shape."""
    if pos.device.type == "cpu":
        return naive.accelerations(pos, mass, **opts)
    block = opts.get("tile_i") or sym_kernel.DEFAULT_BLOCK
    if sym_kernel.fits(pos.shape[1], block, pos.device):
        return sym_kernel.accelerations(pos, mass, **opts)
    return tiled_kernel.accelerations(pos, mass, **opts)

"""Kernel A: the tiled targets x sources force sweep (``csrc/tiled.cu``).

Replaces ``nbody_tpu/ops/pallas_kernel.py::_nbody_kernel``, with its
``dist_dtype``: ``"float32"``, or ``"bfloat16"``, the bf16 distance mode
(each pair delta subtracted in f32 and rounded through bf16, all arithmetic
f32).  The public functions keep the JAX package's layout:
``accelerations_between(pos_tgt (3,Nt), pos_src (3,Ns), mass_src (Ns,)) ->
(3,Nt)`` and ``accelerations(pos, mass)``.

On a CUDA tensor the wrapper launches the hand-written kernel or raises; on
a CPU tensor it runs ``accelerations_between_plain``, the same function in
plain PyTorch.  The kernel masks its ragged edges, so Nt and Ns need no
padding.  Its inverse cube is ``rsqrt`` with one Newton step, within about
an ulp of the plain version's IEEE ``1 / sqrt``, so the two agree to fp32
rounding, not bit for bit.  Design and bound: see the note at the top of
``csrc/tiled.cu``.
"""

from __future__ import annotations

import functools

import torch

from ..types import G_NEWTON, SOFTENING_SQUARED
from ..utils import build

DEFAULT_TILE_I = 64  # targets per CTA (256 threads: 8 rows of 32, 2 each)
SMALL_TILE_I = 32  # where DEFAULT_TILE_I leaves SMs without a CTA
DEFAULT_TILE_J = 256  # sources per shared-memory tile
THREADS = 256
MAX_TILE_J = 3072  # 48 KB of float4 sources

# Kernel launches on CUDA tensors; chip_smoke.py zeroes and reads it.
launches = 0


def check_input(name: str, t: torch.Tensor, shape: tuple,
                device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous fp32 tensor of ``shape`` on
    ``device``."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_autograd(what: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record a call of a CUDA kernel.

    The kernels are launched through ctypes on raw pointers, which autograd
    cannot see: their output would carry no ``grad_fn`` and every gradient
    through it would silently miss the force term.  The differentiable path
    runs the kernels under ``torch.no_grad()`` inside an
    ``autograd.Function`` whose backward is the analytic force VJP."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, and autograd cannot trace a "
            "CUDA kernel launched through ctypes; differentiate through "
            "make_accel_fn(..., differentiable=True) instead"
        )


def check_tiles(tile_i: int, tile_j: int) -> tuple[int, int]:
    """The tiles of a sweep over Kernel A's source loop (0: the defaults),
    or a ValueError: ``tile_i`` a multiple of 32 dividing 256, ``tile_j`` a
    multiple of 256/tile_i, at most ``MAX_TILE_J``."""
    ti = tile_i or DEFAULT_TILE_I
    tj = tile_j or DEFAULT_TILE_J
    if ti % 32 or THREADS % ti:
        raise ValueError(f"tile_i={ti} must be a multiple of 32 dividing {THREADS}")
    if tj % (THREADS // ti) or not 0 < tj <= MAX_TILE_J:
        raise ValueError(
            f"tile_j={tj} must be a multiple of {THREADS // ti} in "
            f"(0, {MAX_TILE_J}]"
        )
    return ti, tj


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def default_tile_i(nt: int, device: torch.device) -> int:
    """The targets a CTA of Kernel A takes where the caller names none:
    ``DEFAULT_TILE_I``, or ``SMALL_TILE_I`` where ``DEFAULT_TILE_I`` would
    give fewer CTAs than the card has SMs (one shard's 4096 targets: 64
    CTAs on 132 SMs)."""
    if -(-nt // DEFAULT_TILE_I) >= _sm_count(device):
        return DEFAULT_TILE_I
    return SMALL_TILE_I


DIST_DTYPES = ("float32", "bfloat16")


def check_dist_dtype(dist_dtype: str) -> bool:
    """Whether ``dist_dtype`` is the bf16 distance mode; raises on a name
    the kernels do not take."""
    if dist_dtype not in DIST_DTYPES:
        raise ValueError(f"unknown dist_dtype {dist_dtype!r}; options: {DIST_DTYPES}")
    return dist_dtype == "bfloat16"


def round_deltas(d: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The bf16 distance mode's rounding of f32 pair deltas: to nearest even
    through bf16 and back (as ``jnp.astype`` and ``__float2bfloat16_rn``)."""
    return d.to(torch.bfloat16).float() if bf16 else d


def accelerations_between_plain(pos_tgt: torch.Tensor, pos_src: torch.Tensor,
                                 mass_src: torch.Tensor, chunk: int = 1024,
                                 dist_dtype: str = "float32") -> torch.Tensor:
    """The kernel's function in plain PyTorch: broadcast pair blocks over
    chunks of targets, with IEEE ``1 / sqrt`` (the kernel's rsqrt and Newton
    step are within about an ulp of it).  The kernel's tiles do not change
    the function."""
    bf16 = check_dist_dtype(dist_dtype)
    gm = mass_src * G_NEWTON
    out = []
    for c0 in range(0, pos_tgt.shape[1], chunk):
        d = round_deltas(pos_src[:, None, :] - pos_tgt[:, c0:c0 + chunk, None],
                         bf16)  # (3, C, Ns)
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + SOFTENING_SQUARED
        inv = 1.0 / torch.sqrt(d2)
        w = gm[None, :] * (inv * inv * inv)
        out.append((d * w).sum(dim=2))
    return torch.cat(out, dim=1)


def accelerations_between(pos_tgt: torch.Tensor, pos_src: torch.Tensor,
                          mass_src: torch.Tensor, tile_i: int = 0,
                          tile_j: int = 0, dist_dtype: str = "float32"
                          ) -> torch.Tensor:
    """Accelerations of targets due to sources.
    pos_tgt (3, Nt), pos_src (3, Ns), mass_src (Ns,) -> (3, Nt) fp32.

    ``tile_i``: targets per CTA, a multiple of 32 dividing 256 (default
    ``default_tile_i``: 64, or 32 where 64 leaves SMs idle).  ``tile_j``:
    sources per shared-memory tile, a multiple of 256/tile_i, at most 3072
    (default 256).  ``dist_dtype``: "float32" or "bfloat16"."""
    global launches
    bf16 = check_dist_dtype(dist_dtype)
    dev = pos_tgt.device
    nt, ns = pos_tgt.shape[1], pos_src.shape[1]
    check_input("pos_tgt", pos_tgt, (3, nt), dev)
    check_input("pos_src", pos_src, (3, ns), dev)
    check_input("mass_src", mass_src, (ns,), dev)
    if dev.type == "cpu":
        return accelerations_between_plain(pos_tgt, pos_src, mass_src,
                                           dist_dtype=dist_dtype)
    if dev.type != "cuda":
        raise ValueError(f"tiled kernel runs on cuda or cpu, not {dev}")
    refuse_autograd("tiled kernel", pos_tgt, pos_src, mass_src)
    ti, tj = check_tiles(tile_i or default_tile_i(nt, dev), tile_j)
    out = torch.empty((3, nt), dtype=torch.float32, device=dev)
    if nt == 0 or ns == 0:
        return out.zero_()
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.nbt_tiled_accel(
            pos_tgt.data_ptr(), nt, pos_src.data_ptr(), mass_src.data_ptr(),
            ns, out.data_ptr(), ti, tj, int(bf16),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "nbt_tiled_accel")
    launches += 1
    return out


def accelerations(pos: torch.Tensor, mass: torch.Tensor, tile_i: int = 0,
                  tile_j: int = 0, dist_dtype: str = "float32") -> torch.Tensor:
    """All-pairs self-accelerations. pos (3,N), mass (N,) -> (3,N)."""
    return accelerations_between(pos, pos, mass, tile_i=tile_i, tile_j=tile_j,
                                 dist_dtype=dist_dtype)

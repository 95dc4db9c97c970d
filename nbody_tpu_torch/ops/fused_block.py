"""The fused sample block (``csrc/fused.cu``): a whole block of Euler or
leapfrog steps in one kernel launch, f32 only.

Replaces ``nbody_tpu/ops/fused_block.py``: ``_rows_kernel``, the rows
layout (Kernel B's pair-symmetric sweep in square blocks), and ``_kernel``,
the columns layout (Kernel A's one-sided tile_i x tile_j sweep).
``fused_block`` takes the JAX package's layout rule: rows, unless the
request asks for a tiling the square blocks cannot honour (``tile_j`` set
and ``tile_i != tile_j``), and it raises the JAX package's ``ValueError``
for a tiling that does not divide N.

On a CUDA tensor it launches one cooperative kernel or raises; on a CPU
tensor it runs ``fused_block_plain``, the same steps through the plain
version of Kernel B or A with the update of ``models/integrators.py``.  It
never writes into its inputs.  Design: see the note at the top of
``csrc/fused.cu``.

Limits come from the card, not from the TPU's VMEM tables (``max_fused_n``,
``max_fused_rows_n``): the state lives in device memory.  The rows layout
keeps Kernel B's partials budget (``sym_kernel.fits``); the columns layout
needs only its state (``fused_cap``).
"""

from __future__ import annotations

import math

import torch

from ..models.integrators import INTEGRATORS, advance, step_sizes
from ..utils import build, spans
from . import sym_kernel, tiled_kernel
from .tiled_kernel import check_input, refuse_autograd

# Rows: the largest power of two up to DEFAULT_BLOCK that divides N.
DEFAULT_BLOCK = sym_kernel.DEFAULT_BLOCK
DEFAULT_TILE_I = tiled_kernel.DEFAULT_TILE_I  # columns
DEFAULT_TILE_J = tiled_kernel.DEFAULT_TILE_J
# Columns state: two position buffers, the velocities and the masses.
COLS_BYTES_PER_BODY = 4 * (3 + 3 + 3 + 1)

# Kernel launches on CUDA tensors, either layout; chip_smoke.py zeroes and
# reads it.  The force sweeps the blocks run, on either device, count in
# ``spans.counts["fused_sweeps"]``: ``steps`` a block under Euler, one more
# under leapfrog (its re-seed); a block of no steps counts none.
launches = 0


def is_rows(tile_i: int = 0, tile_j: int = 0) -> bool:
    """Whether a tiling request takes the rows layout (the JAX rule: a
    lone or rectangular ``tile_j`` needs the columns layout)."""
    return not tile_j or tile_i == tile_j


def layout(n: int, tile_i: int = 0, tile_j: int = 0,
           sym: bool | None = None) -> tuple[bool, int, int]:
    """(rows, tile_i, tile_j) that ``fused_block`` runs for this request;
    rows blocks are square.  ``sym`` forces the layout (None: the rule)."""
    rows = is_rows(tile_i, tile_j) if sym is None else sym
    if rows:
        if tile_i:
            b = min(tile_i, n)
        else:
            b = DEFAULT_BLOCK
            while b > 1 and n % min(b, n):
                b //= 2
            b = min(b, n)
        if n % b:
            raise ValueError(f"N={n} must be divisible by block {b}")
        return True, b, b
    ti = min(tile_i or DEFAULT_TILE_I, n)
    tj = min(tile_j or DEFAULT_TILE_J, n)
    if n % ti or n % tj:
        raise ValueError(f"N={n} must be divisible by tiles ({ti},{tj})")
    return False, ti, tj


def pad_multiple(tile_i: int = 0, tile_j: int = 0) -> int:
    """The particle-count multiple that the layout of this request needs."""
    if is_rows(tile_i, tile_j):
        return tile_i or DEFAULT_BLOCK
    return math.lcm(tile_i or DEFAULT_TILE_I, tile_j or DEFAULT_TILE_J)


def fused_cap(rows: bool, block: int, device: torch.device) -> int:
    """The largest N the layout takes on this card: for rows, while Kernel
    B's partials (12 N^2 / B bytes) fit its share of the card's memory;
    for columns, while the state does."""
    budget = sym_kernel.SCRATCH_SHARE * torch.cuda.get_device_properties(
        device).total_memory
    if rows:
        cap = math.isqrt(int(budget * block / 12))
        return cap - cap % block
    return int(budget // COLS_BYTES_PER_BODY)


def fused_block_plain(pos: torch.Tensor, vel: torch.Tensor,
                      mass: torch.Tensor, dt: float, steps: int,
                      tile_i: int = 0, tile_j: int = 0,
                      integrator: str = "euler", sym: bool | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' function in plain PyTorch: ``steps`` steps through
    ``sym_kernel.accelerations_plain`` (rows) or
    ``tiled_kernel.accelerations_between_plain`` (columns)."""
    rows, ti, _ = layout(pos.shape[1], tile_i, tile_j, sym)
    if rows:
        def accel(p, m):
            return sym_kernel.accelerations_plain(p, m, ti)
    else:
        def accel(p, m):
            return tiled_kernel.accelerations_between_plain(p, p, m)
    return advance(pos, vel, mass, accel, dt, steps, integrator)


def _check_cuda_tiles(rows: bool, ti: int, tj: int) -> None:
    if rows:
        if ti % 32 or ti > sym_kernel.MAX_BLOCK:
            raise ValueError(f"block={ti} must be a multiple of 32, at most "
                             f"{sym_kernel.MAX_BLOCK}")
        return
    threads = tiled_kernel.THREADS
    if ti % 32 or threads % ti:
        raise ValueError(
            f"tile_i={ti} must be a multiple of 32 dividing {threads}")
    if tj % (threads // ti) or tj > tiled_kernel.MAX_TILE_J:
        raise ValueError(f"tile_j={tj} must be a multiple of {threads // ti}, "
                         f"at most {tiled_kernel.MAX_TILE_J}")


def fused_block(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor,
                dt: float, steps: int, tile_i: int = 0, tile_j: int = 0,
                integrator: str = "euler", sym: bool | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance (pos (3,N), vel (3,N)) by ``steps`` steps of ``integrator``
    in one kernel launch; returns new (pos, vel).  ``sym`` forces the rows
    (True) or columns (False) layout; None takes the JAX rule."""
    global launches
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")
    dev = pos.device
    n = pos.shape[1]
    check_input("pos", pos, (3, n), dev)
    check_input("vel", vel, (3, n), dev)
    check_input("mass", mass, (n,), dev)
    rows, ti, tj = layout(n, tile_i, tile_j, sym)
    leapfrog = int(integrator == "leapfrog")
    if dev.type == "cpu":
        if steps:
            spans.counts["fused_sweeps"] += steps + leapfrog
        return fused_block_plain(pos, vel, mass, dt, steps, ti, tj,
                                 integrator, rows)
    if dev.type != "cuda":
        raise ValueError(f"fused block runs on cuda or cpu, not {dev}")
    refuse_autograd("fused block", pos, vel, mass)
    _check_cuda_tiles(rows, ti, tj)
    cap = fused_cap(rows, ti, dev)
    if n > cap:
        raise ValueError(f"fused {'rows' if rows else 'columns'} block "
                         f"supports N <= {cap} on this card, got {n}")
    vel_out = vel.clone()
    if steps == 0:
        return pos.clone(), vel_out
    spans.counts["fused_sweeps"] += steps + leapfrog
    dtf, half = step_sizes(dt)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if rows:
            pos_out = pos.clone()
            part = torch.empty(sym_kernel.scratch_bytes(n, ti) // 4,
                               dtype=torch.float32, device=dev)
            queue = torch.zeros(1, dtype=torch.int32, device=dev)  # counter
            err = lib.nbt_fused_rows(
                pos_out.data_ptr(), vel_out.data_ptr(), mass.data_ptr(), n, ti,
                part.data_ptr(), queue.data_ptr(), steps, dtf, half, leapfrog,
                stream)
        else:
            bufs = torch.empty((2, 3, n), dtype=torch.float32, device=dev)
            bufs[0].copy_(pos)
            err = lib.nbt_fused_cols(
                bufs.data_ptr(), vel_out.data_ptr(), mass.data_ptr(), n, ti,
                tj, steps, dtf, half, leapfrog, stream)
            pos_out = bufs[(steps + leapfrog) % 2]
    build.check(err, "nbt_fused_rows" if rows else "nbt_fused_cols")
    launches += 1
    return pos_out, vel_out

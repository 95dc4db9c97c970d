"""Kernel B: the pair-symmetric self-sweep (``csrc/sym.cu``).

Replaces ``nbody_tpu/ops/pallas_sym.py::_sym_kernel`` with
``fold_mass=True``, f32 only.  Each unordered B x B tile pair is computed
once with the mass-folded weight w = (G m_i)(G m_j)/(d^2+eps^2)^{3/2};
diagonal tiles take a one-sided sum; a = S / (G m), zero mass giving 0.

On Hopper the CTAs run in no order, so the j-side reaction is kept in
deterministic per-tile-pair partials, P[it][jt] and P[jt][it], which a
second kernel adds in a fixed order (see the note in ``csrc/sym.cu``).
The partials take ``scratch_bytes(n, block)`` = 12 N^2 / B bytes of device
memory; ``fits`` bounds them by a share of the card's memory, and the
registry's ``auto`` takes the tiled kernel above it.  The TPU's VMEM cap
(``max_sym_n``) does not carry over.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs ``accelerations_plain``, the same tile-pair algorithm in plain
PyTorch, so the CPU tests exercise the mass-folded math and the partials.

``accelerations_two_sided`` is the targets x sources form
(``csrc/two_sided.cu``, replacing ``pallas_sym.py::_two_sided_kernel``):
each pair once, the action on the targets and the reaction on the sources,
each divided by its own G m.  The pair-symmetric half ring of the particle
decomposition (``parallel/decompose.py``, comm ``ring_sym``) runs it.
"""

from __future__ import annotations

import torch

from ..types import G_NEWTON, SOFTENING_SQUARED
from ..utils import build
from .tiled_kernel import check_input, refuse_autograd

DEFAULT_BLOCK = 128
MAX_BLOCK = 256  # 8 warps of j-side partials fill 24 KB of shared memory
# ``auto`` takes this kernel while its partials fit this share of the card.
SCRATCH_SHARE = 1 / 8

# Kernel launches on CUDA tensors (Kernel B; the two-sided kernel);
# chip_smoke.py zeroes and reads them.
launches = 0
two_sided_launches = 0


def scratch_bytes(n: int, block: int) -> int:
    """Bytes of partials: T x T tile pairs of (3, B) fp32, T = n / B."""
    return 3 * 4 * n * (n // block)


def fits(n: int, block: int, device: torch.device) -> bool:
    """Whether the CUDA kernel takes this shape and its partials stay
    within SCRATCH_SHARE of the card's memory."""
    if block % 32 or block > MAX_BLOCK or n % block:
        return False
    total = torch.cuda.get_device_properties(device).total_memory
    return scratch_bytes(n, block) <= SCRATCH_SHARE * total


def accelerations_plain(pos: torch.Tensor, mass: torch.Tensor,
                        block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: for each i tile, the
    diagonal tile and every later tile in one broadcast block, written into
    the same (T, T, 3, B) partials, then the ordered sum and the divide."""
    n = pos.shape[1]
    b = min(block, n)
    if n % b:
        raise ValueError(f"N={n} must be divisible by block={b}")
    t_count = n // b
    gm = mass * G_NEWTON
    part = torch.empty((t_count, t_count, 3, b), dtype=pos.dtype,
                       device=pos.device)
    for it in range(t_count):
        i0 = it * b
        d = pos[:, None, i0:] - pos[:, i0:i0 + b, None]  # (3, B, N - i0)
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + SOFTENING_SQUARED
        inv = 1.0 / torch.sqrt(d2)
        w = (gm[i0:i0 + b, None] * gm[None, i0:]) * (inv * inv * inv)
        p = (d * w).reshape(3, b, t_count - it, b)  # [c, i, jt - it, j]
        part[it, it:] = p.sum(dim=3).permute(2, 0, 1)  # i side: P[it][jt]
        # j side of the off-diagonal tiles: P[jt][it] = -sum_i w d
        part[it + 1:, it] = -p[:, :, 1:].sum(dim=1).permute(1, 0, 2)
    s = part.sum(dim=1).permute(1, 0, 2).reshape(3, n)
    return _divide(s, gm)


def accelerations(pos: torch.Tensor, mass: torch.Tensor, block: int = 0,
                  tile_i: int = 0, tile_j: int = 0) -> torch.Tensor:
    """All-pairs self-accelerations via the pair-symmetric sweep.
    pos (3, N), mass (N,) -> (3, N) fp32.  N must be divisible by the block
    (``block``, else ``tile_i``, else DEFAULT_BLOCK); on CUDA the block is
    a multiple of 32, at most 256.  ``tile_j`` is accepted for
    registry-option uniformity and unused."""
    global launches
    del tile_j
    dev = pos.device
    n = pos.shape[1]
    check_input("pos", pos, (3, n), dev)
    check_input("mass", mass, (n,), dev)
    b = min(block or tile_i or DEFAULT_BLOCK, n)
    if n % b:
        raise ValueError(f"N={n} must be divisible by block={b}")
    if dev.type == "cpu":
        return accelerations_plain(pos, mass, b)
    if dev.type != "cuda":
        raise ValueError(f"sym kernel runs on cuda or cpu, not {dev}")
    refuse_autograd("sym kernel", pos, mass)
    if b % 32 or b > MAX_BLOCK:
        raise ValueError(f"block={b} must be a multiple of 32, at most {MAX_BLOCK}")
    part = torch.empty(scratch_bytes(n, b) // 4, dtype=torch.float32, device=dev)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.nbt_sym_accel(
            pos.data_ptr(), mass.data_ptr(), n, b, part.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "nbt_sym_accel")
    launches += 1
    return out


def _divide(s: torch.Tensor, gm: torch.Tensor) -> torch.Tensor:
    """a = S / (G m), zero mass giving exactly 0."""
    pos_mass = gm > 0
    return torch.where(pos_mass, s / torch.where(pos_mass, gm, 1.0), 0.0)


def two_sided_block(nt: int, ns: int, block: int = 0) -> int:
    """The block of a two-sided sweep (``block``, else DEFAULT_BLOCK, at
    most min(nt, ns)); raises unless it divides both sets, as the JAX
    package does."""
    b = min(block or DEFAULT_BLOCK, nt, ns)
    if nt % b or ns % b:
        raise ValueError(f"Nt={nt}, Ns={ns} must be divisible by block={b}")
    return b


def accelerations_two_sided_plain(pos_t: torch.Tensor, mass_t: torch.Tensor,
                                  pos_s: torch.Tensor, mass_s: torch.Tensor,
                                  block: int = DEFAULT_BLOCK
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-sided kernel's algorithm in plain PyTorch: for each target
    tile, every source tile in one broadcast block, written into the target
    partials P_t[it][jt] and the source partials P_s[jt][it], then the
    ordered sums and the divides."""
    nt, ns = pos_t.shape[1], pos_s.shape[1]
    b = two_sided_block(nt, ns, block)
    tt, ts = nt // b, ns // b
    gm_t, gm_s = mass_t * G_NEWTON, mass_s * G_NEWTON
    part_t = torch.empty((tt, ts, 3, b), dtype=pos_t.dtype, device=pos_t.device)
    part_s = torch.empty((ts, tt, 3, b), dtype=pos_t.dtype, device=pos_t.device)
    for it in range(tt):
        i0 = it * b
        d = pos_s[:, None, :] - pos_t[:, i0:i0 + b, None]  # (3, B, Ns)
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + SOFTENING_SQUARED
        inv = 1.0 / torch.sqrt(d2)
        w = (gm_t[i0:i0 + b, None] * gm_s[None, :]) * (inv * inv * inv)
        p = (d * w).reshape(3, b, ts, b)  # [c, i, jt, j]
        part_t[it] = p.sum(dim=3).permute(2, 0, 1)  # P_t[it][jt]
        part_s[:, it] = -p.sum(dim=1).permute(1, 0, 2)  # P_s[jt][it]
    s_t = part_t.sum(dim=1).permute(1, 0, 2).reshape(3, nt)
    s_s = part_s.sum(dim=1).permute(1, 0, 2).reshape(3, ns)
    return _divide(s_t, gm_t), _divide(s_s, gm_s)


def accelerations_two_sided(pos_t: torch.Tensor, mass_t: torch.Tensor,
                            pos_s: torch.Tensor, mass_s: torch.Tensor,
                            block: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Action and reaction of one targets x sources sweep: (acc_t (3,Nt),
    acc_s (3,Ns)) fp32, every cross pair computed once, mass-folded.  Nt
    and Ns must be divisible by the block (``block``, else DEFAULT_BLOCK,
    at most min(Nt, Ns)); on CUDA it is a multiple of 32, at most 256."""
    global two_sided_launches
    dev = pos_t.device
    nt, ns = pos_t.shape[1], pos_s.shape[1]
    check_input("pos_t", pos_t, (3, nt), dev)
    check_input("mass_t", mass_t, (nt,), dev)
    check_input("pos_s", pos_s, (3, ns), dev)
    check_input("mass_s", mass_s, (ns,), dev)
    b = two_sided_block(nt, ns, block)
    if dev.type == "cpu":
        return accelerations_two_sided_plain(pos_t, mass_t, pos_s, mass_s, b)
    if dev.type != "cuda":
        raise ValueError(f"two-sided kernel runs on cuda or cpu, not {dev}")
    refuse_autograd("two-sided kernel", pos_t, mass_t, pos_s, mass_s)
    if b % 32 or b > MAX_BLOCK:
        raise ValueError(f"block={b} must be a multiple of 32, at most {MAX_BLOCK}")
    n_part = 3 * nt * (ns // b)  # each side holds as many partials
    part = torch.empty(2 * n_part, dtype=torch.float32, device=dev)
    out_t = torch.empty((3, nt), dtype=torch.float32, device=dev)
    out_s = torch.empty((3, ns), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.nbt_two_sided(
            pos_t.data_ptr(), mass_t.data_ptr(), nt, pos_s.data_ptr(),
            mass_s.data_ptr(), ns, b, part.data_ptr(),
            part[n_part:].data_ptr(), out_t.data_ptr(), out_s.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "nbt_two_sided")
    two_sided_launches += 1
    return out_t, out_s

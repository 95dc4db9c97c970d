"""Kernel B: the pair-symmetric self-sweep (``csrc/sym.cu``).

Replaces ``nbody_tpu/ops/pallas_sym.py::_sym_kernel`` with
``fold_mass=True`` and its ``dist_dtype`` (f32, or the bf16 distance mode).
Each unordered B x B tile pair is computed once with the mass-folded weight
w = (G m_i)(G m_j)/(d^2+eps^2)^{3/2}; diagonal tiles take a one-sided sum;
a = S / (G m), zero mass giving 0.

On Hopper the CTAs run in no order, so the j-side reaction is kept in
deterministic per-tile-pair partials, P[it][jt] and P[jt][it], which a
second kernel adds in a fixed order (see the note in ``csrc/sym.cu``).  All
of them take ``scratch_bytes(n, block)`` = 12 N^2 / B bytes, more than the
card holds at N=1048576.  So the i tiles are swept in bands (``sym_band``):
a band of R tiles takes 12 R (2N - R B) bytes, within a scratch budget of
SCRATCH_SHARE of the device's memory (``device_budget``), and a banded
sweep equals the one-band sweep bit for bit.  Where even a one-tile band
does not fit, a ValueError names ``--kernel pallas``.  ``fits`` says whether
all the partials fit at once; the registry's ``auto`` takes the tiled
kernel where they do not.  The TPU's VMEM cap (``max_sym_n``) does not carry
over.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs ``accelerations_plain``, the same banded tile-pair algorithm in
plain PyTorch, so the CPU tests exercise the mass-folded math, the partials
and the bands.

``accelerations_two_sided`` is the targets x sources form
(``csrc/two_sided.cu``, replacing ``pallas_sym.py::_two_sided_kernel``):
each pair once, the action on the targets and the reaction on the sources,
each divided by its own G m, in bands of target tiles as well
(``two_sided_band``).  The pair-symmetric half ring of the particle
decomposition (``parallel/decompose.py``, comm ``ring_sym``) runs it.
"""

from __future__ import annotations

import os

import torch

from ..types import G_NEWTON, SOFTENING_SQUARED
from ..utils import build
from .tiled_kernel import (
    check_dist_dtype,
    check_input,
    refuse_autograd,
    round_deltas,
)

DEFAULT_BLOCK = 128
MAX_BLOCK = 256  # 8 warps of j-side partials fill 24 KB of shared memory
# The partials' budget, as a share of the device's memory; ``auto`` takes
# this kernel while all of its partials fit it.
SCRATCH_SHARE = 1 / 8
MAX_BAND = 65535  # a two-sided band is its launch grid's y extent
MAX_GRID = 2**31 - 1  # a Kernel B band's tile pairs are its grid's x extent
MAX_TARGETS = 2  # nbt::kMaxSymTargets (csrc/common.cuh)

# Kernel launches on CUDA tensors (Kernel B; the two-sided kernel);
# chip_smoke.py zeroes and reads them.
launches = 0
two_sided_launches = 0


def scratch_bytes(n: int, block: int) -> int:
    """Bytes of partials: T x T tile pairs of (3, B) fp32, T = n / B."""
    return 3 * 4 * n * (n // block)


def fits(n: int, block: int, device: torch.device) -> bool:
    """Whether the CUDA kernel takes this shape and all of its partials
    stay within SCRATCH_SHARE of the card's memory (one band)."""
    if block % 32 or block > MAX_BLOCK or n % block:
        return False
    total = torch.cuda.get_device_properties(device).total_memory
    return scratch_bytes(n, block) <= SCRATCH_SHARE * total


def device_budget(device: torch.device) -> int:
    """Bytes of partials a sweep may take on ``device``: SCRATCH_SHARE of
    the card's memory, or of the host's for the plain versions."""
    device = torch.device(device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(SCRATCH_SHARE * total)


def band_bytes(n: int, block: int, band: int) -> int:
    """Bytes of a Kernel B band of ``band`` i tiles: its rows of partials
    (band x T) and the tail it hands to later rows ((T - band) x band)."""
    t_count = n // block
    return 12 * block * band * (2 * t_count - band)


def _too_big(what: str, need: int, budget: int) -> ValueError:
    return ValueError(
        f"{what}: a band of one tile needs {need} bytes of partials, more "
        f"than the scratch budget of {budget} bytes (use --kernel pallas)")


def lane_targets(block: int, most: int = MAX_TARGETS) -> int:
    """R, the targets a lane of the pair-symmetric tile body owns at tile
    edge ``block`` (nbt::sym_targets): the largest power of two up to
    ``most`` that leaves block / R a multiple of 32."""
    r = most
    while r > 1 and block % (32 * r):
        r //= 2
    return r


def sym_band(n: int, block: int, budget: int) -> int:
    """The most i tiles a Kernel B band takes within ``budget`` bytes:
    the whole sweep (n / block) where all the partials fit, else the
    largest Q with band_bytes(n, block, Q) <= budget, and at most
    MAX_GRID // (n / block), so that a band's tile pairs (fewer than
    Q n / block) fit its launch grid; a ValueError naming ``--kernel
    pallas`` where not even one tile fits."""
    t_count = n // block
    if band_bytes(n, block, 1) > budget:
        raise _too_big(f"pallas_sym at N={n}, block={block}",
                       band_bytes(n, block, 1), budget)
    # band_bytes rises with the band
    lo, hi = 1, min(t_count, MAX_GRID // t_count)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if band_bytes(n, block, mid) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


def pair_terms(pos_i: torch.Tensor, gm_i: torch.Tensor, pos_j: torch.Tensor,
               gm_j: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """w d for every target i and body j, (3, Ni, Nj): d = r_j - r_i
    (rounded through bf16 where ``bf16``), w = (G m_i)(G m_j) /
    (|d|^2 + eps^2)^{3/2} in IEEE fp32.  A tile pair's i-side partial is
    its sum over j, its j-side partial minus its sum over i."""
    d = round_deltas(pos_j[:, None, :] - pos_i[:, :, None], bf16)
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + SOFTENING_SQUARED
    inv = 1.0 / torch.sqrt(d2)
    return d * ((gm_i[:, None] * gm_j[None, :]) * (inv * inv * inv))


def accelerations_plain(pos: torch.Tensor, mass: torch.Tensor,
                        block: int = DEFAULT_BLOCK, dist_dtype: str = "float32",
                        scratch_budget: int = 0) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch, bands and all: for each i
    tile of a band, the diagonal tile and every later tile in one broadcast
    block, written into the band's rows and tail of partials; then each
    row's running sum adds the band's columns in order, and the divide.
    ``scratch_budget``: bytes of partials (0: ``device_budget``)."""
    n = pos.shape[1]
    b = min(block, n)
    if n % b:
        raise ValueError(f"N={n} must be divisible by block={b}")
    bf16 = check_dist_dtype(dist_dtype)
    t_count = n // b
    band = sym_band(n, b, scratch_budget or device_budget(pos.device))
    gm = mass * G_NEWTON
    kw = dict(dtype=pos.dtype, device=pos.device)
    rows = torch.empty((band, t_count, 3, b), **kw)  # P[r0 + r][u]
    tail = torch.empty((t_count - band, band, 3, b), **kw)  # P[r1 + t][r0 + r]
    s = torch.zeros((t_count, 3, b), **kw)  # each row's running sum
    for r0 in range(0, t_count, band):
        r1 = min(t_count, r0 + band)
        for it in range(r0, r1):
            i0 = it * b
            p = pair_terms(pos[:, i0:i0 + b], gm[i0:i0 + b], pos[:, i0:],
                           gm[i0:], bf16).reshape(3, b, t_count - it, b)
            # p: [c, i, jt - it, j]
            rows[it - r0, it:] = p.sum(dim=3).permute(2, 0, 1)  # P[it][jt]
            # j side of the off-diagonal tiles: P[jt][it] = -sum_i w d, into
            # the band's rows for jt < r1, else into its tail.
            jside = -p[:, :, 1:].sum(dim=1).permute(1, 0, 2)
            k = r1 - it - 1
            rows[it - r0 + 1:r1 - r0, it] = jside[:k]
            tail[:t_count - r1, it - r0] = jside[k:]
        for u in range(r0, t_count):  # the band's rows: columns r0.. in order
            s[r0:r1] = s[r0:r1] + rows[:r1 - r0, u]
        for c in range(r1 - r0):  # later rows: the band's columns in order
            s[r1:] = s[r1:] + tail[:t_count - r1, c]
    return _divide(s.permute(1, 0, 2).reshape(3, n), gm)


def accelerations(pos: torch.Tensor, mass: torch.Tensor, block: int = 0,
                  tile_i: int = 0, tile_j: int = 0,
                  dist_dtype: str = "float32",
                  scratch_budget: int = 0) -> torch.Tensor:
    """All-pairs self-accelerations via the pair-symmetric sweep.
    pos (3, N), mass (N,) -> (3, N) fp32.  N must be divisible by the block
    (``block``, else ``tile_i``, else DEFAULT_BLOCK); on CUDA the block is
    a multiple of 32, at most 256.  ``tile_j`` is accepted for
    registry-option uniformity and unused.  ``dist_dtype``: "float32" or
    "bfloat16".  ``scratch_budget``: bytes of partials, which set the bands
    (0: ``device_budget``)."""
    global launches
    del tile_j
    bf16 = check_dist_dtype(dist_dtype)
    dev = pos.device
    n = pos.shape[1]
    check_input("pos", pos, (3, n), dev)
    check_input("mass", mass, (n,), dev)
    b = min(block or tile_i or DEFAULT_BLOCK, n)
    if n % b:
        raise ValueError(f"N={n} must be divisible by block={b}")
    if dev.type == "cpu":
        return accelerations_plain(pos, mass, b, dist_dtype, scratch_budget)
    if dev.type != "cuda":
        raise ValueError(f"sym kernel runs on cuda or cpu, not {dev}")
    refuse_autograd("sym kernel", pos, mass)
    if b % 32 or b > MAX_BLOCK:
        raise ValueError(f"block={b} must be a multiple of 32, at most {MAX_BLOCK}")
    band = sym_band(n, b, scratch_budget or device_budget(dev))
    part = torch.empty(band_bytes(n, b, band) // 4, dtype=torch.float32,
                       device=dev)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.nbt_sym_accel(
            pos.data_ptr(), mass.data_ptr(), n, b, band, part.data_ptr(),
            out.data_ptr(), int(bf16), torch.cuda.current_stream().cuda_stream,
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


def two_sided_band(nt: int, ns: int, block: int, budget: int) -> int:
    """The most target tiles a two-sided band takes within ``budget``
    bytes (24 R Ns for R tiles: both sides' partials), or a ValueError
    naming ``--kernel pallas`` where not even one tile fits."""
    per_tile = 24 * block * (ns // block)
    if per_tile > budget:
        raise _too_big(f"two-sided sweep at Nt={nt}, Ns={ns}, block={block}",
                       per_tile, budget)
    return min(nt // block, budget // per_tile, MAX_BAND)


def accelerations_two_sided_plain(pos_t: torch.Tensor, mass_t: torch.Tensor,
                                  pos_s: torch.Tensor, mass_s: torch.Tensor,
                                  block: int = DEFAULT_BLOCK,
                                  dist_dtype: str = "float32",
                                  scratch_budget: int = 0
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-sided kernel's algorithm in plain PyTorch, bands and all:
    for each target tile of a band, every source tile in one broadcast
    block, written into the band's target partials P_t[it][jt] and source
    partials P_s[jt][it]; then the band's targets are summed in column
    order, the sources' running sums add the band's columns in order, and
    each side is divided."""
    nt, ns = pos_t.shape[1], pos_s.shape[1]
    b = two_sided_block(nt, ns, block)
    bf16 = check_dist_dtype(dist_dtype)
    tt, ts = nt // b, ns // b
    band = two_sided_band(nt, ns, b, scratch_budget or device_budget(pos_t.device))
    gm_t, gm_s = mass_t * G_NEWTON, mass_s * G_NEWTON
    kw = dict(dtype=pos_t.dtype, device=pos_t.device)
    part_t = torch.empty((band, ts, 3, b), **kw)
    part_s = torch.empty((ts, band, 3, b), **kw)
    s_t = torch.zeros((tt, 3, b), **kw)
    s_s = torch.zeros((ts, 3, b), **kw)
    for r0 in range(0, tt, band):
        r1 = min(tt, r0 + band)
        for it in range(r0, r1):
            i0 = it * b
            p = pair_terms(pos_t[:, i0:i0 + b], gm_t[i0:i0 + b], pos_s, gm_s,
                           bf16).reshape(3, b, ts, b)  # [c, i, jt, j]
            part_t[it - r0] = p.sum(dim=3).permute(2, 0, 1)  # P_t[it][jt]
            part_s[:, it - r0] = -p.sum(dim=1).permute(1, 0, 2)  # P_s[jt][it]
        for u in range(ts):
            s_t[r0:r1] = s_t[r0:r1] + part_t[:r1 - r0, u]
        for c in range(r1 - r0):
            s_s = s_s + part_s[:, c]
    return (_divide(s_t.permute(1, 0, 2).reshape(3, nt), gm_t),
            _divide(s_s.permute(1, 0, 2).reshape(3, ns), gm_s))


def accelerations_two_sided(pos_t: torch.Tensor, mass_t: torch.Tensor,
                            pos_s: torch.Tensor, mass_s: torch.Tensor,
                            block: int = 0, dist_dtype: str = "float32",
                            scratch_budget: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Action and reaction of one targets x sources sweep: (acc_t (3,Nt),
    acc_s (3,Ns)) fp32, every cross pair computed once, mass-folded.  Nt
    and Ns must be divisible by the block (``block``, else DEFAULT_BLOCK,
    at most min(Nt, Ns)); on CUDA it is a multiple of 32, at most 256.
    ``dist_dtype`` and ``scratch_budget`` as for ``accelerations``."""
    global two_sided_launches
    bf16 = check_dist_dtype(dist_dtype)
    dev = pos_t.device
    nt, ns = pos_t.shape[1], pos_s.shape[1]
    check_input("pos_t", pos_t, (3, nt), dev)
    check_input("mass_t", mass_t, (nt,), dev)
    check_input("pos_s", pos_s, (3, ns), dev)
    check_input("mass_s", mass_s, (ns,), dev)
    b = two_sided_block(nt, ns, block)
    if dev.type == "cpu":
        return accelerations_two_sided_plain(pos_t, mass_t, pos_s, mass_s, b,
                                             dist_dtype, scratch_budget)
    if dev.type != "cuda":
        raise ValueError(f"two-sided kernel runs on cuda or cpu, not {dev}")
    refuse_autograd("two-sided kernel", pos_t, mass_t, pos_s, mass_s)
    if b % 32 or b > MAX_BLOCK:
        raise ValueError(f"block={b} must be a multiple of 32, at most {MAX_BLOCK}")
    band = two_sided_band(nt, ns, b, scratch_budget or device_budget(dev))
    n_part = 3 * b * band * (ns // b)  # each side holds as many partials
    part = torch.empty(2 * n_part, dtype=torch.float32, device=dev)
    out_t = torch.empty((3, nt), dtype=torch.float32, device=dev)
    out_s = torch.empty((3, ns), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.nbt_two_sided(
            pos_t.data_ptr(), mass_t.data_ptr(), nt, pos_s.data_ptr(),
            mass_s.data_ptr(), ns, b, band, part.data_ptr(),
            part[n_part:].data_ptr(), out_t.data_ptr(), out_s.data_ptr(),
            int(bf16), torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "nbt_two_sided")
    two_sided_launches += 1
    return out_t, out_s

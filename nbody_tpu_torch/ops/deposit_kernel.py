"""The CIC mass deposit in 64-bit fixed point (``csrc/deposit.cu``) and its
plain version.

No Pallas kernel is replaced: the JAX package deposits with an XLA
scatter-add.  ``ops/pm.py``'s ``_deposit`` and ``_deposit_periodic`` call
``deposit`` on a CUDA tensor that autograd does not record, in place of
``_scatter``'s accumulating ``index_put_``; on the CPU, and wherever an
input requires grad, they keep ``_scatter``.

The deposit takes each body's 8 corner contributions m ((wx wy) wz) exactly
as ``_scatter`` forms them (``pm._cic_weights`` or
``pm._cic_weights_periodic``, then ``pm._corner_iter``), scales them by
S = 2^61 / sum |m|, rounds each to an int64 (round half to even) and sums
them per cell as integers, so the sum does not depend on the order of the
bodies.  Each cell is then float32(float64(acc) / S): the float64 sum of
``_scatter``'s float32 contributions, up to 2^-62 sum |m| a contribution,
rounded once to float32.  sum |m| is exact: the masses' significands are
summed as integers in one bin an exponent, and the bins are added in
float64 in one fixed tree order (``_mass_scale``).  A non-finite position,
mass (or open box) gives a grid of NaN; masses that are all 0 give zeros.

On a CUDA tensor ``deposit`` launches the hand kernel or raises; on a CPU
tensor it runs ``deposit_plain``, the same function in plain PyTorch,
which equals the kernel bit for bit.  Design and bound: see the note at
the top of ``csrc/deposit.cu``.
"""

from __future__ import annotations

import math

import torch

from ..utils import build
from . import pm
from .tiled_kernel import check_input, refuse_autograd

# Kernel calls on CUDA tensors (four launches each: zero, masses, deposit,
# convert); chip_smoke.py and scripts/torch_profile.py zero and read it.
launches = 0

# The fixed-point scale is 2^SCALE_BITS / sum |m|: every cell's |sum| stays
# below 2^62.
SCALE_BITS = 61
_BINS = 256  # float32 exponents


def _mass_scale(mass: torch.Tensor) -> float:
    """S = 2^61 / sum |m| as a Python float (0.0 when every mass is 0), as
    ``deposit_mass_kernel`` computes it: each finite |m|'s 24-bit
    significand summed as an int64 in the bin of its exponent, bin e worth
    2^(max(e, 1) - 150) a unit, the bins added in float64 in the kernel's
    tree order (bin t + bin t + s, s = 128, 64, ..., 1).  Reads the bins on
    the host."""
    bits = mass.abs().view(torch.int32).long()
    exp = bits >> 23
    sig = (bits & 0x7FFFFF) | ((exp > 0).long() << 23)
    ok = exp < 255
    bins = torch.zeros(_BINS, dtype=torch.int64, device=mass.device)
    bins.index_add_(0, exp[ok], sig[ok])
    sums = [float(b) * 2.0 ** (max(e, 1) - 150)
            for e, b in enumerate(bins.tolist())]
    s = _BINS // 2
    while s:
        for t in range(s):
            sums[t] = sums[t] + sums[t + s]
        s //= 2
    return 2.0 ** SCALE_BITS / sums[0] if sums[0] > 0 else 0.0


def _corners(pos, ng: int, lo=None, inv_h=None, box=None):
    """``_scatter``'s (flat index, weight) pairs of the open (``lo``,
    ``inv_h``) or the periodic (``box``) grid."""
    if box is None:
        return pm._corner_iter(*pm._cic_weights(pos, lo, inv_h, ng), ng)
    return pm._periodic_corners(pos, box, ng)


def deposit_plain(pos, mass, ng: int, lo=None, inv_h=None, box=None):
    """``csrc/deposit.cu`` in plain PyTorch: the same fp32 contributions as
    ``pm._scatter``, int64 ``index_add_`` of the same rounded values, the
    same conversion.  Reads on the host; the tests' and chip_smoke.py's
    oracle, bit for bit."""
    grid = torch.zeros(ng ** 3, dtype=torch.float32, device=pos.device)
    box_args = (lo, inv_h) if box is None else ()
    if not all(bool(torch.isfinite(t).all()) for t in (pos, mass, *box_args)):
        return grid.fill_(float("nan")).view(ng, ng, ng)
    scale = _mass_scale(mass)
    if scale == 0.0:
        return grid.view(ng, ng, ng)
    s = torch.tensor(scale, dtype=torch.float64, device=pos.device)
    acc = torch.zeros(ng ** 3, dtype=torch.int64, device=pos.device)
    for flat, w in _corners(pos, ng, lo, inv_h, box):
        q = torch.round((mass * w).double() * s).long()
        acc.index_add_(0, flat.long(), q)
    # A tensor divisor: a true division on the card too.
    grid = torch.where(acc != 0, (acc.double() / s).float(), 0.0)
    return grid.view(ng, ng, ng)


def deposit(pos, mass, ng: int, lo=None, inv_h=None, box=None):
    """The CIC deposit of ``mass`` (N,) at ``pos`` (3, N), fp32, onto the
    (ng, ng, ng) fp32 grid: open with the grid's origin ``lo`` and inverse
    spacing ``inv_h`` ((3, 1) fp32 on the same device), or periodic with
    the box edge ``box`` (a positive float), corners wrapped."""
    global launches
    dev = pos.device
    n = pos.shape[1] if pos.dim() == 2 else -1
    check_input("pos", pos, (3, n), dev)
    check_input("mass", mass, (n,), dev)
    if (lo is not None and inv_h is not None) == (box is not None):
        raise ValueError("give lo and inv_h (open) or box (periodic)")
    if box is None:
        check_input("lo", lo, (3, 1), dev)
        check_input("inv_h", inv_h, (3, 1), dev)
    elif not 0.0 < float(box) < math.inf:
        raise ValueError(f"box={box} must be positive and finite")
    if ng < 2:
        raise ValueError(f"ng={ng} must be at least 2")
    if dev.type == "cpu":
        return deposit_plain(pos, mass, ng, lo, inv_h, box)
    if dev.type != "cuda":
        raise ValueError(f"deposit kernel runs on cuda or cpu, not {dev}")
    refuse_autograd("deposit kernel", pos, mass,
                    *(() if box is not None else (lo, inv_h)))
    lib = build.library()
    scratch = torch.empty(ng ** 3 + lib.nbt_deposit_header(),
                          dtype=torch.int64, device=dev)
    out = torch.empty((ng, ng, ng), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.nbt_deposit(
            pos.data_ptr(), mass.data_ptr(), n,
            0 if box is not None else lo.data_ptr(),
            0 if box is not None else inv_h.data_ptr(),
            0.0 if box is None else float(box), ng, scratch.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "nbt_deposit")
    launches += 1
    return out

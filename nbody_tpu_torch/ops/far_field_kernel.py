"""The open boundary's far field in two hand kernels (``csrc/far_field.cu``)
and its plain version.

No Pallas kernel is replaced: the JAX package computes the far field with
XLA ops (``_outlier_moments``, ``_monopole``).  ``ops/pm.py`` calls
``moments`` from ``_outlier_moments`` and ``monopoles`` from ``_monopole``
on CUDA tensors that autograd does not record, in place of its chain of
about 200 small kernels; on the CPU, and wherever an input requires grad,
it keeps the chain.

``moments`` writes one (9, 4) float32 table: row 0 the in-box mass, row
1 + k the out-of-box mass of octant k around the box centre (k = 4 sx + 2
sy + sz, s the side of ``pos > 0.5 (lo_box + hi_box)``); columns M, then
the centre of mass S / max(M, 1e-30).  The sums are taken in float64, in a
fixed order on the card, so the table repeats bit for bit; a non-finite
position, mass or in-box mass makes every entry NaN.  ``monopoles`` is the
target pass: targets whose in-box mask is not positive take row 0's
monopole in place of ``acc``, then every target adds rows 1-8's, in that
order, each through ``pm._monopole``'s arithmetic; given the same table it
equals the chain bit for bit.

On a CUDA tensor ``moments`` and ``monopoles`` launch the kernels or raise;
on a CPU tensor they run ``moments_plain`` and ``monopoles_plain``, the same
functions in plain PyTorch (the moments' float64 sums in another order, so
within one float32 rounding of the kernel's table).  Design and bound: see
the note at the top of ``csrc/far_field.cu``.
"""

from __future__ import annotations

import torch

from ..utils import build
from . import pm
from .tiled_kernel import check_input, refuse_autograd

# Target-pass launches on CUDA tensors: one a force call that took the
# kernels (the moments add a memset and one launch before it);
# chip_smoke.py and scripts/torch_profile.py zero and read it.
launches = 0

_TABLE = (9, 4)


def moments_plain(pos, mass, m_in, lo_box, hi_box):
    """``far_field_moments_kernel`` in plain PyTorch: the (9, 4) float32
    table, its sums in float64.  Reads on the host."""
    n = pos.shape[1]
    table = torch.empty(_TABLE, dtype=torch.float32, device=pos.device)
    if not all(bool(torch.isfinite(t).all()) for t in (pos, mass, m_in)):
        return table.fill_(float("nan"))
    side = (pos > 0.5 * (lo_box + hi_box)).long()
    octant = side[0] * 4 + side[1] * 2 + side[2]
    w = torch.zeros((9, n), dtype=torch.float64, device=pos.device)
    w[0] = m_in.double()
    w[1 + octant, torch.arange(n, device=pos.device)] = (mass - m_in).double()
    big_m = w.sum(dim=1)
    com = (w @ pos.double().T) / big_m.clamp_min(1e-30)[:, None]
    return torch.cat([big_m[:, None], com], dim=1).float()


def monopoles_plain(tgt, table, acc, in_tgt):
    """``far_field_monopoles_kernel`` in plain PyTorch: the solver's chain
    (``pm._monopoles``) on the table's rows."""
    return pm._monopoles(acc, tgt, in_tgt, pm._table_moments(table))


def far_field_plain(pos, mass, m_in, lo_box, hi_box, tgt, in_tgt, acc):
    """The whole far field in plain PyTorch: ``acc`` (3, Nt) with the
    monopoles of ``moments_plain``'s table."""
    return monopoles_plain(tgt, moments_plain(pos, mass, m_in, lo_box, hi_box),
                           acc, in_tgt)


def _device(*tensors):
    """The tensors' device: the plain versions' for the CPU, the kernels'
    for CUDA (autograd refused), else a ValueError."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"far-field kernels run on cuda or cpu, not {dev}")
    if dev.type == "cuda":
        refuse_autograd("far-field kernel", *tensors)
    return dev


def moments(pos, mass, m_in, lo_box, hi_box):
    """The (9, 4) float32 moments table of the sources: ``pos`` (3, N),
    ``mass`` and the in-box masses ``m_in`` (N,), the box corners
    ``lo_box``, ``hi_box`` (3, 1), float32 on one device."""
    dev = pos.device
    n = pos.shape[1] if pos.dim() == 2 else -1
    check_input("pos", pos, (3, n), dev)
    check_input("mass", mass, (n,), dev)
    check_input("m_in", m_in, (n,), dev)
    check_input("lo_box", lo_box, (3, 1), dev)
    check_input("hi_box", hi_box, (3, 1), dev)
    if _device(pos, mass, m_in, lo_box, hi_box).type == "cpu":
        return moments_plain(pos, mass, m_in, lo_box, hi_box)
    lib = build.library()
    scratch = torch.empty(lib.nbt_far_field_scratch(), dtype=torch.float64,
                          device=dev)
    table = torch.empty(_TABLE, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.nbt_far_field_moments(
            pos.data_ptr(), mass.data_ptr(), m_in.data_ptr(), n,
            lo_box.data_ptr(), hi_box.data_ptr(), scratch.data_ptr(),
            table.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "nbt_far_field_moments")
    return table


def monopoles(tgt, table, acc, in_tgt):
    """``acc`` (3, Nt) with the far field of ``table`` (``moments``) at the
    targets ``tgt`` (3, Nt), ``in_tgt`` (Nt,) their in-box mask; float32 on
    one device, written out of place."""
    global launches
    dev = tgt.device
    n = tgt.shape[1] if tgt.dim() == 2 else -1
    check_input("tgt", tgt, (3, n), dev)
    check_input("table", table, _TABLE, dev)
    check_input("acc", acc, (3, n), dev)
    check_input("in_tgt", in_tgt, (n,), dev)
    if _device(tgt, table, acc, in_tgt).type == "cpu":
        return monopoles_plain(tgt, table, acc, in_tgt)
    lib = build.library()
    out = torch.empty_like(acc)
    with torch.cuda.device(dev):
        err = lib.nbt_far_field_monopoles(
            tgt.data_ptr(), in_tgt.data_ptr(), acc.data_ptr(),
            table.data_ptr(), n, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "nbt_far_field_monopoles")
    launches += 1
    return out

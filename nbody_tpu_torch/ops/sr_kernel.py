"""The P3M short-range sweep (``csrc/sr.cu``) and its plain version.

Replaces ``nbody_tpu/ops/pm.py::_sr_sweep_pallas`` (the inner ``kern``).
The sweep runs a t-major worklist of (target slab t, source slab or row s)
entries over the packed slab tables of ``ops/pm._sr_pack`` and accumulates,
for every target slot i of slab t,

    a_i += sum_j m_j d (|d|^2 + eps^2)^{-3/2} (1 - S(|d|^2 / rc2)),

d = r_j - r_i, over the 64 slots j of slab s, or the 128 slots of row s
(slabs 2s and 2s+1) with ``paired``.  ``symmetric`` worklists hold only
s >= t and each entry also adds the reaction -sum_i m_i (same weight) d to
the source; it is skipped on the diagonal (s == t), and with ``paired``
per-slot slab masks keep slab >= t in the forward sum and slab > t in the
reaction.  Only entries in ``[bounds[0], bounds[1])`` run; the sentinel
slab's output is zeroed.  Slots that hold no particle may come out as
garbage (the JAX package's EMPTY-SLOT CONTRACT): callers gather only
occupied slots.

On a CUDA tensor ``sweep`` launches the hand kernel in every layout, or
raises; on a CPU tensor it runs ``sweep_plain``, the same function in plain
PyTorch.  Design and bound: see the note at the top of ``csrc/sr.cu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..types import SOFTENING_SQUARED
from ..utils import build
from .pm import SLAB, _taper
from .tiled_kernel import check_input, refuse_autograd

# Kernel launches on CUDA tensors; chip_smoke.py zeroes and reads it.
launches = 0


def _check_index(name: str, t: torch.Tensor, shape: tuple,
                 device: torch.device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def scratch_floats(nslots: int, e_max: int, unit: int) -> int:
    """Floats of ``csrc/sr.cu``'s scratch: the packed (x, y, z, m) table,
    padded to whole 128-slot rows, then a head and a tail partial (3 x 64)
    for each unit of ``unit`` worklist entries."""
    return 4 * (-(-nslots // 128) * 128) + 2 * 3 * SLAB * -(-e_max // unit)


def packed_table(ptab: torch.Tensor, mtab: torch.Tensor) -> torch.Tensor:
    """``csrc/sr.cu``'s packed table: (x, y, z, m) of every slot as rows of
    an (npad, 4) tensor, zero past nslots up to whole 128-slot rows."""
    nslots = ptab.shape[1]
    tab = torch.zeros((-(-nslots // 128) * 128, 4), dtype=ptab.dtype,
                      device=ptab.device)
    tab[:nslots, :3] = ptab.t()
    tab[:nslots, 3] = mtab
    return tab


def split_order(slabs: torch.Tensor) -> torch.Tensor:
    """The kernel's split of each slab's 64 targets into two compact warps.

    ``slabs`` (nslab, 64, 4) of packed slots -> (nslab, 64) int64: thread k
    of the group (lane k % 32 of warp k // 32) takes the slot ``order[k]``:
    the slots sorted along the slab's longest axis (the first of equal
    extents), ties by slot, as the kernel ranks them."""
    xyz = slabs[..., :3]
    axis = (xyz.amax(dim=1) - xyz.amin(dim=1)).argmax(dim=1)
    key = xyz.gather(2, axis[:, None, None].expand(-1, SLAB, 1))[..., 0]
    return torch.sort(key, dim=1, stable=True).indices


def skip_counts(ptab, mtab, wl_t, wl_s, bounds, rc2, symmetric: bool = False,
                paired: bool = False, chunk: int = 256,
                entries: torch.Tensor | None = None) -> dict:
    """The work of ``csrc/sr.cu``'s schedule: its (warp, source) steps and
    how many of them its warp-uniform skip takes (every pair of the step
    beyond the cutoff), counted in plain PyTorch on the tables' device.

    A forward step is one source against a warp's 32 targets (the slab
    split by ``split_order``); a step of the reaction's rotation pairs lane
    l with source (l + k) mod 32 of a 32-wide subtile; masked subtiles of
    ``pallas_paired_sym`` take no step.  q = |d|^2 / rc2 is rounded once an
    operation here, where the kernel fuses multiply-adds, so a pair on the
    cutoff may fall the other way.  ``entries`` (int64) counts those
    worklist entries instead of all in ``bounds``.  Returns ``{"steps",
    "skipped", "pairs", "inside"}``: steps, skipped steps, pairs evaluated
    and pairs inside the cutoff, as ints."""
    width = 2 * SLAB if paired else SLAB
    tab = packed_table(ptab, mtab)
    nslab = ptab.shape[1] // SLAB
    order = split_order(tab[:nslab * SLAB].view(nslab, SLAB, 4))
    inv_rc2 = 1.0 / rc2
    if entries is None:
        lo, hi = max(int(bounds[0]), 0), min(int(bounds[1]), wl_t.shape[0])
        entries = torch.arange(lo, hi, device=wl_t.device)
    lane = torch.arange(32, device=tab.device)
    rot = (lane[:, None] + lane[None, :]) % 32  # [lane, step] -> source
    out = dict(steps=0, skipped=0, pairs=0, inside=0)
    for c0 in range(0, entries.shape[0], chunk):
        idx = entries[c0:c0 + chunk]
        te, se = wl_t[idx].long(), wl_s[idx].long()
        tg = tab.view(-1, SLAB, 4)[te].gather(
            1, order[te][..., None].expand(-1, -1, 4))
        d = tab.view(-1, width, 4)[se][:, None, :, :3] - tg[:, :, None, :3]
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        beyond = (r2 * inv_rc2 >= 1.0).view(-1, 2, 32, width)
        for u in range(width // 32):
            sub = beyond[..., 32 * u:32 * u + 32]  # (E, warp, lane, source)
            both = torch.zeros_like(te, dtype=torch.bool)
            live = torch.ones_like(both)
            if symmetric:
                slab = 2 * se + u // 2 if paired else se
                live = slab >= te if paired else live
                both = slab > te if paired else se != te
            fwd_skip = sub.all(dim=2)  # a broadcast step: one source
            rot_skip = sub.gather(3, rot.expand(*sub.shape[:2], 32, 32)).all(
                dim=2)  # a rotation step: lane l, source (l + k) mod 32
            skip = torch.where(both[:, None, None], rot_skip, fwd_skip)
            out["steps"] += int(live.sum()) * 2 * 32
            out["skipped"] += int((skip & live[:, None, None]).sum())
            out["pairs"] += int(live.sum()) * SLAB * 32
            out["inside"] += int((~sub & live[:, None, None, None]).sum())
    return out


def sweep_plain(ptab, mtab, wl_t, wl_s, bounds, rc2, symmetric: bool = False,
                paired: bool = False, chunk: int = 256) -> torch.Tensor:
    """The sweep in plain PyTorch: ``chunk`` entries at a time as dense
    (chunk, 64, width) pair blocks, scatter-added per slab or row.  The
    unpaired layouts are the JAX package's ``_sr_sweep``; the paired ones
    follow ``_sr_sweep_pallas``.  Reads ``bounds`` on the host.
    Returns the (3, nslots) accumulator table."""
    nslots = ptab.shape[1]
    width = 2 * SLAB if paired else SLAB
    if paired and (nslots // SLAB) % 2:  # pair the slabs up into full rows
        ptab = F.pad(ptab, (0, SLAB))
        mtab = F.pad(mtab, (0, SLAB))
    p_src = ptab.reshape(3, -1, width)
    m_src = mtab.reshape(-1, width)
    p_tgt = ptab.reshape(3, -1, SLAB)
    m_tgt = mtab.reshape(-1, SLAB)
    atab = torch.zeros_like(ptab)
    a_tgt = atab.view(3, -1, SLAB)
    a_src = atab.view(3, -1, width)
    e_max = wl_t.shape[0]
    lo, hi = max(int(bounds[0]), 0), min(int(bounds[1]), e_max)
    lane_hi = (torch.arange(width, device=ptab.device) >= SLAB).to(torch.int64)
    for c0 in range(lo, hi, chunk):
        te = wl_t[c0:min(c0 + chunk, hi)].long()
        se = wl_s[c0:min(c0 + chunk, hi)].long()
        pt = p_tgt[:, te]  # (3, w, SLAB)
        d = p_src[:, se][:, :, None, :] - pt[:, :, :, None]  # (3, w, SLAB, width)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        u = torch.rsqrt(r2 + SOFTENING_SQUARED)
        w0 = (1.0 - _taper(r2 / rc2)) * (u * u * u)
        if symmetric and paired:
            lane_slab = 2 * se[:, None] + lane_hi[None, :]  # (w, width)
            w0 = w0 * (lane_slab >= te[:, None]).to(w0.dtype)[:, None, :]
        a_tgt.index_add_(1, te, (d * (m_src[se][:, None, :] * w0)).sum(dim=3))
        if symmetric:
            wr = m_tgt[te][:, :, None] * w0
            if paired:
                wr = wr * (lane_slab > te[:, None]).to(w0.dtype)[:, None, :]
            else:
                wr = wr * (se != te).to(w0.dtype)[:, None, None]
            a_src.index_add_(1, se, -(d * wr).sum(dim=2))
    atab = atab[:, :nslots].clone()
    atab[:, nslots - SLAB:] = 0.0
    return atab


def sweep(ptab, mtab, wl_t, wl_s, bounds, rc2, symmetric: bool = False,
          paired: bool = False) -> torch.Tensor:
    """The short-range sweep.  ptab (3, nslots) and mtab (nslots,) f32,
    wl_t and wl_s (e_max,) int32, bounds (2,) int32 and rc2 () f32, all on
    one device -> (3, nslots) f32."""
    global launches
    dev = ptab.device
    nslots = ptab.shape[1]
    e_max = wl_t.shape[0]
    check_input("ptab", ptab, (3, nslots), dev)
    check_input("mtab", mtab, (nslots,), dev)
    check_input("rc2", rc2, (), dev)
    _check_index("wl_t", wl_t, (e_max,), dev)
    _check_index("wl_s", wl_s, (e_max,), dev)
    _check_index("bounds", bounds, (2,), dev)
    if nslots % SLAB or nslots == 0:
        raise ValueError(f"nslots={nslots} must be a positive multiple of {SLAB}")
    if dev.type == "cpu":
        return sweep_plain(ptab, mtab, wl_t, wl_s, bounds, rc2,
                           symmetric=symmetric, paired=paired)
    if dev.type != "cuda":
        raise ValueError(f"sr kernel runs on cuda or cpu, not {dev}")
    refuse_autograd("sr kernel", ptab, mtab, rc2)
    fwd = torch.zeros((3, nslots), dtype=torch.float32, device=dev)
    react = torch.zeros_like(fwd) if symmetric else fwd
    if e_max:
        lib = build.library()
        scratch = torch.empty(scratch_floats(nslots, e_max, lib.nbt_sr_unit()),
                              dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = lib.nbt_sr_sweep(
                ptab.data_ptr(), mtab.data_ptr(), nslots, wl_t.data_ptr(),
                wl_s.data_ptr(), e_max, bounds.data_ptr(), rc2.data_ptr(),
                fwd.data_ptr(), react.data_ptr(), scratch.data_ptr(),
                int(symmetric), int(paired),
                torch.cuda.current_stream().cuda_stream)
        build.check(err, "nbt_sr_sweep")
        launches += 1  # one a sweep: its pack, pairs and finalize kernels
    out = fwd + react if symmetric else fwd
    out[:, nslots - SLAB:] = 0.0
    return out

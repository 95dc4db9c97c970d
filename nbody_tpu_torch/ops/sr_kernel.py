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

The sweep's backward, for the two unpaired layouts (paired rows are never
differentiated, as in the JAX package): ``sweep_vjp`` launches the hand
kernel of ``csrc/sr_vjp.cu`` on a CUDA tensor, or raises, and runs
``sweep_vjp_plain`` on a CPU tensor.  ``sweep_ad`` is the differentiable
sweep, a ``torch.autograd.Function`` with ``sweep`` as its forward and the
VJP as its backward: the port of the JAX package's ``_sr_sweep_pallas_ad``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..types import SOFTENING_SQUARED
from ..utils import build, spans
from .pm import SLAB, _taper
from .tiled_kernel import check_input, refuse_autograd

# Kernel launches on CUDA tensors; chip_smoke.py zeroes and reads them:
# the forward sweep's, and its VJP's.
launches = 0
vjp_launches = 0


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


def kernel_q(d: torch.Tensor, inv_rc2) -> torch.Tensor:
    """q of the pairs ``d`` (..., 3) as the kernels' ``nbt::sr_dist`` takes
    it, one rounding an operation: d2 = ((dx^2 + eps^2) + dy^2) + dz^2 and
    q = d2 / rc2 - eps^2 / rc2."""
    d2 = ((d[..., 0] * d[..., 0] + SOFTENING_SQUARED) + d[..., 1] * d[..., 1]
          ) + d[..., 2] * d[..., 2]
    return d2 * inv_rc2 + (-SOFTENING_SQUARED * inv_rc2)


def vjp_skip_counts(ptab, mtab, wl_t, wl_s, bounds, rc2, chunk: int = 256,
                    entries: torch.Tensor | None = None) -> dict:
    """The work of ``csrc/sr_vjp.cu``'s two passes over the unpaired
    worklist, counted in plain PyTorch on the tables' device: each entry
    takes 2 x 64 (warp, other) steps a pass, a warp being 32 slots of the
    owner slab as ``split_order`` splits it (the target pass's owner is the
    entry's target slab, the source pass's its source slab) and the other one
    slot of the other slab, every lane on it.  A step is skipped when q >= 1
    on every lane (the box ballot drops a subset of these, the vote the
    rest), q as the kernel takes it (``kernel_q``).  ``entries`` (int64)
    counts those worklist entries instead of all in ``bounds``.  Returns
    ``{"steps", "target", "source", "pairs", "inside"}``: the steps a pass,
    each pass's skipped steps, the pairs evaluated and those with q < 1, as
    ints."""
    tab = packed_table(ptab, mtab)
    nslab = ptab.shape[1] // SLAB
    slabs = tab[:nslab * SLAB].view(nslab, SLAB, 4)
    split = slabs.gather(1, split_order(slabs)[..., None].expand(-1, -1, 4))
    inv_rc2 = 1.0 / rc2
    if entries is None:
        lo, hi = max(int(bounds[0]), 0), min(int(bounds[1]), wl_t.shape[0])
        entries = torch.arange(lo, hi, device=wl_t.device)
    out = dict(steps=0, target=0, source=0, pairs=0, inside=0)
    for c0 in range(0, entries.shape[0], chunk):
        idx = entries[c0:c0 + chunk]
        te, se = split[wl_t[idx].long()], split[wl_s[idx].long()]
        beyond = kernel_q(se[:, None, :, :3] - te[:, :, None, :3],
                          inv_rc2) >= 1.0  # (E, target, source)
        n = idx.shape[0]
        out["steps"] += n * 2 * SLAB
        out["target"] += int(beyond.view(n, 2, 32, SLAB).all(dim=2).sum())
        out["source"] += int(beyond.view(n, SLAB, 2, 32).all(dim=3).sum())
        out["pairs"] += beyond.numel()
        out["inside"] += int((~beyond).sum())
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


def _vjp_pair_terms(d, r2, rc2):
    """The pair weight and its derivatives: w = (1 - S(q)) u^3, w' = dw/dr2
    and k = dw/drc2, u = (r2 + eps^2)^(-1/2), q = r2 / rc2 clamped to [0, 1]
    (S'(q) = 30 q^2 (1 - q)^2, 0 outside).  Every term is exactly 0 beyond
    the cutoff."""
    u = torch.rsqrt(r2 + SOFTENING_SQUARED)
    u3 = u * u * u
    q = (r2 / rc2).clamp(0.0, 1.0)
    keep = 1.0 - _taper(r2 / rc2)
    ds = 30.0 * (q * (1.0 - q)) ** 2  # S'(q)
    w = keep * u3
    dw = -1.5 * (w * (u * u)) - u3 * ds / rc2
    return w, dw, u3 * ds * q / rc2


def sweep_vjp_plain(ptab, mtab, wl_t, wl_s, bounds, rc2, g,
                    symmetric: bool = False, chunk: int = 256) -> tuple:
    """The VJP of the unpaired sweep (``sweep_plain`` with ``paired``
    False) in plain PyTorch, for the output cotangent ``g`` (3, nslots):
    ``(gp (3, nslots), gm (nslots,), grc2 ())``.

    For an entry (t, s), target slot i of slab t and source slot j of slab
    s, d = p_j - p_i, the forward adds m_j w d to a_i and, in the symmetric
    layout off the diagonal (s != t), -m_i w d to a_j.  With h = m_j g_i
    (minus m_i g_j with the reaction), the pair gives

        gp_j += V,  gp_i -= V,  V = w h + 2 w' (h . d) d,
        gm_j += w (g_i . d),  gm_i -= w (g_j . d) (reaction),
        grc2 += k (h . d).

    The sentinel slab's output is zeroed in the forward, so its cotangent is
    zeroed here.  Each chunk's dense (chunk, 64, 64) pair block is
    recomputed, as ``ops/grad.force_vjp`` does, so only the tables are held.
    Reads ``bounds`` on the host.  The kernel's oracle."""
    nslots = ptab.shape[1]
    g = g.clone()
    g[:, nslots - SLAB:] = 0.0
    p = ptab.reshape(3, -1, SLAB)
    m = mtab.reshape(-1, SLAB)
    gg = g.reshape(3, -1, SLAB)
    gp = torch.zeros_like(ptab)
    gm = torch.zeros_like(mtab)
    gp_s, gm_s = gp.view(3, -1, SLAB), gm.view(-1, SLAB)
    grc2 = torch.zeros((), dtype=ptab.dtype, device=ptab.device)
    e_max = wl_t.shape[0]
    lo, hi = max(int(bounds[0]), 0), min(int(bounds[1]), e_max)
    for c0 in range(lo, hi, chunk):
        te = wl_t[c0:min(c0 + chunk, hi)].long()
        se = wl_s[c0:min(c0 + chunk, hi)].long()
        d = p[:, se][:, :, None, :] - p[:, te][:, :, :, None]  # (3, w, i, j)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        w, dw, k = _vjp_pair_terms(d, r2, rc2)
        g_i = gg[:, te][:, :, :, None]
        h = m[se][None, :, None, :] * g_i
        if symmetric:
            g_j = gg[:, se][:, :, None, :]
            off = (se != te).to(w.dtype)[:, None, None]  # the reaction's entries
            h = h - (m[te][:, :, None] * off) * g_j
            gm_s.index_add_(0, te, -(off * w * (g_j * d).sum(dim=0)).sum(dim=2))
        hd = (h * d).sum(dim=0)
        v = w * h + (2.0 * dw * hd) * d
        gp_s.index_add_(1, te, -v.sum(dim=3))
        gp_s.index_add_(1, se, v.sum(dim=2))
        gm_s.index_add_(0, se, (w * (g_i * d).sum(dim=0)).sum(dim=1))
        grc2 = grc2 + (k * hd).sum()
    return gp, gm, grc2


def band_order(wl, bounds, nslab: int) -> tuple:
    """The order of the VJP kernel's source pass: ``(perm, start)``, int32,
    where the live entries (those in [bounds[0], bounds[1])) whose slab in
    ``wl`` is q are ``perm[start[q]:start[q + 1]]`` in worklist order (a
    stable sort of the slabs, dead entries keyed past the last slab), so
    ``start[nslab]`` counts the live entries.  On the tables' device, with
    no host sync."""
    idx = torch.arange(wl.shape[0], dtype=torch.int32, device=wl.device)
    live = (idx >= bounds[0]) & (idx < bounds[1])
    key = torch.where(live, wl, nslab)
    ordered, perm = torch.sort(key, stable=True)
    start = torch.searchsorted(
        ordered, torch.arange(nslab + 1, dtype=torch.int32,
                              device=wl.device), out_int32=True)
    return perm.to(torch.int32), start


def vjp_scratch_floats(nslots: int, e_max: int, unit: int) -> int:
    """Floats of ``csrc/sr_vjp.cu``'s scratch: the (x, y, z, m) and (g, 0)
    tables and both sides' sums (8 + 5 + 4 a slot), then a head and a tail
    partial ((5 + 4) x 64) for each unit of ``unit`` positions."""
    return 17 * nslots + 2 * (5 + 4) * SLAB * -(-e_max // unit)


def launch_vjp(lib, ptab, mtab, wl_t, wl_s, bounds, rc2, g,
               symmetric: bool) -> tuple:
    """One call of ``csrc/sr_vjp.cu``'s kernels from the loaded library
    ``lib`` on CUDA tensors, on the current stream: ``(gp, gm, grc2)``.
    ``sweep_vjp`` makes it with the package's library after checking its
    inputs; ``scripts/sr_launch_shapes.py`` with copies of the source built
    at other launch shapes."""
    dev = ptab.device
    nslots, e_max = ptab.shape[1], wl_t.shape[0]
    gp = torch.empty((3, nslots), dtype=torch.float32, device=dev)
    gm = torch.empty((nslots,), dtype=torch.float32, device=dev)
    grc2 = torch.empty((), dtype=torch.float32, device=dev)
    perm, start = band_order(wl_s, bounds, nslots // SLAB)
    scratch = torch.empty(vjp_scratch_floats(nslots, e_max,
                                             lib.nbt_sr_vjp_unit()),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.nbt_sr_vjp(
            ptab.data_ptr(), mtab.data_ptr(), g.data_ptr(), nslots,
            wl_t.data_ptr(), wl_s.data_ptr(), e_max, bounds.data_ptr(),
            perm.data_ptr(), start.data_ptr(), rc2.data_ptr(), int(symmetric),
            gp.data_ptr(), gm.data_ptr(), grc2.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "nbt_sr_vjp")
    return gp, gm, grc2


def sweep_vjp(ptab, mtab, wl_t, wl_s, bounds, rc2, g,
              symmetric: bool = False) -> tuple:
    """The VJP of the unpaired sweep: the cotangent ``g`` (3, nslots) of
    its output -> ``(gp (3, nslots), gm (nslots,), grc2 ())``, f32, as
    ``sweep_vjp_plain``."""
    global vjp_launches
    dev = ptab.device
    nslots = ptab.shape[1]
    e_max = wl_t.shape[0]
    check_input("ptab", ptab, (3, nslots), dev)
    check_input("mtab", mtab, (nslots,), dev)
    check_input("rc2", rc2, (), dev)
    check_input("g", g, (3, nslots), dev)
    _check_index("wl_t", wl_t, (e_max,), dev)
    _check_index("wl_s", wl_s, (e_max,), dev)
    _check_index("bounds", bounds, (2,), dev)
    if nslots % SLAB or nslots == 0:
        raise ValueError(f"nslots={nslots} must be a positive multiple of {SLAB}")
    if dev.type == "cpu":
        return sweep_vjp_plain(ptab, mtab, wl_t, wl_s, bounds, rc2, g,
                               symmetric=symmetric)
    if dev.type != "cuda":
        raise ValueError(f"sr vjp kernel runs on cuda or cpu, not {dev}")
    refuse_autograd("sr vjp kernel", ptab, mtab, rc2, g)
    out = launch_vjp(build.library(), ptab, mtab, wl_t, wl_s, bounds, rc2, g,
                     symmetric)
    vjp_launches += 1  # one a call: its pack, passes, finalizes and finish
    return out


class _SweepPlainVJP(torch.autograd.Function):
    """atab = sweep(...) of an unpaired layout, with ``sweep_vjp_plain``
    as its backward (cotangents for ptab, mtab and rc2)."""

    @staticmethod
    def forward(ctx, ptab, mtab, rc2, wl_t, wl_s, bounds, symmetric):
        with torch.no_grad():  # the CUDA kernel refuses a recorded call
            out = sweep(ptab, mtab, wl_t, wl_s, bounds, rc2,
                        symmetric=symmetric)
        ctx.save_for_backward(ptab, mtab, rc2, wl_t, wl_s, bounds)
        ctx.symmetric = symmetric
        return out

    @staticmethod
    def backward(ctx, g):
        with spans.span("sr.vjp"):
            return _ad_grads(ctx, sweep_vjp_plain(
                *_ad_args(ctx), g.contiguous(), symmetric=ctx.symmetric))


class _SweepKernelVJP(_SweepPlainVJP):
    """The same forward with ``sweep_vjp`` (the kernel on a CUDA tensor) as
    its backward, which cannot itself be differentiated."""

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with spans.span("sr.vjp"):
            return _ad_grads(ctx, sweep_vjp(*_ad_args(ctx), g.contiguous(),
                                            symmetric=ctx.symmetric))


def _ad_args(ctx):
    ptab, mtab, rc2, wl_t, wl_s, bounds = ctx.saved_tensors
    return ptab, mtab, wl_t, wl_s, bounds, rc2


def _ad_grads(ctx, grads):
    gp, gm, grc2 = grads
    need = ctx.needs_input_grad
    return (gp if need[0] else None, gm if need[1] else None,
            grc2 if need[2] else None, None, None, None, None)


def sweep_ad(ptab, mtab, wl_t, wl_s, bounds, rc2,
             symmetric: bool = False) -> torch.Tensor:
    """The differentiable sweep of an unpaired layout: ``sweep``'s output,
    with cotangents for ``ptab``, ``mtab`` and ``rc2`` from the VJP kernel
    on a CUDA tensor and from ``sweep_vjp_plain`` on the CPU."""
    fn = _SweepKernelVJP if ptab.device.type == "cuda" else _SweepPlainVJP
    return fn.apply(ptab, mtab, rc2, wl_t, wl_s, bounds, symmetric)

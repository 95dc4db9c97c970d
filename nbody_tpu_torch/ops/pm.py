"""Particle-mesh (PM) and P3M force solvers, open and periodic boundary.

The port of ``nbody_tpu/ops/pm.py``: the O(N log N) tier above the exact
all-pairs kernels.  The method and its measured accuracy are described
there; in short:

1. **CIC deposit** of the masses onto an ``ng^3`` grid over the robust
   box of the massive particles (``_robust_box``).
2. **FFT convolution on the doubled (2 ng)^3 grid** with the sampled
   Plummer-softened force kernel (``_force_kernel_spectra``), then a CIC
   gather of the three acceleration grids at the targets.  Particles
   outside the box get per-octant monopoles (``_outlier_moments``).
3. **P3M** (``cutoff_cells > 0``): the force splits exactly into a
   tapered long-range part on the mesh and a compact-support residual
   summed exactly over packed slab tables (``_sr_pack``) and a t-major
   worklist of (target slab, source slab or row) blocks (``_sr_ranges``),
   executed by the short-range sweep (``ops/sr_kernel.py``).  Cell-capacity
   overflow falls back to mesh-quality forces through the complement
   kernel (``_p3m_force_grids``).
4. **The periodic boundary** (``boundary="periodic"``, ``box_size`` L):
   wrapped CIC on the ng^3 grid over the box and closed-form spectra
   (``_periodic_between``); periodic P3M packs the sources and their ghost
   images on a cell grid extended by ``sub`` cells a side and runs the same
   sweep (``_periodic_sr_tables``, ``_periodic_p3m_between``).

What differs from the JAX package:

* The transforms are ``torch.fft.rfftn``/``irfftn`` (cuFFT on the card),
  not full-complex ``fftn``/``ifftn``: the JAX package avoided ``irfftn``
  only because the TPU's was broken.  Spectra are the half spectra
  (m, m, m//2+1).  A periodic force factor i k_j has its Nyquist entry
  zeroed on its own axis: JAX's ``ifftn(...).real`` drops that entry (its
  Hermitian part is zero), which a half-spectrum ``irfftn`` cannot do.
* The overflow ``lax.cond`` is a Python branch on ``bool(has_over)``: one
  host sync per P3M step (``sync.p3m_overflow``, counted in
  ``utils/spans.counts``).  Computing both branches instead would cost
  seven extra (2 ng)^3 transforms a step.
* Every host sync of the solver and its plan sits in a ``spans.sync``,
  the explicit reads and the copies of small constants from pageable host
  memory (which wait for the stream) alike; each stage of a step sits in a
  ``spans.span`` (``mesh.*``, ``p3m.*``, ``sr``).
* The short-range dispatch: on a CUDA tensor the hand kernel in the layout
  ``SR_SYMMETRIC`` / ``SR_PAIRED_ROWS`` (paired rows only on the card, as
  the JAX package pairs them only on its accelerator); on the CPU the plain
  sweep, unpaired.  By default the card runs paired rows without the
  symmetric reaction, which the JAX package adds on every device: on the
  card the reaction's atomics add in no fixed order, and the default layout
  repeats bit for bit.  The VMEM gate, the Mosaic probe and ``SR_FLUSH_RUNS``
  of the JAX package are TPU machinery and are not ported.
* Each cell's slotted particles are packed in the order of a sub-cell
  Morton key (``_subcell_key``), not in input order, so that a slab's
  warps and sources are compact and ``csrc/sr.cu``'s exact skips engage in
  dense cells.  Which particles bin, overflow and take slots, the slab
  bounds and the worklist equal the JAX package's bit for bit; ``ptab``,
  ``mtab`` and ``pslot`` equal its tables reordered within each cell, and
  the sweep sums the same pairs in another order.
* ``sr_entry_overflow`` sizes periodic tables from the slots the solver
  bins (sources and ghost cap), where the JAX package's uses the sources.
* ``differentiable=True`` (P3M, open or periodic): paired rows are off on
  every device, as in the JAX package, and the sweep is
  ``sr_kernel.sweep_ad``: the same forward (the hand kernel on the card,
  so its output equals the non-differentiable call in the pinned unpaired
  layout bit for bit) with the VJP as its backward (the hand kernel of
  ``csrc/sr_vjp.cu`` on the card, the plain VJP on the CPU), where the
  JAX package takes ``jax.vjp`` of its plain sweep.  Everything around the
  sweep (box, deposit, transforms, gather, pack, ghosts) differentiates
  through autograd.  Plain PM (``cutoff_cells=0``) is differentiable as
  it stands.  Plans for a differentiable call are sized with
  ``suggest_sr_plan(..., differentiable=True)``.
* The sharded solve (ROADMAP.md queue 1 item 11) is not ported yet and
  raises ``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch

from ..types import G_NEWTON, SOFTENING_SQUARED
from ..utils import spans

DEFAULT_GRID = 128
# P3M split radius in cell-list cells (R_c ~ cutoff_cells grid spacings).
DEFAULT_CUTOFF_CELLS = 4

# Slots per slab: the dense pair-block edge of the short-range sweep.
SLAB = 64

# Bits of the sub-cell key that orders each cell's packed particles: a
# 2^3 sub-grid a cell, 3 bits an axis interleaved (_subcell_key; more bits
# skip no more steps at the P3M gate).
_KEY_BITS = 9

# Short-range sweep layout: pair-symmetric worklist (each unordered slab
# pair once, with a reaction) and paired rows (two slabs per 128-wide
# source row).  Read when the solver runs; set through set_sr_layout.
# SR_SYMMETRIC None lets the state's device decide: the reaction on the
# CPU, as the JAX package runs its sweep there (so both packages size the
# same plans), and none on the card, where csrc/sr.cu adds the reaction
# with global atomics in no fixed order, and the default layout repeats bit
# for bit (pallas_sym is 3% faster at the P3M gate; PERF.md §6).
SR_SYMMETRIC = None
SR_PAIRED_ROWS = True

# Named layouts: name -> (symmetric, paired), the names of the JAX
# package's SR_LAYOUTS.  "xla" and "pallas" both name the plain layout: on
# the card it runs the hand kernel, on the CPU the plain sweep.
SR_LAYOUTS: dict = {
    "xla": (False, False),
    "pallas": (False, False),
    "pallas_sym": (True, False),
    "pallas_paired": (False, True),
    "pallas_paired_sym": (True, True),
}

_I32 = torch.int32
_F32 = torch.float32


def _const(values, dtype, device, site: str) -> torch.Tensor:
    """A constant from the host on ``device``: on the card the copy from
    pageable memory waits for the stream, a host sync (``sync.<site>``)."""
    with spans.sync(site):
        return torch.tensor(values, dtype=dtype, device=device)


def _read(x, site: str) -> int:
    """``int(x)`` of a 0-d device tensor: a host sync (``sync.<site>``)."""
    with spans.sync(site):
        return int(x)


def _stage(name: str, fn, *args, **kw):
    """``fn(*args, **kw)`` inside the span ``name``, opened around the call
    so that a profiler range wrapped around ``fn`` itself stays innermost:
    the profiler credits each kernel to the innermost range only."""
    with spans.span(name):
        return fn(*args, **kw)


def sr_layout_state() -> tuple:
    """The current (SR_SYMMETRIC, SR_PAIRED_ROWS) pair, for set_sr_layout;
    SR_SYMMETRIC may be None (the device decides)."""
    return (SR_SYMMETRIC, SR_PAIRED_ROWS)


def set_sr_layout(layout) -> tuple:
    """Select the short-range sweep layout by name (SR_LAYOUTS) or as a
    (symmetric, paired) pair; returns the previous pair."""
    global SR_SYMMETRIC, SR_PAIRED_ROWS
    prev = sr_layout_state()
    if isinstance(layout, str):
        if layout not in SR_LAYOUTS:
            raise ValueError(f"unknown SR layout {layout!r}; options: "
                             f"{tuple(SR_LAYOUTS)}")
        state = SR_LAYOUTS[layout]
    else:
        state = tuple(layout)
        if len(state) != 2:
            raise ValueError("SR layout state must be a (symmetric, paired) "
                             f"pair, got {layout!r}")
    SR_SYMMETRIC = None if state[0] is None else bool(state[0])
    SR_PAIRED_ROWS = bool(state[1])
    return prev


# ---------------------------------------------------------------------------
# Mesh arithmetic


def _taper(q: torch.Tensor) -> torch.Tensor:
    """C^2 smoothstep S(q) in q = r^2/R_c^2: 0 at r=0, 1 at r >= R_c."""
    q = q.clamp(0.0, 1.0)
    return q * q * q * (q * (q * 6.0 - 15.0) + 10.0)


def _cic_weights(pos, lo, inv_h, ng: int):
    """Lower-corner indices i0 (3,N) int32 in [0, ng-2] and fractions
    frac (3,N) in [0,1].  Clipped in float first: far padding particles
    would overflow the integer conversion."""
    g = ((pos - lo) * inv_h).clamp(0.0, float(ng - 1))
    i0 = torch.floor(g).to(_I32).clamp(0, ng - 2)
    frac = (g - i0.to(_F32)).clamp(0.0, 1.0)
    return i0, frac


def _corner_iter(i0, frac, ng: int, wrap: bool = False):
    """The 8 CIC corners on the flat (ng, ng, ng) grid: yields (flat index
    (N,), weight (N,)).  ``wrap`` folds the upper corners round the
    periodic grid."""
    for cx in (0, 1):
        wx = frac[0] if cx else 1.0 - frac[0]
        for cy in (0, 1):
            wy = frac[1] if cy else 1.0 - frac[1]
            for cz in (0, 1):
                wz = frac[2] if cz else 1.0 - frac[2]
                ix, iy, iz = i0[0] + cx, i0[1] + cy, i0[2] + cz
                if wrap:
                    ix, iy, iz = (torch.where(c >= ng, c - ng, c)
                                  for c in (ix, iy, iz))
                yield (ix * ng + iy) * ng + iz, wx * wy * wz


def _scatter(corners, mass, ng: int):
    """CIC scatter of masses onto an (ng, ng, ng) f32 grid: one accumulating
    ``index_put_`` of all 8 corners on the flat grid."""
    idx, val = [], []
    for flat, w in corners:
        idx.append(flat)
        val.append(mass * w)
    grid = torch.zeros(ng * ng * ng, dtype=_F32, device=mass.device)
    grid.index_put_((torch.cat(idx).long(),), torch.cat(val),
                    accumulate=True)
    return grid.view(ng, ng, ng)


def _interpolate(grids, corners, n: int):
    """CIC interpolation of (k, ng, ng, ng) grids at n points -> (k, n),
    through flat 1-D gathers."""
    flat_grids = grids.reshape(grids.shape[0], -1)
    out = torch.zeros((grids.shape[0], n), dtype=_F32, device=grids.device)
    for flat, w in corners:
        out = out + w * flat_grids.index_select(1, flat)
    return out


def _deposit(pos, mass, lo, inv_h, ng: int):
    """CIC scatter of masses onto the (ng, ng, ng) grid over the box."""
    return _scatter(_corner_iter(*_cic_weights(pos, lo, inv_h, ng), ng),
                    mass, ng)


def _gather(grids, pos, lo, inv_h, ng: int):
    """CIC interpolation of 3 (ng,ng,ng) grids at pos (3,N) -> (3,N)."""
    return _interpolate(
        grids, _corner_iter(*_cic_weights(pos, lo, inv_h, ng), ng),
        pos.shape[1])


def _cic_sharpen(ng: int, device, m: int = 0):
    """Inverse squared CIC window on an ``m``-point grid (default the
    doubled open-boundary grid, 2 ng; the periodic solver passes m = ng), as
    the half spectrum of the real transform: shape (m, m, m//2+1)."""
    m = m or 2 * ng
    j = torch.arange(m, device=device)
    jt = torch.minimum(j, m - j).to(_F32)
    x = math.pi * jt / m
    sinc = torch.where(jt == 0, torch.ones_like(x), torch.sin(x) / x)
    inv = 1.0 / sinc.clamp_min(1e-3) ** 4
    half = inv[: m // 2 + 1]
    return inv[:, None, None] * inv[None, :, None] * half[None, None, :]


def _force_kernel_spectra(h, ng: int, rc2=None, sharpen=False):
    """rfftn half spectra of the three softened force-kernel components
    sampled on the doubled (2ng)^3 grid with signed wraparound
    displacements.  With ``rc2``: the complement (short-range) part
    f (1 - S(r^2/rc2)) only."""
    m = 2 * ng
    idx = torch.arange(m, device=h.device)
    d = torch.where(idx < ng, idx, idx - m).to(_F32)
    rx = (d * h[0])[:, None, None]
    ry = (d * h[1])[None, :, None]
    rz = (d * h[2])[None, None, :]
    r2 = rx * rx + ry * ry + rz * rz
    u = torch.rsqrt(r2 + SOFTENING_SQUARED)
    u3 = u * u * u
    if rc2 is not None:
        u3 = u3 * (1.0 - _taper(r2 / rc2))
    w = _cic_sharpen(ng, h.device) if sharpen else 1.0
    return tuple(torch.fft.rfftn(r * u3) * w for r in (rx, ry, rz))


def _p3m_spectra(h, ng: int, rc2):
    """Tapered and complement spectra for one price: full minus complement
    gives the tapered part.  Returns ((kx,ky,kz), (sx,sy,sz))."""
    f = _force_kernel_spectra(h, ng, sharpen=True)
    s = _force_kernel_spectra(h, ng, rc2=rc2, sharpen=True)
    return tuple(a - b for a, b in zip(f, s)), s


def _inverse(specs, ng: int):
    m = 2 * ng
    return torch.stack([
        -torch.fft.irfftn(s, s=(m, m, m))[:ng, :ng, :ng] for s in specs])


def _pm_force_grids(rho_hat, h, ng: int, spectra=None):
    """Plain-PM acceleration grids a(c) = -(rho * f)(c) per component."""
    kx, ky, kz = spectra or _force_kernel_spectra(h, ng)
    return _stage("mesh.ifft", _inverse,
                  (rho_hat * kx, rho_hat * ky, rho_hat * kz), ng)


def _p3m_force_grids(rho_hat, rho_over_hat_fn, h, ng: int, rc2,
                     has_over: bool, spectra=None):
    """(acc_grids, comp_grids) of the P3M split.  With overflow, the
    overflowed sources also deposit through the complement kernel and
    ``comp_grids`` carries the binned mass's complement field for
    overflowed targets; without, the seven extra transforms are skipped
    and ``comp_grids`` is None.
    ``has_over`` is a Python bool: the caller's overflow sync."""
    (kx, ky, kz), (sx, sy, sz) = spectra or _p3m_spectra(h, ng, rc2)
    if has_over:
        roh = rho_over_hat_fn()
        g = _stage("mesh.ifft", _inverse,
                   (rho_hat * kx + roh * sx, rho_hat * ky + roh * sy,
                    rho_hat * kz + roh * sz), ng)
        rest = rho_hat - roh
        return g, _stage("mesh.ifft", _inverse,
                         (rest * sx, rest * sy, rest * sz), ng)
    return _stage("mesh.ifft", _inverse,
                  (rho_hat * kx, rho_hat * ky, rho_hat * kz), ng), None


# ---------------------------------------------------------------------------
# The box and the far field


def _robust_box(pos, mass):
    """Robust mesh box (lo (3,1), hi (3,1)) of the massive particles: the
    inner-99% quantile span per axis (on a strided subsample of at most
    ~64k), expanded by a quarter span each side and clipped to the exact
    extent.  ``torch.nanquantile`` (linear) differs from JAX's
    ``nanpercentile`` by at most one ulp."""
    real = mass[None, :] > 0
    big = 3e38
    lo_exact = torch.where(real, pos, big).amin(dim=1, keepdim=True)
    hi_exact = torch.where(real, pos, -big).amax(dim=1, keepdim=True)
    stride = max(1, pos.shape[1] // 65536)
    nanpos = torch.where(real[:, ::stride], pos[:, ::stride], math.nan)
    q = torch.nanquantile(
        nanpos, _const([0.005, 0.995], _F32, pos.device, "box_quantiles"),
        dim=1)  # (2, 3)
    return _box_from_stats(lo_exact, hi_exact, q[0][:, None], q[1][:, None])


def _box_from_stats(lo_exact, hi_exact, q_lo, q_hi):
    span_q = 0.25 * (q_hi - q_lo)
    lo = torch.maximum(lo_exact, q_lo - span_q)
    hi = torch.minimum(hi_exact, q_hi + span_q)
    return lo, torch.maximum(hi, lo + 1e-6)


def _inside(pos, lo, hi):
    """(N,) f32 mask: 1 where the particle is inside the mesh box."""
    return ((pos >= lo) & (pos <= hi)).all(dim=0).to(_F32)


def _outlier_moments(pos, mass, m_in, lo_box, hi_box):
    """In-box total (M_in, com_in) and one monopole per direction octant of
    the out-of-box mass around the box centre."""
    tiny = 1e-30
    M_in = m_in.sum()
    com_in = (pos * m_in).sum(dim=1, keepdim=True) / M_in.clamp_min(tiny)
    m_out = mass - m_in
    ctr = 0.5 * (lo_box + hi_box)
    side = (pos > ctr).to(_I32)
    oct_id = side[0] * 4 + side[1] * 2 + side[2]
    octs = []
    for k in range(8):
        m_k = m_out * (oct_id == k).to(_F32)
        M_k = m_k.sum()
        S_k = (pos * m_k).sum(dim=1, keepdim=True)
        octs.append((M_k, S_k / M_k.clamp_min(tiny)))
    return M_in, com_in, octs


def _monopole(pos_tgt, m_tot, com):
    """Softened point-mass field of (m_tot, com) at the targets (3, N)."""
    d = com - pos_tgt
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + SOFTENING_SQUARED
    u = torch.rsqrt(r2)
    return m_tot * d * (u * u * u)


# ---------------------------------------------------------------------------
# Cell geometry and sizing


def _cell_grid_params(ng: int, cutoff_cells: int) -> tuple[int, int]:
    """``nc`` cells per axis and the neighbour reach ``sub``."""
    sub = 1 if ng // int(cutoff_cells) >= 24 else 2
    nc = max(2, (sub * ng) // int(cutoff_cells))
    return min(nc, 40), sub


def _auto_capacity(n_src: int, n_cells: int) -> int:
    """Density-blind cell capacity: ~8x the mean occupancy, a power of two
    in [64, 512]."""
    avg = max(1, n_src // max(n_cells, 1))
    cap = 64
    while cap < 8 * avg and cap < 512:
        cap *= 2
    return cap


def _cell_coords(pos, lo_box, inv_c, nc: int):
    g = ((pos - lo_box) * inv_c).clamp(0.0, float(nc) - 1.0)
    return torch.floor(g).to(_I32)


def _inv_cell(span, nc: int):
    # nc / span as a true division: torch's ``scalar / tensor`` multiplies
    # by the reciprocal, which can round otherwise.
    return torch.full_like(span, float(nc)) / span


def _bin_cids(pos, lo_box, span, nc: int, inc):
    """Cell ids; everything excluded by ``inc`` gets the n_cells sentinel."""
    co = _cell_coords(pos, lo_box, _inv_cell(span, nc), nc)
    cid = (co[0] * nc + co[1]) * nc + co[2]
    return torch.where(inc, cid, nc * nc * nc)


def _subcell_key(pos, lo_box, span, nc: int):
    """(N,) int32 Morton key of each particle's place inside its cell: the
    low 3 bits of its coordinates on the grid refined 8 times (whose high
    bits are ``_cell_coords``'s, as scaling by a power of two is exact),
    interleaved, x the highest bit of each triple (as the cell id is
    x-major).  Below 2^_KEY_BITS."""
    q = _cell_coords(pos, lo_box, _inv_cell(span, nc) * 8, nc * 8) & 7
    # Spread 3 bits b2 b1 b0 to b2 0 0 b1 0 0 b0.
    q = (q | (q << 4)) & 0b1000011
    q = (q | (q << 2)) & 0b1001001
    return (q[0] << 2) | (q[1] << 1) | q[2]


def _sr_rc2(span, nc: int, sub: int):
    """Squared cutoff: ``sub`` cell widths of the shortest box axis."""
    rc = span[:, 0].min() * float(sub) / float(nc)
    return rc * rc


def _sr_sizing(n_cap: int, n_bin: int, n_cells: int, capacity: int,
               sr_slabs: int, sr_entries: int):
    """Cell capacity and the (s_max, e_max) plan bounds: the measured plan
    when given, the guaranteed defaults otherwise."""
    cap = int(capacity) or _auto_capacity(n_cap, n_cells)
    s_max, e_max = int(sr_slabs), int(sr_entries)
    if not (s_max and e_max):
        ds, de = _default_sr_plan(n_bin)
        s_max, e_max = s_max or ds, e_max or de
    return cap, s_max, e_max


def _default_sr_plan(n_bin: int):
    """s_max = ceil(n/SLAB) + 1 and e_max = s_max^2, capped at 2^22."""
    s_max = n_bin // SLAB + 1 + (1 if n_bin % SLAB else 0)
    return s_max, min(s_max * s_max, 1 << 22)


# ---------------------------------------------------------------------------
# Packing and worklist


def _sr_slots(cid, n_cells: int, cap: int, s_max: int):
    """Which particles take slots, by the JAX package's rule: a stable sort
    by cell id, each cell's first ``cap`` particles in input order, and the
    first s_max*SLAB of those.

    ``cid`` (Ns,) int32 in [0, n_cells]; ``n_cells`` marks excluded
    particles.  Returns ``(slab_lo (s_max,), slab_hi, binned (Ns,))``,
    equal to the JAX package's; none depends on the order inside a cell."""
    dev = cid.device
    ns = cid.shape[0]
    order = torch.argsort(cid, stable=True).to(_I32)
    sc = cid[order]
    cells = torch.arange(n_cells, dtype=_I32, device=dev)
    starts = torch.searchsorted(sc, cells, side="left", out_int32=True)
    ar = torch.arange(ns, dtype=_I32, device=dev)
    rank = ar - starts[sc.clamp(0, n_cells - 1)]
    valid = (sc < n_cells) & (rank < cap)
    # A stable partition of the sorted key: binned particles in cid order,
    # then the rest in their sorted order.
    vi = valid.to(_I32)
    nv = torch.cumsum(vi, 0, dtype=_I32) - vi
    n_bin = vi.sum(dtype=_I32)
    dest = torch.where(valid, nv, n_bin + (ar - nv))
    pord = torch.empty_like(ar).scatter_(0, dest.long(), ar)
    pc = torch.where(valid, sc, n_cells)[pord]
    slotted = valid & (nv < s_max * SLAB)
    binned = torch.zeros_like(slotted).scatter_(0, order.long(), slotted)
    sidx = torch.arange(s_max, dtype=_I32, device=dev) * SLAB
    has = sidx < n_bin
    last = torch.minimum(sidx + (SLAB - 1), n_bin - 1).clamp(0, ns - 1)
    slab_lo = torch.where(has, pc[sidx.clamp(max=ns - 1)], n_cells)
    slab_hi = torch.where(has, pc[last], n_cells)
    return slab_lo, slab_hi, binned


def _sr_pack(cid, pos, mass, n_cells: int, cap: int, s_max: int, key):
    """Packed slab tables: the slotted particles (``_sr_slots``), SLAB a
    slab, in cell id order and in ``key`` order (``_subcell_key``) inside
    each cell.

    Returns ``(ptab (3, (s_max+1)*SLAB), mtab, slab_lo (s_max,), slab_hi,
    pslot (Ns,), binned (Ns,))``; slab ``s_max`` is the zero-mass sentinel.
    ``slab_lo``, ``slab_hi`` and ``binned`` equal the JAX package's;
    ``ptab``, ``mtab`` and ``pslot`` are its tables reordered within each
    cell, and equal them under a zero key."""
    dev = cid.device
    ns = cid.shape[0]
    slab_lo, slab_hi, binned = _sr_slots(cid, n_cells, cap, s_max)
    # A stable sort of the binned particles by (cid, key) to the front,
    # ties in input order; the rest follow, and no output reads their
    # order.  The int32 sort key holds: n_cells <= 44^3 (_cell_grid_params'
    # nc <= 40, plus 2 ghost cells a side), under 2^(31 - _KEY_BITS).
    perm = torch.argsort(torch.where(binned, (cid << _KEY_BITS) | key,
                                     n_cells << _KEY_BITS), stable=True)
    n_slot = binned.sum(dtype=_I32)
    nslots = (s_max + 1) * SLAB
    ar = torch.arange(ns, dtype=_I32, device=dev)
    slot = torch.where(ar < n_slot, ar, nslots - 1)
    okk = torch.arange(nslots, dtype=_I32, device=dev) < n_slot
    # Slots past the particles read spread indices, masked below: the
    # gather's backward (an accumulating index_put_) then sums no long run
    # of one index, which it would add one element at a time.
    src = perm[torch.arange(nslots, device=dev) % ns]
    ptab = torch.where(okk[None, :], pos[:, src], 0.0)
    mtab = torch.where(okk, mass[src], 0.0)
    pslot = torch.zeros_like(ar).scatter_(0, perm.long(), slot)
    return ptab, mtab, slab_lo, slab_hi, pslot, binned


def _cumsum(x, dim=0):
    return torch.cumsum(x, dim, dtype=_I32)


def _shift_cummax(x):
    """Exclusive running max along rows, seeded with 0."""
    return torch.cat([torch.zeros_like(x[:, :1]),
                      torch.cummax(x, dim=1).values[:, :-1]], dim=1)


def _sr_ranges(slab_lo, slab_hi, nc: int, sub: int, e_max: int,
               symmetric: bool = False, paired: bool = False):
    """Static-shape t-major worklist of (target slab, source slab or row)
    blocks from the packed slab cid bounds (see the JAX package's
    ``_sr_ranges`` for the construction).  All shapes are static and
    nothing syncs with the host: ``n_entries`` is a 0-d int32 tensor.
    JAX's dropping scatters write here to one extra slot that is cut off.

    Returns ``(wl_t (e_max,), wl_s (e_max,), n_entries)``, int32."""
    dev = slab_lo.device
    s_max = slab_lo.shape[0]
    n_cells = nc * nc * nc
    offs = sorted((ox * nc + oy) * nc for ox in range(-sub, sub + 1)
                  for oy in range(-sub, sub + 1))
    off_arr = _const(offs, _I32, dev, "worklist_offsets")[None, :]
    n_rows = len(offs)
    has = slab_lo < n_cells
    lo_w = slab_lo[:, None] + (off_arr - sub)
    hi_w = (slab_hi[:, None] + (off_arr + sub)).clamp(max=n_cells - 1)

    def count_lt(vals, queries):
        # searchsorted(vals, q, left) on the small domain [0, n_cells]: a
        # scatter-count of vals, a cumsum, and one gather per query.
        cnt = torch.zeros(n_cells + 2, dtype=_I32, device=dev).scatter_add_(
            0, (vals + 1).clamp(0, n_cells + 1).long(), torch.ones_like(vals))
        return _cumsum(cnt)[queries.clamp(0, n_cells + 1).long()]

    s0 = count_lt(slab_hi, lo_w.reshape(-1)).reshape(s_max, n_rows)
    s1 = count_lt(slab_lo, hi_w.reshape(-1) + 1).reshape(s_max, n_rows)
    s0 = torch.maximum(s0, _shift_cummax(s1))
    if symmetric:
        s0 = torch.maximum(
            s0, torch.arange(s_max, dtype=_I32, device=dev)[:, None])
    s1 = torch.maximum(s1, s0)
    sent_s = s_max
    if paired:
        # Coarsen each slab interval to its covering row interval, then
        # strip the boundary row two consecutive intervals can share.
        r0 = s0 // 2
        r1 = torch.where(s1 > s0, (s1 + 1) // 2, r0)
        s0 = torch.maximum(r0, _shift_cummax(r1))
        s1 = torch.maximum(r1, s0)
        sent_s = s_max // 2
    cnt = torch.where(has[:, None], s1 - s0, 0)
    flat = cnt.reshape(-1)
    n_b = flat.shape[0]
    cum = _cumsum(flat)
    n_e = cum[-1]
    base = cum - flat
    e_idx = torch.arange(e_max, dtype=_I32, device=dev)
    nonempty = flat > 0
    start_pos = torch.where(nonempty & (base < e_max), base, e_max).long()
    # Each segment's target slab t and v = s0 - base are constant within
    # it, and an entry's source is v + its position.  Scatter each nonempty
    # segment's deltas of (t, v) against the nonempty segment before it at
    # its start and integrate with a cumsum.  (JAX carries t with a running
    # max; the cumsum gives the same values and is one fast scan here.)
    rank = _cumsum(nonempty.to(_I32))
    order = torch.where(nonempty, rank - 1, n_b).long()
    prev = (rank - 2).clamp_min(0).long()
    fills = []
    for val in (torch.arange(n_b, dtype=_I32, device=dev) // n_rows,
                s0.reshape(-1) - base):
        by_order = torch.zeros(n_b + 1, dtype=_I32, device=dev).scatter_(
            0, order, val)[:n_b]
        delta = torch.where(nonempty,
                            val - torch.where(rank >= 2, by_order[prev], 0), 0)
        marks = torch.zeros(e_max + 1, dtype=_I32, device=dev).scatter_add_(
            0, start_pos, delta)[:e_max]
        fills.append(_cumsum(marks))
    t_fill, v_fill = fills
    ok = e_idx < n_e
    wl_t = torch.where(ok, t_fill, s_max)
    wl_s = torch.where(ok, v_fill + e_idx, sent_s)
    return wl_t, wl_s, n_e


def sr_pack_inputs(pos, mass, grid: int = DEFAULT_GRID,
                   cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                   capacity: int = 0, sr_slabs: int = 0,
                   sr_entries: int = 0, symmetric: bool = False,
                   paired: bool = False) -> dict:
    """The short-range tables and worklist exactly as the self-solve builds
    them.  Returns ``ptab, mtab, wl_t, wl_s, n_e, e_max, rc2``."""
    pos, mass = pos.to(_F32), mass.to(_F32)
    ng = int(grid)
    nc, sub = _cell_grid_params(ng, int(cutoff_cells))
    n_cells = nc * nc * nc
    ns = pos.shape[1]
    lo_box, hi_box = _robust_box(pos, mass)
    span = hi_box - lo_box
    inc = (mass * _inside(pos, lo_box, hi_box)) > 0
    cap, s_max, e_max = _sr_sizing(ns, ns, n_cells, capacity, sr_slabs,
                                   sr_entries)
    cid = _bin_cids(pos, lo_box, span, nc, inc)
    key = _subcell_key(pos, lo_box, span, nc)
    ptab, mtab, slab_lo, slab_hi, _, _ = _sr_pack(cid, pos, mass, n_cells,
                                                  cap, s_max, key)
    wl_t, wl_s, n_e = _sr_ranges(slab_lo, slab_hi, nc, sub, e_max,
                                 symmetric=symmetric, paired=paired)
    return dict(ptab=ptab, mtab=mtab, wl_t=wl_t, wl_s=wl_s, n_e=n_e,
                e_max=e_max, rc2=_sr_rc2(span, nc, sub))


# ---------------------------------------------------------------------------
# The periodic boundary: a fixed cubic box of edge L, the forces of every
# image minus the uniform background (the JAX package's "Periodic-box
# boundary mode").  The mesh is the ng^3 grid over the box, no doubling;
# the kernel spectra are closed forms (the Plummer potential's transform,
# x K1(x)) of which the transforms here take the rfftn half: the last axis
# holds the rfftfreq wavenumbers 0..ng/2.


def _box_scalar(box, like) -> torch.Tensor:
    """The box edge as a 0-d f32 tensor on ``like``'s device.  Dividing by
    a tensor keeps the division true: on the card a Python scalar divisor
    becomes a multiply by its reciprocal, which can round otherwise."""
    return torch.full((), float(box), dtype=_F32, device=like.device)


def _wrap_box(pos, box):
    """Fold positions into the canonical cell [0, box) per axis."""
    L = _box_scalar(box, pos)
    return pos - L * torch.floor(pos / L)


def _xk1(x):
    """g(x) = x K1(x) (modified Bessel K1) for x >= 0, elementwise: the
    Abramowitz & Stegun 9.8.3/9.8.7/9.8.8 polynomials in f32 (abs err
    < 2.2e-7).  g(0) = 1 and g ~ sqrt(pi x / 2) e^-x for large x."""
    x = x.to(_F32)
    xs = x.clamp_min(1e-12)
    t = (x * 0.5) ** 2
    u = (x / torch.full_like(x, 3.75)) ** 2
    i1x = (0.5 + u * (0.87890594 + u * (0.51498869 + u * (0.15084934
           + u * (0.02658733 + u * (0.00301532 + u * 0.00032411))))))
    small = (x * x * torch.log(xs * 0.5) * i1x
             + 1.0 + t * (0.15443144 + t * (-0.67278579 + t * (-0.18156897
             + t * (-0.01919402 + t * (-0.00110404 + t * (-0.00004686)))))))
    w = torch.full_like(x, 2.0) / x.clamp_min(2.0)
    big = (torch.sqrt(xs) * torch.exp(-x)
           * (1.25331414 + w * (0.23498619 + w * (-0.03655620
              + w * (0.01504268 + w * (-0.00780353 + w * (0.00325614
              + w * (-0.00068245))))))))
    return torch.where(x <= 2.0, small, big)


def _f32_quotient(a, b) -> float:
    """f32(a) / f32(b), rounded once in f32, as the JAX package's
    ``jnp.float32(a) / jnp.float32(b)``."""
    return float(torch.tensor(float(a), dtype=_F32)
                 / torch.tensor(float(b), dtype=_F32))


def _periodic_kvecs(box, ng: int, device):
    """Per-axis angular wavenumbers (ng,) f32 of the box's k lattice, in
    fftfreq layout (positive, then negative frequencies)."""
    idx = torch.arange(ng, device=device)
    n = torch.where(idx < (ng + 1) // 2, idx, idx - ng).to(_F32)
    return _f32_quotient(2.0 * math.pi, box) * n


def _periodic_axes(box, ng: int, device, nyquist: bool = True):
    """The three wavenumber axes of the (ng, ng, ng//2+1) half spectrum,
    broadcastable: fftfreq on the first two, rfftfreq on the last.  With
    ``nyquist=False`` each axis's Nyquist entry (even ng) is zeroed, for
    the factor i k_j of a force spectrum on its own axis: the JAX package's
    ``ifftn(...).real`` drops that entry (its Hermitian part is zero), and
    a half-spectrum ``irfftn`` handed it would not."""
    k1d = _periodic_kvecs(box, ng, device)
    if not nyquist and ng % 2 == 0:
        k1d = torch.where(torch.arange(ng, device=device) == ng // 2, 0.0, k1d)
    kz = k1d[: ng // 2 + 1].abs()
    return k1d[:, None, None], k1d[None, :, None], kz[None, None, :]


# 4 pi rounded to f32, as the JAX package's weakly typed ``4.0 * jnp.pi``.
_F32_4PI = float(torch.tensor(4.0 * math.pi, dtype=_F32))


def _periodic_phi_spectrum(box, ng: int, device):
    """Half spectrum (ng, ng, ng//2+1) f32 of the grid-sampled periodic
    Plummer potential kernel, phi_hat(|k|) / h^3, with the k=0 mode zeroed
    (the uniform background's subtraction)."""
    kx, ky, kz = _periodic_axes(box, ng, device)
    k2 = kx * kx + ky * ky + kz * kz
    eps = torch.sqrt(_const(SOFTENING_SQUARED, _F32, device, "periodic_eps"))
    g = _xk1(eps * torch.sqrt(k2))
    h3 = _const(_f32_quotient(box, ng), _F32, device, "periodic_h3") ** 3
    phi = (_F32_4PI * g) / k2.clamp_min(1e-30) / h3
    return torch.where(k2 > 0, phi, 0.0)


def _i_times(v):
    """i v for a real tensor v, as complex64."""
    return torch.complex(torch.zeros_like(v), v)


def _pm_force_spectra_periodic(box, ng: int, device):
    """The three periodic-PM force spectra i k_j phi_hat, half spectra, each
    k_j with its own axis's Nyquist entry zeroed (_periodic_axes)."""
    phi = _periodic_phi_spectrum(box, ng, device)
    return tuple(_i_times(kc * phi)
                 for kc in _periodic_axes(box, ng, device, nyquist=False))


def _periodic_inverse(specs, ng: int):
    return torch.stack([torch.fft.irfftn(s, s=(ng, ng, ng)) for s in specs])


def _pm_force_grids_periodic(rho_hat, box, ng: int, spectra=None):
    """Periodic-PM acceleration grids (3, ng, ng, ng): the spectral multiply
    by +i k_j phi_hat (a = +grad of the potential sum under this module's
    a_i = sum_j m_j (x_j - x_i) u^3 convention), one irfftn a component."""
    spectra = spectra or _pm_force_spectra_periodic(box, ng, rho_hat.device)
    return _stage("mesh.ifft", _periodic_inverse,
                  [rho_hat * s for s in spectra], ng)


def _cic_weights_periodic(pos, box, ng: int):
    """CIC lower corners (3,N) int32 in [0, ng-1] and fractions for wrapped
    positions on the periodic grid (h = box/ng; corners wrap)."""
    L = _box_scalar(box, pos)
    g = _wrap_box(pos, box) * (torch.full_like(L, float(ng)) / L)
    i0 = torch.floor(g).to(_I32).clamp(0, ng - 1)
    frac = (g - i0.to(_F32)).clamp(0.0, 1.0)
    return i0, frac


def _periodic_corners(pos, box, ng: int):
    return _corner_iter(*_cic_weights_periodic(pos, box, ng), ng, wrap=True)


def _deposit_periodic(pos, mass, box, ng: int):
    """CIC scatter onto the periodic (ng, ng, ng) grid (corners wrap)."""
    return _scatter(_periodic_corners(pos, box, ng), mass, ng)


def _gather_periodic(grids, pos, box, ng: int):
    """CIC interpolation of (k, ng, ng, ng) periodic grids at pos -> (k, N)
    (corners wrap)."""
    return _interpolate(grids, _periodic_corners(pos, box, ng), pos.shape[1])


# The <= 7 image shifts a particle near a box corner needs: each axis gives
# at most one shift direction (R_c < L/2), so the combinations are the
# nonempty subsets of the per-axis signs.
_GHOST_COMBOS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0),
                 (1, 0, 1), (0, 1, 1), (1, 1, 1))


def _ghost_combo_table():
    """(8, 7) lookup: row = bitmask of a particle's boundary axes (axis j
    sets bit j), column r = index into _GHOST_COMBOS of its r-th admissible
    combination (the nonempty subsets of the set bits, in _GHOST_COMBOS
    order).  Unused tail columns hold 0."""
    cmb = [[0] * 7 for _ in range(8)]
    for mask in range(8):
        r = 0
        for idx, c in enumerate(_GHOST_COMBOS):
            cm = c[0] | (c[1] << 1) | (c[2] << 2)
            if cm and (cm & mask) == cm:
                cmb[mask][r] = idx
                r += 1
    return tuple(tuple(row) for row in cmb)


_GHOST_COMBO_TABLE = _ghost_combo_table()


def _default_ghost_cap(n: int) -> int:
    """Ghost slots when the caller gives none: 2N rounded up to a power of
    two, capped at the guaranteed 7N.  Density-blind, like _auto_capacity:
    the engine sizes them from suggest_sr_plan's measured count."""
    cap = 64
    while cap < 2 * n:
        cap *= 2
    return min(cap, 7 * n)


def _ghost_cap(n: int, sr_ghosts: int) -> int:
    return int(sr_ghosts) or _default_ghost_cap(n)


def _ghost_images(pos_w, mass, box, rc, gcap: int):
    """Periodic ghost images for the short-range pass.

    Every massive particle within R_c of a box face gets copies shifted by
    the relevant +-L combinations (_GHOST_COMBOS), so every cross-boundary
    min-image pair within R_c becomes a direct pair against some image and
    the open-boundary sweep applies unchanged.  Ghosts exert short-range
    force only.  Static shapes: the images pack into ``gcap`` slots and the
    rest are dropped; ``n_ghost`` stays the exact total whatever ``gcap``.

    Two-stage compaction, as the JAX package's: the boundary particles
    first (one N-long prefix sum), then each ghost slot decodes (parent,
    rank) by ``searchsorted`` on the int32 prefix sums of the parents'
    image counts 2^k - 1, and (mask, rank) -> combination by
    _GHOST_COMBO_TABLE.  Images come particle-major.  Returns
    ``(gpos (3, gcap), gmass (gcap,), n_ghost)``, n_ghost a 0-d int32."""
    dev = pos_w.device
    L = _box_scalar(box, pos_w)
    n = pos_w.shape[1]
    sig = torch.where(pos_w < rc, 1,
                      torch.where(pos_w > L - rc, -1, 0)).to(_I32)  # (3, N)
    nz = sig != 0
    k = nz.sum(dim=0, dtype=_I32)
    live = (k > 0) & (mass > 0)
    gc = torch.where(live, (torch.ones_like(k) << k) - 1, 0)
    n_ghost = gc.sum(dtype=_I32)
    # Stage 1: compact the boundary particles.
    bcap = max(1, min(int(gcap), n))
    cumb = _cumsum(live.to(_I32))
    bslots = torch.arange(bcap, dtype=_I32, device=dev)
    bidx = torch.searchsorted(cumb, bslots + 1, side="left",
                              out_int32=True).clamp(max=n - 1)
    bvalid = bslots < cumb[-1]
    nzb = nz[:, bidx]  # (3, bcap)
    k_b = nzb.sum(dim=0, dtype=_I32)
    gc_b = torch.where(bvalid, (torch.ones_like(k_b) << k_b) - 1, 0)
    cumg = _cumsum(gc_b)
    mask_b = (nzb[0].to(_I32) + 2 * nzb[1].to(_I32) + 4 * nzb[2].to(_I32))
    # Stage 2: ghost slot -> (boundary parent p, image rank) -> combination.
    slots = torch.arange(int(gcap), dtype=_I32, device=dev)
    p = torch.searchsorted(cumg, slots + 1, side="left",
                           out_int32=True).clamp(max=bcap - 1)
    valid = slots < cumg[-1]
    rank = (slots - (cumg[p] - gc_b[p])).clamp(0, 6)
    table = _const(_GHOST_COMBO_TABLE, torch.int64, dev, "ghost_table")
    ci = table[mask_b[p].long(), rank.long()]
    pi = torch.where(valid, bidx[p], slots % n)  # spread, as in _sr_pack
    combos = _const(_GHOST_COMBOS, _I32, dev, "ghost_combos").t()  # (3, 7)
    shift = torch.where(combos[:, ci] == 1, sig[:, pi], 0)  # (3, gcap)
    gpos = torch.where(valid[None, :], pos_w[:, pi] + L * shift.to(_F32), 0.0)
    gmass = torch.where(valid, mass[pi], 0.0)
    return gpos, gmass, n_ghost


def _periodic_cells(ng: int, cutoff_cells: int):
    """The periodic short-range cell grid: ``nc`` cells across the box,
    extended by ``sub`` ghost cells a side (R_c = sub * box/nc is the
    margin).  R_c must lie strictly inside half the box: nc >= 2 sub + 1."""
    nc, sub = _cell_grid_params(ng, int(cutoff_cells))
    if nc < 2 * sub + 1:
        raise ValueError(
            f"periodic P3M needs R_c < box/2 (cell grid nc >= "
            f"{2 * sub + 1}); got nc={nc} from grid={ng}, "
            f"cutoff_cells={cutoff_cells} — raise grid or lower "
            "cutoff_cells")
    return nc, sub


def _periodic_geom(ng: int, cutoff_cells: int, box: float, device):
    """The periodic binning geometry ``(nc, sub, rc, nc_tot, lo_cell,
    span_tot)``, one definition for the solver and the plan diagnostics:
    they must bin onto the same ghost-extended grid.  rc is a 0-d f32
    tensor, lo_cell and span_tot (3, 1) f32."""
    nc, sub = _periodic_cells(ng, cutoff_cells)
    cs = box / nc
    rc = _const(sub * cs, _F32, device, "periodic_rc")
    lo_cell = torch.full((3, 1), -sub * cs, dtype=_F32, device=device)
    span_tot = torch.full((3, 1), box + 2 * sub * cs, dtype=_F32,
                          device=device)
    return nc, sub, rc, nc + 2 * sub, lo_cell, span_tot


def _periodic_ghost_bin(src_w, mass, box, rc, nc_tot: int, lo_cell, span_tot,
                        gcap: int, tgt_w=None):
    """Ghost images and bin candidates on the ghost-extended grid.  Slot
    layout ``[sources | ghosts(gcap)]``, or ``[sources | ghosts(gcap) |
    targets]`` when distinct targets join as massless receivers.  Returns
    ``(pos_bin, m_bin, cid, n_ghost)``."""
    gpos, gmass, n_ghost = _stage("mesh.ghosts", _ghost_images, src_w, mass,
                                  box, rc, gcap)
    if tgt_w is None:
        pos_bin = torch.cat([src_w, gpos], dim=1)
        m_bin = torch.cat([mass, gmass])
        inc = m_bin > 0
    else:
        pos_bin = torch.cat([src_w, gpos, tgt_w], dim=1)
        m_bin = torch.cat([mass, gmass, torch.zeros_like(tgt_w[0])])
        inc = torch.cat([mass > 0, gmass > 0,
                         torch.ones_like(tgt_w[0], dtype=torch.bool)])
    cid = _bin_cids(pos_bin, lo_cell, span_tot, nc_tot, inc)
    return pos_bin, m_bin, cid, n_ghost


def _periodic_sr_tables(pos_src, mass_src, grid: int, box: float,
                        cutoff_cells: int, capacity: int = 0,
                        sr_slabs: int = 0, sr_entries: int = 0,
                        sr_ghosts: int = 0, pos_tgt=None,
                        symmetric: bool = False, paired: bool = False) -> dict:
    """The periodic short-range pass's tables and worklist, as the solver
    builds them: sources wrapped into the box plus their ghost images (and
    distinct targets, massless, when ``pos_tgt`` is given), binned on the
    (nc + 2 sub)^3 grid, packed and listed in the layout (symmetric,
    paired).  The one recipe, which the solver and the card's checks run.
    Returns ``ptab, mtab, wl_t, wl_s, n_e, e_max, rc2`` as sr_pack_inputs
    does, and ``src_w, tgt_w, pslot, binned, n_ghost, gcap, s_max``."""
    pos_src, mass_src = pos_src.to(_F32), mass_src.to(_F32)
    ng = int(grid)
    with spans.span("p3m.bin"):
        nc, sub, rc, nc_tot, lo_cell, span_tot = _periodic_geom(
            ng, int(cutoff_cells), float(box), pos_src.device)
        src_w = _wrap_box(pos_src, box)
        tgt_w = src_w if pos_tgt is None else _wrap_box(pos_tgt.to(_F32),
                                                        box)
        ns = pos_src.shape[1]
        gcap = _ghost_cap(ns, sr_ghosts)
        pos_bin, m_bin, cid, n_ghost = _periodic_ghost_bin(
            src_w, mass_src, box, rc, nc_tot, lo_cell, span_tot, gcap,
            tgt_w=None if pos_tgt is None else tgt_w)
        n_cells = nc_tot ** 3
        cap, s_max, e_max = _sr_sizing(ns, pos_bin.shape[1], n_cells,
                                       capacity, sr_slabs, sr_entries)
        ptab, mtab, slab_lo, slab_hi, pslot, binned = _sr_pack(
            cid, pos_bin, m_bin, n_cells, cap, s_max,
            _subcell_key(pos_bin, lo_cell, span_tot, nc_tot))
    with spans.span("p3m.worklist"):
        wl_t, wl_s, n_e = _sr_ranges(slab_lo, slab_hi, nc_tot, sub, e_max,
                                     symmetric=symmetric, paired=paired)
    return dict(ptab=ptab, mtab=mtab, wl_t=wl_t, wl_s=wl_s, n_e=n_e,
                e_max=e_max, rc2=rc * rc, src_w=src_w, tgt_w=tgt_w,
                pslot=pslot, binned=binned, n_ghost=n_ghost, gcap=gcap,
                s_max=s_max)


def _periodic_p3m_spectra(box, ng: int, rc2):
    """(combined long-range C_j, complement S_j) force spectra of periodic
    P3M, each a 3-tuple of (ng, ng, ng//2+1) complex64 half spectra.

    The complement kernel s_j(d) = d_j (1 - S(r^2/R_c^2)) u^3, sampled at
    minimum-image displacements (its support R_c < L/2 puts one image at
    each grid point), is transformed; the long-range part combines it with
    the closed-form full spectrum, C_j = (i k_j phi_hat + s_hat_j) W and
    S_j = s_hat_j W, W the CIC sharpening on the ng grid.  k_j's Nyquist
    entry is zeroed on its own axis (_periodic_axes); s_hat_j, the
    transform of a real grid, needs nothing."""
    dev = rc2.device
    idx = torch.arange(ng, device=dev)
    # The min-image displacement per axis; the ambiguous ng/2 point (+-L/2)
    # has zero complement weight either way (R_c < L/2).
    d1 = (torch.where(idx <= ng // 2, idx, idx - ng).to(_F32)
          * _f32_quotient(box, ng))
    rx, ry, rz = d1[:, None, None], d1[None, :, None], d1[None, None, :]
    r2 = rx * rx + ry * ry + rz * rz
    u = torch.rsqrt(r2 + SOFTENING_SQUARED)
    w1 = (1.0 - _taper(r2 / rc2)) * (u * u * u)
    phi = _periodic_phi_spectrum(box, ng, dev)
    W = _cic_sharpen(ng, dev, m=ng)
    comb, comp = [], []
    for dj, kc in zip((rx, ry, rz),
                      _periodic_axes(box, ng, dev, nyquist=False)):
        s_hat = torch.fft.rfftn(dj * w1)
        comp.append(s_hat * W)
        comb.append((_i_times(kc * phi) + s_hat) * W)
    return tuple(comb), tuple(comp)


def _periodic_p3m_force_grids(rho_hat, rho_over_hat_fn, comb, comp, ng: int,
                              has_over: bool):
    """(acc_grids, comp_grids) of periodic P3M, as _p3m_force_grids: under
    overflow the unbinned sources' full force rides rho C - roh S and the
    targets' complement field is (roh - rho) S; without, comp_grids is
    None.  ``has_over`` is a Python bool: the caller's overflow sync."""
    if has_over:
        roh = rho_over_hat_fn()
        g = _stage("mesh.ifft", _periodic_inverse,
                   [rho_hat * c - roh * s for c, s in zip(comb, comp)], ng)
        return g, _stage("mesh.ifft", _periodic_inverse,
                         [(roh - rho_hat) * s for s in comp], ng)
    return _stage("mesh.ifft", _periodic_inverse,
                  [rho_hat * c for c in comb], ng), None


def periodic_potential_energy(pos, mass, box: float,
                              grid: int = DEFAULT_GRID) -> torch.Tensor:
    """Background-subtracted periodic potential energy, a 0-d tensor:
    PE = -(G/2) sum_i m_i Phi(x_i), Phi the mesh-solved periodic potential
    with k=0 dropped (the raw image sum of the softened 1/r potential
    diverges, so the open pairwise PE means nothing here).  Mesh quality,
    which is what a drift diagnostic needs; the CIC self-cloud term is
    kept, as the open PE keeps its self term."""
    ng = int(grid)
    pos, mass = pos.to(_F32), mass.to(_F32)
    rho = _deposit_periodic(pos, mass, box, ng)
    phi = torch.fft.irfftn(
        torch.fft.rfftn(rho) * _periodic_phi_spectrum(box, ng, pos.device),
        s=(ng, ng, ng))
    vals = _gather_periodic(phi[None], pos, box, ng)[0]
    return (-0.5 * G_NEWTON) * torch.sum(mass * vals)


def _periodic_between(pos_tgt, pos_src, mass_src, ng: int, box: float,
                      spectra=None):
    """Periodic-box mesh accelerations of targets due to sources: wrapped
    CIC deposit, ng^3 rfftn, the closed-form spectra, wrapped CIC gather.
    Differentiable through autograd (the wrap is the identity almost
    everywhere; the spectra are constants)."""
    rho = _stage("mesh.deposit", _deposit_periodic, pos_src, mass_src, box,
                 ng)
    rho_hat = _stage("mesh.fft", torch.fft.rfftn, rho)
    acc_grids = _pm_force_grids_periodic(rho_hat, box, ng, spectra)
    return _stage("mesh.gather", _gather_periodic, acc_grids, pos_tgt, box,
                  ng) * G_NEWTON


def _periodic_p3m_between(pos_tgt, pos_src, mass_src, same_set: bool,
                          ng: int, box: float, cutoff_cells: int,
                          capacity: int, sr_slabs: int, sr_entries: int,
                          sr_ghosts: int, differentiable: bool = False,
                          spectra=None):
    """Periodic P3M: the periodic long-range mesh solve plus the exact
    short-range correction over ghost images (_periodic_sr_tables), through
    the same sweep as the open path (``differentiable``: as there).
    Gradients reach each ghost's parent through ``_ghost_images``' index.

    Degradation contract, as the JAX package's: dropped ghosts (gcap
    overflow) and capacity-overflowed cells lose short-range exactness for
    their pairs; overflowed real sources and targets keep mesh-quality full
    forces through the complement field.  A ghost that overflowed while its
    parent binned does not turn the complement on (it would count the
    parent's field twice)."""
    sym, pr = _active_sr_layout(pos_src.is_cuda, differentiable)
    tabs = _periodic_sr_tables(
        pos_src, mass_src, ng, box, cutoff_cells, capacity, sr_slabs,
        sr_entries, sr_ghosts, pos_tgt=None if same_set else pos_tgt,
        symmetric=sym, paired=pr)
    ns, gcap = pos_src.shape[1], tabs["gcap"]
    src_w, tgt_w, binned = tabs["src_w"], tabs["tgt_w"], tabs["binned"]
    binned_src = binned[:ns]
    m_over = torch.where(binned_src, 0.0, mass_src)
    over = (~binned_src & (mass_src > 0)).any()
    if not same_set:
        over = over | (~binned[ns + gcap:]).any()
    with spans.sync("p3m_overflow"):
        has_over = bool(over)  # the branch's host sync
    rho = _stage("mesh.deposit", _deposit_periodic, src_w, mass_src, box, ng)
    rho_hat = _stage("mesh.fft", torch.fft.rfftn, rho)
    comb, comp = spectra or _periodic_p3m_spectra(box, ng, tabs["rc2"])
    acc_grids, comp_grids = _periodic_p3m_force_grids(
        rho_hat,
        lambda: _stage("mesh.fft", torch.fft.rfftn, _stage(
            "mesh.deposit", _deposit_periodic, src_w, m_over, box, ng)),
        comb, comp, ng, has_over)
    acc = _stage("mesh.gather", _gather_periodic, acc_grids, tgt_w, box, ng)
    n_e, e_max = tabs["n_e"], tabs["e_max"]
    bounds = torch.stack([torch.zeros_like(n_e), n_e.clamp(max=e_max)])
    atab = _sr_sweep(tabs["ptab"], tabs["mtab"], tabs["wl_t"], tabs["wl_s"],
                     bounds, tabs["rc2"], sym, pr, differentiable)
    tgt = slice(0, ns) if same_set else slice(ns + gcap, None)
    a_sr = _gather_slots(atab, tabs["pslot"][tgt], binned[tgt])
    if has_over:
        a_comp = _stage("mesh.gather", _gather_periodic, comp_grids, tgt_w,
                        box, ng)
    else:
        a_comp = torch.zeros_like(tgt_w)
    acc = acc + torch.where(binned[tgt][None, :], a_sr, a_comp)
    return acc * G_NEWTON


def _make_periodic_env(ng: int, cutoff_cells: int, box: float, device) -> dict:
    """The periodic mesh environment: the force spectra alone (the box is
    fixed, so there is no box to freeze).  They are constants of (box,
    grid, cutoff): the engine builds one a run."""
    if cutoff_cells:
        rc = _periodic_geom(ng, int(cutoff_cells), float(box), device)[2]
        return {"spectra": _periodic_p3m_spectra(float(box), ng, rc * rc)}
    return {"spectra": _pm_force_spectra_periodic(float(box), ng, device)}


# ---------------------------------------------------------------------------
# The solver


def _check_boundary(boundary: str, box_size: float) -> bool:
    """Validate the boundary options; True for periodic."""
    if boundary not in ("open", "periodic"):
        raise ValueError(
            f"unknown boundary {boundary!r}; options: 'open', 'periodic'")
    if boundary == "open":
        return False
    if not box_size or float(box_size) <= 0:
        raise ValueError(
            "boundary='periodic' needs box_size > 0 (the fixed cubic box "
            "edge; positions are wrapped into [0, box_size))")
    return True


def _check_mesh_env(mesh_env: dict, ng: int, cutoff_cells: int,
                    periodic: bool = False):
    """Validate a mesh_env against the solver config; return its spectra:
    ((kx,ky,kz),(sx,sy,sz)) for p3m, (kx,ky,kz) for pm, each over (2ng)^3
    for the open boundary and ng^3 for the periodic one (which is also what
    tells the two apart)."""
    spectra = mesh_env["spectra"]
    env_is_p3m = isinstance(spectra[0], tuple)
    env_m = (spectra[0][0] if env_is_p3m else spectra[0]).shape[0]
    want_m = ng if periodic else 2 * ng
    if env_is_p3m != bool(cutoff_cells) or env_m != want_m:
        raise ValueError(
            "mesh_env was built for a different solver config "
            f"(env spectra {env_m}^3, p3m={env_is_p3m}; call has "
            f"grid={ng}, p3m={bool(cutoff_cells)}, "
            f"boundary={'periodic' if periodic else 'open'} -> "
            f"wants {want_m}^3)")
    return spectra


def _gather_slots(atab, slot, binned):
    """atab[:, slot] for the binned targets; the others, whose value the
    caller masks, read spread slots instead of the sentinel's, so that the
    gather's backward sums no long run of one index."""
    spread = torch.arange(slot.shape[0], dtype=slot.dtype,
                          device=slot.device) % atab.shape[1]
    return atab[:, torch.where(binned, slot, spread)]


def _sr_sweep(ptab, mtab, wl_t, wl_s, bounds, rc2, symmetric: bool,
              paired: bool, differentiable: bool):
    """The short-range sweep of the solver: ``sr_kernel.sweep``, or under
    ``differentiable`` (where paired rows are off) ``sr_kernel.sweep_ad``,
    which carries the VJP (the JAX package's ``_sr_sweep_pallas_ad``)."""
    from . import sr_kernel

    with spans.span("sr"):
        if differentiable:
            return sr_kernel.sweep_ad(ptab, mtab, wl_t, wl_s, bounds, rc2,
                                      symmetric=symmetric)
        return sr_kernel.sweep(ptab, mtab, wl_t, wl_s, bounds, rc2,
                               symmetric=symmetric, paired=paired)


def accelerations_between(pos_tgt, pos_src, mass_src, grid: int = DEFAULT_GRID,
                          cutoff_cells: int = 0, capacity: int = 0,
                          sr_slabs: int = 0, sr_entries: int = 0,
                          sr_ghosts: int = 0, differentiable: bool = False,
                          boundary: str = "open", box_size: float = 0.0,
                          mesh_env: dict | None = None, **_opts):
    """Mesh-solved accelerations of targets due to sources.
    pos_tgt (3, Nt), pos_src (3, Ns), mass_src (Ns,) -> (3, Nt) f32.

    Same-set solves are recognised by identity (``pos_tgt is pos_src``);
    otherwise the targets join the cell tables as massless entries.
    ``cutoff_cells > 0`` adds the exact short-range correction (P3M).
    ``boundary="periodic"`` solves in the fixed box of edge ``box_size``
    (``sr_ghosts``: the P3M ghost-image slots, 0 = _default_ghost_cap).
    ``mesh_env`` (make_mesh_env) freezes the box and the kernel spectra.
    ``differentiable`` runs P3M's sweep with its VJP, paired rows off
    (_sr_sweep); plain pm differentiates through autograd either way.
    Extra registry options (tiles) are accepted and ignored."""
    ng = int(grid)
    if ng < 8:
        raise ValueError(f"pm grid must be >= 8, got {ng}")
    same_set = pos_tgt is pos_src
    pos_src = pos_src.to(_F32)
    pos_tgt = pos_src if same_set else pos_tgt.to(_F32)
    mass_src = mass_src.to(_F32)
    periodic = _check_boundary(boundary, box_size)
    if periodic:
        p_spec = None
        if mesh_env:
            p_spec = _check_mesh_env(mesh_env, ng, cutoff_cells, periodic=True)
        if not cutoff_cells:
            return _periodic_between(pos_tgt, pos_src, mass_src, ng,
                                     float(box_size), spectra=p_spec)
        return _periodic_p3m_between(
            pos_tgt, pos_src, mass_src, same_set, ng, float(box_size),
            int(cutoff_cells), capacity, sr_slabs, sr_entries, sr_ghosts,
            differentiable=differentiable, spectra=p_spec)
    spectra = None
    with spans.span("mesh.box"):
        if mesh_env:
            spectra = _check_mesh_env(mesh_env, ng, cutoff_cells)
            lo_box, hi_box = mesh_env["lo_box"], mesh_env["hi_box"]
        else:
            lo_box, hi_box = _robust_box(pos_src, mass_src)
        span = hi_box - lo_box
        in_src = _inside(pos_src, lo_box, hi_box)
        in_tgt = _inside(pos_tgt, lo_box, hi_box)
        m_in = mass_src * in_src
        M_in, com_in, octs = _outlier_moments(pos_src, mass_src, m_in,
                                              lo_box, hi_box)
        # ng-3 usable cells: one margin cell each side plus the CIC corner.
        h = (span / float(ng - 3))[:, 0]
        inv_h = 1.0 / h[:, None]
        lo = lo_box - h[:, None]
    rho = _stage("mesh.deposit", _deposit, pos_src, m_in, lo, inv_h, ng)
    m = 2 * ng
    rho_hat = _stage("mesh.fft", torch.fft.rfftn, rho, s=(m, m, m))
    if cutoff_cells:
        nc, sub = _cell_grid_params(ng, cutoff_cells)
        n_cells = nc * nc * nc
        ns = pos_src.shape[1]
        with spans.span("p3m.bin"):
            if same_set:
                pos_bin, m_bin, inc = pos_src, m_in, m_in > 0
            else:
                pos_bin = torch.cat([pos_src, pos_tgt], dim=1)
                m_bin = torch.cat([m_in, torch.zeros_like(pos_tgt[0])])
                inc = torch.cat([m_in > 0, in_tgt > 0])
            cap, s_max, e_max = _sr_sizing(ns, pos_bin.shape[1], n_cells,
                                           capacity, sr_slabs, sr_entries)
            rc2 = _sr_rc2(span, nc, sub)
            cid = _bin_cids(pos_bin, lo_box, span, nc, inc)
            ptab, mtab, slab_lo, slab_hi, pslot, binned_all = _sr_pack(
                cid, pos_bin, m_bin, n_cells, cap, s_max,
                _subcell_key(pos_bin, lo_box, span, nc))
            binned = binned_all[:ns]
            m_over = torch.where(binned, 0.0, m_in)
            over = (~binned_all & inc).any()
        with spans.sync("p3m_overflow"):
            has_over = bool(over)  # the branch's host sync
        acc_grids, comp_grids = _p3m_force_grids(
            rho_hat,
            lambda: _stage("mesh.fft", torch.fft.rfftn, _stage(
                "mesh.deposit", _deposit, pos_src, m_over, lo, inv_h, ng),
                s=(m, m, m)),
            h, ng, rc2, has_over, spectra=spectra)
    else:
        acc_grids = _pm_force_grids(rho_hat, h, ng, spectra=spectra)
    acc = _stage("mesh.gather", _gather, acc_grids, pos_tgt, lo, inv_h, ng)
    if cutoff_cells:
        with spans.span("p3m.worklist"):
            sym, pr = _active_sr_layout(ptab.is_cuda, differentiable)
            wl_t, wl_s, n_e = _sr_ranges(slab_lo, slab_hi, nc, sub, e_max,
                                         symmetric=sym, paired=pr)
            bounds = torch.stack([torch.zeros_like(n_e),
                                  n_e.clamp(max=e_max)])
        atab = _sr_sweep(ptab, mtab, wl_t, wl_s, bounds, rc2, sym, pr,
                         differentiable)
        tgt_slot = pslot if same_set else pslot[ns:]
        tgt_binned = binned_all if same_set else binned_all[ns:]
        a_sr = _gather_slots(atab, tgt_slot, tgt_binned)
        if has_over:
            a_comp = _stage("mesh.gather", _gather, comp_grids, pos_tgt, lo,
                            inv_h, ng)
        else:
            a_comp = torch.zeros_like(pos_tgt)
        acc = acc + torch.where(tgt_binned[None, :], a_sr, a_comp)
    with spans.span("mesh.box"):
        acc = torch.where(in_tgt > 0, acc, _monopole(pos_tgt, M_in, com_in))
        for M_k, com_k in octs:
            acc = acc + _monopole(pos_tgt, M_k, com_k)
    return acc * G_NEWTON


def make_mesh_env(pos, mass, grid: int = DEFAULT_GRID, cutoff_cells: int = 0,
                  boundary: str = "open", box_size: float = 0.0,
                  **_opts) -> dict:
    """Per-sample-block mesh environment: the robust source box and the
    (2ng)^3 force-kernel spectra, computed once at block entry and passed
    to every step as ``mesh_env=``.  A periodic env holds the ng^3 spectra
    alone (_make_periodic_env), on ``pos``'s device."""
    ng = int(grid)
    if _check_boundary(boundary, box_size):
        return _make_periodic_env(ng, cutoff_cells, float(box_size),
                                  pos.device)
    lo_box, hi_box = _robust_box(pos.to(_F32), mass.to(_F32))
    span = hi_box - lo_box
    h = (span / float(ng - 3))[:, 0]
    env = {"lo_box": lo_box, "hi_box": hi_box}
    if cutoff_cells:
        nc, sub = _cell_grid_params(ng, int(cutoff_cells))
        env["spectra"] = _p3m_spectra(h, ng, _sr_rc2(span, nc, sub))
    else:
        env["spectra"] = _force_kernel_spectra(h, ng)
    return env


def accelerations(pos, mass, grid: int = DEFAULT_GRID, cutoff_cells: int = 0,
                  capacity: int = 0, sr_slabs: int = 0, sr_entries: int = 0,
                  sr_ghosts: int = 0, differentiable: bool = False,
                  boundary: str = "open", box_size: float = 0.0,
                  mesh_env: dict | None = None, **_opts):
    """All-source mesh accelerations. pos (3,N), mass (N,) -> (3,N).
    Plain pm (``cutoff_cells=0``) is differentiable through autograd; P3M
    with ``differentiable=True`` (accelerations_between)."""
    return accelerations_between(
        pos, pos, mass, grid=grid, cutoff_cells=cutoff_cells,
        capacity=capacity, sr_slabs=sr_slabs, sr_entries=sr_entries,
        sr_ghosts=sr_ghosts, differentiable=differentiable,
        boundary=boundary, box_size=box_size, mesh_env=mesh_env)


def p3m_accelerations(pos, mass, grid: int = DEFAULT_GRID,
                      cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                      capacity: int = 0, sr_slabs: int = 0,
                      sr_entries: int = 0, sr_ghosts: int = 0,
                      differentiable: bool = False,
                      boundary: str = "open", box_size: float = 0.0,
                      mesh_env: dict | None = None, **_opts):
    """The ``p3m`` registry entry: the short-range correction on by
    default."""
    return accelerations_between(
        pos, pos, mass, grid=grid,
        cutoff_cells=cutoff_cells or DEFAULT_CUTOFF_CELLS,
        capacity=capacity, sr_slabs=sr_slabs, sr_entries=sr_entries,
        sr_ghosts=sr_ghosts, differentiable=differentiable,
        boundary=boundary, box_size=box_size, mesh_env=mesh_env)


def p3m_accelerations_between(pos_tgt, pos_src, mass_src,
                              grid: int = DEFAULT_GRID,
                              cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                              capacity: int = 0, sr_slabs: int = 0,
                              sr_entries: int = 0, sr_ghosts: int = 0,
                              differentiable: bool = False,
                              boundary: str = "open", box_size: float = 0.0,
                              **_opts):
    return accelerations_between(
        pos_tgt, pos_src, mass_src, grid=grid,
        cutoff_cells=cutoff_cells or DEFAULT_CUTOFF_CELLS,
        capacity=capacity, sr_slabs=sr_slabs, sr_entries=sr_entries,
        sr_ghosts=sr_ghosts, differentiable=differentiable,
        boundary=boundary, box_size=box_size)


# ---------------------------------------------------------------------------
# The plan: capacity, slab and worklist sizes measured on a concrete state


def _plan_bin(pos, mass, grid: int, cutoff_cells: int, boundary: str,
              box_size: float, gcap: int = 0):
    """The plan functions' binning of one state, onto the cells the solver
    bins on: the in-box massive particles (open), or the sources wrapped
    into the box and their ghost images packed into ``gcap`` slots (0: the
    guaranteed 7N, which holds every image).  Returns ``(n_slots, cid,
    n_in, nc, sub, n_ghost)``: the slots, their int32 cell ids (the
    ``nc^3`` sentinel where excluded), the binned count, the cells a side
    (ghost-extended when periodic), the reach, and the exact image count
    whatever ``gcap`` (0 when open); both counts 0-d int32."""
    pos, mass = pos.to(_F32), mass.to(_F32)
    if boundary == "periodic":
        box = float(box_size)
        _, sub, rc, nc, lo_cell, span_tot = _periodic_geom(
            int(grid), int(cutoff_cells), box, pos.device)
        pos_b, m_b, cid, n_ghost = _periodic_ghost_bin(
            _wrap_box(pos, box), mass, box, rc, nc, lo_cell, span_tot,
            int(gcap) or 7 * pos.shape[1])
    else:
        lo_box, hi_box = _robust_box(pos, mass)
        nc, sub = _cell_grid_params(int(grid), int(cutoff_cells))
        m_b = mass * _inside(pos, lo_box, hi_box)
        pos_b, cid = pos, _bin_cids(pos, lo_box, hi_box - lo_box, nc, m_b > 0)
        n_ghost = torch.zeros((), dtype=_I32, device=pos.device)
    return pos_b.shape[1], cid, (m_b > 0).sum(dtype=_I32), nc, sub, n_ghost


def _cid_counts(cid, n_cells: int):
    """Per-cell counts (n_cells,) int32 of the cell ids; the sentinel
    ``n_cells`` is not counted."""
    counts = torch.zeros(n_cells + 1, dtype=_I32, device=cid.device)
    counts.scatter_add_(0, cid.long(), torch.ones_like(cid))
    return counts[:-1]


def _cell_counts(pos, mass, grid: int, cutoff_cells: int,
                 boundary: str = "open", box_size: float = 0.0):
    """Per-cell in-box massive-particle counts (n_cells,) and the in-box
    count, both int32.  The periodic boundary counts on the ghost-extended
    grid, the ghost images included (a capacity must cover the ghost cells
    too: they mirror the densest boundary regions)."""
    _, cid, n_in, nc, _, _ = _plan_bin(pos, mass, grid, cutoff_cells,
                                       boundary, box_size)
    return _cid_counts(cid, nc ** 3), n_in


def _overflow_frac(counts, n_in, cap: int):
    return (counts - cap).clamp_min(0).sum() / n_in.clamp_min(1)


def _max_occupancy(pos, mass, grid: int, cutoff_cells: int,
                   boundary: str = "open", box_size: float = 0.0):
    return _cell_counts(pos, mass, grid, cutoff_cells, boundary,
                        box_size)[0].max()


def _n_cells(grid: int, cutoff_cells: int, boundary: str) -> int:
    """The cells the solver bins on: the ghost-extended (nc + 2 sub)^3 grid
    under the periodic boundary, nc^3 under the open one."""
    if boundary == "periodic":
        nc, sub = _periodic_cells(int(grid), int(cutoff_cells))
        return (nc + 2 * sub) ** 3
    return _cell_grid_params(int(grid), int(cutoff_cells))[0] ** 3


def cell_overflow_fraction(pos, mass, grid: int = DEFAULT_GRID,
                           cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                           capacity: int = 0, boundary: str = "open",
                           box_size: float = 0.0):
    """Fraction of in-box massive particles (and, periodic, ghost images)
    the P3M cell list cannot bin at ``capacity`` (0 resolves as the solver
    does, on the solver's cell count), as a 0-d tensor."""
    _check_boundary(boundary, box_size)
    cap = int(capacity) or _auto_capacity(
        pos.shape[1], _n_cells(grid, cutoff_cells, boundary))
    counts, n_in = _cell_counts(pos, mass, grid, cutoff_cells, boundary,
                                box_size)
    return _overflow_frac(counts, n_in, cap)


def suggest_capacity(pos, mass, grid: int = DEFAULT_GRID,
                     cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                     headroom: float = 1.25, max_capacity: int = 2048,
                     boundary: str = "open", box_size: float = 0.0) -> int:
    """Host-side cell capacity: the measured max cell occupancy times
    ``headroom``, a power of two in [64, max_capacity]."""
    _check_boundary(boundary, box_size)
    occ = _read(_max_occupancy(pos, mass, int(grid), int(cutoff_cells),
                               boundary, box_size), "plan")
    cap = 64
    while cap < headroom * occ and cap < max_capacity:
        cap *= 2
    return cap


def _ghost_count(pos, mass, grid: int, cutoff_cells: int, box_size: float):
    """The exact number of periodic ghost images of this state (0-d)."""
    box = float(box_size)
    rc = _periodic_geom(int(grid), int(cutoff_cells), box, pos.device)[2]
    return _ghost_images(_wrap_box(pos.to(_F32), box), mass.to(_F32), box,
                         rc, 1)[2]


def ghost_overflow_count(pos, mass, grid: int = DEFAULT_GRID,
                         cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                         sr_ghosts: int = 0, box_size: float = 0.0) -> int:
    """Periodic ghost images beyond the ghost cap for this state (the cap 0
    resolves as the solver does).  Nonzero means cross-boundary pairs lose
    their whole short-range term (no complement makes up for them): raise
    ``sr_ghosts`` or re-run suggest_sr_plan.  The count read adds to
    ``spans.counts["ghost_images"]``."""
    gcap = _ghost_cap(pos.shape[1], sr_ghosts)
    n = _read(_ghost_count(pos, mass, grid, cutoff_cells, box_size),
              "ghost_overflow")
    spans.counts["ghost_images"] += n
    return max(0, n - gcap)


def _entry_count(cid, n_slots: int, nc: int, sub: int, cap: int,
                 layout: tuple):
    """The exact worklist entry count (0-d int32) of a binning in the
    (symmetric, paired) ``layout``, and ``_sr_slots``' binned mask."""
    slab_lo, slab_hi, binned = _sr_slots(cid, nc ** 3, int(cap),
                                         n_slots // SLAB + 2)
    sym, pr = layout
    return _sr_ranges(slab_lo, slab_hi, nc, sub, 1, symmetric=sym,
                      paired=pr)[2], binned


def _sr_plan_counts(pos, mass, grid: int, cutoff: int, cap: int,
                    layout: tuple, boundary: str = "open",
                    box_size: float = 0.0):
    """Measured (S, E, n_ghost): the packed slab count, the exact worklist
    entry count in ``layout``, and (periodic) the exact ghost image count
    for this state; the periodic tables are binned at the guaranteed 7N
    ghost bound."""
    n_slots, cid, _, nc, sub, n_ghost = _plan_bin(pos, mass, grid, cutoff,
                                                  boundary, box_size)
    n_e, binned = _entry_count(cid, n_slots, nc, sub, cap, layout)
    return binned.sum(dtype=_I32) // SLAB + 2, n_e, n_ghost


def _active_sr_layout(on_cuda: bool, differentiable: bool = False) -> tuple:
    """The (symmetric, paired) layout the solver dispatches on a state on
    the CUDA card (``on_cuda``) or on the CPU, under the current module
    layout: paired rows only for the card's kernel, never differentiable;
    SR_SYMMETRIC None is the reaction on the CPU only.  Plans must be sized
    through this, or the worklist they size is not the one that runs and
    entries drop without an error."""
    sym = (not on_cuda) if SR_SYMMETRIC is None else SR_SYMMETRIC
    return sym, SR_PAIRED_ROWS and on_cuda and not differentiable


def _pow2_at_least(x):
    v = 64
    while v < x:
        v *= 2
    return v


def suggest_sr_plan(pos, mass, grid: int = DEFAULT_GRID,
                    cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                    capacity: int = 0, headroom: float = 1.5,
                    boundary: str = "open", box_size: float = 0.0,
                    layout=None, differentiable: bool = False) -> dict:
    """Host-side short-range plan from the concrete state: the measured
    slab count and the worklist entry count of the layout that will run
    (``layout=None``: the active one on the state's device; a name from
    SR_LAYOUTS; or ``"full"``; ``differentiable``: for a differentiable
    call, whose layout has no paired rows), times ``headroom``, rounded up
    to powers of two.  Returns ``{"capacity", "sr_slabs", "sr_entries"}``, and under the
    periodic boundary ``"sr_ghosts"``: the measured image count times
    ``headroom``, capped at the guaranteed 7N."""
    _check_boundary(boundary, box_size)
    if layout == "full":
        sym, pr = False, False
    elif layout is None:
        sym, pr = _active_sr_layout(pos.is_cuda, differentiable)
    else:
        if layout not in SR_LAYOUTS:
            raise ValueError(f"unknown SR layout {layout!r}; options: "
                             f"{tuple(SR_LAYOUTS)} or 'full'")
        sym, want_pr = SR_LAYOUTS[layout]
        pr = want_pr and pos.is_cuda and not differentiable
    cap = int(capacity) or suggest_capacity(pos, mass, grid, cutoff_cells,
                                            boundary=boundary,
                                            box_size=box_size)
    s, e, g = _sr_plan_counts(pos, mass, int(grid), int(cutoff_cells), cap,
                              (sym, pr), boundary, box_size)
    s_planned = _pow2_at_least(_read(s, "plan") * headroom)
    e = _read(e, "plan")
    plan = {"capacity": cap, "sr_slabs": s_planned,
            "sr_entries": _pow2_at_least(e * headroom)}
    if boundary == "periodic":
        plan["sr_ghosts"] = min(_pow2_at_least(_read(g, "plan") * headroom),
                                7 * pos.shape[1])
    return plan


def _entry_guard_sizing(ns: int, grid: int, cutoff_cells: int, capacity: int,
                        sr_slabs: int, sr_entries: int, boundary: str,
                        sr_ghosts: int = 0) -> tuple:
    """(cap, s_max, e_max) as the solver sizes its tables: the slab tables
    hold ``n_bin`` slots, the sources and, periodic, the ghost cap.  (The
    JAX package's guard sizes periodic tables from the sources alone.)"""
    n_bin = ns + (_ghost_cap(ns, sr_ghosts) if boundary == "periodic" else 0)
    return _sr_sizing(ns, n_bin, _n_cells(grid, cutoff_cells, boundary),
                      capacity, sr_slabs, sr_entries)


def sr_entry_overflow(pos, mass, grid: int = DEFAULT_GRID,
                      cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                      capacity: int = 0, sr_slabs: int = 0,
                      sr_entries: int = 0, boundary: str = "open",
                      box_size: float = 0.0, sr_ghosts: int = 0,
                      differentiable: bool = False) -> int:
    """Worklist entries this state would drop past the static
    ``sr_entries`` under the active layout, or that of a differentiable
    call (0 for the guaranteed bound)."""
    _check_boundary(boundary, box_size)
    if not int(sr_entries):
        return 0
    cap, _, e_max = _entry_guard_sizing(
        pos.shape[1], grid, cutoff_cells, capacity, sr_slabs, sr_entries,
        boundary, sr_ghosts)
    n_e = _sr_plan_counts(pos, mass, int(grid), int(cutoff_cells), cap,
                          _active_sr_layout(pos.is_cuda, differentiable),
                          boundary, box_size)[1]
    return max(0, _read(n_e, "entry_overflow") - e_max)


def sr_plan_health(pos, mass, grid: int = DEFAULT_GRID,
                   cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                   capacity: int = 0, sr_slabs: int = 0, sr_entries: int = 0,
                   sr_ghosts: int = 0, boundary: str = "open",
                   box_size: float = 0.0) -> tuple:
    """The plan health check's three readings of one state, from one
    binning and one copy to the host (``sync.health``): ``(fraction,
    ghosts, entries)``, equal to ``cell_overflow_fraction``,
    ``ghost_overflow_count`` (0 under the open boundary) and
    ``sr_entry_overflow`` (the active layout's worklist alone) called
    apart.  The image count adds to ``spans.counts["ghost_images"]``.

    A periodic state bins at the solver's ghost cap, not at the guaranteed
    7N.  While every image fits in the cap, the first n_ghost slots hold
    the same images in the same order and the rest are massless, so the
    cell counts, the stable sort and every slab that holds a particle are
    the same; the cap's fewer sentinel slabs add nothing to an entry count.
    Where the images overflow the cap, the fraction and the entries are
    measured again at 7N (``spans.counts["health_full_bins"]``)."""
    periodic = _check_boundary(boundary, box_size)
    ns = pos.shape[1]
    cap, _, e_max = _entry_guard_sizing(ns, grid, cutoff_cells, capacity,
                                        sr_slabs, sr_entries, boundary,
                                        sr_ghosts)
    gcap = _ghost_cap(ns, sr_ghosts)

    def readings(ghost_slots: int) -> tuple:
        n_slots, cid, n_in, nc, sub, n_ghost = _plan_bin(
            pos, mass, grid, cutoff_cells, boundary, box_size, ghost_slots)
        frac = _overflow_frac(_cid_counts(cid, nc ** 3), n_in, cap)
        n_e = _entry_count(cid, n_slots, nc, sub, cap,
                           _active_sr_layout(pos.is_cuda))[0] \
            if int(sr_entries) else torch.zeros_like(n_ghost)
        # float64 holds the f32 fraction and both int32 counts exactly.
        with spans.sync("health"):
            frac, n_ghost, n_e = torch.stack(
                [frac.double(), n_ghost.double(), n_e.double()]).tolist()
        return frac, int(n_ghost), int(n_e)

    frac, n_ghost, n_e = readings(gcap if periodic else 0)
    if n_ghost > gcap:
        spans.counts["health_full_bins"] += 1
        frac, _, n_e = readings(7 * ns)
    if periodic:
        spans.counts["ghost_images"] += n_ghost
    return frac, max(0, n_ghost - gcap), max(0, n_e - e_max)


def force_error_vs_exact(pos, mass, grid: int = DEFAULT_GRID,
                         cutoff_cells: int = 0, capacity: int = 0):
    """Relative L2 force error of the mesh solve (pm, or p3m when
    ``cutoff_cells`` > 0) against the exact all-pairs forces of ``auto``
    (``naive`` on the CPU, Kernel B or A on the card), as a 0-d tensor."""
    from . import registry

    a_pm = accelerations(pos, mass, grid=grid, cutoff_cells=cutoff_cells,
                         capacity=capacity)
    a_ref = registry.get("auto")(pos, mass)
    num = torch.sqrt(torch.sum((a_pm - a_ref) ** 2))
    den = torch.sqrt(torch.sum(a_ref ** 2))
    return num / den.clamp_min(1e-30)

"""Particle-mesh (PM) and P3M force solvers, open boundary.

The port of ``nbody_tpu/ops/pm.py`` for the isolated (vacuum) boundary:
the O(N log N) tier above the exact all-pairs kernels.  The method and
its measured accuracy are described there; in short:

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

What differs from the JAX package:

* The transforms are ``torch.fft.rfftn``/``irfftn`` (cuFFT on the card),
  not full-complex ``fftn``/``ifftn``: the JAX package avoided ``irfftn``
  only because the TPU's was broken.  Spectra are the half spectra
  (m, m, m//2+1).
* The overflow ``lax.cond`` is a Python branch on ``bool(has_over)``: one
  host sync per P3M step (counted in ``host_syncs``).  Computing both
  branches instead would cost seven extra (2 ng)^3 transforms a step.
* The short-range dispatch: on a CUDA tensor the hand kernel in the layout
  ``SR_SYMMETRIC`` / ``SR_PAIRED_ROWS`` (paired rows only on the card, as
  the JAX package pairs them only on its accelerator); on the CPU the plain
  sweep, unpaired.  By default the card runs paired rows without the
  symmetric reaction, which the JAX package adds on every device: on the
  card the reaction's atomics add in no fixed order, and the default layout
  repeats bit for bit.  The VMEM gate, the Mosaic probe and ``SR_FLUSH_RUNS``
  of the JAX package are TPU machinery and are not ported.
* The periodic boundary (ROADMAP.md queue 1 item 9), the differentiable
  P3M sweep (item 10) and the sharded solve (item 11) are not ported yet
  and raise ``NotImplementedError``.  Plain PM (``cutoff_cells=0``) is
  differentiable through autograd as it stands.
"""

from __future__ import annotations

import math

import torch

from ..types import G_NEWTON, SOFTENING_SQUARED

DEFAULT_GRID = 128
# P3M split radius in cell-list cells (R_c ~ cutoff_cells grid spacings).
DEFAULT_CUTOFF_CELLS = 4

# Slots per slab: the dense pair-block edge of the short-range sweep.
SLAB = 64

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

# Host syncs taken by the P3M overflow branch (one per solve).
host_syncs = 0

_I32 = torch.int32
_F32 = torch.float32


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


def _corner_iter(i0, frac):
    """The 8 CIC corners: yields (index triple, weight (N,))."""
    for cx in (0, 1):
        wx = frac[0] if cx else 1.0 - frac[0]
        for cy in (0, 1):
            wy = frac[1] if cy else 1.0 - frac[1]
            for cz in (0, 1):
                wz = frac[2] if cz else 1.0 - frac[2]
                yield (i0[0] + cx, i0[1] + cy, i0[2] + cz), wx * wy * wz


def _deposit(pos, mass, lo, inv_h, ng: int):
    """CIC scatter of masses onto an (ng, ng, ng) f32 grid: one accumulating
    ``index_put_`` of all 8 corners on the flat grid."""
    i0, frac = _cic_weights(pos, lo, inv_h, ng)
    idx, val = [], []
    for (ix, iy, iz), w in _corner_iter(i0, frac):
        idx.append((ix * ng + iy) * ng + iz)
        val.append(mass * w)
    grid = torch.zeros(ng * ng * ng, dtype=_F32, device=pos.device)
    grid.index_put_((torch.cat(idx).long(),), torch.cat(val),
                    accumulate=True)
    return grid.view(ng, ng, ng)


def _gather(grids, pos, lo, inv_h, ng: int):
    """CIC interpolation of 3 (ng,ng,ng) grids at pos (3,N) -> (3,N),
    through flat 1-D indices."""
    i0, frac = _cic_weights(pos, lo, inv_h, ng)
    flat = grids.reshape(3, ng * ng * ng)
    out = torch.zeros((3, pos.shape[1]), dtype=_F32, device=pos.device)
    for (ix, iy, iz), w in _corner_iter(i0, frac):
        out = out + w * flat.index_select(1, (ix * ng + iy) * ng + iz)
    return out


def _cic_sharpen(ng: int, device):
    """Inverse squared CIC window on the doubled m = 2 ng grid, as the half
    spectrum of the real transform: shape (m, m, m//2+1)."""
    m = 2 * ng
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
    return _inverse((rho_hat * kx, rho_hat * ky, rho_hat * kz), ng)


def _p3m_force_grids(rho_hat, rho_over_hat_fn, h, ng: int, rc2,
                     has_over: bool, spectra=None):
    """(acc_grids, comp_grids) of the P3M split.  With overflow, the
    overflowed sources also deposit through the complement kernel and
    ``comp_grids`` carries the binned mass's complement field for
    overflowed targets; without, the seven extra transforms are skipped
    and ``comp_grids`` is None.
    ``has_over`` is a Python bool: the caller's one host sync."""
    (kx, ky, kz), (sx, sy, sz) = spectra or _p3m_spectra(h, ng, rc2)
    if has_over:
        roh = rho_over_hat_fn()
        g = _inverse((rho_hat * kx + roh * sx, rho_hat * ky + roh * sy,
                      rho_hat * kz + roh * sz), ng)
        rest = rho_hat - roh
        return g, _inverse((rest * sx, rest * sy, rest * sz), ng)
    return _inverse((rho_hat * kx, rho_hat * ky, rho_hat * kz), ng), None


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
        nanpos, torch.tensor([0.005, 0.995], dtype=_F32, device=pos.device),
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


def _sr_pack(cid, pos, mass, n_cells: int, cap: int, s_max: int):
    """Packed slab tables: SLAB consecutive cid-sorted particles per slab.

    ``cid`` (Ns,) int32 in [0, n_cells]; ``n_cells`` marks excluded
    particles, and particles past a cell's capacity are excluded too.
    Returns ``(ptab (3, (s_max+1)*SLAB), mtab, slab_lo (s_max,), slab_hi,
    pslot (Ns,), binned (Ns,))``; slab ``s_max`` is the zero-mass sentinel.
    The sort is stable, as JAX's, so the tables equal the JAX package's."""
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
    perm = order[pord]
    pc = torch.where(valid, sc, n_cells)[pord]
    nslots = (s_max + 1) * SLAB
    ok = (ar < n_bin) & (ar < s_max * SLAB)
    slot = torch.where(ok, ar, nslots - 1)
    kk = torch.arange(nslots, dtype=_I32, device=dev)
    okk = (kk < n_bin) & (kk < s_max * SLAB)
    src = perm[kk.clamp(max=ns - 1)]
    ptab = torch.where(okk[None, :], pos[:, src], 0.0)
    mtab = torch.where(okk, mass[src], 0.0)
    pslot = torch.zeros_like(ar).scatter_(0, perm.long(), slot)
    binned = pslot != (nslots - 1)
    sidx = torch.arange(s_max, dtype=_I32, device=dev) * SLAB
    has = sidx < n_bin
    last = torch.minimum(sidx + (SLAB - 1), n_bin - 1).clamp(0, ns - 1)
    slab_lo = torch.where(has, pc[sidx.clamp(max=ns - 1)], n_cells)
    slab_hi = torch.where(has, pc[last], n_cells)
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
    off_arr = torch.tensor(offs, dtype=_I32, device=dev)[None, :]
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
    ptab, mtab, slab_lo, slab_hi, _, _ = _sr_pack(cid, pos, mass, n_cells,
                                                  cap, s_max)
    wl_t, wl_s, n_e = _sr_ranges(slab_lo, slab_hi, nc, sub, e_max,
                                 symmetric=symmetric, paired=paired)
    return dict(ptab=ptab, mtab=mtab, wl_t=wl_t, wl_s=wl_s, n_e=n_e,
                e_max=e_max, rc2=_sr_rc2(span, nc, sub))


# ---------------------------------------------------------------------------
# The solver


def _check_boundary(boundary: str, box_size: float) -> bool:
    """Validate the boundary mode.  Only the open boundary is ported."""
    if boundary not in ("open", "periodic"):
        raise ValueError(
            f"unknown boundary {boundary!r}; options: 'open', 'periodic'")
    if boundary == "periodic" or box_size:
        raise NotImplementedError(
            "the periodic boundary is not ported yet: ROADMAP.md queue 1 "
            "item 9 (periodic boundary)")
    return False


def _check_mesh_env(mesh_env: dict, ng: int, cutoff_cells: int):
    """Validate a mesh_env against the solver config; return its spectra:
    ((kx,ky,kz),(sx,sy,sz)) for p3m, (kx,ky,kz) for pm, each (2ng)^3."""
    spectra = mesh_env["spectra"]
    env_is_p3m = isinstance(spectra[0], tuple)
    env_m = (spectra[0][0] if env_is_p3m else spectra[0]).shape[0]
    want_m = 2 * ng
    if env_is_p3m != bool(cutoff_cells) or env_m != want_m:
        raise ValueError(
            "mesh_env was built for a different solver config "
            f"(env spectra {env_m}^3, p3m={env_is_p3m}; call has "
            f"grid={ng}, p3m={bool(cutoff_cells)}, boundary=open -> "
            f"wants {want_m}^3)")
    return spectra


def _refuse_differentiable_p3m():
    raise NotImplementedError(
        "differentiable P3M is not ported yet: ROADMAP.md queue 1 item 10 "
        "(differentiable P3M); plain pm (no cutoff) differentiates natively")


def accelerations_between(pos_tgt, pos_src, mass_src, grid: int = DEFAULT_GRID,
                          cutoff_cells: int = 0, capacity: int = 0,
                          sr_slabs: int = 0, sr_entries: int = 0,
                          differentiable: bool = False,
                          boundary: str = "open", box_size: float = 0.0,
                          mesh_env: dict | None = None, **_opts):
    """Mesh-solved accelerations of targets due to sources, open boundary.
    pos_tgt (3, Nt), pos_src (3, Ns), mass_src (Ns,) -> (3, Nt) f32.

    Same-set solves are recognised by identity (``pos_tgt is pos_src``);
    otherwise the targets join the cell tables as massless entries.
    ``cutoff_cells > 0`` adds the exact short-range correction (P3M).
    ``mesh_env`` (make_mesh_env) freezes the box and the kernel spectra.
    Extra registry options (tiles) are accepted and ignored."""
    global host_syncs
    ng = int(grid)
    if ng < 8:
        raise ValueError(f"pm grid must be >= 8, got {ng}")
    same_set = pos_tgt is pos_src
    pos_src = pos_src.to(_F32)
    pos_tgt = pos_src if same_set else pos_tgt.to(_F32)
    mass_src = mass_src.to(_F32)
    _check_boundary(boundary, box_size)
    if cutoff_cells and differentiable:
        _refuse_differentiable_p3m()
    spectra = None
    if mesh_env:
        spectra = _check_mesh_env(mesh_env, ng, cutoff_cells)
        lo_box, hi_box = mesh_env["lo_box"], mesh_env["hi_box"]
    else:
        lo_box, hi_box = _robust_box(pos_src, mass_src)
    span = hi_box - lo_box
    in_src = _inside(pos_src, lo_box, hi_box)
    in_tgt = _inside(pos_tgt, lo_box, hi_box)
    m_in = mass_src * in_src
    M_in, com_in, octs = _outlier_moments(pos_src, mass_src, m_in, lo_box,
                                          hi_box)
    # ng-3 usable cells: one margin cell each side plus the CIC corner.
    h = (span / float(ng - 3))[:, 0]
    inv_h = 1.0 / h[:, None]
    lo = lo_box - h[:, None]
    rho = _deposit(pos_src, m_in, lo, inv_h, ng)
    m = 2 * ng
    rho_hat = torch.fft.rfftn(rho, s=(m, m, m))
    if cutoff_cells:
        from . import sr_kernel

        nc, sub = _cell_grid_params(ng, cutoff_cells)
        n_cells = nc * nc * nc
        ns = pos_src.shape[1]
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
            cid, pos_bin, m_bin, n_cells, cap, s_max)
        binned = binned_all[:ns]
        m_over = torch.where(binned, 0.0, m_in)
        has_over = bool((~binned_all & inc).any())  # the one host sync
        host_syncs += 1
        acc_grids, comp_grids = _p3m_force_grids(
            rho_hat,
            lambda: torch.fft.rfftn(_deposit(pos_src, m_over, lo, inv_h, ng),
                                    s=(m, m, m)),
            h, ng, rc2, has_over, spectra=spectra)
    else:
        acc_grids = _pm_force_grids(rho_hat, h, ng, spectra=spectra)
    acc = _gather(acc_grids, pos_tgt, lo, inv_h, ng)
    if cutoff_cells:
        sym, pr = _active_sr_layout(ptab.is_cuda)
        wl_t, wl_s, n_e = _sr_ranges(slab_lo, slab_hi, nc, sub, e_max,
                                     symmetric=sym, paired=pr)
        bounds = torch.stack([torch.zeros_like(n_e),
                              n_e.clamp(max=e_max)])
        atab = sr_kernel.sweep(ptab, mtab, wl_t, wl_s, bounds, rc2,
                               symmetric=sym, paired=pr)
        tgt_slot = pslot if same_set else pslot[ns:]
        tgt_binned = binned_all if same_set else binned_all[ns:]
        a_sr = atab[:, tgt_slot]
        if has_over:
            a_comp = _gather(comp_grids, pos_tgt, lo, inv_h, ng)
        else:
            a_comp = torch.zeros_like(pos_tgt)
        acc = acc + torch.where(tgt_binned[None, :], a_sr, a_comp)
    acc = torch.where(in_tgt > 0, acc, _monopole(pos_tgt, M_in, com_in))
    for M_k, com_k in octs:
        acc = acc + _monopole(pos_tgt, M_k, com_k)
    return acc * G_NEWTON


def make_mesh_env(pos, mass, grid: int = DEFAULT_GRID, cutoff_cells: int = 0,
                  boundary: str = "open", box_size: float = 0.0,
                  **_opts) -> dict:
    """Per-sample-block mesh environment: the robust source box and the
    (2ng)^3 force-kernel spectra, computed once at block entry and passed
    to every step as ``mesh_env=``."""
    ng = int(grid)
    _check_boundary(boundary, box_size)
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
                  differentiable: bool = False,
                  boundary: str = "open", box_size: float = 0.0,
                  mesh_env: dict | None = None, **_opts):
    """All-source mesh accelerations. pos (3,N), mass (N,) -> (3,N).
    Plain pm (``cutoff_cells=0``) is differentiable through autograd."""
    return accelerations_between(
        pos, pos, mass, grid=grid, cutoff_cells=cutoff_cells,
        capacity=capacity, sr_slabs=sr_slabs, sr_entries=sr_entries,
        differentiable=differentiable, boundary=boundary, box_size=box_size,
        mesh_env=mesh_env)


def p3m_accelerations(pos, mass, grid: int = DEFAULT_GRID,
                      cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                      capacity: int = 0, sr_slabs: int = 0,
                      sr_entries: int = 0, differentiable: bool = False,
                      boundary: str = "open", box_size: float = 0.0,
                      mesh_env: dict | None = None, **_opts):
    """The ``p3m`` registry entry: the short-range correction on by
    default."""
    return accelerations_between(
        pos, pos, mass, grid=grid,
        cutoff_cells=cutoff_cells or DEFAULT_CUTOFF_CELLS,
        capacity=capacity, sr_slabs=sr_slabs, sr_entries=sr_entries,
        differentiable=differentiable, boundary=boundary, box_size=box_size,
        mesh_env=mesh_env)


def p3m_accelerations_between(pos_tgt, pos_src, mass_src,
                              grid: int = DEFAULT_GRID,
                              cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                              capacity: int = 0, sr_slabs: int = 0,
                              sr_entries: int = 0,
                              differentiable: bool = False,
                              boundary: str = "open", box_size: float = 0.0,
                              **_opts):
    return accelerations_between(
        pos_tgt, pos_src, mass_src, grid=grid,
        cutoff_cells=cutoff_cells or DEFAULT_CUTOFF_CELLS,
        capacity=capacity, sr_slabs=sr_slabs, sr_entries=sr_entries,
        differentiable=differentiable, boundary=boundary, box_size=box_size)


# ---------------------------------------------------------------------------
# The plan: capacity, slab and worklist sizes measured on a concrete state


def _cell_counts(pos, mass, grid: int, cutoff_cells: int):
    """Per-cell in-box massive-particle counts (n_cells,) and the in-box
    count, both int32."""
    pos, mass = pos.to(_F32), mass.to(_F32)
    lo_box, hi_box = _robust_box(pos, mass)
    nc, _ = _cell_grid_params(int(grid), int(cutoff_cells))
    n_cells = nc * nc * nc
    m_in = mass * _inside(pos, lo_box, hi_box)
    cid = _bin_cids(pos, lo_box, hi_box - lo_box, nc, m_in > 0)
    counts = torch.zeros(n_cells + 1, dtype=_I32, device=pos.device)
    counts.scatter_add_(0, cid.long(), torch.ones_like(cid))
    return counts[:-1], (m_in > 0).sum(dtype=_I32)


def _overflow_frac(counts, n_in, cap: int):
    return (counts - cap).clamp_min(0).sum() / n_in.clamp_min(1)


def _max_occupancy(pos, mass, grid: int, cutoff_cells: int):
    return _cell_counts(pos, mass, grid, cutoff_cells)[0].max()


def cell_overflow_fraction(pos, mass, grid: int = DEFAULT_GRID,
                           cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                           capacity: int = 0, boundary: str = "open",
                           box_size: float = 0.0):
    """Fraction of in-box massive particles the P3M cell list cannot bin
    at ``capacity`` (0 resolves as the solver does), as a 0-d tensor."""
    _check_boundary(boundary, box_size)
    nc, _ = _cell_grid_params(int(grid), int(cutoff_cells))
    cap = int(capacity) or _auto_capacity(pos.shape[1], nc ** 3)
    counts, n_in = _cell_counts(pos, mass, grid, cutoff_cells)
    return _overflow_frac(counts, n_in, cap)


def suggest_capacity(pos, mass, grid: int = DEFAULT_GRID,
                     cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                     headroom: float = 1.25, max_capacity: int = 2048,
                     boundary: str = "open", box_size: float = 0.0) -> int:
    """Host-side cell capacity: the measured max cell occupancy times
    ``headroom``, a power of two in [64, max_capacity]."""
    _check_boundary(boundary, box_size)
    occ = int(_max_occupancy(pos, mass, int(grid), int(cutoff_cells)))
    cap = 64
    while cap < headroom * occ and cap < max_capacity:
        cap *= 2
    return cap


# Index order of the per-layout entry counts: symmetric + 2 * paired.
_SR_COMBOS = ((False, False), (True, False), (False, True), (True, True))


def _count_all_layouts(slab_lo, slab_hi, nc: int, sub: int):
    """Worklist entry count of every (symmetric, paired) layout, (4,)."""
    return torch.stack([
        _sr_ranges(slab_lo, slab_hi, nc, sub, 1, symmetric=sym,
                   paired=pr)[2] for sym, pr in _SR_COMBOS])


def _sr_plan_counts(pos, mass, grid: int, cutoff: int, cap: int):
    """Measured (S, E[4]): the packed slab count and the exact worklist
    entry count of every layout for this state."""
    pos, mass = pos.to(_F32), mass.to(_F32)
    ns = pos.shape[1]
    lo_box, hi_box = _robust_box(pos, mass)
    nc, sub = _cell_grid_params(int(grid), int(cutoff))
    n_cells = nc * nc * nc
    span = hi_box - lo_box
    m_in = mass * _inside(pos, lo_box, hi_box)
    cid = _bin_cids(pos, lo_box, span, nc, m_in > 0)
    _, _, slab_lo, slab_hi, _, binned = _sr_pack(cid, pos, m_in, n_cells,
                                                 int(cap), ns // SLAB + 2)
    n_e4 = _count_all_layouts(slab_lo, slab_hi, nc, sub)
    n_bin = binned.sum(dtype=_I32)
    return n_bin // SLAB + 2, n_e4


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
                    layout=None) -> dict:
    """Host-side short-range plan from the concrete state: the measured
    slab count and the worklist entry count of the layout that will run
    (``layout=None``: the active one on the state's device; a name from
    SR_LAYOUTS; or ``"full"``), times ``headroom``, rounded up to powers of
    two.  Returns ``{"capacity", "sr_slabs", "sr_entries"}``."""
    _check_boundary(boundary, box_size)
    cap = int(capacity) or suggest_capacity(pos, mass, grid, cutoff_cells)
    s, e4 = _sr_plan_counts(pos, mass, int(grid), int(cutoff_cells), cap)
    s_planned = _pow2_at_least(int(s) * headroom)
    if layout == "full":
        sym, pr = False, False
    elif layout is None:
        sym, pr = _active_sr_layout(pos.is_cuda)
    else:
        if layout not in SR_LAYOUTS:
            raise ValueError(f"unknown SR layout {layout!r}; options: "
                             f"{tuple(SR_LAYOUTS)} or 'full'")
        sym, want_pr = SR_LAYOUTS[layout]
        pr = want_pr and pos.is_cuda
    e = int(e4[int(sym) + 2 * int(pr)])
    return {"capacity": cap, "sr_slabs": s_planned,
            "sr_entries": _pow2_at_least(e * headroom)}


def sr_entry_overflow(pos, mass, grid: int = DEFAULT_GRID,
                      cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                      capacity: int = 0, sr_slabs: int = 0,
                      sr_entries: int = 0, boundary: str = "open",
                      box_size: float = 0.0) -> int:
    """Worklist entries this state would drop past the static
    ``sr_entries`` under the active layout (0 for the guaranteed bound)."""
    _check_boundary(boundary, box_size)
    if not int(sr_entries):
        return 0
    nc, _ = _cell_grid_params(int(grid), int(cutoff_cells))
    ns = pos.shape[1]
    cap, _, e_max = _sr_sizing(ns, ns, nc ** 3, capacity, sr_slabs,
                               sr_entries)
    sym, pr = _active_sr_layout(pos.is_cuda)
    _, e4 = _sr_plan_counts(pos, mass, int(grid), int(cutoff_cells), cap)
    return max(0, int(e4[int(sym) + 2 * int(pr)]) - e_max)


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

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
   (``_PeriodicMesh``); periodic P3M packs the sources and their ghost
   images on a cell grid extended by ``sub`` cells a side and runs the same
   sweep.

Both boundaries share one binning (``_sr_candidates``), one sizing
(``_sr_sizing``), one table recipe (``_sr_bin``, ``_sr_tables``,
``_sr_worklist``; public as ``sr_pack_inputs``) and one P3M body
(``_p3m``).  A boundary is one object, ``_OpenMesh`` or ``_PeriodicMesh``,
which supplies only what differs: its mesh, its short-range geometry
(``geom``), how it places the bodies (``bodies``: in-box masses, or
wrapped) and its candidates (``candidates``: the sources, or the sources
and their ghost images).

What differs from the JAX package:

* The transforms are ``torch.fft.rfftn``/``irfftn`` (cuFFT on the card),
  not full-complex ``fftn``/``ifftn``: the JAX package avoided ``irfftn``
  only because the TPU's was broken.  Spectra are the half spectra
  (m, m, m//2+1).  A periodic force factor i k_j has its Nyquist entry
  zeroed on its own axis: JAX's ``ifftn(...).real`` drops that entry (its
  Hermitian part is zero), which a half-spectrum ``irfftn`` cannot do.
* The CIC deposit: on a CUDA tensor that autograd does not record, the
  hand kernel of ``csrc/deposit.cu`` (``ops/deposit_kernel.py``), which
  sums each cell's float32 contributions in 64-bit fixed point, so the
  grid repeats bit for bit whatever the bodies' order; under autograd and
  on the CPU ``_scatter``'s accumulating ``index_put_``, the JAX package's
  scatter-add (``_hand_deposit`` chooses).
* The open far field: on CUDA tensors that autograd does not record, the
  two hand kernels of ``csrc/far_field.cu`` (``ops/far_field_kernel.py``):
  the moments summed in float64 into one (9, 4) table, then the nine
  monopoles at the targets in one pass, equal to the chain's bit for bit
  given the same table; under autograd and on the CPU the chain of masks,
  float32 sums and nine ``_monopole`` calls (``_hand_far_field`` chooses).
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
* One P3M step for both boundaries (``_p3m``): the candidates bin and
  take their slots, the worklist and the overflow read follow, then the
  deposit and transform, the force grids, the gather and the sweep.  The
  tables fill before the worklist on the periodic boundary and after the
  deposit on the open one (``_OpenMesh.fill_late``), as each boundary's
  solver always has, so that every gradient keeps its rounding.  The JAX
  package's open step packs after the deposit and lists the worklist
  after the gather.
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
from typing import NamedTuple

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


def _hand_deposit(*tensors) -> bool:
    """Whether the deposit takes the hand kernel (``ops/deposit_kernel.py``):
    on the card, where autograd records nothing of it.  Under autograd, and
    on the CPU, ``_scatter`` deposits, as the JAX package's scatter-add."""
    return tensors[0].is_cuda and not (
        torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def _hand_far_field(*tensors) -> bool:
    """Whether the far field takes the hand kernels
    (``ops/far_field_kernel.py``), by the deposit's rule: on the card,
    where autograd records nothing of it.  Under autograd, and on the CPU,
    the chain of ``_outlier_moments`` and ``_monopoles`` runs, as the JAX
    package's ops."""
    return _hand_deposit(*tensors)


def _deposit(pos, mass, lo, inv_h, ng: int):
    """CIC scatter of masses onto the (ng, ng, ng) grid over the box."""
    if _hand_deposit(pos, mass, lo, inv_h):
        from . import deposit_kernel

        return deposit_kernel.deposit(pos.contiguous(), mass.contiguous(), ng,
                                      lo=lo, inv_h=inv_h)
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
    """Plain PM's three spectrum products, the half spectra of the
    acceleration grids a(c) = -(rho * f)(c) per component (``_inverse``
    makes the grids)."""
    kx, ky, kz = spectra or _force_kernel_spectra(h, ng)
    return rho_hat * kx, rho_hat * ky, rho_hat * kz


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


class _Moments(NamedTuple):
    """The far field's masses: the in-box total ``M_in`` (0-d) at
    ``com_in`` (3, 1), and ``octs``, (M_k, com_k) of the out-of-box mass in
    each octant k around the box centre.  From the moments kernel they are
    views of its (9, 4) ``table`` (``ops/far_field_kernel.py``); from the
    chain ``table`` is None."""
    M_in: torch.Tensor
    com_in: torch.Tensor
    octs: list
    table: torch.Tensor | None = None


def _table_moments(table) -> _Moments:
    """``_Moments`` as views of a (9, 4) table: row 0 the in-box mass, row
    1 + k octant k; columns M, then the centre of mass."""
    return _Moments(table[0, 0], table[0, 1:, None],
                    [(table[k, 0], table[k, 1:, None]) for k in range(1, 9)],
                    table)


def _outlier_moments(pos, mass, m_in, lo_box, hi_box) -> _Moments:
    """In-box total (M_in, com_in) and one monopole per direction octant of
    the out-of-box mass around the box centre: on the card off autograd
    the moments kernel's table (its sums in float64), else the chain of
    float32 masks and sums."""
    if _hand_far_field(pos, mass, m_in, lo_box, hi_box):
        from . import far_field_kernel

        return _table_moments(far_field_kernel.moments(
            pos.contiguous(), mass.contiguous(), m_in.contiguous(),
            lo_box.contiguous(), hi_box.contiguous()))
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
    return _Moments(M_in, com_in, octs)


def _monopole(pos_tgt, m_tot, com, acc=None, in_tgt=None):
    """Softened point-mass field of (m_tot, com) at the targets (3, N).

    With ``acc`` and ``in_tgt`` (the far field on the card off autograd,
    ``com`` None), ``m_tot`` is the moments kernel's (9, 4) table and the
    call is ``_monopoles`` on ``acc`` in one launch of the target kernel:
    one function holds the far field's target pass on either path, so that
    a profiler range around it sees the whole pass."""
    if acc is not None:
        from . import far_field_kernel

        return far_field_kernel.monopoles(pos_tgt.contiguous(), m_tot,
                                          acc.contiguous(),
                                          in_tgt.contiguous())
    d = com - pos_tgt
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + SOFTENING_SQUARED
    u = torch.rsqrt(r2)
    return m_tot * d * (u * u * u)


def _monopoles(acc, tgt, in_tgt, moments: _Moments):
    """The far field's chain: targets outside the box (``in_tgt`` not
    positive) take the in-box mass's monopole in place of ``acc``, then
    every target adds the out-of-box octants', one ``_monopole`` each."""
    acc = torch.where(in_tgt > 0, acc,
                      _monopole(tgt, moments.M_in, moments.com_in))
    for M_k, com_k in moments.octs:
        acc = acc + _monopole(tgt, M_k, com_k)
    return acc


# ---------------------------------------------------------------------------
# Cell geometry and sizing


def _cell_grid_params(ng: int, cutoff_cells: int) -> tuple[int, int]:
    """``nc`` cells per axis and the neighbour reach ``sub``."""
    sub = 1 if ng // int(cutoff_cells) >= 24 else 2
    nc = max(2, (sub * ng) // int(cutoff_cells))
    return min(nc, 40), sub


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


class _Geom(NamedTuple):
    """The short range's binning geometry, a boundary's ``geom``: ``nc``
    cells a side of the grid the bodies bin on (ghost-extended when
    periodic), the reach ``sub``, the grid's origin ``lo`` and ``span``
    (3, 1) f32, the squared cutoff ``rc2`` (0-d); periodic only, the cutoff
    ``rc`` (0-d, the ghost margin)."""
    nc: int
    sub: int
    lo: torch.Tensor
    span: torch.Tensor
    rc2: torch.Tensor
    rc: torch.Tensor | None = None


def _pow2_at_least(x):
    v = 64
    while v < x:
        v *= 2
    return v


def _ghost_cap(n: int, sr_ghosts: int) -> int:
    """Ghost slots: ``sr_ghosts``, or when the caller gives none 2N rounded
    up to a power of two, capped at the guaranteed 7N.  Density-blind, like
    the default capacity: the engine sizes them from suggest_sr_plan's
    measured count."""
    return int(sr_ghosts) or min(_pow2_at_least(2 * n), 7 * n)


def _sr_sizing(geom: _Geom, ns: int, n_more: int, capacity: int,
               sr_slabs: int, sr_entries: int) -> tuple:
    """``(cap, s_max, e_max)`` of the tables of ``ns`` sources and
    ``n_more`` other slots (ghost images, distinct targets) on ``geom``'s
    cells: the measured plan where given, the guaranteed defaults
    otherwise.  The defaults: a density-blind capacity, ~8x the mean
    occupancy, a power of two in [64, 512]; s_max = ceil(slots/SLAB) + 1
    and e_max = s_max^2, capped at 2^22.  The solver, sr_pack_inputs and
    the plan's checks all size here.  (The JAX package's guard sizes
    periodic tables from the sources alone.)"""
    avg = max(1, ns // geom.nc ** 3)
    cap = int(capacity) or min(_pow2_at_least(8 * avg), 512)
    s_def = -(-(ns + n_more) // SLAB) + 1
    return (cap, int(sr_slabs) or s_def,
            int(sr_entries) or min(s_def * s_def, 1 << 22))


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
    each cell.  The solver takes its two halves apart (_sr_bin, _sr_tables);
    whole, this is the seam the JAX package's ``_sr_pack`` is held against.

    Returns ``(ptab (3, (s_max+1)*SLAB), mtab, slab_lo (s_max,), slab_hi,
    pslot (Ns,), binned (Ns,))``; slab ``s_max`` is the zero-mass sentinel.
    ``slab_lo``, ``slab_hi`` and ``binned`` equal the JAX package's;
    ``ptab``, ``mtab`` and ``pslot`` are its tables reordered within each
    cell, and equal them under a zero key."""
    slab_lo, slab_hi, binned = _sr_slots(cid, n_cells, cap, s_max)
    ptab, mtab, pslot = _sr_fill(cid, pos, mass, binned, n_cells, s_max, key)
    return ptab, mtab, slab_lo, slab_hi, pslot, binned


def _sr_fill(cid, pos, mass, binned, n_cells: int, s_max: int, key):
    """The slab tables of the slotted particles (``binned``, _sr_slots'):
    ``(ptab, mtab, pslot)`` of _sr_pack."""
    dev = cid.device
    ns = cid.shape[0]
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
    return ptab, mtab, pslot


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
    if _hand_deposit(pos, mass):
        from . import deposit_kernel

        return deposit_kernel.deposit(pos.contiguous(), mass.contiguous(), ng,
                                      box=box)
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


def _periodic_geom(ng: int, cutoff_cells: int, box: float, device):
    """The periodic binning geometry ``(nc, sub, rc, nc_tot, lo_cell,
    span_tot)``: ``nc`` cells across the box, extended by ``sub`` ghost
    cells a side (R_c = sub * box/nc is the margin) to ``nc_tot``.  R_c
    must lie strictly inside half the box: nc >= 2 sub + 1.  rc is a 0-d
    f32 tensor, lo_cell and span_tot (3, 1) f32."""
    nc, sub = _cell_grid_params(ng, int(cutoff_cells))
    if nc < 2 * sub + 1:
        raise ValueError(
            f"periodic P3M needs R_c < box/2 (cell grid nc >= "
            f"{2 * sub + 1}); got nc={nc} from grid={ng}, "
            f"cutoff_cells={cutoff_cells} — raise grid or lower "
            "cutoff_cells")
    cs = box / nc
    rc = _const(sub * cs, _F32, device, "periodic_rc")
    lo_cell = torch.full((3, 1), -sub * cs, dtype=_F32, device=device)
    span_tot = torch.full((3, 1), box + 2 * sub * cs, dtype=_F32,
                          device=device)
    return nc, sub, rc, nc + 2 * sub, lo_cell, span_tot


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


def _periodic_p3m_force_grids(rho_hat, rho_over_hat_fn, box, ng: int, rc2,
                              has_over: bool, spectra=None):
    """(acc_grids, comp_grids) of periodic P3M, as _p3m_force_grids: under
    overflow the unbinned sources' full force rides rho C - roh S and the
    targets' complement field is (roh - rho) S; without, comp_grids is
    None.  ``has_over`` is a Python bool: the caller's overflow sync."""
    comb, comp = spectra or _periodic_p3m_spectra(box, ng, rc2)
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


def _make_periodic_env(ng: int, cutoff_cells: int, box: float, device) -> dict:
    """The periodic mesh environment: the force spectra alone (the box is
    fixed, so there is no box to freeze).  They are constants of (box,
    grid, cutoff): the engine builds one a run."""
    if cutoff_cells:
        rc2 = _PeriodicMesh(ng, box).geom(cutoff_cells, device).rc2
        return {"spectra": _periodic_p3m_spectra(box, ng, rc2)}
    return {"spectra": _pm_force_spectra_periodic(box, ng, device)}


# ---------------------------------------------------------------------------
# The boundaries: each supplies its mesh, its short-range geometry, how it
# places the bodies and its bin candidates


class _OpenMesh:
    """The open boundary over the box ``[lo_box, hi_box]`` (3, 1): CIC on
    the ng^3 grid with a margin cell, transforms on the doubled (2 ng)^3
    grid (``spectra`` a mesh_env's, or None to build them), and the short
    range's nc^3 cells over the box.  One ``span`` serves the mesh and the
    cells, so that a gradient through the box sums the same terms in one
    order."""

    # The tables fill after the deposit: their gathers then take the
    # sources after it, the order in which autograd has always summed the
    # open solver's cotangents of the sources (it adds a tensor's
    # cotangents in the reverse order of its uses).
    fill_late = True

    def __init__(self, ng: int, lo_box, hi_box, spectra=None):
        self.lo_box, self.hi_box = lo_box, hi_box
        self.span = hi_box - lo_box
        # ng-3 usable cells: one margin cell each side plus the CIC corner.
        self.h = (self.span / float(ng - 3))[:, 0]
        self.inv_h = 1.0 / self.h[:, None]
        self.lo = lo_box - self.h[:, None]
        self.ng, self.spectra = ng, spectra

    def geom(self, cutoff_cells: int, device=None) -> _Geom:
        """nc^3 cells over the box; the cutoff is ``sub`` cell widths of
        its shortest axis."""
        nc, sub = _cell_grid_params(self.ng, int(cutoff_cells))
        rc = self.span[:, 0].min() * float(sub) / float(nc)
        return _Geom(nc, sub, self.lo_box, self.span, rc * rc)

    def bodies(self, pos_src, mass_src, pos_tgt, sr: bool = True):
        """``(src, m, tgt, in_tgt)``: the sources with their in-box masses,
        the targets with their in-box mask (N,) f32, for the mesh and the
        short range alike.  Same-set targets are the sources (``pos_tgt is
        pos_src``)."""
        in_src = _inside(pos_src, self.lo_box, self.hi_box)
        in_tgt = in_src if pos_tgt is pos_src else \
            _inside(pos_tgt, self.lo_box, self.hi_box)
        return pos_src, mass_src * in_src, pos_tgt, in_tgt

    @staticmethod
    def ghost_cap(ns: int, sr_ghosts: int) -> int:
        return 0

    @staticmethod
    def candidates(geom: _Geom, src, m, gcap: int):
        """The bin candidates ``(pos, mass, n_ghost)``: the sources alone,
        no image count."""
        return src, m, None

    def rho_hat(self, pos, m):
        n = 2 * self.ng
        rho = _stage("mesh.deposit", _deposit, pos, m, self.lo, self.inv_h,
                     self.ng)
        return _stage("mesh.fft", torch.fft.rfftn, rho, s=(n, n, n))

    def grids(self, rho_hat, rc2=None, rho_over_hat_fn=None,
              has_over=False):
        """The force grids inside ``mesh.grids``, which holds the spectrum
        products; plain PM's inverse transforms follow it in ``mesh.ifft``,
        P3M's nest inside it."""
        if rc2 is None:
            specs = _stage("mesh.grids", _pm_force_grids, rho_hat, self.h,
                           self.ng, self.spectra)
            return _stage("mesh.ifft", _inverse, specs, self.ng)
        return _stage("mesh.grids", _p3m_force_grids, rho_hat,
                      rho_over_hat_fn, self.h, self.ng, rc2, has_over,
                      self.spectra)

    def gather(self, grids, pos):
        return _stage("mesh.gather", _gather, grids, pos, self.lo,
                      self.inv_h, self.ng)


class _PeriodicMesh:
    """The periodic boundary of the box of edge ``box``: wrapped CIC on the
    ng^3 grid, ng^3 transforms with the closed-form spectra (``spectra`` a
    mesh_env's, or None to build them), and the short range's cells over
    the box extended by ``sub`` ghost cells a side."""

    # The tables fill before the worklist and the read: they gather from
    # the candidates, built at binning, so where they fill moves no
    # gradient's rounding, and the read then waits on no mesh work.
    fill_late = False

    def __init__(self, ng: int, box: float, spectra=None):
        self.ng, self.box, self.spectra = ng, box, spectra

    def geom(self, cutoff_cells: int, device=None) -> _Geom:
        """The ghost-extended cells of _periodic_geom."""
        _, sub, rc, nc, lo, span = _periodic_geom(self.ng, int(cutoff_cells),
                                                  self.box, device)
        return _Geom(nc, sub, lo, span, rc * rc, rc)

    def bodies(self, pos_src, mass_src, pos_tgt, sr: bool = True):
        """``(src, m, tgt, None)``: every target is inside.  The mesh wraps
        what it deposits and gathers itself; for the short range (``sr``)
        the bodies are wrapped into the box first."""
        if not sr:
            return pos_src, mass_src, pos_tgt, None
        src = _wrap_box(pos_src, self.box)
        tgt = src if pos_tgt is pos_src else _wrap_box(pos_tgt, self.box)
        return src, mass_src, tgt, None

    @staticmethod
    def ghost_cap(ns: int, sr_ghosts: int) -> int:
        return _ghost_cap(ns, sr_ghosts)

    def candidates(self, geom: _Geom, src, m, gcap: int):
        """The bin candidates ``(pos, mass, n_ghost)``: the sources and
        their ghost images in ``gcap`` slots, and the exact image count
        whatever ``gcap`` (_ghost_images)."""
        gpos, gmass, n_ghost = _stage("mesh.ghosts", _ghost_images, src, m,
                                      self.box, geom.rc, gcap)
        return torch.cat([src, gpos], dim=1), torch.cat([m, gmass]), n_ghost

    def rho_hat(self, pos, m):
        rho = _stage("mesh.deposit", _deposit_periodic, pos, m, self.box,
                     self.ng)
        return _stage("mesh.fft", torch.fft.rfftn, rho)

    def grids(self, rho_hat, rc2=None, rho_over_hat_fn=None,
              has_over=False):
        if rc2 is None:
            return _pm_force_grids_periodic(rho_hat, self.box, self.ng,
                                            self.spectra)
        return _periodic_p3m_force_grids(rho_hat, rho_over_hat_fn, self.box,
                                         self.ng, rc2, has_over,
                                         self.spectra)

    def gather(self, grids, pos):
        return _stage("mesh.gather", _gather_periodic, grids, pos, self.box,
                      self.ng)


# ---------------------------------------------------------------------------
# The short range: one binning and one table recipe for both boundaries


def _sr_candidates(mesh, geom: _Geom, src, m, gcap: int):
    """The sources' bin candidates, of the solver, sr_pack_inputs and the
    plan alike: the boundary's candidates (``mesh.candidates``), each
    included where massive.  Returns ``(pos, mass, inc, cid, n_ghost)``:
    cid the int32 cell ids (the nc^3 sentinel where excluded), n_ghost the
    exact image count (None when open)."""
    pos, mass, n_ghost = mesh.candidates(geom, src, m, gcap)
    inc = mass > 0
    return pos, mass, inc, _bin_cids(pos, geom.lo, geom.span, geom.nc,
                                     inc), n_ghost


def _sr_bin(mesh, cutoff_cells: int, bodies, same_set: bool, plan) -> dict:
    """The table recipe's first part, under ``p3m.bin``: the boundary's
    geometry and ghost cap, the sizing (_sr_sizing of ``plan``, (capacity,
    sr_slabs, sr_entries, sr_ghosts)), the candidates' cells
    (_sr_candidates, then distinct targets', massless, included where
    ``in_tgt``; None: every target) and their slots (_sr_slots).
    _sr_tables fills the tables, _sr_worklist lists the worklist."""
    src, m, tgt, in_tgt = bodies
    ns = src.shape[1]
    with spans.span("p3m.bin"):
        geom = mesh.geom(cutoff_cells, src.device)
        gcap = mesh.ghost_cap(ns, plan[3])
        cap, s_max, e_max = _sr_sizing(
            geom, ns, gcap + (0 if same_set else tgt.shape[1]), *plan[:3])
        pos, mass, inc, cid, n_ghost = _sr_candidates(mesh, geom, src, m,
                                                      gcap)
        if not same_set:
            t_inc = torch.ones_like(tgt[0], dtype=torch.bool) \
                if in_tgt is None else in_tgt > 0
            inc = torch.cat([inc, t_inc])
            cid = torch.cat([cid, _bin_cids(tgt, geom.lo, geom.span, geom.nc,
                                            t_inc)])
        slab_lo, slab_hi, binned = _sr_slots(cid, geom.nc ** 3, cap, s_max)
    return dict(geom=geom, pos=pos, mass=mass, tgt=None if same_set else tgt,
                cid=cid, inc=inc, slab_lo=slab_lo, slab_hi=slab_hi,
                binned=binned, e_max=e_max, rc2=geom.rc2, n_ghost=n_ghost,
                gcap=gcap, s_max=s_max)


def _sr_tables(t: dict) -> dict:
    """The table recipe's second part, under ``p3m.bin``: distinct
    targets' positions join _sr_bin's candidates, and the slotted ones fill
    the slab tables in sub-cell key order (_sr_fill).  Returns ``t`` with
    ``ptab, mtab, pslot``, without the candidates (freed before the mesh
    runs)."""
    geom, pos, mass, tgt = t["geom"], t["pos"], t["mass"], t["tgt"]
    with spans.span("p3m.bin"):
        if tgt is not None:
            pos = torch.cat([pos, tgt], dim=1)
            mass = torch.cat([mass, torch.zeros_like(tgt[0])])
        ptab, mtab, pslot = _sr_fill(
            t["cid"], pos, mass, t["binned"], geom.nc ** 3, t["s_max"],
            _subcell_key(pos, geom.lo, geom.span, geom.nc))
    return dict({k: v for k, v in t.items()
                 if k not in ("pos", "mass", "tgt", "cid")},
                ptab=ptab, mtab=mtab, pslot=pslot)


def _sr_worklist(t: dict, layout) -> dict:
    """The table recipe's last part, under ``p3m.worklist``: the worklist
    of _sr_bin's slabs in ``layout``, (symmetric, paired).  Returns ``t``
    with ``wl_t, wl_s, n_e``."""
    geom = t["geom"]
    with spans.span("p3m.worklist"):
        wl_t, wl_s, n_e = _sr_ranges(t["slab_lo"], t["slab_hi"], geom.nc,
                                     geom.sub, t["e_max"], *layout)
    return dict(t, wl_t=wl_t, wl_s=wl_s, n_e=n_e)


def _state_sr(pos, mass, grid: int, boundary: str, box_size: float,
              pos_tgt=None):
    """A state's boundary and bodies as the solver takes them without a
    mesh env: ``(mesh, bodies)``, the open box the sources' _robust_box."""
    periodic = _check_boundary(boundary, box_size)
    pos, mass = pos.to(_F32), mass.to(_F32)
    tgt = pos if pos_tgt is None else pos_tgt.to(_F32)
    mesh = _PeriodicMesh(int(grid), float(box_size)) if periodic else \
        _OpenMesh(int(grid), *_robust_box(pos, mass))
    return mesh, mesh.bodies(pos, mass, tgt)


def sr_pack_inputs(pos, mass, grid: int = DEFAULT_GRID,
                   cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                   capacity: int = 0, sr_slabs: int = 0,
                   sr_entries: int = 0, symmetric: bool = False,
                   paired: bool = False, boundary: str = "open",
                   box_size: float = 0.0, sr_ghosts: int = 0,
                   pos_tgt=None) -> dict:
    """The short-range tables and worklist exactly as the solver builds
    them (_sr_bin, _sr_tables, _sr_worklist), for the sources ``pos`` and,
    when ``pos_tgt`` is given, distinct targets joining as massless slots,
    in the layout (symmetric, paired).  The open box is the sources'
    _robust_box; the periodic tables hold the sources wrapped into the box
    of edge ``box_size`` and their ghost images.  Returns ``ptab, mtab,
    wl_t, wl_s, n_e, e_max, rc2``, and ``src_w, tgt_w`` (the bodies as
    placed; wrapped when periodic), ``slab_lo, slab_hi, pslot, binned,
    inc``, ``n_ghost`` (periodic; None when open), ``gcap, s_max``."""
    mesh, bodies = _state_sr(pos, mass, grid, boundary, box_size, pos_tgt)
    t = _sr_bin(mesh, cutoff_cells, bodies, pos_tgt is None,
                (capacity, sr_slabs, sr_entries, sr_ghosts))
    t = _sr_worklist(_sr_tables(t), (symmetric, paired))
    return dict({k: v for k, v in t.items() if k != "geom"},
                src_w=bodies[0], tgt_w=bodies[2])


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


def _p3m(mesh, cutoff_cells: int, bodies, same_set: bool, plan,
         differentiable: bool):
    """The P3M accelerations (G = 1) of either boundary (``mesh``), in one
    order: the candidates bin and take their slots, the worklist follows,
    then the overflow read; the mesh deposits and transforms, and the force
    grids, the gather, the short-range sweep and the complement field
    follow.  The reads then wait on the tables' small work alone.  The
    tables fill where the boundary says (``fill_late``): before the
    worklist, or after the deposit.

    Degradation contract, as the JAX package's: dropped ghosts (gcap
    overflow) and capacity-overflowed cells lose short-range exactness for
    their pairs; overflowed real sources and targets keep mesh-quality full
    forces through the complement field.  A ghost that overflowed while its
    parent binned does not turn the complement on (it would count the
    parent's field twice).  Gradients reach each ghost's parent through
    ``_ghost_images``' index."""
    src, m, tgt, _ = bodies
    ns = src.shape[1]
    layout = _active_sr_layout(src.is_cuda, differentiable)
    t = _sr_bin(mesh, cutoff_cells, bodies, same_set, plan)
    if not mesh.fill_late:
        t = _sr_tables(t)
    t = _sr_worklist(t, layout)
    binned, gcap = t["binned"], t["gcap"]
    lost = ~binned & t["inc"]
    over = lost[:ns].any()
    if not same_set:
        over = over | lost[ns + gcap:].any()
    with spans.sync("p3m_overflow"):
        has_over = bool(over)  # the branch's host sync
    m_over = torch.where(binned[:ns], 0.0, m)
    rho_hat = mesh.rho_hat(src, m)
    if mesh.fill_late:
        t = _sr_tables(t)
    acc_grids, comp_grids = mesh.grids(
        rho_hat, t["rc2"], lambda: mesh.rho_hat(src, m_over), has_over)
    acc = mesh.gather(acc_grids, tgt)
    n_e = t["n_e"]
    bounds = torch.stack([torch.zeros_like(n_e), n_e.clamp(max=t["e_max"])])
    atab = _sr_sweep(t["ptab"], t["mtab"], t["wl_t"], t["wl_s"], bounds,
                     t["rc2"], *layout, differentiable)
    sel = slice(0, ns) if same_set else slice(ns + gcap, None)
    a_sr = _gather_slots(atab, t["pslot"][sel], binned[sel])
    a_comp = mesh.gather(comp_grids, tgt) if has_over else \
        torch.zeros_like(tgt)
    return acc + torch.where(binned[sel][None, :], a_sr, a_comp)


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
    (``sr_ghosts``: the P3M ghost-image slots, 0 = _ghost_cap's default).
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
    spectra = _check_mesh_env(mesh_env, ng, cutoff_cells, periodic) \
        if mesh_env else None
    if periodic:
        mesh = _PeriodicMesh(ng, float(box_size), spectra)
        bodies = mesh.bodies(pos_src, mass_src, pos_tgt, bool(cutoff_cells))
    else:
        with spans.span("mesh.box"):
            mesh = _OpenMesh(ng, *((mesh_env["lo_box"], mesh_env["hi_box"])
                                   if mesh_env else _robust_box(pos_src,
                                                                mass_src)),
                             spectra)
            bodies = mesh.bodies(pos_src, mass_src, pos_tgt)
            moments = _outlier_moments(
                pos_src, mass_src, bodies[1], mesh.lo_box, mesh.hi_box)
    src, m, tgt, in_tgt = bodies
    if cutoff_cells:
        acc = _p3m(mesh, cutoff_cells, bodies, same_set,
                   (capacity, sr_slabs, sr_entries, sr_ghosts),
                   differentiable)
    else:
        acc = mesh.gather(mesh.grids(mesh.rho_hat(src, m)), tgt)
    if not periodic:
        # The far field: targets outside the box take the in-box mass's
        # monopole, and every target adds the out-of-box octants'; in one
        # launch where the moments are the kernel's table.
        with spans.span("mesh.box"):
            if moments.table is not None and _hand_far_field(tgt, in_tgt,
                                                             acc):
                acc = _monopole(tgt, moments.table, None, acc, in_tgt)
            else:
                acc = _monopoles(acc, tgt, in_tgt, moments)
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
    mesh = _OpenMesh(ng, *_robust_box(pos.to(_F32), mass.to(_F32)))
    spectra = _p3m_spectra(mesh.h, ng, mesh.geom(cutoff_cells).rc2) \
        if cutoff_cells else _force_kernel_spectra(mesh.h, ng)
    return {"lo_box": mesh.lo_box, "hi_box": mesh.hi_box, "spectra": spectra}


def accelerations(pos, mass, grid: int = DEFAULT_GRID, cutoff_cells: int = 0,
                  **kw):
    """All-source mesh accelerations. pos (3,N), mass (N,) -> (3,N), with
    accelerations_between's options.  Plain pm (``cutoff_cells=0``) is
    differentiable through autograd; P3M with ``differentiable=True``."""
    return accelerations_between(pos, pos, mass, grid, cutoff_cells, **kw)


def p3m_accelerations(pos, mass, grid: int = DEFAULT_GRID,
                      cutoff_cells: int = DEFAULT_CUTOFF_CELLS, **kw):
    """The ``p3m`` registry entry: the short-range correction on by
    default."""
    return p3m_accelerations_between(pos, pos, mass, grid, cutoff_cells, **kw)


def p3m_accelerations_between(pos_tgt, pos_src, mass_src,
                              grid: int = DEFAULT_GRID,
                              cutoff_cells: int = DEFAULT_CUTOFF_CELLS, **kw):
    return accelerations_between(pos_tgt, pos_src, mass_src, grid,
                                 cutoff_cells or DEFAULT_CUTOFF_CELLS, **kw)


# ---------------------------------------------------------------------------
# The plan: capacity, slab and worklist sizes measured on a concrete state


def _plan_bin(pos, mass, grid: int, cutoff_cells: int, boundary: str = "open",
              box_size: float = 0.0, gcap: int = 0):
    """The plan's binning of one state: the solver's geometry and
    candidates (_sr_candidates) for sr_pack_inputs' boundary and bodies,
    the ghost images in ``gcap`` slots (0: the guaranteed 7N, which holds
    every image).  Returns ``(geom, inc, cid, n_ghost)``, n_ghost 0-d int32
    (0 when open)."""
    mesh, (src, m, _, _) = _state_sr(pos, mass, grid, boundary, box_size)
    geom = mesh.geom(cutoff_cells, src.device)
    _, _, inc, cid, n_ghost = _sr_candidates(mesh, geom, src, m,
                                             int(gcap) or 7 * src.shape[1])
    if n_ghost is None:
        n_ghost = torch.zeros((), dtype=_I32, device=src.device)
    return geom, inc, cid, n_ghost


def _cid_counts(cid, n_cells: int):
    """Per-cell counts (n_cells,) int32 of the cell ids; the sentinel
    ``n_cells`` is not counted."""
    counts = torch.zeros(n_cells + 1, dtype=_I32, device=cid.device)
    counts.scatter_add_(0, cid.long(), torch.ones_like(cid))
    return counts[:-1]


def _overflow_frac(geom: _Geom, inc, cid, cap: int):
    """The binned candidates past their cell's capacity over the binned
    candidates (0-d)."""
    over = (_cid_counts(cid, geom.nc ** 3) - cap).clamp_min(0).sum()
    return over / inc.sum(dtype=_I32).clamp_min(1)


def cell_overflow_fraction(pos, mass, grid: int = DEFAULT_GRID,
                           cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                           capacity: int = 0, boundary: str = "open",
                           box_size: float = 0.0):
    """Fraction of in-box massive particles (and, periodic, ghost images)
    the P3M cell list cannot bin at ``capacity`` (0 resolves as the solver
    does, on the solver's cell count), as a 0-d tensor."""
    geom, inc, cid, _ = _plan_bin(pos, mass, grid, cutoff_cells, boundary,
                                  box_size)
    cap = _sr_sizing(geom, pos.shape[1], 0, capacity, 0, 0)[0]
    return _overflow_frac(geom, inc, cid, cap)


def suggest_capacity(pos, mass, grid: int = DEFAULT_GRID,
                     cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                     headroom: float = 1.25, max_capacity: int = 2048,
                     boundary: str = "open", box_size: float = 0.0) -> int:
    """Host-side cell capacity: the measured max cell occupancy times
    ``headroom``, a power of two in [64, max_capacity]."""
    geom, _, cid, _ = _plan_bin(pos, mass, grid, cutoff_cells, boundary,
                                box_size)
    occ = _read(_cid_counts(cid, geom.nc ** 3).max(), "plan")
    cap = 64
    while cap < headroom * occ and cap < max_capacity:
        cap *= 2
    return cap


def ghost_overflow_count(pos, mass, grid: int = DEFAULT_GRID,
                         cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                         sr_ghosts: int = 0, box_size: float = 0.0) -> int:
    """Periodic ghost images beyond the ghost cap for this state (the cap 0
    resolves as the solver does).  Nonzero means cross-boundary pairs lose
    their whole short-range term (no complement makes up for them): raise
    ``sr_ghosts`` or re-run suggest_sr_plan.  The count read adds to
    ``spans.counts["ghost_images"]``."""
    mesh, (src, m, _, _) = _state_sr(pos, mass, grid, "periodic", box_size)
    rc = mesh.geom(cutoff_cells, src.device).rc
    n = _read(_ghost_images(src, m, mesh.box, rc, 1)[2], "ghost_overflow")
    spans.counts["ghost_images"] += n
    return max(0, n - _ghost_cap(pos.shape[1], sr_ghosts))


def _entry_count(geom: _Geom, cid, cap: int, layout: tuple):
    """The exact worklist entry count (0-d int32) of a binning in the
    (symmetric, paired) ``layout``, and ``_sr_slots``' binned mask."""
    slab_lo, slab_hi, binned = _sr_slots(cid, geom.nc ** 3, int(cap),
                                         cid.shape[0] // SLAB + 2)
    return _sr_ranges(slab_lo, slab_hi, geom.nc, geom.sub, 1,
                      *layout)[2], binned


def _active_sr_layout(on_cuda: bool, differentiable: bool = False) -> tuple:
    """The (symmetric, paired) layout the solver dispatches on a state on
    the CUDA card (``on_cuda``) or on the CPU, under the current module
    layout: paired rows only for the card's kernel, never differentiable;
    SR_SYMMETRIC None is the reaction on the CPU only.  Plans must be sized
    through this, or the worklist they size is not the one that runs and
    entries drop without an error."""
    sym = (not on_cuda) if SR_SYMMETRIC is None else SR_SYMMETRIC
    return sym, SR_PAIRED_ROWS and on_cuda and not differentiable


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
    geom, _, cid, g = _plan_bin(pos, mass, grid, cutoff_cells, boundary,
                                box_size)
    e, binned = _entry_count(geom, cid, cap, (sym, pr))
    s = _read(binned.sum(dtype=_I32) // SLAB + 2, "plan")
    plan = {"capacity": cap, "sr_slabs": _pow2_at_least(s * headroom),
            "sr_entries": _pow2_at_least(_read(e, "plan") * headroom)}
    if boundary == "periodic":
        plan["sr_ghosts"] = min(_pow2_at_least(_read(g, "plan") * headroom),
                                7 * pos.shape[1])
    return plan


def sr_entry_overflow(pos, mass, grid: int = DEFAULT_GRID,
                      cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                      capacity: int = 0, sr_slabs: int = 0,
                      sr_entries: int = 0, boundary: str = "open",
                      box_size: float = 0.0, sr_ghosts: int = 0,
                      differentiable: bool = False) -> int:
    """Worklist entries this state would drop past the static
    ``sr_entries`` under the active layout, or that of a differentiable
    call (0 for the guaranteed bound)."""
    periodic = _check_boundary(boundary, box_size)
    if not int(sr_entries):
        return 0
    ns = pos.shape[1]
    geom, _, cid, _ = _plan_bin(pos, mass, grid, cutoff_cells, boundary,
                                box_size)
    cap, _, e_max = _sr_sizing(geom, ns,
                               _ghost_cap(ns, sr_ghosts) if periodic else 0,
                               capacity, sr_slabs, sr_entries)
    n_e = _entry_count(geom, cid, cap,
                       _active_sr_layout(pos.is_cuda, differentiable))[0]
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
    gcap = _ghost_cap(ns, sr_ghosts) if periodic else 0

    def readings(ghost_slots: int) -> tuple:
        geom, inc, cid, n_ghost = _plan_bin(pos, mass, grid, cutoff_cells,
                                            boundary, box_size, ghost_slots)
        cap, _, e_max = _sr_sizing(geom, ns, gcap, capacity, sr_slabs,
                                   sr_entries)
        frac = _overflow_frac(geom, inc, cid, cap)
        n_e = _entry_count(geom, cid, cap, _active_sr_layout(pos.is_cuda))[0] \
            if int(sr_entries) else torch.zeros_like(n_ghost)
        # float64 holds the f32 fraction and both int32 counts exactly.
        with spans.sync("health"):
            frac, n_ghost, n_e = torch.stack(
                [frac.double(), n_ghost.double(), n_e.double()]).tolist()
        return frac, int(n_ghost), max(0, int(n_e) - e_max)

    frac, n_ghost, entries = readings(gcap)
    if n_ghost > gcap:
        spans.counts["health_full_bins"] += 1
        frac, _, entries = readings(7 * ns)
    if periodic:
        spans.counts["ghost_images"] += n_ghost
    return frac, max(0, n_ghost - gcap), entries


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

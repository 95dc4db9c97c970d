// The VJP of the P3M short-range sweep (csrc/sr.cu), fp32, for the two
// unpaired layouts (pallas / xla and pallas_sym): paired rows are never
// differentiated.
//
// Replaces nbody_tpu/ops/pm.py:1844 _sr_ad_bwd, the backward of
// _sr_sweep_pallas_ad: jax.vjp of the plain static-bound sweep, which XLA
// compiles (there is no Pallas kernel behind it).  For an entry (t, s),
// target slot i of slab t and source slot j of slab s, d = p_j - p_i,
// r2 = |d|^2, u = (r2 + eps^2)^{-1/2}, q = r2 / rc2 and T = 1 - S(q), S the
// quintic taper of ops/pm.py, the forward adds m_j w d to a_i, w = T u^3,
// and, in pallas_sym off the diagonal (s != t), the reaction -m_i w d to
// a_j.  For the cotangent g of the output, with h = m_j g_i (minus m_i g_j
// with the reaction), w' = dw/dr2 = -3/2 T u^5 - u^3 S'(q) / rc2 and
// k = dw/drc2 = u^3 S'(q) q / rc2, S'(q) = 30 q^2 (1 - q)^2:
//
//   gp_j += V, gp_i -= V, V = w h + 2 w' (h . d) d,
//   gm_j += w (g_i . d), gm_i -= w (g_j . d) (reaction),
//   grc2 += k (h . d).
//
// Every term is exactly 0 for q >= 1 (T = S' = 0), so those pairs are
// skipped; self pairs (d = 0) cancel between the two sides and stay
// unmasked.  The sentinel slab's output is zeroed by the forward, so its
// cotangent is zeroed here.  ops/sr_kernel.sweep_vjp_plain is the oracle.
//
// Bound.  Operations: a pair beyond the cutoff costs the 10 fp32
// operations of its distance test, one inside it 68 evaluated once for
// both sides (rsqrt counts one; 81 with the reaction).  chip_smoke.py
// counts the pairs inside the cutoff of this run's data in the layout the
// card's AD runs (pallas: at the Plummer gate 1035818 entries x 4096 =
// 4.24e9 pairs, 18% inside) and in the cheapest one (pallas_sym: half the
// entries, each pair once for both directions), and takes the smaller as
// the bound.  The tables (8.4 MB at the gate) and the cotangents stay in
// L2, and nothing is written per entry.  This kernel evaluates each kept
// pair twice, once a side: with the skips below each pass issues about as
// many steps as the forward (half of them at the gate), so the two passes
// issue about as many full-body steps as one pass with no skip.
//
// Design: two gather passes in the shape of the forward's kernel
// (csrc/sr.cu), one a side, each summing its own slots' terms in registers
// along a run, so no per-entry partial is written and no float atomic is
// taken.  Seven kernels a call on one stream, nothing synced to the host
// (`bounds`, rc2 and the source pass's live length are read on the card):
//
// 1. sr_vjp_pack_kernel: (x, y, z, m) and (g, 0) of every slot as float4
//    tables, the sentinel slab's g zeroed.
// 2. sr_vjp_pass_kernel<target>: the worklist [bounds[0], bounds[1]) in its
//    own t-major order.  A lane owns target slot i of slab t; every lane of
//    a warp takes the same source j (a broadcast read) and sums
//    -V (as g_i sum(w m_j) - m_i sum(w g_j) + sum(2 w' (h . d) d)), the
//    reaction's -w (g_j . d) and grc2's k (h . d).
// 3. sr_vjp_pass_kernel<source>: the same entries in the transposed order
//    `perm` (stably sorted by source slab, ops/sr_kernel.band_order), whose
//    live length is start[nslab].  A lane owns source slot j of slab s, every
//    lane takes the same target i, and sums V (as m_j sum(w g_i) - g_j
//    sum(w m_i) + sum(2 w' (h . d) d)) and w (g_i . d).
//    Both passes take the forward's machinery (its helpers in common.cuh):
//    balanced units of kUnit positions, one group of 64 threads a unit, so
//    no run (the entries of one owner slab) is one CTA's serial work; the
//    owner slab split into two spatially compact warps at each segment (a
//    run cut at the unit's ends); per 32 others the ballot of their gaps to
//    the warp's box, then, over the kept ones in an unrolled loop, the vote
//    on q >= 1 on every lane, both exact (q from sr_dist, as in the
//    forward, and the terms from that q, clamped: at q >= 1 w, w' and k are
//    exactly 0); a kept pair's one rsqrt.approx, with no Newton step, as in
//    the forward (the gate is 1e-5 of the largest gp and gm); cp.async
//    double-buffered staging of the other slab's rows; a named barrier a
//    group.  A segment that is a whole run stores its sums; a run cut by
//    unit ends leaves a head or a tail partial a unit (kRows x 64 floats).
// 4. sr_vjp_finalize_kernel, once a side: each slab whose run spans
//    several units adds its partials in unit order.
// 5. sr_vjp_combine_kernel adds the two sides a slot (target side first),
//    and sr_vjp_sum_kernel sums grc2's per-slot terms in one CTA in a fixed
//    order.
//
// Every sum is taken in a fixed order (others in order within an entry,
// entries in order within a unit, units in order), so two launches repeat
// bit for bit.  Scratch: the tables and both sides' sums (17 floats a slot)
// and a head and a tail partial a unit; the launch shape (kGroups, kUnit)
// is timed against others by scripts/sr_launch_shapes.py (PERF.md).
#include "common.cuh"

namespace {

constexpr int kSlab = nbt::kSrSlab;  // slots of a slab = threads of a group
constexpr int kGroups = 2;           // groups of 64 threads a CTA
constexpr int kUnit = 16;            // positions a unit (one group's work)
constexpr int kTargetRows = 5;  // sums of a target slot: gp x, y, z, gm, grc2
constexpr int kSourceRows = 4;  // sums of a source slot: gp x, y, z, gm
constexpr int kSumThreads = 1024;
static_assert(kGroups <= 4, "nbt::group_sync has four barriers");

// The split of slab `slab`'s 64 slots into two spatially compact halves,
// one a warp: the slab's bounding box, its longest axis (the first of
// equal extents), each slot's rank along it (ties by slot), and thread
// `rank` of group g takes the slot.  Which thread owns a slot changes no
// sum, and compact warps lie beyond the cutoff together more often.
// ops/sr_kernel.split_order is the same rule; csrc/sr.cu writes the same
// steps out inline, where a call to this function compiles to other code
// than the forward's launch shape was timed with.  Every thread of the
// group calls it, thread tid with slot tid of the slab; `box`, `key` and
// `order` are the group's shared scratch.  Returns the slot (0..63) thread
// tid owns.
__device__ __forceinline__ int sr_split(const float4* tab, int slab, int tid,
                                        int g, float (*box)[6], float* key,
                                        int* order) {
  const int lane = tid & 31, warp = tid >> 5;
  const float4 me = tab[slab * kSlab + tid];
  float lo[3] = {me.x, me.y, me.z}, hi[3] = {me.x, me.y, me.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    for (int off = 16; off; off >>= 1) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(nbt::kFullMask, lo[c], off));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(nbt::kFullMask, hi[c], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      box[warp][c] = lo[c];
      box[warp][3 + c] = hi[c];
    }
  }
  nbt::group_sync(g);
  float ext[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ext[c] = fmaxf(box[0][3 + c], box[1][3 + c]) - fminf(box[0][c], box[1][c]);
  }
  const int axis = ext[0] >= ext[1] ? (ext[0] >= ext[2] ? 0 : 2)
                                    : (ext[1] >= ext[2] ? 1 : 2);
  const float mine = axis == 0 ? me.x : (axis == 1 ? me.y : me.z);
  key[tid] = mine;
  nbt::group_sync(g);
  int rank = 0;
  for (int k = 0; k < kSlab; ++k) {
    const float other = key[k];
    rank += (other < mine || (other == mine && k < tid)) ? 1 : 0;
  }
  order[rank] = tid;
  nbt::group_sync(g);
  return order[tid];
}

// The box [lo, hi] of the warp's 32 slots, each lane holding one (p).
__device__ __forceinline__ void sr_warp_box(float4 p, float3& lo, float3& hi) {
  lo = make_float3(p.x, p.y, p.z);
  hi = lo;
  for (int o = 16; o; o >>= 1) {
    lo.x = fminf(lo.x, __shfl_xor_sync(nbt::kFullMask, lo.x, o));
    lo.y = fminf(lo.y, __shfl_xor_sync(nbt::kFullMask, lo.y, o));
    lo.z = fminf(lo.z, __shfl_xor_sync(nbt::kFullMask, lo.z, o));
    hi.x = fmaxf(hi.x, __shfl_xor_sync(nbt::kFullMask, hi.x, o));
    hi.y = fmaxf(hi.y, __shfl_xor_sync(nbt::kFullMask, hi.y, o));
    hi.z = fmaxf(hi.z, __shfl_xor_sync(nbt::kFullMask, hi.z, o));
  }
}

// What a call's pairs share: 1 / rc2, -eps^2 / rc2, 60 / rc2 and -6.
struct VjpConst {
  float inv_rc2, eps_q, inv60, m6;
};

// The terms of a pair from its (d2, q) (nbt::sr_dist): w, c2 = 2 w' and
// k2 = 2 k.  With qc = min(q, 1) and a2 = 60 u^3 (qc (1 - qc))^2 / rc2 =
// 2 u^3 S'(qc) / rc2: c2 = -3 w u^2 - a2 and k2 = a2 qc.  At q >= 1, qc = 1
// and all three are exactly 0 (sr_keep is 0, qc (1 - qc) is 0).
struct VjpTerms {
  float w, c2, k2;
};
__device__ __forceinline__ VjpTerms vjp_terms(nbt::SrDist r,
                                              const VjpConst& c) {
  const float u = nbt::rsqrt_approx(r.d2);
  const float u2 = u * u;
  const float u3 = u2 * u;
  const float qc = fminf(r.q, 1.0f);
  const float qq = qc * (1.0f - qc);
  const float a2 = (u3 * (qq * qq)) * c.inv60;
  const float w = nbt::sr_keep(r.q, c.m6) * u3;
  return {w, fmaf(-3.0f * w, u2, -a2), a2 * qc};
}

// A lane's sums along a segment.  The target pass: wm = sum w m_j, g =
// sum w g_j and m = sum w (g_j . d) (the reaction's), d = sum c2 (h . d) d,
// r = sum k2 (h . d).  The source pass: g = sum w g_i, wm = sum w m_i (the
// reaction's), m = sum w (g_i . d), d as above.  The self pair's w is
// eps^-3 (about 31623), far above any other pair's, and its w m_i g_i
// cancels only between the two sides' sums, so the sums that carry it
// (the target pass's wm, the source pass's g) are taken an entry at a time
// and then added to the segment's: an entry after the self pair's adds one
// rounded sum to that large value, not each of its terms.
struct Sums {
  float3 d, g;
  float wm, m, r;
};

// The target pass's sums of a lane's target (t: x, y, z, m; gi its
// cotangent) over the 64 sources src[0..64) (gsrc: their cotangents, read
// only with the reaction), every lane on the same source, with the
// forward's two exact skips.
template <bool kReact>
__device__ __forceinline__ void target_sweep(const float4* src,
                                             const float4* gsrc, float4 t,
                                             float3 gi, float3 lo, float3 hi,
                                             int lane, const VjpConst& c,
                                             Sums& a) {
  float ewm = 0.f;  // this entry's sum w m_j
  for (int j0 = 0; j0 < kSlab; j0 += 32) {
    const unsigned near =
        nbt::sr_box_ballot(src[j0 + lane], lo, hi, c.inv_rc2, c.eps_q);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (!((near >> k) & 1u)) continue;  // beyond the box: every lane
      const int j = j0 + k;
      const float4 p = src[j];
      const float dx = p.x - t.x, dy = p.y - t.y, dz = p.z - t.z;
      const nbt::SrDist r = nbt::sr_dist(dx, dy, dz, c.inv_rc2, c.eps_q);
      if (nbt::warp_all_beyond(r.q)) continue;  // every lane: terms 0
      const VjpTerms w = vjp_terms(r, c);
      float hd = p.w * fmaf(gi.z, dz, fmaf(gi.y, dy, gi.x * dx));
      if (kReact) {
        const float4 gj = gsrc[j];
        const float gjd = fmaf(gj.z, dz, fmaf(gj.y, dy, gj.x * dx));
        hd = fmaf(-t.w, gjd, hd);
        a.g.x = fmaf(w.w, gj.x, a.g.x);
        a.g.y = fmaf(w.w, gj.y, a.g.y);
        a.g.z = fmaf(w.w, gj.z, a.g.z);
        a.m = fmaf(w.w, gjd, a.m);
      }
      ewm = fmaf(w.w, p.w, ewm);
      const float cc = w.c2 * hd;
      a.d.x = fmaf(cc, dx, a.d.x);
      a.d.y = fmaf(cc, dy, a.d.y);
      a.d.z = fmaf(cc, dz, a.d.z);
      a.r = fmaf(w.k2, hd, a.r);
    }
  }
  a.wm += ewm;
}

// The source pass's sums of a lane's source (s: x, y, z, m; gj its
// cotangent) over the 64 targets tgt[0..64) and their cotangents gtgt,
// every lane on the same target, with the same skips.
template <bool kReact>
__device__ __forceinline__ void source_sweep(const float4* tgt,
                                             const float4* gtgt, float4 s,
                                             float3 gj, float3 lo, float3 hi,
                                             int lane, const VjpConst& c,
                                             Sums& a) {
  float3 eg = make_float3(0.f, 0.f, 0.f);  // this entry's sum w g_i
  for (int i0 = 0; i0 < kSlab; i0 += 32) {
    const unsigned near =
        nbt::sr_box_ballot(tgt[i0 + lane], lo, hi, c.inv_rc2, c.eps_q);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (!((near >> k) & 1u)) continue;
      const int i = i0 + k;
      const float4 o = tgt[i];
      const float dx = s.x - o.x, dy = s.y - o.y, dz = s.z - o.z;
      const nbt::SrDist r = nbt::sr_dist(dx, dy, dz, c.inv_rc2, c.eps_q);
      if (nbt::warp_all_beyond(r.q)) continue;
      const VjpTerms w = vjp_terms(r, c);
      const float4 gi = gtgt[i];
      const float gid = fmaf(gi.z, dz, fmaf(gi.y, dy, gi.x * dx));
      float hd = s.w * gid;
      if (kReact) {
        hd = fmaf(-o.w, fmaf(gj.z, dz, fmaf(gj.y, dy, gj.x * dx)), hd);
        a.wm = fmaf(w.w, o.w, a.wm);
      }
      eg.x = fmaf(w.w, gi.x, eg.x);
      eg.y = fmaf(w.w, gi.y, eg.y);
      eg.z = fmaf(w.w, gi.z, eg.z);
      a.m = fmaf(w.w, gid, a.m);
      const float cc = w.c2 * hd;
      a.d.x = fmaf(cc, dx, a.d.x);
      a.d.y = fmaf(cc, dy, a.d.y);
      a.d.z = fmaf(cc, dz, a.d.z);
    }
  }
  a.g.x += eg.x;
  a.g.y += eg.y;
  a.g.z += eg.z;
}

// Offset of a unit's partial in a side's scratch, [unit][head, tail][kRows]
// [64] floats: `which` 0 for the segment that continues a run (head), 1 for
// the one that starts a run that goes on (tail).
template <int kRows>
__device__ __forceinline__ long long vjp_partial(long long unit, int which) {
  return (unit * 2 + which) * kRows * kSlab;
}

// One side's pass.  Its positions: the target pass's are the worklist
// entries in [lim[0], lim[1]) (the bounds); the source pass's are indices
// into perm in [0, lim[0]) (lim = start + nslab: the live entries), entry
// perm[r].  The owner slab of a position is its entry's target (source),
// the other its entry's source (target).  acc: kRows rows of nslots, the
// side's sums, zeroed by the launcher; part: the side's unit partials.
// At most 64 registers a thread: at the count ptxas picks by itself (56)
// the source pass spills; 64 hold every instantiation without a spill
// (nvcc.log) and leave room for 8 CTAs of 128 threads an SM.
template <bool kSource, bool kSym>
__global__ void __maxnreg__(64)
sr_vjp_pass_kernel(const float4* __restrict__ tab,
                   const float4* __restrict__ gtab,
                   const int* __restrict__ wl_t, const int* __restrict__ wl_s,
                   const int* __restrict__ perm, const int* __restrict__ lim,
                   int e_max, const float* __restrict__ rc2p, int nslots,
                   float* __restrict__ acc, float* __restrict__ part) {
  constexpr int kRows = kSource ? kSourceRows : kTargetRows;
  constexpr bool kStageG = kSource || kSym;  // the others' cotangents
  __shared__ __align__(16) float4 pos_all[kGroups][2][kSlab];
  __shared__ __align__(16) float4 cot_all[kStageG ? kGroups : 1][2][kSlab];
  __shared__ float box_all[kGroups][2][6];
  __shared__ float key_all[kGroups][kSlab];
  __shared__ int order_all[kGroups][kSlab];
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = threadIdx.y;
  const long long unit = static_cast<long long>(blockIdx.x) * kGroups + g;
  const int b0 = kSource ? 0 : max(lim[0], 0);
  const int b1 = min(kSource ? lim[0] : lim[1], e_max);
  const long long first = unit * kUnit;
  const int e0 = static_cast<int>(max(first, static_cast<long long>(b0)));
  const int e1 =
      static_cast<int>(min(first + kUnit, static_cast<long long>(b1)));
  if (e0 >= e1) return;  // the whole group: it syncs with no one else
  const float inv_rc2 = 1.0f / *rc2p;
  const VjpConst c = {inv_rc2, -nbt::kSoftening2 * inv_rc2, 60.0f * inv_rc2,
                      nbt::minus_six()};
  float4(*buf)[kSlab] = pos_all[g];
  float4(*gbuf)[kSlab] = cot_all[kStageG ? g : 0];

  auto entry = [&](int r) { return kSource ? perm[r] : r; };
  auto owner = [&](int r) { return kSource ? wl_s[entry(r)] : wl_t[r]; };
  auto other = [&](int r) { return kSource ? wl_t[entry(r)] : wl_s[r]; };
  // Copy the other slab's rows of position r into buffer `slot`.
  auto stage = [&](int r, int slot) {
    const size_t row = static_cast<size_t>(other(r)) * kSlab + tid;
    nbt::cp_async16(buf[slot] + tid, tab + row);
    if (kStageG) nbt::cp_async16(gbuf[slot] + tid, gtab + row);
    nbt::cp_async_commit();
  };
  stage(e0, 0);
  int cur = 0;
  for (int r = e0; r < e1;) {
    const int own = owner(r);
    int end = r + 1;
    while (end < e1 && owner(end) == own) ++end;
    const bool starts = r == b0 || owner(r - 1) != own;
    const bool ends = end == b1 || owner(end) != own;

    const int off =
        sr_split(tab, own, tid, g, box_all[g], key_all[g], order_all[g]);
    const int mi = own * kSlab + off;
    const float4 me = tab[mi];
    const float4 gm4 = gtab[mi];
    const float3 gme = make_float3(gm4.x, gm4.y, gm4.z);
    float3 lo, hi;  // the warp's box
    sr_warp_box(me, lo, hi);

    Sums a = {make_float3(0.f, 0.f, 0.f), make_float3(0.f, 0.f, 0.f), 0.f,
              0.f, 0.f};
    for (int k = r; k < end; ++k) {
      nbt::cp_async_wait_all();
      // Every thread's copies of buffer `cur` have landed, and every
      // thread is done with the other buffer, which the next copy fills.
      nbt::group_sync(g);
      if (k + 1 < e1) stage(k + 1, cur ^ 1);
      const bool react = kSym && other(k) != own;  // group-uniform
      if constexpr (kSource) {
        if (react) {
          source_sweep<true>(buf[cur], gbuf[cur], me, gme, lo, hi, lane, c, a);
        } else {
          source_sweep<false>(buf[cur], gbuf[cur], me, gme, lo, hi, lane, c,
                              a);
        }
      } else if (react) {
        target_sweep<true>(buf[cur], gbuf[cur], me, gme, lo, hi, lane, c, a);
      } else {
        target_sweep<false>(buf[cur], gbuf[cur], me, gme, lo, hi, lane, c, a);
      }
      cur ^= 1;
    }

    // The segment's sums of the slot: gp, gm (and grc2's term).  The
    // source pass: gp_j = m_j sum(w g_i) - g_j sum(w m_i) + sum(c2 hd d);
    // the target pass: gp_i = -(g_i sum(w m_j) - m_i sum(w g_j) +
    // sum(c2 hd d)).
    float out[kRows];
    if constexpr (kSource) {
      out[0] = fmaf(me.w, a.g.x, fmaf(-gme.x, a.wm, a.d.x));
      out[1] = fmaf(me.w, a.g.y, fmaf(-gme.y, a.wm, a.d.y));
      out[2] = fmaf(me.w, a.g.z, fmaf(-gme.z, a.wm, a.d.z));
      out[3] = a.m;
    } else {
      out[0] = -fmaf(gme.x, a.wm, fmaf(-me.w, a.g.x, a.d.x));
      out[1] = -fmaf(gme.y, a.wm, fmaf(-me.w, a.g.y, a.d.y));
      out[2] = -fmaf(gme.z, a.wm, fmaf(-me.w, a.g.z, a.d.z));
      out[3] = -a.m;
      out[4] = 0.5f * a.r;
    }
    if (starts && ends) {  // a whole run
#pragma unroll
      for (int q = 0; q < kRows; ++q) acc[q * nslots + mi] = out[q];
    } else {  // continues a run (head) or starts one that goes on (tail)
      float* p = part + vjp_partial<kRows>(unit, starts ? 1 : 0);
#pragma unroll
      for (int q = 0; q < kRows; ++q) p[q * kSlab + off] = out[q];
    }
    r = end;
  }
}

// Slab blockIdx.x * kGroups + threadIdx.y, slot threadIdx.x: if its run of
// positions [r0, r1) spans units c0 < c1, acc = tail[c0] + head[c0 + 1] +
// ... + head[c1], in unit order.  The target pass's run is the slab's
// entries in the bounds (wl_t is sorted); the source pass's is [start[q],
// start[q + 1]).
template <bool kSource>
__global__ void __launch_bounds__(kSlab * kGroups)
sr_vjp_finalize_kernel(int nslab, const int* __restrict__ wl_t,
                       const int* __restrict__ start,
                       const int* __restrict__ bounds, int e_max,
                       const float* __restrict__ part,
                       float* __restrict__ acc, int nslots) {
  constexpr int kRows = kSource ? kSourceRows : kTargetRows;
  const int q = blockIdx.x * kGroups + threadIdx.y;
  if (q >= nslab) return;
  int r0, r1;
  if (kSource) {
    r0 = start[q];
    r1 = start[q + 1];
  } else {
    const int b0 = max(bounds[0], 0);
    const int b1 = min(bounds[1], e_max);
    if (b0 >= b1) return;
    r0 = nbt::lower_bound(wl_t, b0, b1, q);
    r1 = nbt::lower_bound(wl_t, r0, b1, q + 1);
  }
  if (r0 >= r1) return;
  const long long c0 = r0 / kUnit, c1 = (r1 - 1) / kUnit;
  if (c0 == c1) return;  // stored by the pass
  const int l = threadIdx.x;
  float sum[kRows];
  const float* p = part + vjp_partial<kRows>(c0, 1);
#pragma unroll
  for (int k = 0; k < kRows; ++k) sum[k] = p[k * kSlab + l];
  for (long long u = c0 + 1; u <= c1; ++u) {
    p = part + vjp_partial<kRows>(u, 0);
#pragma unroll
    for (int k = 0; k < kRows; ++k) sum[k] += p[k * kSlab + l];
  }
  const int slot = q * kSlab + l;
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k * nslots + slot] = sum[k];
}

__global__ void sr_vjp_pack_kernel(const float* __restrict__ ptab,
                                   const float* __restrict__ mtab,
                                   const float* __restrict__ g, int nslots,
                                   float4* __restrict__ tab,
                                   float4* __restrict__ gtab) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nslots) return;
  tab[i] = make_float4(ptab[i], ptab[nslots + i], ptab[2 * nslots + i],
                       mtab[i]);
  gtab[i] = i < nslots - kSlab
                ? make_float4(g[i], g[nslots + i], g[2 * nslots + i], 0.f)
                : make_float4(0.f, 0.f, 0.f, 0.f);
}

// gp and gm: the two sides' sums of a slot, target side first.
__global__ void sr_vjp_combine_kernel(const float* __restrict__ acc_t,
                                      const float* __restrict__ acc_s,
                                      int nslots, float* __restrict__ gp,
                                      float* __restrict__ gm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nslots) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gp[c * nslots + i] = acc_t[c * nslots + i] + acc_s[c * nslots + i];
  }
  gm[i] = acc_t[3 * nslots + i] + acc_s[3 * nslots + i];
}

// out = the sum of x[0..n) in one CTA: thread k adds x[k], x[k + 1024], ...
// in order, then a tree over the threads in shared memory.
__global__ void __launch_bounds__(kSumThreads)
sr_vjp_sum_kernel(const float* __restrict__ x, int n,
                  float* __restrict__ out) {
  __shared__ float red[kSumThreads];
  const int k = threadIdx.x;
  float s = 0.f;
  for (int i = k; i < n; i += kSumThreads) s += x[i];
  red[k] = s;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (k < w) red[k] += red[k + w];
    __syncthreads();
  }
  if (k == 0) *out = red[0];
}

template <bool kSource, bool kSym>
void launch_pass(const float4* tab, const float4* gtab, const int* wl_t,
                 const int* wl_s, const int* perm, const int* lim, int e_max,
                 const float* rc2, int nslots, float* acc, float* part,
                 cudaStream_t stream) {
  const long long units = (e_max + kUnit - 1) / kUnit;
  const dim3 grid(static_cast<unsigned>((units + kGroups - 1) / kGroups));
  sr_vjp_pass_kernel<kSource, kSym><<<grid, dim3(kSlab, kGroups), 0, stream>>>(
      tab, gtab, wl_t, wl_s, perm, lim, e_max, rc2, nslots, acc, part);
}

}  // namespace

// Positions a unit of either pass (one group's work): the wrapper sizes the
// scratch of nbt_sr_vjp from it.
extern "C" int nbt_sr_vjp_unit() { return kUnit; }

// ptab (3,nslots), mtab (nslots,), g (3,nslots) f32; wl_t, wl_s (e_max,),
// bounds (2,) int32; perm (e_max,) and start (nslots / 64 + 1,) int32, the
// source pass's order (ops/sr_kernel.band_order of wl_s over the whole
// worklist); rc2 () f32 -> gp (3,nslots), gm (nslots,), grc2 () f32.
// scratch: f32, 8 * nslots floats of tables, 9 * nslots of the two sides'
// sums, then 2 * (5 + 4) * 64 * ceil(e_max / nbt_sr_vjp_unit()) of unit
// partials.  nslots is a multiple of 64; the wrapper checks it.  Launches
// the kernels on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int nbt_sr_vjp(const float* ptab, const float* mtab,
                          const float* g, int nslots, const int* wl_t,
                          const int* wl_s, int e_max, const int* bounds,
                          const int* perm, const int* start, const float* rc2,
                          int symmetric, float* gp, float* gm, float* grc2,
                          float* scratch, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(nslots);
  auto* tab = reinterpret_cast<float4*>(scratch);
  float4* gtab = tab + n;
  float* acc_t = scratch + 8 * n;
  float* acc_s = acc_t + kTargetRows * n;
  float* part_t = acc_s + kSourceRows * n;
  const long long units = (e_max + kUnit - 1) / kUnit;
  float* part_s = part_t + units * 2 * kTargetRows * kSlab;
  const int nslab = nslots / kSlab;
  cudaError_t err = cudaMemsetAsync(
      acc_t, 0, (kTargetRows + kSourceRows) * n * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  sr_vjp_pack_kernel<<<(nslots + 255) / 256, 256, 0, st>>>(ptab, mtab, g,
                                                           nslots, tab, gtab);
  if (e_max > 0) {
    const int* live = start + nslab;
    if (symmetric) {
      launch_pass<false, true>(tab, gtab, wl_t, wl_s, perm, bounds, e_max, rc2,
                               nslots, acc_t, part_t, st);
      launch_pass<true, true>(tab, gtab, wl_t, wl_s, perm, live, e_max, rc2,
                              nslots, acc_s, part_s, st);
    } else {
      launch_pass<false, false>(tab, gtab, wl_t, wl_s, perm, bounds, e_max,
                                rc2, nslots, acc_t, part_t, st);
      launch_pass<true, false>(tab, gtab, wl_t, wl_s, perm, live, e_max, rc2,
                               nslots, acc_s, part_s, st);
    }
    const dim3 grid((nslab + kGroups - 1) / kGroups), block(kSlab, kGroups);
    sr_vjp_finalize_kernel<false><<<grid, block, 0, st>>>(
        nslab, wl_t, start, bounds, e_max, part_t, acc_t, nslots);
    sr_vjp_finalize_kernel<true><<<grid, block, 0, st>>>(
        nslab, wl_t, start, bounds, e_max, part_s, acc_s, nslots);
  }
  sr_vjp_combine_kernel<<<(nslots + 255) / 256, 256, 0, st>>>(acc_t, acc_s,
                                                              nslots, gp, gm);
  sr_vjp_sum_kernel<<<1, kSumThreads, 0, st>>>(acc_t + 4 * n, nslots, grc2);
  return static_cast<int>(cudaGetLastError());
}

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
// L2; the partials (2304 bytes an entry) are the only traffic to device
// memory.  This kernel evaluates each pair twice, in the target and the
// source pass, and skips no whole (warp, source) step: it has about twice
// the bound's operations to issue, and more where a warp's lanes diverge
// on the cutoff test.
//
// Design, simple first (a faster one, with the forward's warp-uniform skip,
// cp.async staging and balanced units, is later work).  Four kernels a call
// on one stream, nothing synced to the host:
//
// 1. sr_vjp_pack_kernel: (x, y, z, m) and (g, 0) of every slot as float4
//    tables, the sentinel slab's g zeroed.
// 2. sr_vjp_pairs_kernel: one CTA of 64 threads an entry, both slabs and
//    both cotangent slabs staged in shared memory.  A target pass (thread k
//    owns slot k of slab t and sums over the 64 sources) and a source pass
//    (thread k owns slot k of slab s and sums over the 64 targets) each
//    recompute the pair terms, so each pair is evaluated twice; each writes
//    its per-entry partials: 5 floats a target slot (gp, gm, grc2's term),
//    4 a source slot (gp, gm).  Entries outside [bounds[0], bounds[1])
//    write nothing.
// 3. sr_vjp_reduce_kernel, once a side: thread k of slab q adds its slot's
//    partials over the entries of slab q in worklist order (perm, start:
//    a stable sort of the band's slabs, by the wrapper) and adds the sum
//    to the side's accumulator.  A long worklist is swept in bands within a
//    scratch budget (ops/sr_kernel.vjp_band); each band's sums are added in
//    band order.
// 4. sr_vjp_combine_kernel adds the two sides a slot, and sr_vjp_sum_kernel
//    sums grc2's per-slot terms in one CTA in a fixed order.
//
// There are no float atomics: every sum is taken in a fixed order, so two
// launches repeat bit for bit.
#include "common.cuh"

namespace {

constexpr int kSlab = 64;    // slots of a slab = threads of a pairs CTA
constexpr int kGroups = 2;   // slabs a reduce CTA (64 threads each)
constexpr int kTarget = 5;   // partials of a target slot: gp x, y, z, gm, grc2
constexpr int kSource = 4;   // partials of a source slot: gp x, y, z, gm
constexpr int kPartial = (kTarget + kSource) * kSlab;  // floats an entry
constexpr int kSumThreads = 1024;

// The terms of one pair inside the cutoff: the weight w, its derivative
// w' = dw/dr2 and k = dw/drc2.
struct VjpTerms {
  float w, dw, k;
};

// q = r2 / rc2 < 1 (the pair is inside the cutoff) and its terms.
__device__ __forceinline__ bool vjp_terms(float dx, float dy, float dz,
                                          float inv_rc2, VjpTerms& t) {
  const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
  const float q = r2 * inv_rc2;
  if (q >= 1.0f) return false;
  const float u = nbt::rsqrt_newton(r2 + nbt::kSoftening2);
  const float u2 = u * u;
  const float u3 = u2 * u;
  const float keep = fmaf(q * q * q, fmaf(fmaf(-6.0f, q, 15.0f), q, -10.0f),
                          1.0f);  // 1 - S(q)
  const float qq = q * (1.0f - q);
  const float ds = 30.0f * qq * qq;  // S'(q)
  t.w = keep * u3;
  t.dw = fmaf(-1.5f * t.w, u2, -(u3 * ds) * inv_rc2);
  t.k = (u3 * ds) * q * inv_rc2;
  return true;
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

template <bool kSym>
__global__ void __launch_bounds__(kSlab)
sr_vjp_pairs_kernel(const float4* __restrict__ tab,
                    const float4* __restrict__ gtab,
                    const int* __restrict__ wl_t,
                    const int* __restrict__ wl_s, int e0,
                    const int* __restrict__ bounds,
                    const float* __restrict__ rc2p,
                    float* __restrict__ part) {
  const int e = e0 + static_cast<int>(blockIdx.x);
  if (e < bounds[0] || e >= bounds[1]) return;  // the whole CTA
  __shared__ float4 pt[kSlab], ps[kSlab], gt[kSlab], gs[kSlab];
  const int k = threadIdx.x;
  const int t = wl_t[e], s = wl_s[e];
  pt[k] = tab[t * kSlab + k];
  ps[k] = tab[s * kSlab + k];
  gt[k] = gtab[t * kSlab + k];
  gs[k] = gtab[s * kSlab + k];
  __syncthreads();
  const float inv_rc2 = 1.0f / *rc2p;
  const bool react = kSym && s != t;
  float* out = part + static_cast<size_t>(blockIdx.x) * kPartial;

  {  // target pass: slot k of slab t over the sources
    const float4 me = pt[k], gi = gt[k];
    float ax = 0.f, ay = 0.f, az = 0.f, am = 0.f, ar = 0.f;
    for (int j = 0; j < kSlab; ++j) {
      const float4 o = ps[j];
      const float dx = o.x - me.x, dy = o.y - me.y, dz = o.z - me.z;
      VjpTerms w;
      if (!vjp_terms(dx, dy, dz, inv_rc2, w)) continue;
      float hx = o.w * gi.x, hy = o.w * gi.y, hz = o.w * gi.z;
      if (react) {
        const float4 gj = gs[j];
        hx = fmaf(-me.w, gj.x, hx);
        hy = fmaf(-me.w, gj.y, hy);
        hz = fmaf(-me.w, gj.z, hz);
        am = fmaf(-w.w, fmaf(gj.z, dz, fmaf(gj.y, dy, gj.x * dx)), am);
      }
      const float hd = fmaf(hz, dz, fmaf(hy, dy, hx * dx));
      const float c = 2.0f * w.dw * hd;
      ax -= fmaf(w.w, hx, c * dx);
      ay -= fmaf(w.w, hy, c * dy);
      az -= fmaf(w.w, hz, c * dz);
      ar = fmaf(w.k, hd, ar);
    }
    out[k] = ax;
    out[kSlab + k] = ay;
    out[2 * kSlab + k] = az;
    out[3 * kSlab + k] = am;
    out[4 * kSlab + k] = ar;
  }
  {  // source pass: slot k of slab s over the targets
    const float4 me = ps[k], gj = gs[k];
    float bx = 0.f, by = 0.f, bz = 0.f, bm = 0.f;
    for (int i = 0; i < kSlab; ++i) {
      const float4 o = pt[i];
      const float dx = me.x - o.x, dy = me.y - o.y, dz = me.z - o.z;
      VjpTerms w;
      if (!vjp_terms(dx, dy, dz, inv_rc2, w)) continue;
      const float4 gi = gt[i];
      float hx = me.w * gi.x, hy = me.w * gi.y, hz = me.w * gi.z;
      if (react) {
        hx = fmaf(-o.w, gj.x, hx);
        hy = fmaf(-o.w, gj.y, hy);
        hz = fmaf(-o.w, gj.z, hz);
      }
      const float hd = fmaf(hz, dz, fmaf(hy, dy, hx * dx));
      const float c = 2.0f * w.dw * hd;
      bx += fmaf(w.w, hx, c * dx);
      by += fmaf(w.w, hy, c * dy);
      bz += fmaf(w.w, hz, c * dz);
      bm = fmaf(w.w, fmaf(gi.z, dz, fmaf(gi.y, dy, gi.x * dx)), bm);
    }
    float* src = out + kTarget * kSlab;
    src[k] = bx;
    src[kSlab + k] = by;
    src[2 * kSlab + k] = bz;
    src[3 * kSlab + k] = bm;
  }
}

// Slab blockIdx.x * kGroups + threadIdx.y, slot threadIdx.x: the sum of
// the slot's partials (kC floats from `first` on) over the band's entries
// perm[start[q]], ..., perm[start[q + 1] - 1] in that order, added to acc
// (kC rows of nslots).
template <int kC>
__global__ void __launch_bounds__(kSlab * kGroups)
sr_vjp_reduce_kernel(const float* __restrict__ part, int first,
                     const int* __restrict__ perm,
                     const int* __restrict__ start, int nslab,
                     float* __restrict__ acc, int nslots) {
  const int q = blockIdx.x * kGroups + threadIdx.y;
  if (q >= nslab) return;
  const int r0 = start[q], r1 = start[q + 1];
  if (r0 >= r1) return;
  const int k = threadIdx.x;
  float sum[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) sum[c] = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float* p = part + static_cast<size_t>(perm[r]) * kPartial +
                     first * kSlab + k;
#pragma unroll
    for (int c = 0; c < kC; ++c) sum[c] += p[c * kSlab];
  }
  const int slot = q * kSlab + k;
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c * nslots + slot] += sum[c];
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

}  // namespace

// ptab (3,nslots), mtab (nslots,), g (3,nslots) f32 -> tabs: (2, nslots, 4)
// f32, the (x, y, z, m) table then the (g, 0) table with the sentinel
// (last) slab's g zeroed.
extern "C" int nbt_sr_vjp_pack(const float* ptab, const float* mtab,
                               const float* g, int nslots, float* tabs,
                               void* stream) {
  auto* tab = reinterpret_cast<float4*>(tabs);
  sr_vjp_pack_kernel<<<(nslots + 255) / 256, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ptab, mtab, g, nslots, tab, tab + nslots);
  return static_cast<int>(cudaGetLastError());
}

// One band of nb worklist entries from e0: the pairs kernel's partials
// (part: nb x 9 x 64 floats), then each side's reduce into acc_t (5 rows of
// nslots) and acc_s (4 rows) in the order of (perm_t, start_t) and
// (perm_s, start_s) (int32: nb and nslots / 64 + 1 long).  wl_t, wl_s,
// bounds int32 and rc2 f32 on the card; nb >= 1.
extern "C" int nbt_sr_vjp_band(const float* tabs, int nslots, const int* wl_t,
                               const int* wl_s, int e0, int nb,
                               const int* bounds, const float* rc2,
                               int symmetric, float* part, const int* perm_t,
                               const int* start_t, const int* perm_s,
                               const int* start_s, float* acc_t, float* acc_s,
                               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* tab = reinterpret_cast<const float4*>(tabs);
  if (symmetric) {
    sr_vjp_pairs_kernel<true><<<nb, kSlab, 0, st>>>(
        tab, tab + nslots, wl_t, wl_s, e0, bounds, rc2, part);
  } else {
    sr_vjp_pairs_kernel<false><<<nb, kSlab, 0, st>>>(
        tab, tab + nslots, wl_t, wl_s, e0, bounds, rc2, part);
  }
  const int nslab = nslots / kSlab;
  const dim3 grid((nslab + kGroups - 1) / kGroups), block(kSlab, kGroups);
  sr_vjp_reduce_kernel<kTarget><<<grid, block, 0, st>>>(
      part, 0, perm_t, start_t, nslab, acc_t, nslots);
  sr_vjp_reduce_kernel<kSource><<<grid, block, 0, st>>>(
      part, kTarget, perm_s, start_s, nslab, acc_s, nslots);
  return static_cast<int>(cudaGetLastError());
}

// gp (3,nslots) and gm (nslots,) from the two sides' sums, grc2 () the sum
// of acc_t's fifth row.
extern "C" int nbt_sr_vjp_finish(const float* acc_t, const float* acc_s,
                                 int nslots, float* gp, float* gm,
                                 float* grc2, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  sr_vjp_combine_kernel<<<(nslots + 255) / 256, 256, 0, st>>>(
      acc_t, acc_s, nslots, gp, gm);
  sr_vjp_sum_kernel<<<1, kSumThreads, 0, st>>>(acc_t + 4 * size_t{1} * nslots,
                                               nslots, grc2);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the partials of one worklist entry (sizes the band's scratch).
extern "C" int nbt_sr_vjp_partial_floats() { return kPartial; }

// The P3M short-range sweep, fp32.
//
// Replaces nbody_tpu/ops/pm.py::_sr_sweep_pallas (the inner `kern`),
// which walks a t-major worklist of (target slab t, source slab or row s)
// entries over VMEM-resident slab tables on the TPU's sequential grid and
// carries a (SLAB, width) accumulator that it flushes when the target
// changes.  For each entry and each target slot i of slab t:
//
//   a_i += sum_j m_j d (|d|^2 + eps^2)^{-3/2} (1 - S(|d|^2 / rc2)),
//
// j over the 64 slots of slab s, or the 128 slots of row s (slabs 2s and
// 2s+1) with `paired`; S is the quintic taper of ops/pm.py.  Symmetric
// worklists hold only s >= t, and each entry adds the reaction
// -sum_i m_i (same weight) d to the source: skipped when s == t, and with
// `paired` masked per source slot (forward keeps slab >= t, reaction slab
// > t).  The diagonal is not masked: d = 0 gives exactly 0.
//
// Bound.  Each entry is 64 x width pair evaluations of about 31 fp32
// operations and one rsqrt, against sources that come from L2 (the tables,
// 8.4 MB at Plummer N=262144, stay there): the sweep is bound by the rate
// at which the SMs issue instructions.  At the JAX package's P3M gate 18%
// of the evaluated pairs lie inside the cutoff; the others add exactly 0,
// so the design spends as few instructions on them as it can
// (scripts/sr_launch_shapes.py --stats counts them).
//
// Design.  Three kernels a call, on one stream, with nothing synced to the
// host (`bounds` and rc2 are read from device memory; grids and scratch
// are sized from the static e_max and nslots):
//
// 1. sr_pack_kernel packs (x, y, z, m) of every slot into one float4
//    table, zero-padded to whole 128-slot rows, so a source is one 16-byte
//    copy and rows past an odd slab count read as zero-mass slots at the
//    origin (the JAX package's pad slab).
// 2. sr_pairs_kernel.  Balanced units: the worklist [bounds[0], bounds[1])
//    is cut into units of kUnit consecutive entries, and each group of 64
//    threads (kGroups a CTA) takes one unit, so no run (the entries of one
//    target slab) is one CTA's serial work: the longest run of the gate's
//    default layout, 521 entries, is 33 units spread over the card.  A
//    group walks its unit's segments (runs cut at the unit's ends), one
//    target slot a thread.  At each segment's start it splits the slab's
//    64 targets into two spatially compact halves, one a warp (the median
//    along the slab's longest axis, by rank): which thread owns a target
//    changes no sum, and compact warps lie beyond the cutoff together more
//    often.  Staging is off the critical path: the sources of the next
//    entry are copied by cp.async into the group's second buffer while
//    this entry's pairs run, and a group syncs only its own 64 threads (a
//    named barrier with an immediate id), once an entry.
//    The forward body (the layouts without a reaction, and the slabs of
//    the symmetric layouts that take none): every lane of a warp takes the
//    same source (a broadcast read).  Two warp-uniform skips, both exact,
//    drop a (warp, source) step: a ballot over 32 sources of their
//    distance to the warp's bounding box, and a vote (warp_all_beyond) on
//    q >= 1 on every lane, where q = d2 / rc2 - eps^2 / rc2 comes from the
//    same d2 register as the weight's rsqrt (sr_dist), and the clamp gives
//    q = 1, S(1) = 1 and a weight of exactly 0.  A kept pair costs one
//    rsqrt.approx (no Newton step: the sweep's tolerance is 2e-5 of the
//    largest slot), the taper in Horner form and three FMAs.
//    The reaction (pallas_sym and pallas_paired_sym, slabs that take it):
//    the rotation of nbt::sym_tile_cross.  At step k of a 32-wide source
//    subtile lane l takes source (l + k) mod 32 (each subtile is staged
//    twice, so the read is one immediate offset), adds both sides, and
//    hands the source's sum on to the lane that takes it next (3
//    shuffles), so after 32 steps lane l holds the warp's sum for source
//    l.  The vote skips a step whose 32 pairs all lie beyond the cutoff,
//    fewer than in the forward body, since a step spans 32 sources.  The
//    two warps' sums meet in shared memory, are added in warp order, and go
//    to the reaction table with one coalesced global atomic a source and
//    coordinate (no shared-memory atomics).
//    A segment that is a whole run stores its forward sum to the output; a
//    run cut by unit ends leaves a partial a unit in scratch instead: the
//    segment that starts it (`tail`) and each one that continues it
//    (`head`).
// 3. sr_finalize_kernel: for each target slab whose run spans several
//    units, its partials added in unit order and stored.
//
// So every forward sum is taken in a fixed order (entries in order within
// a unit, units in order), and the layouts without a reaction repeat bit
// for bit; the reaction's global atomics add in no fixed order, so the
// symmetric layouts repeat within rounding, and the card's default layout
// is pallas_paired (ops/pm.py).  The launch shape (kGroups 2, kUnit 16) is
// the fastest of groups 1, 2, 3 by unit 8, 16, 32 at the gate
// (scripts/sr_launch_shapes.py, PERF.md).
#include "common.cuh"

namespace {

constexpr int kSlab = nbt::kSrSlab;  // target slots of a slab = a group
constexpr int kGroups = 2;  // groups of 64 threads a CTA
constexpr int kUnit = 16;   // worklist entries a unit (one group's work)
static_assert(kGroups <= 4, "nbt::group_sync has four barriers");

using nbt::cp_async16;
using nbt::cp_async_commit;
using nbt::cp_async_wait_all;
using nbt::group_sync;
using nbt::minus_six;
using nbt::sr_dist;
using nbt::sr_keep;
using nbt::SrDist;

// The forward sum of a target (t: x, y, z) over `N` sources src[0..N) in
// order, every lane of the warp on the same source (a broadcast), with two
// warp-uniform skips, both exact: per 32 sources the ballot of their gaps
// to the box [lo, hi] of the warp's targets (nbt::sr_box_ballot), then for
// each kept source d, d2 and q, and if q >= 1 on every lane
// (warp_all_beyond) the weight is exactly 0 on every lane.
template <int N>
__device__ __forceinline__ void sr_forward(const float4* src, float4 t,
                                           float3 lo, float3 hi, int lane,
                                           float inv_rc2, float eps_q,
                                           float m6, float3& a) {
  for (int j0 = 0; j0 < N; j0 += 32) {
    const unsigned near =
        nbt::sr_box_ballot(src[j0 + lane], lo, hi, inv_rc2, eps_q);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (!((near >> k) & 1u)) continue;  // beyond the box: every lane
      const float4 p = src[j0 + k];
      const float dx = p.x - t.x, dy = p.y - t.y, dz = p.z - t.z;
      const SrDist r = sr_dist(dx, dy, dz, inv_rc2, eps_q);
      if (nbt::warp_all_beyond(r.q)) continue;  // every lane: weight 0
      const float u = nbt::rsqrt_approx(r.d2);
      const float w = sr_keep(r.q, m6) * ((p.w * u) * (u * u));
      a.x = fmaf(w, dx, a.x);
      a.y = fmaf(w, dy, a.y);
      a.z = fmaf(w, dz, a.z);
    }
  }
}

// Both sides over one 32-wide source subtile staged twice (sub[l + k] is
// source (l + k) mod 32): the forward sum of the lane's target (t, mass
// t.w) into a, and the reaction on each source, rotated through the lanes,
// into b: on return lane l holds the warp's reaction on source l.
__device__ __forceinline__ void sr_both_sides(const float4* sub, float4 t,
                                              float inv_rc2, float eps_q,
                                              float m6, int lane, float3& a,
                                              float3& b) {
  const int from = (lane + 1) & 31;
  b = make_float3(0.f, 0.f, 0.f);
  sub += lane;
#pragma unroll 8
  for (int k = 0; k < 32; ++k) {
    const float4 p = sub[k];
    const float dx = p.x - t.x, dy = p.y - t.y, dz = p.z - t.z;
    const SrDist r = sr_dist(dx, dy, dz, inv_rc2, eps_q);
    if (!nbt::warp_all_beyond(r.q)) {
      const float u = nbt::rsqrt_approx(r.d2);
      const float w = sr_keep(r.q, m6) * (u * u * u);
      const float wf = p.w * w, wr = -(t.w * w);
      a.x = fmaf(wf, dx, a.x);
      a.y = fmaf(wf, dy, a.y);
      a.z = fmaf(wf, dz, a.z);
      b.x = fmaf(wr, dx, b.x);
      b.y = fmaf(wr, dy, b.y);
      b.z = fmaf(wr, dz, b.z);
    }
    b.x = __shfl_sync(nbt::kFullMask, b.x, from);
    b.y = __shfl_sync(nbt::kFullMask, b.y, from);
    b.z = __shfl_sync(nbt::kFullMask, b.z, from);
  }
}

// Offset of a unit's forward partial in the scratch, [unit][head, tail][3]
// [64] floats: `which` 0 for the segment that continues a run (head), 1 for
// the one that starts a run that goes on (tail).
__device__ __forceinline__ long long sr_partial(long long unit, int which) {
  return (unit * 2 + which) * 3 * kSlab;
}

template <bool kSym, bool kPaired>
__global__ void __launch_bounds__(kSlab * kGroups)
sr_pairs_kernel(const float4* __restrict__ tab, int nslots,
                const int* __restrict__ wl_t, const int* __restrict__ wl_s,
                int e_max, const int* __restrict__ bounds,
                const float* __restrict__ rc2p, float* __restrict__ fwd,
                float* __restrict__ react, float* __restrict__ part) {
  constexpr int kW = kPaired ? 2 * kSlab : kSlab;  // source slots an entry
  constexpr int kStage = kSym ? 2 * kW : kW;  // the reaction: subtiles twice
  __shared__ __align__(16) float4 src_all[kGroups][2][kStage];
  __shared__ float box_all[kGroups][2][6];
  __shared__ float key_all[kGroups][kSlab];
  __shared__ int order_all[kGroups][kSlab];
  // The reaction of an entry: [group][entry parity][warp][xyz][source].
  __shared__ float red_all[kSym ? kGroups : 1][2][2][3][kW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = threadIdx.y;
  const long long unit = static_cast<long long>(blockIdx.x) * kGroups + g;
  const int b0 = max(bounds[0], 0);
  const int b1 = min(bounds[1], e_max);
  const long long first = unit * kUnit;
  const int e0 = static_cast<int>(max(first, static_cast<long long>(b0)));
  const int e1 =
      static_cast<int>(min(first + kUnit, static_cast<long long>(b1)));
  if (e0 >= e1) return;  // the whole group: it syncs with no one else
  const float inv_rc2 = 1.0f / *rc2p;
  const float eps_q = -nbt::kSoftening2 * inv_rc2;
  const float m6 = minus_six();
  float4(*buf)[kStage] = src_all[g];
  float* key = key_all[g];
  int* order = order_all[g];

  // Copy the sources of entry e into buffer `slot` (cp.async, one group).
  auto stage = [&](int e, int slot) {
    const float4* row = tab + static_cast<size_t>(wl_s[e]) * kW;
    for (int j = tid; j < kW; j += kSlab) {
      if (kSym) {  // subtile u = j / 32 at 64 u, twice
        float4* d = buf[slot] + 2 * (j & ~31) + (j & 31);
        cp_async16(d, row + j);
        cp_async16(d + 32, row + j);
      } else {
        cp_async16(buf[slot] + j, row + j);
      }
    }
    cp_async_commit();
  };
  // Add the reaction of an entry (source s, target t), its two warps' sums
  // in warp order, to the reaction table: one atomic a source and
  // coordinate, for the slots that take it.
  auto flush = [&](int parity, int s, int t) {
    for (int j = tid; j < kW; j += kSlab) {
      const int slab = kPaired ? 2 * s + j / kSlab : s;
      const int slot = s * kW + j;
      if (!(kPaired ? slab > t : s != t) || slot >= nslots) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* r = red_all[kSym ? g : 0][parity][0][c];
        atomicAdd(react + c * nslots + slot, r[j] + r[3 * kW + j]);
      }
    }
  };
  int prev_s = -1, prev_t = -1;  // the entry whose reaction waits
  stage(e0, 0);
  int cur = 0;
  for (int e = e0; e < e1;) {
    const int t = wl_t[e];
    int end = e + 1;
    while (end < e1 && wl_t[end] == t) ++end;
    const bool starts = e == b0 || wl_t[e - 1] != t;
    const bool ends = end == b1 || wl_t[end] != t;

    // Split the slab's 64 targets into two compact halves, one a warp: the
    // slab's bounding box, its longest axis, each target's rank along it
    // (ties by slot), and thread `rank` takes the target.
    const float4 me = tab[t * kSlab + tid];
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
        box_all[g][warp][c] = lo[c];
        box_all[g][warp][3 + c] = hi[c];
      }
    }
    group_sync(g);
    float ext[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ext[c] = fmaxf(box_all[g][0][3 + c], box_all[g][1][3 + c]) -
               fminf(box_all[g][0][c], box_all[g][1][c]);
    }
    const int axis = ext[0] >= ext[1] ? (ext[0] >= ext[2] ? 0 : 2)
                                      : (ext[1] >= ext[2] ? 1 : 2);
    const float mine = axis == 0 ? me.x : (axis == 1 ? me.y : me.z);
    key[tid] = mine;
    group_sync(g);
    int rank = 0;
    for (int k = 0; k < kSlab; ++k) {
      const float other = key[k];
      rank += (other < mine || (other == mine && k < tid)) ? 1 : 0;
    }
    order[rank] = tid;
    group_sync(g);
    const int off = order[tid];
    const int ti = t * kSlab + off;
    const float4 tg = tab[ti];
    float3 wlo = make_float3(tg.x, tg.y, tg.z), whi = wlo;  // the warp's box
    for (int o = 16; o; o >>= 1) {
      wlo.x = fminf(wlo.x, __shfl_xor_sync(nbt::kFullMask, wlo.x, o));
      wlo.y = fminf(wlo.y, __shfl_xor_sync(nbt::kFullMask, wlo.y, o));
      wlo.z = fminf(wlo.z, __shfl_xor_sync(nbt::kFullMask, wlo.z, o));
      whi.x = fmaxf(whi.x, __shfl_xor_sync(nbt::kFullMask, whi.x, o));
      whi.y = fmaxf(whi.y, __shfl_xor_sync(nbt::kFullMask, whi.y, o));
      whi.z = fmaxf(whi.z, __shfl_xor_sync(nbt::kFullMask, whi.z, o));
    }

    float3 a = make_float3(0.f, 0.f, 0.f);
    for (int k = e; k < end; ++k) {
      cp_async_wait_all();
      // Every thread's copies of buffer `cur` have landed, and every
      // thread is done with the other buffer, which the next copy fills.
      group_sync(g);
      if (k + 1 < e1) stage(k + 1, cur ^ 1);
      if (kSym && prev_s >= 0) flush(cur ^ 1, prev_s, prev_t);
      const float4* src = buf[cur];
      if (!kSym) {
        sr_forward<kW>(src, tg, wlo, whi, lane, inv_rc2, eps_q, m6, a);
      } else {
        const int s = wl_s[k];
#pragma unroll
        for (int u = 0; u < kW / 32; ++u) {  // 32-wide source subtiles
          const int slab = kPaired ? 2 * s + u / 2 : s;  // group-uniform
          if (kPaired && slab < t) continue;  // neither side: masked
          const bool reaction = kPaired ? slab > t : s != t;
          if (!reaction) {
            sr_forward<32>(src + 64 * u, tg, wlo, whi, lane, inv_rc2,
                           eps_q, m6, a);
            continue;
          }
          float3 b;
          sr_both_sides(src + 64 * u, tg, inv_rc2, eps_q, m6, lane, a, b);
          float* r = red_all[kSym ? g : 0][cur][warp][0] + 32 * u + lane;
          r[0] = b.x;
          r[kW] = b.y;
          r[2 * kW] = b.z;
        }
        prev_s = s;
        prev_t = t;
      }
      cur ^= 1;
    }

    if (starts && ends) {  // a whole run
      fwd[ti] = a.x;
      fwd[nslots + ti] = a.y;
      fwd[2 * nslots + ti] = a.z;
    } else {  // continues a run (head) or starts one that goes on (tail)
      float* p = part + sr_partial(unit, starts ? 1 : 0);
      p[off] = a.x;
      p[kSlab + off] = a.y;
      p[2 * kSlab + off] = a.z;
    }
    e = end;
  }
  if (kSym) {  // the unit's last reaction
    group_sync(g);
    flush(cur ^ 1, prev_s, prev_t);
  }
}

// Slab blockIdx.x * kGroups + threadIdx.y, slot threadIdx.x: if its run in
// [bounds[0], bounds[1]) spans units c0 < c1, the sum tail[c0] + head[c0 +
// 1] + ... + head[c1], in unit order.
__global__ void __launch_bounds__(kSlab * kGroups)
sr_finalize_kernel(int nslab, const int* __restrict__ wl_t, int e_max,
                   const int* __restrict__ bounds,
                   const float* __restrict__ part, float* __restrict__ fwd,
                   int nslots) {
  const int t = blockIdx.x * kGroups + threadIdx.y;
  if (t >= nslab) return;
  const int b0 = max(bounds[0], 0);
  const int b1 = min(bounds[1], e_max);
  if (b0 >= b1) return;
  const int r0 = nbt::lower_bound(wl_t, b0, b1, t);
  const int r1 = nbt::lower_bound(wl_t, r0, b1, t + 1);
  if (r0 >= r1) return;
  const long long c0 = r0 / kUnit, c1 = (r1 - 1) / kUnit;
  if (c0 == c1) return;  // stored by sr_pairs_kernel
  const int l = threadIdx.x;
  const float* p = part + sr_partial(c0, 1);
  float ax = p[l], ay = p[kSlab + l], az = p[2 * kSlab + l];
  for (long long c = c0 + 1; c <= c1; ++c) {
    p = part + sr_partial(c, 0);
    ax += p[l];
    ay += p[kSlab + l];
    az += p[2 * kSlab + l];
  }
  const int ti = t * kSlab + l;
  fwd[ti] = ax;
  fwd[nslots + ti] = ay;
  fwd[2 * nslots + ti] = az;
}

// tab[i] = (x, y, z, m) of slot i, zero past nslots.
__global__ void sr_pack_kernel(const float* __restrict__ ptab,
                               const float* __restrict__ mtab, int nslots,
                               int npad, float4* __restrict__ tab) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  tab[i] = i < nslots ? make_float4(ptab[i], ptab[nslots + i],
                                    ptab[2 * nslots + i], mtab[i])
                      : make_float4(0.f, 0.f, 0.f, 0.f);
}

int padded_slots(int nslots) { return (nslots + 127) / 128 * 128; }

long long units(int e_max) { return (e_max + kUnit - 1) / kUnit; }

template <bool kSym, bool kPaired>
void launch_pairs(const float4* tab, int nslots, const int* wl_t,
                  const int* wl_s, int e_max, const int* bounds,
                  const float* rc2, float* fwd, float* react, float* part,
                  cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((units(e_max) + kGroups - 1) /
                                        kGroups));
  sr_pairs_kernel<kSym, kPaired><<<grid, dim3(kSlab, kGroups), 0, stream>>>(
      tab, nslots, wl_t, wl_s, e_max, bounds, rc2, fwd, react, part);
}

}  // namespace

// Entries a unit of the sweep (one group's work): the wrapper sizes the
// scratch of nbt_sr_sweep from it.
extern "C" int nbt_sr_unit() { return kUnit; }

// ptab (3,nslots), mtab (nslots,) f32; wl_t, wl_s (e_max,), bounds (2,)
// int32; rc2 () f32; fwd and react (3,nslots) f32, zeroed by the caller
// (react is written only when `symmetric`); scratch: f32, 4 * (nslots
// rounded up to 128) floats of packed table, then 2 * 3 * 64 * ceil(e_max
// / nbt_sr_unit()) floats of partials.  nslots is a multiple of 64, e_max
// >= 1; the wrapper checks them.  Launches the three kernels on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int nbt_sr_sweep(const float* ptab, const float* mtab, int nslots,
                            const int* wl_t, const int* wl_s, int e_max,
                            const int* bounds, const float* rc2, float* fwd,
                            float* react, float* scratch, int symmetric,
                            int paired, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int npad = padded_slots(nslots);
  auto* tab = reinterpret_cast<float4*>(scratch);
  float* part = scratch + 4 * static_cast<size_t>(npad);
  sr_pack_kernel<<<(npad + 255) / 256, 256, 0, st>>>(ptab, mtab, nslots,
                                                     npad, tab);
  if (symmetric && paired) {
    launch_pairs<true, true>(tab, nslots, wl_t, wl_s, e_max, bounds, rc2, fwd,
                             react, part, st);
  } else if (symmetric) {
    launch_pairs<true, false>(tab, nslots, wl_t, wl_s, e_max, bounds, rc2,
                              fwd, react, part, st);
  } else if (paired) {
    launch_pairs<false, true>(tab, nslots, wl_t, wl_s, e_max, bounds, rc2,
                              fwd, react, part, st);
  } else {
    launch_pairs<false, false>(tab, nslots, wl_t, wl_s, e_max, bounds, rc2,
                               fwd, react, part, st);
  }
  const int nslab = nslots / kSlab;
  sr_finalize_kernel<<<(nslab + kGroups - 1) / kGroups, dim3(kSlab, kGroups),
                       0, st>>>(nslab, wl_t, e_max, bounds, part, fwd, nslots);
  return static_cast<int>(cudaGetLastError());
}

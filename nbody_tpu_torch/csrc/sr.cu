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
// Design.  CTAs run in no order, so the TPU's flush-on-target-change
// accumulator has no counterpart; ownership of runs takes its place.  The
// entries of one target slab form one contiguous run.  CTA b owns the runs
// that START in its chunk [b*kChunk, (b+1)*kChunk) of [bounds[0],
// bounds[1]) (an entry starts a run when it is the first in bounds or its
// target differs from the entry before) and walks each to its end, past its
// chunk if need be.  Each of its kGroups groups of 64 threads holds one
// target slot per thread in registers; the groups take the run's entries
// in turn, each staging its source slab or row (x, y, z, m) through shared
// memory.  At
// the end of a run the groups' register sums are added in group order and
// stored once: the forward sum is deterministic and needs no atomics, so
// the layouts without a reaction repeat bit for bit.  The reaction of
// the symmetric layouts is summed per entry in shared memory (each thread
// visits the sources in an order staggered by its lane, so a warp's
// shared-memory atomics hit 32 different words) and added to a separate
// reaction table with global atomicAdd; the wrapper adds the two tables.
// Sources reach one slab from many CTAs, so the symmetric layouts are not
// bit-reproducible.  `bounds` and rc2 are read from device memory and the
// grid is sized from the static e_max: CTAs past bounds[1] return at once,
// and nothing syncs with the host.  Paired rows past the table (an odd
// slab count) read as zero-mass slots at the origin, as the JAX package's
// pad slab does, and receive no reaction.
//
// Bound.  Each entry is 64 x width pair evaluations of about 30 fp32
// operations (one rsqrtf), against 64 * width * 16 bytes of sources that
// come from L2 (the tables, 8.4 MB at Plummer N=262144, stay there), so
// the sweep is bound by the operation rate, plus three shared-memory
// atomics a pair in the symmetric layouts, which cost more than the pairs
// they save (the card's default layout is paired rows without the
// reaction).  Idle lanes are the cost of the simple design: a run shorter
// than kGroups entries leaves groups idle, and one long run is one CTA's
// serial work.  The launch shape (kGroups 4, kChunk 16) is the fastest of
// groups 1, 2, 4 by chunk 4, 16, 64 at Plummer N=262144 (PERF.md §6).
#include "common.cuh"

namespace {

constexpr int kSlab = 64;   // slots per slab = threads per group
constexpr int kGroups = 4;  // groups of 64 threads per CTA
constexpr int kChunk = 16;  // worklist entries per CTA

template <bool kSym, bool kPaired>
__global__ void __launch_bounds__(kSlab * kGroups)
sr_sweep_kernel(const float* __restrict__ ptab, const float* __restrict__ mtab,
                int nslots, const int* __restrict__ wl_t,
                const int* __restrict__ wl_s, int e_max,
                const int* __restrict__ bounds, const float* __restrict__ rc2p,
                float* __restrict__ fwd, float* __restrict__ react) {
  constexpr int kW = kPaired ? 2 * kSlab : kSlab;  // source slots an entry
  __shared__ float4 src_all[kGroups][kW];  // each group's source slab or row
  __shared__ float react_all[kSym ? kGroups : 1][3][kW];  // reaction sums
  __shared__ float part[3][kGroups][kSlab];  // the groups' forward sums
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  float4* src = src_all[g];
  float* rx = react_all[kSym ? g : 0][0];
  float* ry = react_all[kSym ? g : 0][1];
  float* rz = react_all[kSym ? g : 0][2];

  const int b0 = max(bounds[0], 0);
  const int b1 = min(bounds[1], e_max);
  const long long first = static_cast<long long>(blockIdx.x) * kChunk;
  const int c0 = static_cast<int>(max(first, static_cast<long long>(b0)));
  const int c1 = static_cast<int>(min(first + kChunk, static_cast<long long>(b1)));
  if (c0 >= c1) return;
  const float inv_rc2 = 1.0f / *rc2p;
  const float* px = ptab;
  const float* py = ptab + nslots;
  const float* pz = ptab + 2 * nslots;

  for (int e = c0; e < c1; ++e) {
    const int t = wl_t[e];
    if (e > b0 && wl_t[e - 1] == t) continue;  // not a run start
    int end = e + 1;
    while (end < b1 && wl_t[end] == t) ++end;
    const int ti = t * kSlab + lane;
    const float xt = px[ti], yt = py[ti], zt = pz[ti];
    const float mt = kSym ? mtab[ti] : 0.0f;
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    for (int k = e; k < end; k += kGroups) {
      const int ee = k + g;
      const bool live = ee < end;
      const int s = live ? wl_s[ee] : 0;
      const bool react_on = kSym && live && (kPaired || s != t);
      for (int j = lane; j < kW; j += kSlab) {
        const int slot = s * kW + j;
        src[j] = (live && slot < nslots)
                     ? make_float4(px[slot], py[slot], pz[slot], mtab[slot])
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (kSym) {
          rx[j] = 0.0f;
          ry[j] = 0.0f;
          rz[j] = 0.0f;
        }
      }
      __syncthreads();
      if (live) {
#pragma unroll 4
        for (int kk = 0; kk < kW; ++kk) {
          const int j = kSym ? ((kk + lane) & (kW - 1)) : kk;
          const float4 sj = src[j];
          const float dx = sj.x - xt, dy = sj.y - yt, dz = sj.z - zt;
          const float r2 = dx * dx + dy * dy + dz * dz;
          const float u = rsqrtf(r2 + nbt::kSoftening2);
          const float q = fminf(fmaxf(r2 * inv_rc2, 0.0f), 1.0f);
          const float taper = q * q * q * (q * (q * 6.0f - 15.0f) + 10.0f);
          float w = (1.0f - taper) * (u * u * u);
          float wr = w;
          if (kSym && kPaired) {
            const int lane_slab = 2 * s + (j >= kSlab ? 1 : 0);
            w = lane_slab >= t ? w : 0.0f;
            wr = lane_slab > t ? w : 0.0f;
          }
          const float wm = sj.w * w;
          ax = fmaf(wm, dx, ax);
          ay = fmaf(wm, dy, ay);
          az = fmaf(wm, dz, az);
          if (react_on) {
            const float c = mt * wr;
            atomicAdd(rx + j, -c * dx);
            atomicAdd(ry + j, -c * dy);
            atomicAdd(rz + j, -c * dz);
          }
        }
      }
      __syncthreads();
      if (react_on) {
        // Each thread flushes (and, at the next staging, zeroes) the same
        // slots, so no barrier is needed between the two.
        for (int j = lane; j < kW; j += kSlab) {
          const int slot = s * kW + j;
          if (slot < nslots) {
            atomicAdd(react + slot, rx[j]);
            atomicAdd(react + nslots + slot, ry[j]);
            atomicAdd(react + 2 * nslots + slot, rz[j]);
          }
        }
      }
    }
    // Add the groups' sums in group order.
    part[0][g][lane] = ax;
    part[1][g][lane] = ay;
    part[2][g][lane] = az;
    __syncthreads();
    if (g == 0) {
      for (int h = 1; h < kGroups; ++h) {
        ax += part[0][h][lane];
        ay += part[1][h][lane];
        az += part[2][h][lane];
      }
      fwd[ti] = ax;
      fwd[nslots + ti] = ay;
      fwd[2 * nslots + ti] = az;
    }
    __syncthreads();
  }
}

template <bool kSym, bool kPaired>
cudaError_t launch(const float* ptab, const float* mtab, int nslots,
                   const int* wl_t, const int* wl_s, int e_max,
                   const int* bounds, const float* rc2, float* fwd,
                   float* react, cudaStream_t stream) {
  const dim3 block(kSlab, kGroups);
  const dim3 grid((e_max + kChunk - 1) / kChunk);
  sr_sweep_kernel<kSym, kPaired><<<grid, block, 0, stream>>>(
      ptab, mtab, nslots, wl_t, wl_s, e_max, bounds, rc2, fwd, react);
  return cudaGetLastError();
}

}  // namespace

// ptab (3,nslots), mtab (nslots,) f32; wl_t, wl_s (e_max,), bounds (2,)
// int32; rc2 () f32; fwd and react (3,nslots) f32, zeroed by the caller
// (react is written only when `symmetric`).  nslots is a multiple of 64,
// e_max >= 1; the wrapper checks them.
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int nbt_sr_sweep(const float* ptab, const float* mtab, int nslots,
                            const int* wl_t, const int* wl_s, int e_max,
                            const int* bounds, const float* rc2, float* fwd,
                            float* react, int symmetric, int paired,
                            void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (symmetric && paired) {
    err = launch<true, true>(ptab, mtab, nslots, wl_t, wl_s, e_max, bounds,
                             rc2, fwd, react, st);
  } else if (symmetric) {
    err = launch<true, false>(ptab, mtab, nslots, wl_t, wl_s, e_max, bounds,
                              rc2, fwd, react, st);
  } else if (paired) {
    err = launch<false, true>(ptab, mtab, nslots, wl_t, wl_s, e_max, bounds,
                              rc2, fwd, react, st);
  } else {
    err = launch<false, false>(ptab, mtab, nslots, wl_t, wl_s, e_max, bounds,
                               rc2, fwd, react, st);
  }
  return static_cast<int>(err);
}

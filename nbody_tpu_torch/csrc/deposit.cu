// The CIC mass deposit onto the ng^3 mesh, fp32 in and out, summed in
// 64-bit fixed point.
//
// Replaces no Pallas kernel: nbody_tpu/ops/pm.py deposits with an XLA
// scatter-add, and the port's plain deposit (ops/pm.py _scatter) is an
// accumulating index_put_ of the 8 N (corner, weight) pairs, which PyTorch
// runs on the card as a radix sort of the flat indices and a reduction of
// each run (indexing_backward_kernel): 2.2 ms a step at N = 1048576.
//
// Bound.  A deposit reads 16 B a body (x, y, z, m) and writes the grid: at
// N = 1048576 and ng = 128, 16.8 MB read and 8.4 MB written, about 8 us at
// 3.35 TB/s.  Its 8 N accumulations are L2 atomics (the int64 grid, 16.8
// MB, stays in L2): about a tenth of a millisecond.
//
// Design.  Four kernels a call, on one stream, nothing synced to the host
// (the box is read from device memory; grids are sized from N and ng):
//
// 1. deposit_zero_kernel zeroes the int64 scratch: the ng^3 accumulators
//    and a header (the exponent bins of the masses, a block counter, the
//    non-finite flag and the scale).
// 2. deposit_mass_kernel takes sum |m| exactly and in no fixed order: each
//    |m| adds its 24-bit significand to the int64 bin of its exponent (runs
//    of equal exponents summed in a register, then a block's bins in
//    shared memory, then one global atomic a bin a block).  The last block
//    to finish (a counter after a fence) sums the 256 bins scaled to their
//    exponents in double, in one fixed tree order, and stores the scale
//    S = 2^61 / sum |m| (0 when every mass is 0).  So S depends on the set
//    of masses alone, not on their order.
// 3. deposit_cic_kernel: one thread a body.  It computes the cell g, the
//    lower corner i0 and the fractions exactly as ops/pm.py's
//    _cic_weights does (open: (x - lo) * inv_h, clamped) or as
//    _cic_weights_periodic and _wrap_box do (x - L floor(x / L), times
//    ng / L, corners wrapped): the same fp32 operations in the same order,
//    each rounded once (__fsub_rn, __fmul_rn, __fdiv_rn: no contraction to
//    an FMA, and true divisions where the plain code divides by a tensor).
//    Each corner's contribution m ((wx wy) wz) is _scatter's own fp32
//    value; it adds llrint(double(m w) S) to its cell with a 64-bit integer
//    atomicAdd.  Integer addition is associative, so the grid is the same
//    bit for bit whatever order the atomics land in, and each cell's sum
//    is exact up to one rounding of 2^-62 sum |m| a contribution (AMBER's
//    SPFP accumulation: Le Grand, Goetz and Walker 2013, Comput. Phys.
//    Commun. 184, 374).  |acc| <= S sum |m| (1 + 2^-20) + 4 N < 2^62, so
//    no cell overflows.  A non-finite position, mass or open box sets the
//    flag.
// 4. deposit_convert_kernel writes each cell as float(double(acc) / S)
//    into the fp32 grid the transform takes, or NaN everywhere when the
//    flag is set: a non-finite state still gives a non-finite grid.
//
// The result is the float64 sum of _scatter's fp32 contributions, rounded
// once to fp32.  ops/deposit_kernel.py's deposit_plain computes the same
// bits in plain PyTorch.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;  // fp32 exponents: the bins of sum |m|
constexpr int kMassBlocks = 264;  // 2 CTAs for each of the H100's 132 SMs
// The header's int64 words after the ng^3 accumulators.
constexpr int kCount = kBins;      // blocks of deposit_mass_kernel done
constexpr int kFlag = kBins + 1;   // a non-finite input was seen
constexpr int kScale = kBins + 2;  // S, a double's bits
constexpr int kHeader = kBins + 4;

using u64 = unsigned long long;
static_assert(kThreads == kBins, "the last block sums one bin a thread");

__global__ void deposit_zero_kernel(long long* scratch, long long words) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < words; i += stride) {
    scratch[i] = 0;
  }
}

__global__ void deposit_mass_kernel(const float* __restrict__ mass, int n,
                                    long long* __restrict__ head) {
  __shared__ u64 bins[kBins];
  __shared__ double sums[kBins];
  __shared__ bool last;
  const int t = threadIdx.x;
  bins[t] = 0;
  __syncthreads();
  int run_e = -1;
  u64 run = 0;
  for (int i = blockIdx.x * kThreads + t; i < n; i += gridDim.x * kThreads) {
    const unsigned bits = __float_as_uint(mass[i]) & 0x7fffffffu;
    const int e = static_cast<int>(bits >> 23);
    if (e == 255) continue;  // inf or NaN: deposit_cic_kernel flags it
    if (e != run_e) {
      if (run_e >= 0) atomicAdd(&bins[run_e], run);
      run_e = e;
      run = 0;
    }
    run += (bits & 0x7fffffu) | (e ? 0x800000u : 0u);
  }
  if (run_e >= 0) atomicAdd(&bins[run_e], run);
  __syncthreads();
  if (bins[t]) atomicAdd(reinterpret_cast<u64*>(head) + t, bins[t]);
  __threadfence();
  __syncthreads();
  if (t == 0) {
    last = atomicAdd(reinterpret_cast<u64*>(head) + kCount, 1ull) ==
           gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // Bin e holds significands of 2^(max(e, 1) - 150): exact products.
  sums[t] = __dmul_rn(__ll2double_rn(__ldcg(head + t)),
                      ldexp(1.0, max(t, 1) - 150));
  __syncthreads();
  for (int s = kBins / 2; s > 0; s >>= 1) {
    if (t < s) sums[t] = __dadd_rn(sums[t], sums[t + s]);
    __syncthreads();
  }
  if (t == 0) {
    const double total = sums[0];
    head[kScale] = __double_as_longlong(
        total > 0.0 ? __ddiv_rn(ldexp(1.0, 61), total) : 0.0);
  }
}

// _cic_weights for one axis: g = clamp((x - lo) * inv_h, 0, ng - 1),
// i0 = clamp(floor(g), 0, ng - 2), frac = clamp(g - i0, 0, 1).
__device__ __forceinline__ int open_axis(float x, float lo, float inv_h,
                                         int ng, float& frac) {
  float g = __fmul_rn(__fsub_rn(x, lo), inv_h);
  g = fminf(fmaxf(g, 0.f), static_cast<float>(ng - 1));
  const int i0 = min(max(static_cast<int>(floorf(g)), 0), ng - 2);
  frac = fminf(fmaxf(__fsub_rn(g, static_cast<float>(i0)), 0.f), 1.f);
  return i0;
}

// _cic_weights_periodic for one axis: w = x - L floor(x / L) (_wrap_box),
// g = w * (ng / L), i0 = clamp(floor(g), 0, ng - 1), frac = clamp(g - i0,
// 0, 1).
__device__ __forceinline__ int periodic_axis(float x, float box, float scale,
                                             int ng, float& frac) {
  const float w = __fsub_rn(x, __fmul_rn(box, floorf(__fdiv_rn(x, box))));
  const float g = __fmul_rn(w, scale);
  const int i0 = min(max(static_cast<int>(floorf(g)), 0), ng - 1);
  frac = fminf(fmaxf(__fsub_rn(g, static_cast<float>(i0)), 0.f), 1.f);
  return i0;
}

template <bool kPeriodic>
__global__ void deposit_cic_kernel(const float* __restrict__ pos,
                                   const float* __restrict__ mass, int n,
                                   const float* __restrict__ lo,
                                   const float* __restrict__ inv_h, float box,
                                   int ng, long long* __restrict__ acc,
                                   long long* __restrict__ head) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float p[3] = {pos[i], pos[n + i], pos[2 * static_cast<size_t>(n) + i]};
  const float m = mass[i];
  bool bad = !isfinite(p[0]) || !isfinite(p[1]) || !isfinite(p[2]) ||
             !isfinite(m);
  if (!kPeriodic) {
    for (int a = 0; a < 3; ++a) {
      bad = bad || !isfinite(lo[a]) || !isfinite(inv_h[a]);
    }
  }
  if (bad) {
    head[kFlag] = 1;
    return;
  }
  if (m == 0.f) return;  // every contribution is 0
  const float scale = kPeriodic ? __fdiv_rn(static_cast<float>(ng), box) : 0.f;
  int i0[3];
  float w[3][2];
  for (int a = 0; a < 3; ++a) {
    float f;
    i0[a] = kPeriodic ? periodic_axis(p[a], box, scale, ng, f)
                      : open_axis(p[a], lo[a], inv_h[a], ng, f);
    w[a][0] = __fsub_rn(1.f, f);
    w[a][1] = f;
  }
  const double s = __longlong_as_double(head[kScale]);
  for (int cx = 0; cx < 2; ++cx) {
    int ix = i0[0] + cx;
    if (kPeriodic && ix >= ng) ix -= ng;
    for (int cy = 0; cy < 2; ++cy) {
      int iy = i0[1] + cy;
      if (kPeriodic && iy >= ng) iy -= ng;
      const float wxy = __fmul_rn(w[0][cx], w[1][cy]);
      const long long row = (static_cast<long long>(ix) * ng + iy) * ng;
      for (int cz = 0; cz < 2; ++cz) {
        int iz = i0[2] + cz;
        if (kPeriodic && iz >= ng) iz -= ng;
        const float v = __fmul_rn(m, __fmul_rn(wxy, w[2][cz]));
        const long long q = __double2ll_rn(__dmul_rn(static_cast<double>(v), s));
        if (q) atomicAdd(reinterpret_cast<u64*>(acc + row + iz),
                         static_cast<u64>(q));
      }
    }
  }
}

__global__ void deposit_convert_kernel(const long long* __restrict__ acc,
                                       long long cells,
                                       const long long* __restrict__ head,
                                       float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool bad = head[kFlag] != 0;
  const double s = __longlong_as_double(head[kScale]);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < cells; i += stride) {
    const long long a = acc[i];
    out[i] = bad ? __int_as_float(0x7fc00000)
                 : a ? __double2float_rn(__ddiv_rn(__ll2double_rn(a), s))
                     : 0.f;
  }
}

unsigned blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

}  // namespace

// The int64 words of nbt_deposit's scratch beyond the ng^3 accumulators:
// the wrapper sizes the scratch from it.
extern "C" int nbt_deposit_header() { return kHeader; }

// pos (3,n), mass (n,) f32; open (box <= 0): lo, inv_h (3,) f32 on the
// device, the grid's origin and inverse spacing; periodic (box > 0): the
// box edge L, lo and inv_h unused.  scratch: int64, ng^3 +
// nbt_deposit_header() words; out: the (ng, ng, ng) f32 grid.  All
// contiguous; ng >= 2.  Launches the four kernels on `stream` without
// synchronising; returns the first launch's cudaGetLastError() that is not
// cudaSuccess, else cudaSuccess.
extern "C" int nbt_deposit(const float* pos, const float* mass, int n,
                           const float* lo, const float* inv_h, float box,
                           int ng, long long* scratch, float* out,
                           void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(ng) * ng * ng;
  long long* head = scratch + cells;
  deposit_zero_kernel<<<blocks_for(cells + kHeader), kThreads, 0, st>>>(
      scratch, cells + kHeader);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned mass_blocks =
      static_cast<unsigned>(std::min<long long>((n + kThreads - 1) / kThreads,
                                                kMassBlocks));
  deposit_mass_kernel<<<mass_blocks > 0 ? mass_blocks : 1, kThreads, 0, st>>>(
      mass, n, head);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    if (box > 0.f) {
      deposit_cic_kernel<true><<<grid, kThreads, 0, st>>>(
          pos, mass, n, lo, inv_h, box, ng, scratch, head);
    } else {
      deposit_cic_kernel<false><<<grid, kThreads, 0, st>>>(
          pos, mass, n, lo, inv_h, box, ng, scratch, head);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  deposit_convert_kernel<<<blocks_for(cells), kThreads, 0, st>>>(
      scratch, cells, head, out);
  return static_cast<int>(cudaGetLastError());
}

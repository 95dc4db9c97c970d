// The open boundary's far field: the moments of the in-box mass and of the
// out-of-box mass in each octant around the box centre, then the nine
// softened monopoles at the targets, fp32 in and out.
//
// Replaces no Pallas kernel: nbody_tpu/ops/pm.py computes the far field
// with XLA ops (_outlier_moments, _monopole).  The port's plain version
// (ops/pm.py _outlier_moments, _monopoles) is a chain of about 200 small
// PyTorch kernels a force call: 8 octants of a mask, a cast, a multiply and
// two sums, then 9 monopoles of about 12 elementwise ops each, a where and
// 8 adds, each over all N.  At N = 1048576 they hold 0.92 device ms a step
// and half the step's launches, for no body outside the box.
//
// Bound.  The moments read 20 B a source (x, y, z, the mass and the in-box
// mass); the targets read 28 B (x, y, z, the in-box mask, the 3
// accelerations) and write 12 B.  At N = 1048576 that is about 63 MB,
// ~19 us at 3.35 TB/s.
//
// Design.  Two kernels a call, on one stream, after a memset of the
// moments' counter and flag; nothing is synced to the host:
//
// 1. far_field_moments_kernel: each thread walks a strided range of the
//    sources.  It forms m_out = mass - m_in and the octant from pos > ctr,
//    ctr = 0.5 (lo_box + hi_box) rounded as torch rounds it (the add, then
//    the multiply), so every body falls in the octant the plain chain puts
//    it in, and accumulates 9 groups (M, sum m x, sum m y, sum m z), the
//    in-box mass and each octant's out-of-box mass, in float64 (each
//    product m x exact; a zero mass adds nothing).  A block reduces in a
//    fixed order (warp shuffles, then its warps in order) and writes its
//    36 partials; the last block to finish (a counter after a fence, as in
//    deposit.cu's deposit_mass_kernel) sums the partials in a fixed tree
//    order and writes the (9, 4) fp32 table of M and com = S / max(M,
//    1e-30).  No float atomics: the grid depends on N alone (never on the
//    card's SM count), so the table repeats bit for bit from call to call
//    and card to card.  A non-finite position, mass or in-box mass makes
//    the whole table NaN, as it makes the plain chain's far field.
// 2. far_field_monopoles_kernel: one thread a target, the table in shared
//    memory.  It computes the plain chain's arithmetic in its order, each
//    operation rounded once (__fmul_rn, __fadd_rn, __fsub_rn: no
//    contraction to an FMA), with the rsqrtf that torch.rsqrt runs for
//    fp32 on the card (ATen's rsqrt_wrapper calls ::rsqrt, rsqrtf for a
//    float): acc = in_tgt > 0 ? acc : mono_in, then acc += mono_k for k =
//    0..7, each monopole (m d) ((u u) u), u = rsqrt(d.d + eps^2).  Given the
//    same table its output equals the chain bit for bit.  It writes out of
//    place, and the targets may differ from the sources.
//
// ops/far_field_kernel.py's moments_plain and monopoles_plain are the same
// functions in plain PyTorch (moments in float64, in another order: within
// one fp32 rounding of the table).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 9;  // the in-box mass, then the 8 octants
constexpr int kSums = 4 * kGroups;  // M, S_x, S_y, S_z a group
constexpr int kMaxBlocks = 264;  // the moments' partials: a fixed cap
// SOFTENING_SQUARED: the Python float, rounded to fp32 as torch adds it.
constexpr float kEps2 = static_cast<float>(1e-3);
// The scratch's doubles: a header (the block counter and the non-finite
// flag, as 32-bit words), then kMaxBlocks x kSums partials.
constexpr int kHeader = 2;

static_assert(kThreads >= kSums, "the table is loaded one entry a thread");

// The moments' grid: from N alone.
unsigned moment_blocks(int n) {
  const long long b = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

__device__ __forceinline__ void add_group(double* s, float m, float x,
                                          float y, float z) {
  const double dm = static_cast<double>(m);
  s[0] = __dadd_rn(s[0], dm);
  s[1] = __fma_rn(static_cast<double>(x), dm, s[1]);
  s[2] = __fma_rn(static_cast<double>(y), dm, s[2]);
  s[3] = __fma_rn(static_cast<double>(z), dm, s[3]);
}

// One source into the 9 groups: its in-box mass into group 0, its
// out-of-box mass into the group of its octant around (cx, cy, cz).
__device__ __forceinline__ void add_source(double* s, bool& bad, float x,
                                           float y, float z, float m,
                                           float mi, float cx, float cy,
                                           float cz) {
  bad = bad || !isfinite(x) || !isfinite(y) || !isfinite(z) ||
        !isfinite(m) || !isfinite(mi);
  if (mi != 0.f) add_group(s, mi, x, y, z);
  const float mo = __fsub_rn(m, mi);
  if (mo != 0.f) {
    const int o = (x > cx) * 4 + (y > cy) * 2 + (z > cz);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (o == k) add_group(s + 4 * (k + 1), mo, x, y, z);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
far_field_moments_kernel(const float* __restrict__ pos,
                         const float* __restrict__ mass,
                         const float* __restrict__ m_in, int n,
                         const float* __restrict__ lo_box,
                         const float* __restrict__ hi_box,
                         double* __restrict__ scratch,
                         float* __restrict__ table) {
  __shared__ double red[kWarps][kSums];
  __shared__ double tot[kSums];
  __shared__ bool last;
  unsigned* head = reinterpret_cast<unsigned*>(scratch);
  double* part = scratch + kHeader;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float cx = __fmul_rn(0.5f, __fadd_rn(lo_box[0], hi_box[0]));
  const float cy = __fmul_rn(0.5f, __fadd_rn(lo_box[1], hi_box[1]));
  const float cz = __fmul_rn(0.5f, __fadd_rn(lo_box[2], hi_box[2]));
  const size_t nn = static_cast<size_t>(n);
  double s[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) s[q] = 0.0;
  bool bad = false;
  // Two sources a pass, their loads issued together.
  const int stride = gridDim.x * kThreads;
  int i = blockIdx.x * kThreads + t;
  for (; i + stride < n; i += 2 * stride) {
    const int j = i + stride;
    const float x0 = pos[i], y0 = pos[nn + i], z0 = pos[2 * nn + i];
    const float x1 = pos[j], y1 = pos[nn + j], z1 = pos[2 * nn + j];
    const float m0 = mass[i], m1 = mass[j], mi0 = m_in[i], mi1 = m_in[j];
    add_source(s, bad, x0, y0, z0, m0, mi0, cx, cy, cz);
    add_source(s, bad, x1, y1, z1, m1, mi1, cx, cy, cz);
  }
  if (i < n) {
    add_source(s, bad, pos[i], pos[nn + i], pos[2 * nn + i], mass[i],
               m_in[i], cx, cy, cz);
  }
  // The block's sums: each warp by shuffles in one fixed order, then the
  // warps in order.
#pragma unroll
  for (int q = 0; q < kSums; ++q) {
    double v = s[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  if (t < kSums) {
    double v = red[0][t];
    for (int w = 1; w < kWarps; ++w) v = __dadd_rn(v, red[w][t]);
    part[static_cast<size_t>(blockIdx.x) * kSums + t] = v;
    __threadfence();
  }
  if (__syncthreads_or(bad) && t == 0) atomicOr(head + 1, 1u);
  if (t == 0) {
    __threadfence();
    last = atomicAdd(head, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last block: column q of the partials, warp q % kWarps; each lane
  // sums blocks lane, lane + 32, ... in order, then the lanes by shuffles.
  const int blocks = gridDim.x;
  for (int q = warp; q < kSums; q += kWarps) {
    double v = 0.0;
    for (int b = lane; b < blocks; b += 32) {
      v = __dadd_rn(v, __ldcg(part + static_cast<size_t>(b) * kSums + q));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    if (lane == 0) tot[q] = v;
  }
  __syncthreads();
  if (t < kGroups) {
    const bool nonfinite = __ldcg(head + 1) != 0u;
    const double M = tot[4 * t];
    const double den = fmax(M, 1e-30);
    float* row = table + 4 * t;
    row[0] = nonfinite ? __int_as_float(0x7fc00000) : __double2float_rn(M);
    for (int a = 1; a < 4; ++a) {
      row[a] = nonfinite ? __int_as_float(0x7fc00000)
                         : __double2float_rn(__ddiv_rn(tot[4 * t + a], den));
    }
  }
}

// pm._monopole of one table row at one target: (m d) ((u u) u), d = com -
// p, u = rsqrt(((d0 d0 + d1 d1) + d2 d2) + eps^2).
__device__ __forceinline__ void monopole(const float* row, const float* p,
                                         float* out) {
  const float d0 = __fsub_rn(row[1], p[0]);
  const float d1 = __fsub_rn(row[2], p[1]);
  const float d2 = __fsub_rn(row[3], p[2]);
  const float r2 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                __fmul_rn(d2, d2)),
      kEps2);
  const float u = rsqrtf(r2);
  const float u3 = __fmul_rn(__fmul_rn(u, u), u);
  out[0] = __fmul_rn(__fmul_rn(row[0], d0), u3);
  out[1] = __fmul_rn(__fmul_rn(row[0], d1), u3);
  out[2] = __fmul_rn(__fmul_rn(row[0], d2), u3);
}

__global__ void __launch_bounds__(kThreads)
far_field_monopoles_kernel(const float* __restrict__ tgt,
                           const float* __restrict__ in_tgt,
                           const float* __restrict__ acc,
                           const float* __restrict__ table, int n,
                           float* __restrict__ out) {
  __shared__ float tab[kSums];
  if (threadIdx.x < kSums) tab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t nn = static_cast<size_t>(n);
  const float p[3] = {tgt[i], tgt[nn + i], tgt[2 * nn + i]};
  float a[3] = {acc[i], acc[nn + i], acc[2 * nn + i]};
  float m[3];
  if (!(in_tgt[i] > 0.f)) monopole(tab, p, a);
#pragma unroll
  for (int k = 1; k < kGroups; ++k) {
    monopole(tab + 4 * k, p, m);
    a[0] = __fadd_rn(a[0], m[0]);
    a[1] = __fadd_rn(a[1], m[1]);
    a[2] = __fadd_rn(a[2], m[2]);
  }
  out[i] = a[0];
  out[nn + i] = a[1];
  out[2 * nn + i] = a[2];
}

}  // namespace

// The doubles of nbt_far_field_moments' scratch: the wrapper sizes it.
extern "C" int nbt_far_field_scratch() {
  return kHeader + kMaxBlocks * kSums;
}

// pos (3, n), mass (n,), m_in (n,) f32; lo_box, hi_box (3,) f32 on the
// device; scratch: nbt_far_field_scratch() doubles; table: (9, 4) f32.  All
// contiguous; n >= 0.  Zeroes the scratch's header and launches the moments
// kernel on `stream` without synchronising; returns the first error
// (cudaGetLastError() after the launch), else cudaSuccess.
extern "C" int nbt_far_field_moments(const float* pos, const float* mass,
                                     const float* m_in, int n,
                                     const float* lo_box, const float* hi_box,
                                     double* scratch, float* table,
                                     void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, kHeader * sizeof(double), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  far_field_moments_kernel<<<moment_blocks(n), kThreads, 0, st>>>(
      pos, mass, m_in, n, lo_box, hi_box, scratch, table);
  return static_cast<int>(cudaGetLastError());
}

// tgt (3, n), in_tgt (n,), acc (3, n), table (9, 4), out (3, n) f32, all
// contiguous on the device; n >= 0.  Launches the target kernel on
// `stream` without synchronising; returns cudaGetLastError() after it.
extern "C" int nbt_far_field_monopoles(const float* tgt, const float* in_tgt,
                                       const float* acc, const float* table,
                                       int n, float* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  far_field_monopoles_kernel<<<grid, kThreads, 0, st>>>(tgt, in_tgt, acc,
                                                        table, n, out);
  return static_cast<int>(cudaGetLastError());
}

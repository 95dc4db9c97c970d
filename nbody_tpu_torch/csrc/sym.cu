// Kernel B: the pair-symmetric self-sweep, fp32, mass-folded.
//
// Replaces nbody_tpu/ops/pallas_sym.py::_sym_kernel (fold_mass=True).  The
// force is antisymmetric, so each unordered B x B tile pair (it <= jt) is
// computed once with the mass-folded weight
//
//   w = (G m_i)(G m_j) / (|d|^2 + eps^2)^{3/2},   d = r_j - r_i,
//
// the i side adding sum_j w d and the j side subtracting sum_i w d.  A
// diagonal tile holds both orderings of its pairs, so it takes a one-sided
// sum; the diagonal itself is never masked (d = 0 gives exactly 0).  The
// epilogue divides, a = S / (G m), and zero-mass padding gets exactly 0.
//
// What differs from the TPU.  The TPU grid runs in order, so the Pallas
// kernel carries the j-side reaction in one VMEM accumulator across grid
// steps.  On Hopper the CTAs run in parallel and in no order, so the
// reaction needs accumulation across CTAs.  This kernel keeps it
// deterministic with partials: the CTA of tile pair (it, jt) writes its
// i-side sum to P[it][jt] and its j-side sum to P[jt][it], each (3, B), and
// a second small kernel adds P[t][0..T-1] in a fixed order and divides.
// The scratch is 12 N^2 / B bytes (25 MB at N=16384, B=128); the wrapper
// allocates it and the registry's `auto` bounds it.
//
// Inside a CTA.  Thread t owns target i = it*B + t and keeps its i-side sum
// in registers.  The j tile is staged in shared memory as float4 (x, y, z,
// G m).  The j-side sum is a reduction across the threads, done without a
// shuffle tree: each warp walks a 32-wide j subtile in 32 steps, lane l
// taking j = (l + k) mod 32 at step k, and the three j-side accumulators
// rotate one lane per step (__shfl_sync), so after 32 steps lane l holds
// sum_i over the warp's 32 targets for j = l.  That is 3 shuffles per 32
// pairs instead of 15 for a tree.  The warps' sums meet in shared memory
// and are added in warp order.
//
// Bound.  Compute-bound like Kernel A, at half the pair evaluations: about
// 26 flops, one IEEE sqrt, one IEEE divide and 3 shuffles per unordered
// pair.  Device memory traffic is the 12 N^2 / B bytes of partials written
// once and read once.
#include "common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__global__ void sym_pairs_kernel(const float* __restrict__ pos,
                                 const float* __restrict__ mass, int n,
                                 float* __restrict__ part) {
  const int B = blockDim.x, T = gridDim.x;
  const int it = blockIdx.y, jt = blockIdx.x;
  if (jt < it) return;  // each unordered tile pair once
  extern __shared__ float4 smem[];
  float4* sj = smem;                                  // the j tile
  float* red = reinterpret_cast<float*>(smem + B);    // [warp][3][B]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nwarps = B >> 5;
  const int i = it * B + t, j = jt * B + t;
  sj[t] = make_float4(pos[j], pos[n + j], pos[2 * n + j], mass[j] * nbt::kG);
  const float xi = pos[i], yi = pos[n + i], zi = pos[2 * n + i];
  const float gmi = mass[i] * nbt::kG;
  __syncthreads();

  float* pi = part + (size_t(it) * T + jt) * 3 * B;  // P[it][jt]
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (it == jt) {  // diagonal tile: one-sided sum over all of its pairs
    for (int k = 0; k < B; ++k) {
      const float4 p = sj[k];
      const float dx = p.x - xi, dy = p.y - yi, dz = p.z - zi;
      const float w = (gmi * p.w) * nbt::inv_cube(dx, dy, dz);
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
    }
    pi[t] = ax;
    pi[B + t] = ay;
    pi[2 * B + t] = az;
    return;
  }

  for (int s = 0; s < nwarps; ++s) {  // 32-wide j subtiles
    const float4* sub = sj + s * 32;
    float bx = 0.f, by = 0.f, bz = 0.f;  // j side of j = s*32 + (lane+k)%32
    for (int k = 0; k < 32; ++k) {
      const float4 p = sub[(lane + k) & 31];
      const float dx = p.x - xi, dy = p.y - yi, dz = p.z - zi;
      const float w = (gmi * p.w) * nbt::inv_cube(dx, dy, dz);
      const float px = w * dx, py = w * dy, pz = w * dz;
      ax += px;
      ay += py;
      az += pz;
      bx -= px;
      by -= py;
      bz -= pz;
      // Hand each j-side sum to the lane that takes its j at step k+1.
      const int from = (lane + 1) & 31;
      bx = __shfl_sync(kFullMask, bx, from);
      by = __shfl_sync(kFullMask, by, from);
      bz = __shfl_sync(kFullMask, bz, from);
    }
    red[(warp * 3 + 0) * B + s * 32 + lane] = bx;
    red[(warp * 3 + 1) * B + s * 32 + lane] = by;
    red[(warp * 3 + 2) * B + s * 32 + lane] = bz;
  }
  __syncthreads();

  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int w = 0; w < nwarps; ++w) {  // fixed order: deterministic
    sx += red[(w * 3 + 0) * B + t];
    sy += red[(w * 3 + 1) * B + t];
    sz += red[(w * 3 + 2) * B + t];
  }
  pi[t] = ax;
  pi[B + t] = ay;
  pi[2 * B + t] = az;
  float* pj = part + (size_t(jt) * T + it) * 3 * B;  // P[jt][it]
  pj[t] = sx;
  pj[B + t] = sy;
  pj[2 * B + t] = sz;
}

// a = (sum_u P[t][u]) / (G m), u in order; zero mass gives exactly 0.
__global__ void sym_reduce_kernel(const float* __restrict__ part,
                                  const float* __restrict__ mass, int n, int B,
                                  float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int T = n / B, t = idx / B, l = idx - t * B;
  const float gm = mass[idx] * nbt::kG;
  const float* row = part + size_t(t) * T * 3 * B + l;
  for (int c = 0; c < 3; ++c) {
    float s = 0.f;
    for (int u = 0; u < T; ++u) s += row[(size_t(u) * 3 + c) * B];
    out[size_t(c) * n + idx] = gm > 0.f ? s / gm : 0.f;
  }
}

}  // namespace

// pos (3,n), mass (n,) -> out (3,n), fp32 and contiguous.  block: a
// multiple of 32, at most 256, dividing n.  partials: 3 * n * (n / block)
// floats of scratch.  The wrapper checks all of it.  Launches both kernels
// on `stream` without synchronising and returns cudaGetLastError() after
// each launch.
extern "C" int nbt_sym_accel(const float* pos, const float* mass, int n,
                             int block, float* partials, float* out,
                             void* stream) {
  const int T = n / block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = block * sizeof(float4) + (block / 32) * 3 * block * sizeof(float);
  sym_pairs_kernel<<<dim3(T, T), block, smem, s>>>(pos, mass, n, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sym_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(partials, mass, n, block, out);
  return static_cast<int>(cudaGetLastError());
}

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
//
// The tile-pair body and the ordered sum are the device functions
// nbt::sym_tile_pair and nbt::sym_reduce (common.cuh), which the fused rows
// block (fused.cu) runs too.
#include "common.cuh"

namespace {

__global__ void sym_pairs_kernel(const float* __restrict__ pos,
                                 const float* __restrict__ mass, int n,
                                 float* __restrict__ part) {
  const int B = blockDim.x, T = gridDim.x;
  const int it = blockIdx.y, jt = blockIdx.x;
  if (jt < it) return;  // each unordered tile pair once
  extern __shared__ float4 smem[];
  float4* sj = smem;                                // the j tile
  float* red = reinterpret_cast<float*>(smem + B);  // [warp][3][B]
  const int t = threadIdx.x;
  constexpr nbt::Loads kLoads = nbt::Loads::kFixed;
  sj[t] = nbt::load_body<kLoads>(pos, mass, n, jt * B + t);
  const float4 bi = nbt::load_body<kLoads>(pos, mass, n, it * B + t);
  __syncthreads();
  nbt::sym_tile_pair(sj, red, bi, it, jt, T, part);
}

// a = (sum_u P[t][u]) / (G m), u in order; zero mass gives exactly 0.
__global__ void sym_reduce_kernel(const float* __restrict__ part,
                                  const float* __restrict__ mass, int n, int B,
                                  float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float gm = mass[idx] * nbt::kG;
  const float3 a = nbt::sym_reduce<nbt::Loads::kFixed>(part, gm, idx, n / B, B);
  out[idx] = a.x;
  out[n + idx] = a.y;
  out[2 * n + idx] = a.z;
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

// The two-sided sweep: targets x sources, each pair once, fp32, mass-folded.
//
// Replaces nbody_tpu/ops/pallas_sym.py::_two_sided_kernel, the building
// block of the pair-symmetric half ring (parallel/decompose.py, comm
// "ring_sym"): a block pair of two shards is evaluated by one of them, and
// the reaction rides the ring home.  Each target x source pair forms
//
//   w = (G m_t)(G m_s) / (|d|^2 + eps^2)^{3/2},   d = r_s - r_t,
//
// once; the target side adds sum_s w d, the source side subtracts
// sum_t w d, and each side is divided by its own G m, zero mass giving
// exactly 0.  Nt and Ns must be multiples of the block B; the wrapper checks
// it, as the JAX package does (no ragged edge in the kernel).
//
// What differs from the TPU.  The Pallas kernel runs its target tiles in
// order and carries the source side in one VMEM accumulator.  Here the CTAs
// run in no order, so both sides go to deterministic per-tile-pair partials,
// as Kernel B's do (sym.cu): the CTA of tile pair (it, jt) writes its
// target-side sum to P_t[it][jt] and its source-side sum to P_s[jt][it],
// each (3, B), and a second kernel adds P_t[it][.] and P_s[jt][.] in a fixed
// order and divides.  The scratch is 12 Nt Ns / B bytes a side (1.5 MB a
// side at Nt = Ns = 4096, B = 128).  The CTA body is Kernel B's off-diagonal
// tile pair (nbt::sym_tile_cross) with the i tile taken from the targets and
// the j tile from the sources, and the ordered sum is nbt::sym_reduce, so
// two launches on one input agree bit for bit.
//
// Bound.  Compute-bound like Kernel B: about 26 flops, one IEEE sqrt, one
// IEEE divide and 3 shuffles per pair, Nt Ns pairs; device memory traffic
// is the partials written once and read once.
#include "common.cuh"

namespace {

constexpr nbt::Loads kLoads = nbt::Loads::kFixed;

__global__ void two_sided_kernel(const float* __restrict__ pos_t,
                                 const float* __restrict__ mass_t, int nt,
                                 const float* __restrict__ pos_s,
                                 const float* __restrict__ mass_s, int ns,
                                 float* __restrict__ part_t,
                                 float* __restrict__ part_s) {
  const int B = blockDim.x, Tt = gridDim.y, Ts = gridDim.x;
  const int it = blockIdx.y, jt = blockIdx.x, t = threadIdx.x;
  extern __shared__ float4 smem[];
  float4* sj = smem;                                // the source tile
  float* red = reinterpret_cast<float*>(smem + B);  // [warp][3][B]
  sj[t] = nbt::load_body<kLoads>(pos_s, mass_s, ns, jt * B + t);
  const float4 bi = nbt::load_body<kLoads>(pos_t, mass_t, nt, it * B + t);
  __syncthreads();
  nbt::sym_tile_cross(sj, red, bi, part_t + (size_t(it) * Ts + jt) * 3 * B,
                      part_s + (size_t(jt) * Tt + it) * 3 * B);
}

// Targets first, then sources: a = (sum_u P[t][u]) / (G m), u in order.
__global__ void two_sided_reduce_kernel(
    const float* __restrict__ part_t, const float* __restrict__ mass_t, int nt,
    const float* __restrict__ part_s, const float* __restrict__ mass_s, int ns,
    int B, float* __restrict__ out_t, float* __restrict__ out_s) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const float* part = part_t;
  const float* mass = mass_t;
  float* out = out_t;
  int n = nt, cols = ns / B;
  if (idx >= nt) {
    idx -= nt;
    part = part_s;
    mass = mass_s;
    out = out_s;
    n = ns;
    cols = nt / B;
  }
  if (idx >= n) return;
  const float gm = mass[idx] * nbt::kG;
  const float3 a = nbt::sym_reduce<kLoads>(part, gm, idx, cols, B);
  out[idx] = a.x;
  out[n + idx] = a.y;
  out[2 * n + idx] = a.z;
}

}  // namespace

// pos_t (3,nt), mass_t (nt,), pos_s (3,ns), mass_s (ns,) -> out_t (3,nt),
// out_s (3,ns), fp32 and contiguous.  block: a multiple of 32, at most 256,
// dividing nt and ns.  part_t: 3 * nt * (ns / block) floats of scratch,
// part_s: 3 * ns * (nt / block).  The wrapper checks all of it.  Launches
// both kernels on `stream` without synchronising and returns
// cudaGetLastError() after each launch.
extern "C" int nbt_two_sided(const float* pos_t, const float* mass_t, int nt,
                             const float* pos_s, const float* mass_s, int ns,
                             int block, float* part_t, float* part_s,
                             float* out_t, float* out_s, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      block * sizeof(float4) + (block / 32) * 3 * block * sizeof(float);
  two_sided_kernel<<<dim3(ns / block, nt / block), block, smem, s>>>(
      pos_t, mass_t, nt, pos_s, mass_s, ns, part_t, part_s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  two_sided_reduce_kernel<<<(nt + ns + 255) / 256, 256, 0, s>>>(
      part_t, mass_t, nt, part_s, mass_s, ns, block, out_t, out_s);
  return static_cast<int>(cudaGetLastError());
}

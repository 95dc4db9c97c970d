// Kernel A: the tiled targets x sources force sweep, fp32 arithmetic, with
// fp32 or bf16-rounded pair deltas.
//
// Replaces nbody_tpu/ops/pallas_kernel.py::_nbody_kernel, which streams
// (TILE_I, TILE_J) pair blocks through VMEM with (N,8)/(8,N) double
// packing.  That packing is a TPU lane artifact and is not copied: the
// kernel reads the (3,N) coordinate rows and the (N,) masses directly.
//
//   a_t = sum_s G m_s (r_s - r_t) / (|r_s - r_t|^2 + eps^2)^{3/2}
//
// Design.  A CTA of 256 threads owns tile_i targets (one thread per target,
// x) and splits each source tile among 256/tile_i thread rows (y), so small
// N still puts enough CTAs on the 132 SMs.  Source tiles of (x, y, z, G m)
// are staged once per CTA through shared memory as float4 and read by
// broadcast (every lane of a warp reads the same source).  Each thread
// accumulates in fp32 registers; the thread rows' partial sums are added
// in a fixed order at the end, so the result is deterministic.  The kernel
// masks the ragged edges itself: targets past Nt compute and never store,
// and sources past Ns are staged as zero mass, which adds exactly nothing.
// So unpadded Nt and Ns are fine.
//
// Bound.  At N=16384 the sweep is compute-bound: each pair costs about 20
// flops plus one IEEE sqrt and one IEEE divide, against 16 bytes of shared
// memory per source that every thread of the CTA reuses.  Device memory
// traffic is (Nt/tile_i) * Ns * 16 bytes, under 70 MB at N=16384, and the
// source rows sit in the 50 MB L2.  What remains is the instruction rate
// of the pair loop, which is unrolled by 8 to overlap the sqrt and divide
// latencies of neighbouring pairs.
//
// The source loop and the ordered row sum are the device functions
// nbt::tiled_source_loop and nbt::tiled_row_sum (common.cuh), which the
// fused columns block (fused.cu) runs too.  The kernel is a template on the
// pair deltas' precision (nbt::Dist): f32, or the JAX package's bf16
// distance mode (`dist_dtype="bfloat16"`).
#include "common.cuh"

namespace {

template <nbt::Dist D>
__global__ void __launch_bounds__(nbt::kTiledThreads)
tiled_accel_kernel(const float* __restrict__ pos_t, int nt,
                   const float* __restrict__ pos_s,
                   const float* __restrict__ mass_s, int ns,
                   float* __restrict__ out, int tile_j) {
  extern __shared__ float4 src[];  // tile_j sources: x, y, z, G*m
  __shared__ float part[3 * nbt::kTiledThreads];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int ic = i < nt ? i : nt - 1;  // ragged edge: compute, never store
  const float3 acc = nbt::tiled_source_loop<nbt::Loads::kFixed, D>(
      src, pos_s, mass_s, ns, tile_j, pos_t[ic], pos_t[nt + ic],
      pos_t[2 * nt + ic]);
  const float3 a = nbt::tiled_row_sum(part, acc);
  if (threadIdx.y == 0 && i < nt) {
    out[i] = a.x;
    out[nt + i] = a.y;
    out[2 * nt + i] = a.z;
  }
}

}  // namespace

// pos_t (3,nt), pos_s (3,ns), mass_s (ns,) -> out (3,nt), all fp32 and
// contiguous.  tile_i targets per CTA: a multiple of 32 that divides 256.
// tile_j sources per shared-memory tile: a multiple of 256/tile_i, at most
// 3072 (48 KB).  The wrapper checks both.  bf16: the bf16 distance mode.
// Launches on `stream` without synchronising and returns cudaGetLastError().
extern "C" int nbt_tiled_accel(const float* pos_t, int nt, const float* pos_s,
                               const float* mass_s, int ns, float* out,
                               int tile_i, int tile_j, int bf16, void* stream) {
  const dim3 block(tile_i, nbt::kTiledThreads / tile_i);
  const dim3 grid((nt + tile_i - 1) / tile_i);
  const size_t smem = size_t(tile_j) * sizeof(float4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    tiled_accel_kernel<nbt::Dist::kBF16><<<grid, block, smem, s>>>(
        pos_t, nt, pos_s, mass_s, ns, out, tile_j);
  } else {
    tiled_accel_kernel<nbt::Dist::kF32><<<grid, block, smem, s>>>(
        pos_t, nt, pos_s, mass_s, ns, out, tile_j);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

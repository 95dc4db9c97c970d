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
// Design.  A CTA of 256 threads owns tile_i targets and splits each source
// tile among its thread rows, so small N still puts enough CTAs on the 132
// SMs.  Each thread owns R = nbt::tiled_targets(tile_i, tile_j) targets
// (nbt::TiledThread), so a CTA has 256 R / tile_i rows; R is capped by
// nbt::kMaxTargets = 2, which the measurements favour over the ring and the
// fused block (Kernel A alone is within 4% at R = 1; the loop is bound by
// issue, not by its shared-memory reads; PERF.md, scripts/sweep_shapes.py
// --targets), and is 1 at tile_i 32.  Source tiles of (x, y, z,
// G m) are staged once per CTA through shared memory as float4 and read by
// broadcast: a warp's 32 lanes are 32 targets of one row and read one
// source at a time, which feeds R pairs each.  Per pair: three deltas,
// |d|^2 + eps^2 (FMAs), the inverse cube as rsqrt.approx plus one Newton
// step (nbt::rsqrt_cube: one SFU op, no IEEE divide or square root, no
// branch), the weight and three FMAs into fp32 sums.  The rows' partial
// sums are added in a fixed order at the end, so the result is
// deterministic.  The kernel masks the ragged edges itself: targets past
// Nt compute and never store, and sources past Ns are staged as zero mass,
// which adds exactly nothing.  So unpadded Nt and Ns are fine.
//
// Bound.  At N=16384 the sweep is compute-bound: 17 FP32 operations, one
// SFU op and one shared-memory read a pair, against 16 bytes of shared
// memory per source that every thread of the CTA reuses.  Device memory
// traffic is (Nt/tile_i) * Ns * 16 bytes, under 70 MB at N=16384, and the
// source rows sit in the 50 MB L2.  What remains is the rate at which a
// warp scheduler issues (one instruction a clock, four schedulers an SM):
// about 19 a pair, so at most about 6.7 pairs an SM a clock.  The function's
// least work (chip_smoke.py's bound) counts N^2/2 pairs, as Kernel B does.
//
// The source loop and the ordered row sum are the device functions
// nbt::tiled_source_loop and nbt::tiled_row_sum (common.cuh), which the
// fused columns block (fused.cu) and the ring (ring.cu) run too.  The
// kernel is a template on R and on the pair deltas' precision (nbt::Dist):
// f32, or the JAX package's bf16 distance mode (`dist_dtype="bfloat16"`).
#include "common.cuh"

namespace {

template <int R, nbt::Dist D>
__global__ void __launch_bounds__(nbt::kTiledThreads)
tiled_accel_kernel(const float* __restrict__ pos_t, int nt,
                   const float* __restrict__ pos_s,
                   const float* __restrict__ mass_s, int ns,
                   float* __restrict__ out, int tile_i, int tile_j) {
  extern __shared__ float4 src[];  // tile_j sources: x, y, z, G*m
  __shared__ float part[3 * nbt::kTiledThreads * R];
  const nbt::TiledThread<R> th(tile_i);
  const int i0 = blockIdx.x * tile_i;
  float3 t[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(i0 + th.target(r), nt - 1);  // ragged edge: never stored
    t[r] = make_float3(pos_t[i], pos_t[nt + i], pos_t[2 * nt + i]);
  }
  nbt::tiled_source_loop<nbt::Loads::kFixed, R, D>(src, pos_s, mass_s, ns,
                                                    tile_j, th, t, acc);
  const float3 a = nbt::tiled_row_sum(part, th, acc);
  const int i = i0 + threadIdx.x;
  if (int(threadIdx.x) < tile_i && i < nt) {
    out[i] = a.x;
    out[nt + i] = a.y;
    out[2 * nt + i] = a.z;
  }
}

template <nbt::Dist D>
void launch(const float* pos_t, int nt, const float* pos_s,
            const float* mass_s, int ns, float* out, int tile_i, int tile_j,
            cudaStream_t s) {
  const dim3 grid((nt + tile_i - 1) / tile_i);
  const size_t smem = size_t(tile_j) * sizeof(float4);
  nbt::with_targets(tile_i, tile_j, [&](auto r) {
    tiled_accel_kernel<decltype(r)::value, D>
        <<<grid, nbt::kTiledThreads, smem, s>>>(pos_t, nt, pos_s, mass_s, ns,
                                                out, tile_i, tile_j);
  });
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<nbt::Dist::kBF16>(pos_t, nt, pos_s, mass_s, ns, out, tile_i,
                             tile_j, s);
  } else {
    launch<nbt::Dist::kF32>(pos_t, nt, pos_s, mass_s, ns, out, tile_i, tile_j,
                            s);
  }
  return static_cast<int>(cudaGetLastError());
}

// R = nbt::tiled_targets(tile_i, tile_j): the targets a thread of Kernel A,
// the fused columns block and the ring owns at these tiles.
extern "C" int nbt_tiled_targets(int tile_i, int tile_j) {
  return nbt::tiled_targets(tile_i, tile_j);
}

extern "C" const char* nbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

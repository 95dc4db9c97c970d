// The |r|^2-expansion force sweep (`--kernel pallas_mxu`), fp32, SIMT.
//
// Replaces nbody_tpu/ops/pallas_mxu.py::_kernel, which rewrites the pair
// interaction as two matrix products for the TPU's MXU:
//
//   d2_ij = max(A_j . B_i, eps^2),   A_j = [x, y, z, |r|^2, 1, G m, 0, 0],
//                                    B_i = [-2x, -2y, -2z, 1, |r|^2 + eps^2,
//                                           0, 0, 0]
//   w_ij  = G m_j d2_ij^{-3/2}
//   m_i   = sum_j w_ij [x_j, y_j, z_j, 1]
//   a_i   = m_i[0:3] - r_i m_i[3]
//
// so the self pair cancels exactly (w_ii r_i - r_i w_ii = 0).  The expansion
// cancels as |r| grows, hence the clamp at eps^2; a zero-mass source has
// w = 0 and adds exactly nothing.
//
// Design.  As Kernel A (tiled.cu): a CTA of 256 threads owns tile_i targets
// (x) and splits each source tile among 256/tile_i thread rows (y).  The CTA
// stages the source tile's (x, y, z, |r|^2) as float4 and G m as float in
// shared memory; each thread keeps its target's (-2x, -2y, -2z,
// |r|^2 + eps^2) in registers.  Per pair: d2 as the dot product over the
// five nonzero augmented terms in JAX's k order, each product and sum
// rounded on its own (__fmul_rn/__fadd_rn, no FMA contraction), so d2 and w
// equal the plain PyTorch version's bit for bit; the clamp; inv =
// 1.0f / sqrtf(d2) (IEEE, as common.cuh); w = G m_j inv^3; four FMAs into
// m.  The epilogue's difference cancels (|m| is many times |a|), so the
// rounding of one long fp32 running sum over a thread row's thousands of
// sources would show in a.  Each thread therefore sums each chunk of 64 of
// its sources into a fresh partial and adds the partial to its running m,
// which keeps every fp32 sum short whatever the tiles.  The thread rows' m
// are added in a fixed order (deterministic) and the epilogue writes
// a = m[0:3] - r m[3].  Ragged edges are masked as in Kernel A: sources
// past Ns are staged as zero mass and targets past Nt are not written, so
// Nt and Ns need no padding.
//
// Why SIMT and not the tensor cores, in this port.  The first product has
// K = 8, one TF32 mma k-step, and the second, transposed, has N = 8; but
// TF32 keeps about three decimal digits, which cannot hold the |r|^2
// expansion to fp32.  A tensor-core version needs a 3xTF32 hi/lo split of
// both products: a later redesign (ROADMAP.md).
//
// Bound.  The function's least work puts both K=8 products on the tensor
// cores with a 3xTF32 split, 3 x (16 + 16) = 96 flops a pair at 495 TF32
// TFLOP/s, and about 6 fp32 operations a pair (clamp, sqrt, divide, two for
// the cube, one for G m) at 67 TFLOP/s: at N=16384, N^2 ordered pairs, the
// tensor cores set it at about 0.052 ms (chip_smoke.py computes it).  This
// SIMT kernel does about 20 fp32 operations and an IEEE sqrt and divide a
// pair on the FP32 pipes, so it sits far above that bound.
#include "common.cuh"

namespace {

constexpr int kThreads = nbt::kTiledThreads;
constexpr int kChunk = 64;  // sources a thread sums before adding to its m

__global__ void __launch_bounds__(kThreads)
mxu_accel_kernel(const float* __restrict__ pos_t, int nt,
                 const float* __restrict__ pos_s,
                 const float* __restrict__ mass_s, int ns,
                 float* __restrict__ out, int tile_j) {
  extern __shared__ float4 src[];  // tile_j of (x, y, z, |r|^2), then G m
  float* sgm = reinterpret_cast<float*>(src + tile_j);
  __shared__ float part[4 * kThreads];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx, per = tile_j / blockDim.y;
  const int i = blockIdx.x * blockDim.x + tx;
  const int ic = i < nt ? i : nt - 1;  // ragged edge: compute, never store
  const float xi = pos_t[ic], yi = pos_t[nt + ic], zi = pos_t[2 * nt + ic];
  // B_i, as JAX builds it: (x^2 + y^2) + z^2, then + eps^2.
  const float bx = -2.f * xi, by = -2.f * yi, bz = -2.f * zi;
  const float b4 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(xi, xi), __fmul_rn(yi, yi)),
                __fmul_rn(zi, zi)),
      nbt::kSoftening2);
  float mx = 0.f, my = 0.f, mz = 0.f, mw = 0.f;
  for (int j0 = 0; j0 < ns; j0 += tile_j) {
    __syncthreads();  // every thread is done with the previous tile
    for (int k = tid; k < tile_j; k += kThreads) {
      const int j = j0 + k;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      float g = 0.f;
      if (j < ns) {
        a.x = pos_s[j];
        a.y = pos_s[ns + j];
        a.z = pos_s[2 * ns + j];
        a.w = __fadd_rn(__fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)),
                        __fmul_rn(a.z, a.z));
        g = mass_s[j] * nbt::kG;
      }
      src[k] = a;
      sgm[k] = g;
    }
    __syncthreads();
    const float4* mine = src + ty * per;
    const float* mine_gm = sgm + ty * per;
    for (int k0 = 0; k0 < per; k0 += kChunk) {
      const int k1 = min(per, k0 + kChunk);
      float lx = 0.f, ly = 0.f, lz = 0.f, lw = 0.f;  // this chunk's sums
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        const float4 p = mine[k];
        float d2 = __fmul_rn(p.x, bx);
        d2 = __fadd_rn(d2, __fmul_rn(p.y, by));
        d2 = __fadd_rn(d2, __fmul_rn(p.z, bz));
        d2 = __fadd_rn(d2, p.w);
        d2 = __fadd_rn(d2, b4);
        d2 = fmaxf(d2, nbt::kSoftening2);  // the cancellation floor
        const float inv = 1.0f / sqrtf(d2);
        const float w = mine_gm[k] * (inv * inv * inv);
        lx = fmaf(w, p.x, lx);
        ly = fmaf(w, p.y, ly);
        lz = fmaf(w, p.z, lz);
        lw += w;
      }
      mx += lx;
      my += ly;
      mz += lz;
      mw += lw;
    }
  }
  // The thread rows' sums, added in a fixed order by row 0.
  part[tid] = mx;
  part[kThreads + tid] = my;
  part[2 * kThreads + tid] = mz;
  part[3 * kThreads + tid] = mw;
  __syncthreads();
  if (ty != 0 || i >= nt) return;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < int(blockDim.y); ++r) {
    for (int c = 0; c < 4; ++c) s[c] += part[c * kThreads + r * blockDim.x + tx];
  }
  out[i] = __fsub_rn(s[0], __fmul_rn(xi, s[3]));
  out[nt + i] = __fsub_rn(s[1], __fmul_rn(yi, s[3]));
  out[2 * nt + i] = __fsub_rn(s[2], __fmul_rn(zi, s[3]));
}

}  // namespace

// pos_t (3,nt), pos_s (3,ns), mass_s (ns,) -> out (3,nt), all fp32 and
// contiguous.  tile_i targets per CTA: a multiple of 32 that divides 256.
// tile_j sources per shared-memory tile: a multiple of 256/tile_i, at most
// 2048 (40 KB).  The wrapper checks both.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int nbt_mxu_accel(const float* pos_t, int nt, const float* pos_s,
                             const float* mass_s, int ns, float* out,
                             int tile_i, int tile_j, void* stream) {
  const dim3 block(tile_i, kThreads / tile_i);
  const dim3 grid((nt + tile_i - 1) / tile_i);
  const size_t smem = size_t(tile_j) * (sizeof(float4) + sizeof(float));
  mxu_accel_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      pos_t, nt, pos_s, mass_s, ns, out, tile_j);
  return static_cast<int>(cudaGetLastError());
}

// The force VJP: the backward of the all-pairs self-acceleration, fp32.
//
// Replaces nbody_tpu/ops/grad.py::_vjp_kernel.  With r = p_j - p_k,
// u = |r|^2 + eps^2, s = u^{-3/2}, q = 3 u^{-5/2} and the output cotangent
// g, each target k sums over every source j
//
//   A_k = sum_j [ s g_j - q (r . g_j) r ]
//   B_k = sum_j G m_j [ s g_k - q (r . g_k) r ]
//   S_k = sum_j (r . g_j) s
//
// and the epilogue writes d_pos_k = G m_k A_k - B_k and d_mass_k = -G S_k.
// The j == k term is left unmasked, as in the JAX kernel: it adds the same
// G m_k s0 g_k to both position terms, which cancel in exact arithmetic.
//
// Design: Kernel A's sibling (tiled.cu).  A CTA of 256 threads owns tile_i
// targets (one thread per target, x) and splits each source tile among
// 256/tile_i thread rows (y).  Source tiles of (x, y, z, G m) and
// (gx, gy, gz, 0) are staged once per CTA through shared memory as two
// float4 and read by broadcast.  Each thread keeps its seven sums in fp32
// registers; the thread rows' partial sums are added in a fixed order, so
// the result is deterministic.  The JAX kernel carries its sums across the
// sequential j grid axis in its output block; here that axis is the loop
// over source tiles inside one CTA, so nothing is reduced across CTAs.
// The (N,8)/(8,N) packing of the JAX kernel is a TPU lane artifact: the
// kernel reads the (3,N) rows directly.  Ragged edges are masked in the
// kernel: targets past N compute and never store, and sources past N are
// staged as zero mass and zero cotangent, which add exact zeros to A, B and
// S.  So any N runs without padding, and zero-mass padding with a zero
// cotangent leaves the real targets' results bit for bit as they were.
//
// Bound.  Like Kernel A the sweep is compute-bound at N=16384: each pair
// costs one IEEE sqrt, one IEEE divide and about 45 flops, against 32
// bytes of shared memory per source that every thread of the CTA reuses.
// Device memory traffic is (N/tile_i) * N * 32 bytes, and the rows sit in
// the 50 MB L2.
#include "common.cuh"

namespace {

constexpr int kSums = 7;  // A_xyz, B_xyz, S

__global__ void __launch_bounds__(nbt::kTiledThreads)
force_vjp_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
                 const float* __restrict__ g, int n, float* __restrict__ d_pos,
                 float* __restrict__ d_mass, int tile_j) {
  extern __shared__ float4 src[];  // tile_j bodies, then tile_j cotangents
  __shared__ float part[kSums * nbt::kTiledThreads];
  const int ti = blockDim.x, tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * ti + tx;
  const int k = blockIdx.x * ti + tx;
  const int kc = k < n ? k : n - 1;  // ragged edge: compute, never store
  const float xk = pos[kc], yk = pos[n + kc], zk = pos[2 * n + kc];
  const float gkx = g[kc], gky = g[n + kc], gkz = g[2 * n + kc];
  float4* body = src;
  float4* cot = src + tile_j;
  const int per = tile_j / blockDim.y;
  const float4* my_body = body + ty * per;
  const float4* my_cot = cot + ty * per;

  float ax = 0.f, ay = 0.f, az = 0.f;
  float bx = 0.f, by = 0.f, bz = 0.f;
  float sg = 0.f;
  for (int j0 = 0; j0 < n; j0 += tile_j) {
    __syncthreads();  // every thread is done with the previous tile
    for (int t = tid; t < tile_j; t += nbt::kTiledThreads) {
      const int j = j0 + t;
      if (j < n) {
        body[t] = nbt::load_body<nbt::Loads::kFixed>(pos, mass, n, j);
        cot[t] = make_float4(g[j], g[n + j], g[2 * n + j], 0.f);
      } else {
        body[t] = make_float4(0.f, 0.f, 0.f, 0.f);
        cot[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < per; ++t) {
      const float4 p = my_body[t];
      const float4 c = my_cot[t];
      const float rx = p.x - xk, ry = p.y - yk, rz = p.z - zk;
      const float u = rx * rx + ry * ry + rz * rz + nbt::kSoftening2;
      const float inv = 1.0f / sqrtf(u);
      const float s = inv * inv * inv;
      const float q = 3.0f * s * (inv * inv);
      const float rgj = rx * c.x + ry * c.y + rz * c.z;
      const float rgk = rx * gkx + ry * gky + rz * gkz;
      const float cj = q * rgj, ck = q * rgk;
      ax += s * c.x - cj * rx;
      ay += s * c.y - cj * ry;
      az += s * c.z - cj * rz;
      bx += p.w * (s * gkx - ck * rx);
      by += p.w * (s * gky - ck * ry);
      bz += p.w * (s * gkz - ck * rz);
      sg += rgj * s;
    }
  }

  const float mine[kSums] = {ax, ay, az, bx, by, bz, sg};
#pragma unroll
  for (int v = 0; v < kSums; ++v) part[v * nbt::kTiledThreads + tid] = mine[v];
  __syncthreads();
  if (ty != 0 || k >= n) return;
  float tot[kSums];
#pragma unroll
  for (int v = 0; v < kSums; ++v) {
    float x = 0.f;
    for (int r = 0; r < int(blockDim.y); ++r) {  // fixed order: deterministic
      x += part[v * nbt::kTiledThreads + r * ti + tx];
    }
    tot[v] = x;
  }
  const float gmk = mass[k] * nbt::kG;
  d_pos[k] = gmk * tot[0] - tot[3];
  d_pos[n + k] = gmk * tot[1] - tot[4];
  d_pos[2 * n + k] = gmk * tot[2] - tot[5];
  d_mass[k] = -nbt::kG * tot[6];
}

}  // namespace

// pos (3,n), mass (n,), g (3,n) -> d_pos (3,n), d_mass (n,), all fp32 and
// contiguous.  tile_i targets per CTA: a multiple of 32 that divides 256.
// tile_j sources per shared-memory tile: a multiple of 256/tile_i, at most
// 1024 (32 KB of staged sources beside 7 KB of row sums).  The wrapper
// checks both.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int nbt_force_vjp(const float* pos, const float* mass,
                             const float* g, int n, float* d_pos,
                             float* d_mass, int tile_i, int tile_j,
                             void* stream) {
  const dim3 block(tile_i, nbt::kTiledThreads / tile_i);
  const dim3 grid((n + tile_i - 1) / tile_i);
  const size_t smem = 2 * size_t(tile_j) * sizeof(float4);
  force_vjp_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, mass, g, n, d_pos, d_mass, tile_j);
  return static_cast<int>(cudaGetLastError());
}

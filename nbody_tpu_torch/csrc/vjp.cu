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
// Design: Kernel A's source loop (tiled.cu, nbt::tiled_source_sweep),
// applied to the backward.  A one-dimensional CTA of 256 threads owns
// tile_i targets; each thread owns R = nbt::tiled_targets(tile_i, tile_j)
// of them (nbt::TiledThread: R = 2 where tile_i is a multiple of 64), so a
// CTA has 256 R / tile_i thread rows, and each row sweeps its share of
// every source tile.  Source tiles of (x, y, z, G m) and (gx, gy, gz, 0)
// are staged once per CTA through shared memory as two float4; a warp's 32
// lanes are 32 targets of one row and read one source at a time (a
// broadcast), which feeds R pairs, so the two shared-memory reads of a pair
// are 2 / R.  The inverse powers come from one rsqrt.approx and one Newton
// step (nbt::rsqrt_newton): inv, s = inv^3 and q = 3 s inv^2, with no IEEE
// square root or divide and no branch.  Each thread keeps its 7 R sums in
// fp32 registers; the rows' partial sums are added in row order, so the
// result is deterministic.  The JAX kernel carries its sums across the
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
// is about 45 fp32 operations of the function (chip_smoke.py's count, the
// square root and the divide one each), which the kernel issues as one SFU
// op and about 40 instructions, against 32 bytes of shared memory a source
// that every thread of the CTA reuses.  Device memory traffic is (N /
// tile_i) * N * 28 bytes, and the rows sit in the 50 MB L2.  tile_i 64 (R =
// 2) fills the 132 SMs from N = 8448 on; below, 32 (R = 1) gives twice the
// CTAs (ops/vjp_kernel.py).
#include "common.cuh"

namespace {

constexpr int kSums = 7;  // A_xyz, B_xyz, S

template <int R>
__global__ void __launch_bounds__(nbt::kTiledThreads)
force_vjp_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
                 const float* __restrict__ g, int n, float* __restrict__ d_pos,
                 float* __restrict__ d_mass, int tile_i, int tile_j) {
  extern __shared__ float4 src[];  // tile_j bodies, then tile_j cotangents
  __shared__ float part[kSums * nbt::kTiledThreads * R];
  const nbt::TiledThread<R> th(tile_i);
  const int i0 = blockIdx.x * tile_i;
  float xk[R], yk[R], zk[R], gkx[R], gky[R], gkz[R];
  float acc[R][kSums];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = min(i0 + th.target(r), n - 1);  // ragged edge: never stored
    xk[r] = pos[k];
    yk[r] = pos[n + k];
    zk[r] = pos[2 * n + k];
    gkx[r] = g[k];
    gky[r] = g[n + k];
    gkz[r] = g[2 * n + k];
#pragma unroll
    for (int v = 0; v < kSums; ++v) acc[r][v] = 0.f;
  }
  float4* body = src;
  float4* cot = src + tile_j;
  const int per = tile_j / th.rows;
  const float4* my_body = body + th.ty * per;
  const float4* my_cot = cot + th.ty * per;

  for (int j0 = 0; j0 < n; j0 += tile_j) {
    __syncthreads();  // every thread is done with the previous tile
    for (int t = threadIdx.x; t < tile_j; t += nbt::kTiledThreads) {
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
#pragma unroll (4 / R)
    for (int t = 0; t < per; ++t) {
      const float4 p = my_body[t];
      const float4 c = my_cot[t];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float rx = p.x - xk[r], ry = p.y - yk[r], rz = p.z - zk[r];
        const float u =
            fmaf(rz, rz, fmaf(ry, ry, fmaf(rx, rx, nbt::kSoftening2)));
        const float inv = nbt::rsqrt_newton(u);
        const float inv2 = inv * inv;
        const float s = inv2 * inv;
        const float q = (3.0f * s) * inv2;
        const float rgj = fmaf(rz, c.z, fmaf(ry, c.y, rx * c.x));
        const float rgk = fmaf(rz, gkz[r], fmaf(ry, gky[r], rx * gkx[r]));
        const float cj = q * rgj;
        const float ms = p.w * s, mck = p.w * (q * rgk);
        float* a = acc[r];
        a[0] = fmaf(-cj, rx, fmaf(s, c.x, a[0]));
        a[1] = fmaf(-cj, ry, fmaf(s, c.y, a[1]));
        a[2] = fmaf(-cj, rz, fmaf(s, c.z, a[2]));
        a[3] = fmaf(-mck, rx, fmaf(ms, gkx[r], a[3]));
        a[4] = fmaf(-mck, ry, fmaf(ms, gky[r], a[4]));
        a[5] = fmaf(-mck, rz, fmaf(ms, gkz[r], a[5]));
        a[6] = fmaf(rgj, s, a[6]);
      }
    }
  }

  // The rows' partial sums of every target, added in row order.
  const int plane = th.rows * tile_i;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = th.ty * tile_i + th.target(r);
#pragma unroll
    for (int v = 0; v < kSums; ++v) part[v * plane + c] = acc[r][v];
  }
  __syncthreads();
  const int i = threadIdx.x, k = i0 + i;
  if (i >= tile_i || k >= n) return;
  float tot[kSums];
#pragma unroll
  for (int v = 0; v < kSums; ++v) {
    float x = 0.f;
    for (int row = 0; row < th.rows; ++row) x += part[v * plane + row * tile_i + i];
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
// 1024 (32 KB of staged sources beside 14 KB of row sums).  The wrapper
// checks both.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int nbt_force_vjp(const float* pos, const float* mass,
                             const float* g, int n, float* d_pos,
                             float* d_mass, int tile_i, int tile_j,
                             void* stream) {
  const dim3 grid((n + tile_i - 1) / tile_i);
  const size_t smem = 2 * size_t(tile_j) * sizeof(float4);
  const auto st = static_cast<cudaStream_t>(stream);
  nbt::with_targets(tile_i, tile_j, [&](auto r) {
    force_vjp_kernel<decltype(r)::value>
        <<<grid, nbt::kTiledThreads, smem, st>>>(pos, mass, g, n, d_pos,
                                                 d_mass, tile_i, tile_j);
  });
  return static_cast<int>(cudaGetLastError());
}

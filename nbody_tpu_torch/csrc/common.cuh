// Shared pieces of the port's CUDA kernels: the reference's physics
// constants, the softened inverse cube of one pair distance, and the bodies
// of the two force sweeps.  The unfused kernels (sym.cu, tiled.cu) and the
// fused sample blocks (fused.cu) run the same device functions, so they
// share one copy of the pair arithmetic.
#pragma once

#include <cuda_runtime.h>

namespace nbt {

// ver0/GSimulation.cpp:114-116, as nbody_tpu/types.py.  Both literals round
// to the same fp32 values as jnp.float32 of the Python doubles.
constexpr float kSoftening2 = 1e-3f;
constexpr float kG = 6.67259e-11f;

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTiledThreads = 256;  // threads of a tiled-sweep CTA

// 1 / (|d|^2 + eps^2)^{3/2}.  1.0f / sqrtf is IEEE-rounded under nvcc's
// default -prec-div=true -prec-sqrt=true (no --use_fast_math); rsqrtf is
// approximate and is not used.
__device__ __forceinline__ float inv_cube(float dx, float dy, float dz) {
  const float d2 = dx * dx + dy * dy + dz * dz + kSoftening2;
  const float inv = 1.0f / sqrtf(d2);
  return inv * inv * inv;
}

// How a kernel loads positions and partials.  The unfused kernels read
// inputs that stay fixed while they run (`const __restrict__`, so the
// compiler may take the read-only path, which keeps Kernel A at 40
// registers).  The fused kernels rewrite them between grid barriers, so
// they load through L2 (ld.global.cg), never through the non-coherent
// read-only path, which could return a stale value after a barrier.
enum class Loads { kFixed, kRewritten };

template <Loads L>
__device__ __forceinline__ float load(const float* p) {
  if constexpr (L == Loads::kRewritten) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// Body j of (3,n) coordinate rows and (n,) masses as (x, y, z, G m).
template <Loads L>
__device__ __forceinline__ float4 load_body(const float* pos, const float* mass,
                                            int n, int j) {
  return make_float4(load<L>(pos + j), load<L>(pos + n + j),
                     load<L>(pos + 2 * n + j), load<L>(mass + j) * kG);
}

// ---------------------------------------------------------------------------
// The pair-symmetric sweep (Kernel B; see the note in sym.cu).

// One unordered B x B tile pair (it <= jt), run by the B = blockDim.x
// threads of a CTA.  Thread t owns target i = it*B + t and passes its body
// bi = (x, y, z, G m_i); the j tile is staged in shared memory `sj` and
// `red` is (B/32)*3*B floats of shared scratch.  Writes the i-side sum to
// P[it][jt] and, off the diagonal, the j-side sum to P[jt][it], each (3, B)
// in `part`, T tiles a side.  Every thread of the CTA calls it.
__device__ __forceinline__ void sym_tile_pair(const float4* sj, float* red,
                                              float4 bi, int it, int jt,
                                              int T, float* part) {
  const int B = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = B >> 5;
  float* pi = part + (size_t(it) * T + jt) * 3 * B;  // P[it][jt]
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (it == jt) {  // diagonal tile: one-sided sum over all of its pairs
    for (int k = 0; k < B; ++k) {
      const float4 p = sj[k];
      const float dx = p.x - bi.x, dy = p.y - bi.y, dz = p.z - bi.z;
      const float w = (bi.w * p.w) * inv_cube(dx, dy, dz);
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
    }
    pi[t] = ax;
    pi[B + t] = ay;
    pi[2 * B + t] = az;
    return;  // uniform across the CTA
  }

  for (int s = 0; s < nwarps; ++s) {  // 32-wide j subtiles
    const float4* sub = sj + s * 32;
    float bx = 0.f, by = 0.f, bz = 0.f;  // j side of j = s*32 + (lane+k)%32
    for (int k = 0; k < 32; ++k) {
      const float4 p = sub[(lane + k) & 31];
      const float dx = p.x - bi.x, dy = p.y - bi.y, dz = p.z - bi.z;
      const float w = (bi.w * p.w) * inv_cube(dx, dy, dz);
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

// a = (sum_u P[t][u]) / (G m) for body idx of tile t = idx / B, u in order;
// zero mass gives exactly 0.
template <Loads L>
__device__ __forceinline__ float3 sym_reduce(const float* part, float gm,
                                             int idx, int T, int B) {
  const int t = idx / B, l = idx - t * B;
  const float* row = part + size_t(t) * T * 3 * B + l;
  float a[3];
  for (int c = 0; c < 3; ++c) {
    float s = 0.f;
    for (int u = 0; u < T; ++u) s += load<L>(row + (size_t(u) * 3 + c) * B);
    a[c] = gm > 0.f ? s / gm : 0.f;
  }
  return make_float3(a[0], a[1], a[2]);
}

// ---------------------------------------------------------------------------
// The tiled targets x sources sweep (Kernel A; see the note in tiled.cu).

// The source loop of a CTA of blockDim (ti, rows), ti * rows =
// kTiledThreads: thread (tx, ty) sums, for its target (xi, yi, zi), the
// sources ty*per .. (ty+1)*per - 1 of every tile_j-wide source tile, which
// the CTA stages in shared memory `src` as float4.  Sources past ns are
// staged as zero mass and add exactly nothing.  Every thread calls it.
template <Loads L>
__device__ __forceinline__ float3 tiled_source_loop(float4* src,
                                                    const float* pos_s,
                                                    const float* mass_s, int ns,
                                                    int tile_j, float xi,
                                                    float yi, float zi) {
  const int ty = threadIdx.y, tid = ty * blockDim.x + threadIdx.x;
  const int per = tile_j / blockDim.y;
  const float4* mine = src + ty * per;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int j0 = 0; j0 < ns; j0 += tile_j) {
    __syncthreads();  // every thread is done with the previous tile
    for (int k = tid; k < tile_j; k += kTiledThreads) {
      const int j = j0 + k;
      src[k] = j < ns ? load_body<L>(pos_s, mass_s, ns, j)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < per; ++k) {
      const float4 p = mine[k];
      const float dx = p.x - xi, dy = p.y - yi, dz = p.z - zi;
      const float w = p.w * inv_cube(dx, dy, dz);
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
    }
  }
  return make_float3(ax, ay, az);
}

// The thread rows' partial sums added in a fixed order (deterministic); the
// thread of row 0 gets its target's total.  part: 3 * kTiledThreads floats
// of shared memory.  Every thread calls it.
__device__ __forceinline__ float3 tiled_row_sum(float* part, float3 a) {
  const int ti = blockDim.x, tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * ti + tx;
  part[tid] = a.x;
  part[kTiledThreads + tid] = a.y;
  part[2 * kTiledThreads + tid] = a.z;
  __syncthreads();
  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (ty == 0) {
    for (int r = 0; r < int(blockDim.y); ++r) {
      sx += part[r * ti + tx];
      sy += part[kTiledThreads + r * ti + tx];
      sz += part[2 * kTiledThreads + r * ti + tx];
    }
  }
  return make_float3(sx, sy, sz);
}

}  // namespace nbt

// The fused sample blocks: `steps` Euler or leapfrog-KDK steps of the whole
// system in one cooperative kernel launch, fp32.
//
// Replaces nbody_tpu/ops/fused_block.py::_rows_kernel (the rows layout: the
// pair-symmetric sweep of Kernel B in square B-blocks) and ::_kernel (the
// columns layout: the one-sided tile_i x tile_j sweep of Kernel A).
//
// What differs from the TPU.  The Pallas kernels keep the whole state in
// VMEM and run their grid in order on one core, so a step follows the last
// with no synchronisation.  Hopper has neither property: the state lives in
// device memory (and the 50 MB L2), and the CTAs run in parallel in no
// order.  So each kernel is one cooperative launch of a persistent grid (at
// most as many CTAs as the card holds at once, each looping over work
// items), and the phases of a step are separated by device-wide barriers
// (cooperative_groups' grid.sync(): release/acquire at GPU scope).  What
// the fusion removes is the host: one launch per block instead of about six
// launches and allocations per step.
//
// Rows kernel, per sweep (two barriers):
//   1. the CTAs draw the unordered tile pairs (it <= jt) from a counter in
//      device memory (one atomicAdd a pair) and write Kernel B's
//      deterministic partials P[it][jt] and P[jt][it] (nbt::sym_tile_pair:
//      Kernel B's tile body, B / R threads a CTA at Kernel B's R).
//      A static grid-stride split left the CTAs that fell behind with no
//      one to share their work: at N=16384 the pair phase took 276 us a
//      step against 228 us unfused.  Which CTA takes a pair does not
//      change any result bit: each pair writes its own partials;
//   2. the CTAs take the particles in a grid-stride loop; each adds its
//      P[t][.] in order and divides by G m, zero mass giving exactly 0
//      (nbt::sym_reduce), and steps.  Positions are updated in place: in
//      phase 2 a thread reads no position but its own.
// Columns kernel, per sweep (one barrier): each CTA owns target tiles of
// tile_i and sweeps every source through Kernel A's source loop
// (nbt::tiled_source_loop: shared-memory float4 staging, R targets a
// thread, rsqrt_cube), so an Euler block equals the unfused block over
// Kernel A at the same tiles bit for bit.  Positions ping-pong between two
// (3,n) buffers, so a CTA writes its new positions while the others still
// read the old ones.  The (N,8)/(8,N) layouts and the per-step transpose of
// the TPU kernel are lane artifacts and are not copied.
//
// The update.  Euler: v += a dt, then p += v dt.  Leapfrog KDK carries the
// acceleration: one seed sweep, then per step a half kick, a drift, a sweep
// and a half kick.  Here each sweep is followed by the closing kick of its
// step and the opening kick and drift of the next, so the carried
// acceleration never leaves the thread: steps + 1 sweeps a block, as in
// models/integrators.py.  Each update rounds as the unfused path's two
// torch ops (vel + acc * dt, then pos + vel * dt): __fmul_rn and __fadd_rn
// keep nvcc from contracting them into an FMA.  So an Euler block runs the
// same arithmetic as the unfused block over Kernel B (rows) or A (columns).
//
// Coherence.  Positions and partials are written inside the kernel and read
// by other CTAs after a barrier, so every load of them is ld.global.cg
// (cached in L2 only, nbt::Loads::kRewritten), never the non-coherent
// read-only path; no pointer here is `const __restrict__`.  Velocities are
// read and written only by the thread that owns the particle: the
// grid-stride assignment is the same in every sweep.  No thread returns
// before a barrier.
//
// Bound.  At large N, the pair loop, as in Kernels B (rows) and A
// (columns).  A grid barrier
// costs 1-4 us on an H100 (measured with %globaltimer): 2 (rows) or 1
// (columns) per step.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// Positions and partials are rewritten between grid barriers.
constexpr nbt::Loads kLoads = nbt::Loads::kRewritten;

struct Steps {
  int steps;     // steps of the block
  float dt;      // fp32 dt
  float half;    // fp32 0.5 * dt
  int leapfrog;  // 0: Euler, 1: leapfrog KDK
};

// x + y * h, rounded after the product and after the sum.
__device__ __forceinline__ float axpy_rn(float x, float y, float h) {
  return __fadd_rn(x, __fmul_rn(y, h));
}

// Advance body idx with the acceleration `a` of sweep s (0 .. steps - 1 +
// leapfrog), reading its position from p_in and writing it to p_out.
__device__ __forceinline__ void advance_body(const float* p_in, float* p_out,
                                             float* vel, int n, int idx,
                                             float3 a, int s, const Steps& st) {
  const float ac[3] = {a.x, a.y, a.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const size_t k = size_t(c) * n + idx;
    float v = vel[k];
    float p = nbt::load<kLoads>(p_in + k);
    if (!st.leapfrog) {
      v = axpy_rn(v, ac[c], st.dt);  // v += a dt
      p = axpy_rn(p, v, st.dt);      // p += v dt
    } else {
      if (s > 0) v = axpy_rn(v, ac[c], st.half);  // closing kick of step s
      if (s < st.steps) {                          // step s + 1: kick, drift
        v = axpy_rn(v, ac[c], st.half);
        p = axpy_rn(p, v, st.dt);
      }
    }
    vel[k] = v;
    p_out[k] = p;
  }
}

template <int R>
__global__ void fused_rows_kernel(float* pos, float* vel, const float* mass,
                                  int n, float* part, unsigned* queue,
                                  Steps st) {
  cg::grid_group grid = cg::this_grid();
  const int nt = blockDim.x, B = nt * R, T = n / B, t = threadIdx.x;
  const int pairs = T * (T + 1) / 2;
  extern __shared__ float4 smem[];
  float4* sj = smem;                                    // the j tile, twice
  float* red = reinterpret_cast<float*>(smem + 2 * B);  // [warp][3][B]
  __shared__ int q;                                     // the CTA's tile pair
  const int sweeps = st.steps + st.leapfrog;
  for (int s = 0; s < sweeps; ++s) {
    for (;;) {
      __syncthreads();  // the CTA is done with the last pair's q, sj and red
      if (t == 0) q = static_cast<int>(atomicAdd(queue, 1u));
      __syncthreads();
      if (q >= pairs) break;
      int it, jt;
      nbt::tile_pair(q, T, it, jt);
      float4 bi[R];
      nbt::sym_load<R, kLoads>(pos, mass, n, it * B, pos, mass, n, jt * B, sj,
                               bi);
      __syncthreads();
      nbt::sym_tile_pair<R>(sj, red, bi, it, jt, T, part);
    }
    grid.sync();  // every partial of this sweep is written
    // Every draw of this sweep came before the barrier above, and the next
    // sweep draws only after the one below: reset the counter in between.
    if (blockIdx.x == 0 && t == 0) atomicExch(queue, 0u);
    for (int idx = blockIdx.x * nt + t; idx < n; idx += gridDim.x * nt) {
      const float gm = mass[idx] * nbt::kG;
      const float3 a = nbt::sym_reduce<kLoads>(part, gm, idx, T, B);
      advance_body(pos, pos, vel, n, idx, a, s, st);
    }
    grid.sync();  // every position is stepped and every partial read
  }
}

template <int R>
__global__ void __launch_bounds__(nbt::kTiledThreads)
fused_cols_kernel(float* pos, float* vel, const float* mass, int n,
                  int tile_i, int tile_j, Steps st) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 src[];  // tile_j sources: x, y, z, G*m
  __shared__ float part[3 * nbt::kTiledThreads * R];
  const nbt::TiledThread<R> th(tile_i);
  const int tiles = n / tile_i;
  const int sweeps = st.steps + st.leapfrog;
  for (int s = 0; s < sweeps; ++s) {
    const float* p_in = pos + size_t(s & 1) * 3 * n;
    float* p_out = pos + size_t((s + 1) & 1) * 3 * n;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      float3 t[R], acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = tile * tile_i + th.target(r);
        t[r] = make_float3(nbt::load<kLoads>(p_in + i),
                           nbt::load<kLoads>(p_in + n + i),
                           nbt::load<kLoads>(p_in + 2 * n + i));
      }
      nbt::tiled_source_loop<kLoads, R>(src, p_in, mass, n, tile_j, th, t,
                                        acc);
      const float3 a = nbt::tiled_row_sum(part, th, acc);
      if (int(threadIdx.x) < tile_i)
        advance_body(p_in, p_out, vel, n, tile * tile_i + threadIdx.x, a, s,
                     st);
    }
    grid.sync();  // every new position is written; the old buffer is free
  }
}

}  // namespace

// The rows block.  pos (3,n) and vel (3,n) are stepped in place; mass (n,);
// all fp32 and contiguous.  block: a multiple of 32, at most 256, dividing
// n; a CTA takes B / R threads, R = nbt::sym_targets(block) as in Kernel
// B.  partials: 3 * n * (n / block) floats of scratch; queue: one
// zeroed unsigned int, the tile-pair counter.  dt and half: the fp32 step
// and half step.  The wrapper checks all of it.  One launch on `stream`,
// without synchronising; returns the launch's cudaError_t.
extern "C" int nbt_fused_rows(float* pos, float* vel, const float* mass, int n,
                              int block, float* partials, unsigned* queue,
                              int steps, float dt, float half, int leapfrog,
                              void* stream) {
  const int T = n / block;
  const Steps st{steps, dt, half, leapfrog};
  return static_cast<int>(nbt::with_r<nbt::kMaxSymTargets>(
      nbt::sym_targets(block), [&](auto r) {
        constexpr int R = decltype(r)::value;
        return nbt::launch_persistent(
            fused_rows_kernel<R>, T * (T + 1) / 2, 1, dim3(block / R),
            nbt::sym_smem(block, R), static_cast<cudaStream_t>(stream), pos,
            vel, mass, n, partials, queue, st);
      }));
}

// The columns block.  pos2: two (3,n) position buffers, the first holding
// the initial positions; after the block the positions are in buffer
// (steps + leapfrog) % 2.  vel (3,n) is stepped in place; mass (n,); all
// fp32 and contiguous.  tile_i and tile_j as for nbt_tiled_accel, both
// dividing n.  One launch on `stream`, without synchronising; returns the
// launch's cudaError_t.
extern "C" int nbt_fused_cols(float* pos2, float* vel, const float* mass,
                              int n, int tile_i, int tile_j, int steps,
                              float dt, float half, int leapfrog,
                              void* stream) {
  const size_t smem = size_t(tile_j) * sizeof(float4);
  const Steps st{steps, dt, half, leapfrog};
  return static_cast<int>(nbt::with_targets(tile_i, tile_j, [&](auto r) {
    return nbt::launch_persistent(
        fused_cols_kernel<decltype(r)::value>, n / tile_i, 1,
        dim3(nbt::kTiledThreads), smem, static_cast<cudaStream_t>(stream), pos2,
        vel, mass, n, tile_i, tile_j, st);
  }));
}

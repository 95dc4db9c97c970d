// Shared pieces of the port's CUDA kernels: the reference's physics
// constants, the inverse square root and cube of one pair distance, the
// P3M sweep's warp-uniform skip predicate and what its kernel shares with
// its VJP's (staging, distance, taper, the box skip), the
// bodies of the two force sweeps and the cooperative launcher.  The unfused
// kernels (sym.cu, tiled.cu), the fused sample blocks (fused.cu), the
// two-sided sweep (two_sided.cu), the ring (ring.cu) and the force VJP
// (vjp.cu) run the same device functions, so they share one copy of the
// pair arithmetic; so do the P3M sweep (sr.cu) and its VJP (sr_vjp.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <type_traits>

namespace nbt {

// ver0/GSimulation.cpp:114-116, as nbody_tpu/types.py.  Both literals round
// to the same fp32 values as jnp.float32 of the Python doubles.
constexpr float kSoftening2 = 1e-3f;
constexpr float kG = 6.67259e-11f;

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTiledThreads = 256;  // threads of a tiled-sweep CTA

// 1 / sqrt(d2) for d2 >= eps^2 from the SFU alone: rsqrt.approx, within a
// few ulp (.ftz changes nothing, since d2 is never subnormal).  One MUFU op,
// no branch.
__device__ __forceinline__ float rsqrt_approx(float d2) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(d2));
  return y;
}

// d2^{-1/2} for d2 >= eps^2: rsqrt_approx and one Newton step
// y (3 - d2 y^2) / 2, which leaves it within about an ulp of 1 / sqrt.  One
// MUFU op and four FP32 ops, with no branch (IEEE 1.0f / sqrtf carries two
// refinement sequences, each with a slow-path branch).  The force VJP takes
// it for its two inverse powers.
__device__ __forceinline__ float rsqrt_newton(float d2) {
  const float y = rsqrt_approx(d2);
  const float h = 0.5f * d2;
  return y * fmaf(-h * y, y, 1.5f);
}

// d2^{-3/2} for d2 >= eps^2: rsqrt_newton, then the cube.  One MUFU op and
// six FP32 ops.  Every exact pair loop takes it: the tiled sweep and the
// pair-symmetric tile body; the mxu kernel and the P3M short-range sweep
// take rsqrt_approx alone.
__device__ __forceinline__ float rsqrt_cube(float d2) {
  const float y = rsqrt_newton(d2);
  return y * y * y;
}

// Whether every lane of the warp has q >= 1: a pair beyond the P3M cutoff,
// where the taper's weight is exactly 0 (the short-range sweep's
// warp-uniform skip).  Every lane of the warp calls it.
__device__ __forceinline__ bool warp_all_beyond(float q) {
  return __all_sync(kFullMask, q >= 1.0f);
}

// ---------------------------------------------------------------------------
// The P3M short-range sweep (sr.cu) and its VJP (sr_vjp.cu): their staging,
// the pair distance and taper, and the schedule's box skip.

constexpr int kSrSlab = 64;  // slots of a slab = threads of a group

// One 16-byte asynchronous copy from device to shared memory (cp.async,
// through L2 only), and its commit and wait: the calling thread's copies
// have landed after cp_async_wait_all; a barrier then shows them to the
// other threads.  Both addresses are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Group g's named barrier (id 1 + g, 64 threads), by immediate ids, so a
// kernel holds only the barriers it uses.  At most 4 groups a CTA.
__device__ __forceinline__ void group_sync(int g) {
  switch (g) {
    case 0: asm volatile("bar.sync 1, 64;" ::: "memory"); break;
    case 1: asm volatile("bar.sync 2, 64;" ::: "memory"); break;
    case 2: asm volatile("bar.sync 3, 64;" ::: "memory"); break;
    default: asm volatile("bar.sync 4, 64;" ::: "memory"); break;
  }
}

// 1 - S(q) for q = r2 / rc2 >= 0, S the quintic taper of ops/pm.py, in
// Horner form: 1 + q^3 (-10 + q (15 - 6 q)) at q clamped to 1.  At q >= 1
// it is 1 - 1 = 0 exactly (15 - 6 = 9, 9 - 10 = -1, 1 - 1 = 0).  `m6` is
// -6 held in a register (minus_six): an FMA takes one immediate, and 15
// is the other.
__device__ __forceinline__ float sr_keep(float q, float m6) {
  const float qc = fminf(q, 1.0f);
  const float p = fmaf(fmaf(m6, qc, 15.0f), qc, -10.0f);
  return fmaf(qc * qc * qc, p, 1.0f);
}

// -6.0f from a move the compiler keeps in a register across the loops,
// rather than one it rematerialises before every taper.
__device__ __forceinline__ float minus_six() {
  float v;
  asm("mov.b32 %0, 0xc0c00000;" : "=f"(v));
  return v;
}

// d2 = |d|^2 + eps^2 and q = |d|^2 / rc2 of the pair (dx, dy, dz), both
// from one chain of FMAs: q = d2 / rc2 - eps^2 / rc2 (`eps_q`), so the
// weight's rsqrt and its taper, and the skips' tests, read the same d2.
// Each operation rounds monotonically in |dx|, |dy|, |dz|: a larger gap
// gives a d2 and a q no smaller.
struct SrDist {
  float d2, q;
};
__device__ __forceinline__ SrDist sr_dist(float dx, float dy, float dz,
                                          float inv_rc2, float eps_q) {
  const float d2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, kSoftening2)));
  return {d2, fmaf(d2, inv_rc2, eps_q)};
}

// The box skip: lane l takes `o`, slot l of a 32-wide subtile of the other
// slab, and measures q of its gap to the box [lo, hi] of the warp's own
// slots (x gap max(lo.x - o.x, o.x - hi.x, 0), and so on); the ballot keeps
// the slots with q < 1.  For every other one each lane's |dx| >= the x gap
// (and so on), so its q, rounded monotonically by sr_dist, is >= 1 too.
__device__ __forceinline__ unsigned sr_box_ballot(float4 o, float3 lo,
                                                  float3 hi, float inv_rc2,
                                                  float eps_q) {
  const float ex = fmaxf(fmaxf(lo.x - o.x, o.x - hi.x), 0.0f);
  const float ey = fmaxf(fmaxf(lo.y - o.y, o.y - hi.y), 0.0f);
  const float ez = fmaxf(fmaxf(lo.z - o.z, o.z - hi.z), 0.0f);
  return __ballot_sync(kFullMask,
                       sr_dist(ex, ey, ez, inv_rc2, eps_q).q < 1.0f);
}

// The first index of [lo, hi) whose value in the sorted `keys` is >= v.
__device__ __forceinline__ int lower_bound(const int* keys, int lo, int hi,
                                          int v) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (keys[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The pair deltas' precision, a compile-time flag of the pair arithmetic.
// kBF16 is the JAX package's bf16 distance mode
// (nbody_tpu/ops/pallas_kernel.py:75-87, pallas_sym.py:72-82): each delta is
// subtracted in f32, rounded to nearest even through bf16, and the rounded
// delta feeds both |d|^2 and the force sum; all arithmetic stays f32.
// Rounding commutes with negation, so the pair-symmetric sweeps stay exactly
// antisymmetric.  kF32 leaves the delta as it is, so the f32 instantiations
// compile to the same code as before the flag.
enum class Dist { kF32, kBF16 };

template <Dist D>
__device__ __forceinline__ float round_delta(float d) {
  if constexpr (D == Dist::kBF16) {
    return __bfloat162float(__float2bfloat16_rn(d));
  } else {
    return d;
  }
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

// Most targets a lane of the pair-symmetric tile body owns (R).  Each lane's
// non-broadcast read of a j body from shared memory and the 3 shuffles that
// hand its j-side sums on then serve R pairs instead of one.
// scripts/sweep_shapes.py --sym-targets measures R = 1, 2, 4: R = 2 takes
// 13% off R = 1 at N=16384, R = 4 (56-80 registers) nothing more (PERF.md).
constexpr int kMaxSymTargets = 2;

// R at tile edge `block`: the largest power of two up to kMaxSymTargets
// that leaves whole warps (B / R a multiple of 32), so 2 where B is a
// multiple of 64 (the default 128) and 1 at B = 32, 96, 160, 224.  A
// function of B alone: Kernel B, the two-sided sweep and the fused rows
// block run the same body at one B on any card.
// (R = 1 is 3-12% faster on the card where a sweep gives each SM only a
// few warps, but those shapes are host-bound end to end; PERF.md.)
constexpr int sym_targets(int block) {
  int r = kMaxSymTargets;
  while (r > 1 && block % (32 * r) != 0) r /= 2;
  return r;
}

// f(std::integral_constant<int, R>{}) for r in {1, 2, 4} up to Max: a
// launcher's pick among its kernel's instantiations.
template <int Max, class F>
auto with_r(int r, F&& f) {
  if constexpr (Max >= 4) {
    if (r == 4) return f(std::integral_constant<int, 4>{});
  }
  if constexpr (Max >= 2) {
    if (r == 2) return f(std::integral_constant<int, 2>{});
  }
  return f(std::integral_constant<int, 1>{});
}

// Shared memory of a tile body's CTA: the j tile, each 32-wide subtile
// staged twice (2 B float4), and the warps' j-side sums ([warp][3][B]
// floats, B / (32 R) warps).
inline size_t sym_smem(int block, int r) {
  return 2 * block * sizeof(float4) +
         (block / (32 * r)) * 3 * block * sizeof(float);
}

// Stage the B bodies j0 .. j0 + B - 1 of (3,n) coordinate rows and (n,)
// masses in shared memory `sj`, each 32-wide subtile s twice (sj[64 s + m]
// holds body j0 + 32 s + m mod 32, m < 64, so the rotation's reads need no
// wrap-around), and load the R targets of the calling thread, bodies i0 + t
// + r B / R.  Every thread of a CTA of B / R threads calls it; the caller
// synchronises before the body reads `sj`.
template <int R, Loads L>
__device__ __forceinline__ void sym_load(const float* pos_i,
                                         const float* mass_i, int ni, int i0,
                                         const float* pos_j,
                                         const float* mass_j, int nj, int j0,
                                         float4* sj, float4 (&bi)[R]) {
  const int nt = blockDim.x, t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = t + r * nt, m = (k & 31) + 64 * (k >> 5);
    sj[m] = sj[m + 32] = load_body<L>(pos_j, mass_j, nj, j0 + k);
    bi[r] = load_body<L>(pos_i, mass_i, ni, i0 + k);
  }
}

// One pair of the body: d = r_j - r_i (rounded by D), d2 = |d|^2 + eps^2 as
// three FMAs, the mass-folded weight w = (G m_i)(G m_j) d2^{-3/2}
// (rsqrt_cube; d = 0 gives exactly 0), w d
// added to the i side a and subtracted from the j side b, each as an FMA of
// the exact product, so the two sides stay exactly antisymmetric.
template <Dist D, bool JSide>
__device__ __forceinline__ void sym_pair(float4 bi, float4 p, float3& a,
                                         float3& b) {
  const float dx = round_delta<D>(p.x - bi.x);
  const float dy = round_delta<D>(p.y - bi.y);
  const float dz = round_delta<D>(p.z - bi.z);
  const float d2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, kSoftening2)));
  const float w = (bi.w * p.w) * rsqrt_cube(d2);
  a.x = fmaf(w, dx, a.x);
  a.y = fmaf(w, dy, a.y);
  a.z = fmaf(w, dz, a.z);
  if constexpr (JSide) {
    b.x = fmaf(-w, dx, b.x);
    b.y = fmaf(-w, dy, b.y);
    b.z = fmaf(-w, dz, b.z);
  }
}

// One B x B tile pair of two different tiles, run by the B / R threads of a
// CTA.  Thread t = 32 w + l owns targets t + r B / R (r < R) of the i tile,
// so a target's lane is its index mod 32, and passes their bodies bi =
// (x, y, z, G m_i); the j tile is staged in shared memory `sj` and `red` is
// (B / (32 R)) * 3 * B floats of shared scratch.  At step k of a 32-wide j
// subtile s, lane l reads j = 32 s + (l + k) mod 32 once (a float4 of its
// own: no broadcast; the doubled subtile makes it sj[64 s + l + k], an
// immediate offset) and evaluates it against its R targets; the j-side sums
// of j take the R reactions and then rotate one lane (3 shuffles), so after
// 32 steps lane l holds the sum over the warp's 32 R targets for j = 32 s +
// l.  The warps' sums meet in `red` and are added in warp order.  Each
// target adds its j in the same order whatever R (subtiles in order, then
// its lane's rotation).  Writes the i-side sum sum_j w d to pi and the
// j-side sum -sum_i w d to pj, each (3, B).  The i and j tiles may come from
// one set (Kernel B's off-diagonal tiles) or from two (the two-sided
// sweep).  Every thread of the CTA calls it.
template <int R, Dist D>
__device__ __forceinline__ void sym_tile_cross(const float4* sj, float* red,
                                               const float4 (&bi)[R],
                                               float* pi, float* pj) {
  const int nt = blockDim.x, B = nt * R, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = nt >> 5;
  float3 a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = make_float3(0.f, 0.f, 0.f);
  const int from = (lane + 1) & 31;
  for (int s = 0; s < B / 32; ++s) {  // 32-wide j subtiles
    const float4* sub = sj + s * 64 + lane;  // sub[k]: j = 32 s + (lane+k)%32
    float3 b = make_float3(0.f, 0.f, 0.f);  // j side of that j
#pragma unroll (8 / R)
    for (int k = 0; k < 32; ++k) {
      const float4 p = sub[k];
#pragma unroll
      for (int r = 0; r < R; ++r) sym_pair<D, true>(bi[r], p, a[r], b);
      // Hand each j-side sum to the lane that takes its j at step k+1.
      b.x = __shfl_sync(kFullMask, b.x, from);
      b.y = __shfl_sync(kFullMask, b.y, from);
      b.z = __shfl_sync(kFullMask, b.z, from);
    }
    red[(warp * 3 + 0) * B + s * 32 + lane] = b.x;
    red[(warp * 3 + 1) * B + s * 32 + lane] = b.y;
    red[(warp * 3 + 2) * B + s * 32 + lane] = b.z;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = t + r * nt;  // target i, and j = i of the j side
    float sx = 0.f, sy = 0.f, sz = 0.f;
    for (int w = 0; w < nwarps; ++w) {  // fixed order: deterministic
      sx += red[(w * 3 + 0) * B + i];
      sy += red[(w * 3 + 1) * B + i];
      sz += red[(w * 3 + 2) * B + i];
    }
    pi[i] = a[r].x;
    pi[B + i] = a[r].y;
    pi[2 * B + i] = a[r].z;
    pj[i] = sx;
    pj[B + i] = sy;
    pj[2 * B + i] = sz;
  }
}

// One unordered B x B tile pair (it <= jt) of one set: the i-side sum goes
// to pi and, off the diagonal, the j-side sum to pj, each (3, B).  A
// diagonal tile takes a one-sided sum over all of its pairs, each target
// reading j = 0 .. B - 1 in order (broadcasts).  Arguments as for
// sym_tile_cross.
template <int R, Dist D>
__device__ __forceinline__ void sym_tile_pair_at(const float4* sj, float* red,
                                                 const float4 (&bi)[R],
                                                 bool diagonal, float* pi,
                                                 float* pj) {
  if (diagonal) {  // one-sided sum over all of the tile's pairs
    const int nt = blockDim.x, B = nt * R, t = threadIdx.x;
    float3 a[R], unused;
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = make_float3(0.f, 0.f, 0.f);
    for (int s = 0; s < B / 32; ++s) {
#pragma unroll (8 / R)
      for (int m = 0; m < 32; ++m) {
        const float4 p = sj[s * 64 + m];  // j = 32 s + m
#pragma unroll
        for (int r = 0; r < R; ++r)
          sym_pair<D, false>(bi[r], p, a[r], unused);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = t + r * nt;
      pi[i] = a[r].x;
      pi[B + i] = a[r].y;
      pi[2 * B + i] = a[r].z;
    }
    return;  // uniform across the CTA
  }
  sym_tile_cross<R, D>(sj, red, bi, pi, pj);
}

// Unordered tile pair q of T (T + 1) / 2 as (it, jt), it <= jt: row it
// holds the T - it pairs from q = it T - it (it - 1) / 2 on, jt from T - 1
// down to it.  Counted from the end, tile row it = T - 1 - k holds the k + 1
// pairs from the triangular number k (k + 1) / 2 on.  In 64 bits: T (T + 1)
// / 2 passes 2^31 from T = 65536 on, its intermediates from T = 46341.
__device__ __forceinline__ void tile_pair(long long q, int T, int& it,
                                          int& jt) {
  const long long r = 1LL * T * (T + 1) / 2 - 1 - q;
  long long k = (long long)((sqrt(8.0 * r + 1.0) - 1.0) * 0.5);
  while ((k + 1) * (k + 2) / 2 <= r) ++k;
  while (k * (k + 1) / 2 > r) --k;
  it = T - 1 - int(k);
  jt = it + int(r - k * (k + 1) / 2);
}

// sym_tile_pair_at on the (T, T) partials `part` of one set, T tiles a
// side: the i side to P[it][jt], the j side to P[jt][it].
template <int R>
__device__ __forceinline__ void sym_tile_pair(const float4* sj, float* red,
                                              const float4 (&bi)[R], int it,
                                              int jt, int T, float* part) {
  const int B = blockDim.x * R;
  sym_tile_pair_at<R, Dist::kF32>(sj, red, bi, it == jt,
                                  part + (size_t(it) * T + jt) * 3 * B,
                                  part + (size_t(jt) * T + it) * 3 * B);
}

// s + P[t][u0] + P[t][u0 + 1] + ... for `cols` columns of one coordinate,
// one fp32 add a column in column order: the one summation order of every
// pair-symmetric reduce (Kernel B's, banded or not, the two-sided sweep's
// and the fused rows block's), so their results agree bit for bit.  `col`
// points at the coordinate's lane of P[t][u0]; columns are 3 B floats apart.
template <Loads L>
__device__ __forceinline__ float sym_row_sum(const float* col, int cols,
                                             int B, float s) {
  for (int u = 0; u < cols; ++u) s += load<L>(col + size_t(u) * 3 * B);
  return s;
}

// a = S / (G m); zero mass gives exactly 0.
__device__ __forceinline__ float sym_divide(float s, float gm) {
  return gm > 0.f ? s / gm : 0.f;
}

// a = (sum_u P[t][u]) / (G m) for body idx of tile t = idx / B, u in order.
template <Loads L>
__device__ __forceinline__ float3 sym_reduce(const float* part, float gm,
                                             int idx, int T, int B) {
  const int t = idx / B, l = idx - t * B;
  const float* row = part + size_t(t) * T * 3 * B + l;
  float a[3];
  for (int c = 0; c < 3; ++c)
    a[c] = sym_divide(sym_row_sum<L>(row + c * B, T, B, 0.f), gm);
  return make_float3(a[0], a[1], a[2]);
}

// ---------------------------------------------------------------------------
// The tiled targets x sources sweep (Kernel A; see the note in tiled.cu).

// Most targets a thread of the tiled sweep owns (R).  Each broadcast read of
// a source from shared memory then feeds R pairs instead of one, and the R
// independent sums give the scheduler work between the SFU's results.
// scripts/sweep_shapes.py --targets measures R = 1, 2, 4: 2 is the best
// over the shapes of Kernel A, the ring and the fused columns block
// (PERF.md).
constexpr int kMaxTargets = 2;

// R at tile_i x tile_j: the largest power of two up to kMaxTargets that
// keeps a warp's 32 lanes on 32 targets of one thread row (so a source read
// stays a broadcast) and splits tile_j evenly among the rows.  R = 1 is the
// rule the wrappers check, so every tile they accept has an R.
inline int tiled_targets(int tile_i, int tile_j) {
  for (int r = kMaxTargets; r > 1; r /= 2)
    if (tile_i % (32 * r) == 0 && tile_j % (kTiledThreads * r / tile_i) == 0)
      return r;
  return 1;
}

// f(std::integral_constant<int, R>{}) at R = tiled_targets(tile_i, tile_j):
// a launcher's pick among its kernel's instantiations, of which only those
// up to kMaxTargets are built.
template <class F>
auto with_targets(int tile_i, int tile_j, F&& f) {
  return with_r<kMaxTargets>(tiled_targets(tile_i, tile_j), f);
}

// Thread threadIdx.x of a 1-D CTA of kTiledThreads threads that sweeps
// tile_i targets, R a thread: column tx of cols = tile_i / R and row ty of
// rows = kTiledThreads / cols.  Its targets are the CTA's target(0..R-1) =
// tx, tx + cols, ..., so the R loads of a warp are each coalesced; its
// sources are row ty's share of every source tile.
template <int R>
struct TiledThread {
  int cols, rows, tx, ty;
  __device__ explicit TiledThread(int tile_i)
      : cols(tile_i / R),
        rows(kTiledThreads / cols),
        tx(int(threadIdx.x) % cols),
        ty(int(threadIdx.x) / cols) {}
  __device__ int target(int r) const { return tx + r * cols; }
};

// The source loop of a tiled-sweep CTA: thread th sums into acc[r], for each
// of its targets t[r] = (x, y, z), the sources ty*per .. (ty+1)*per - 1 of
// every tile_j-wide source tile, which the CTA stages in shared memory `src`
// as float4 (x, y, z, G m) taken from body(j).  Sources past ns are staged
// as zero mass and add exactly nothing.  Per pair: the deltas (round_delta),
// |d|^2 + eps^2, rsqrt_cube, w = G m_j d2^{-3/2} and three FMAs; a warp's
// lanes read one source at a time (a broadcast), which feeds R pairs each.
// Every thread calls it.
template <int R, Dist D, class Body>
__device__ __forceinline__ void tiled_source_sweep(float4* src,
                                                   const Body& body, int ns,
                                                   int tile_j,
                                                   const TiledThread<R>& th,
                                                   const float3 (&t)[R],
                                                   float3 (&acc)[R]) {
  const int per = tile_j / th.rows;
  const float4* mine = src + th.ty * per;
  float ax[R], ay[R], az[R];
#pragma unroll
  for (int r = 0; r < R; ++r) ax[r] = ay[r] = az[r] = 0.f;
  for (int j0 = 0; j0 < ns; j0 += tile_j) {
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < tile_j; k += kTiledThreads) {
      const int j = j0 + k;
      src[k] = j < ns ? body(j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll (8 / R)
    for (int k = 0; k < per; ++k) {
      const float4 p = mine[k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = round_delta<D>(p.x - t[r].x);
        const float dy = round_delta<D>(p.y - t[r].y);
        const float dz = round_delta<D>(p.z - t[r].z);
        const float w =
            p.w * rsqrt_cube(dx * dx + dy * dy + dz * dz + kSoftening2);
        ax[r] += w * dx;
        ay[r] += w * dy;
        az[r] += w * dz;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float3(ax[r], ay[r], az[r]);
}

// tiled_source_sweep over sources held as (3,ns) coordinate rows and (ns,)
// masses.
template <Loads L, int R, Dist D = Dist::kF32>
__device__ __forceinline__ void tiled_source_loop(
    float4* src, const float* pos_s, const float* mass_s, int ns, int tile_j,
    const TiledThread<R>& th, const float3 (&t)[R], float3 (&acc)[R]) {
  tiled_source_sweep<R, D>(
      src, [=](int j) { return load_body<L>(pos_s, mass_s, ns, j); }, ns,
      tile_j, th, t, acc);
}

// The rows' partial sums of every target added in row order (deterministic):
// thread threadIdx.x < tile_i gets the total of the CTA's target
// threadIdx.x, the others zeros.  part: 3 * kTiledThreads * R floats of
// shared memory.  Every thread calls it.
template <int R>
__device__ __forceinline__ float3 tiled_row_sum(float* part,
                                                const TiledThread<R>& th,
                                                const float3 (&a)[R]) {
  const int ti = th.cols * R, plane = th.rows * ti;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = th.ty * ti + th.target(r);
    part[c] = a[r].x;
    part[plane + c] = a[r].y;
    part[2 * plane + c] = a[r].z;
  }
  __syncthreads();
  float sx = 0.f, sy = 0.f, sz = 0.f;
  const int i = threadIdx.x;
  if (i < ti) {
    for (int row = 0; row < th.rows; ++row) {
      sx += part[row * ti + i];
      sy += part[plane + row * ti + i];
      sz += part[2 * plane + row * ti + i];
    }
  }
  return make_float3(sx, sy, sz);
}

template <typename T>
struct Same {
  using type = T;
};

// Launch `kernel` cooperatively on a persistent grid of `work` CTAs, or of
// as many as the card holds at once if that is fewer, rounded down to a
// multiple of `unit` (a kernel whose CTAs work in groups of `unit`).  The
// arguments are converted to the kernel's own parameter types.  A card that
// cannot take the launch returns an error; nothing falls back.  All CTAs
// of a cooperative launch are resident at once, so they may wait on each
// other.
template <typename... Args>
cudaError_t launch_persistent(void (*kernel)(Args...), int work, int unit,
                              dim3 block, size_t smem, cudaStream_t stream,
                              typename Same<Args>::type... args) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, block.x * block.y * block.z, smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const int resident = per_sm * sms / unit * unit;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  const dim3 grid(std::min(work, resident));
  void* argv[] = {static_cast<void*>(&args)...};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     grid, block, argv, smem, stream);
}

}  // namespace nbt

// Kernel B: the pair-symmetric self-sweep, fp32 arithmetic, mass-folded.
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
//
// Bands.  All T x T partials take 12 N^2 / B bytes (25 MB at N=16384,
// B=128; 103 GB at N=1048576, more than the card holds), so the i tiles are
// swept in bands of Q, one launch pair a band, within a scratch budget that
// the wrapper derives from the card.  Band [r0, r1) writes the partials of
// its own rows, P[r0..r1-1][r0..T-1] ("rows", Q x T), and the j sides its
// pairs hand to later rows, P[r1..T-1][r0..r1-1] ("tail", (T - r1) x Q):
// 12 Q (2N - Q B) bytes, at most about 24 Q N.  The band's reduce adds, in
// column order, the columns r0.. that the band wrote to every row t >= r0,
// starting from the running sum that earlier bands left in `out`; a row of
// the band is then complete and divided.  So each row still adds
// P[t][0], P[t][1], ..., P[t][T-1] in that order, in fp32, and a banded
// sweep equals the one-band sweep bit for bit.  With Q = T the one band's
// rows are the whole (T, T) partials and there is no tail.
//
// Inside a CTA.  A CTA of B / R threads sweeps one tile pair, and each lane
// owns R targets (R = nbt::sym_targets(B): 2 where B is a multiple of 64, else
// 1).  The lanes keep their targets' i-side sums in registers.  The j tile is
// staged in shared memory as float4 (x, y, z, G m).  The j-side sum is a
// reduction across the threads, done without a shuffle tree: each warp walks a
// 32-wide j subtile in 32 steps, lane l reading j = (l + k) mod 32 at step k
// once and evaluating it against its R targets, and the three j-side
// accumulators take the R reactions and then rotate one lane (__shfl_sync), so
// after 32 steps lane l holds sum_i over the warp's 32 R targets for j = l.  A
// pair so costs 3 / R shuffles and 1 / R of a non-broadcast float4 read.  Each
// 32-wide subtile is staged twice, so lane l's read at step k is
// sj[64 s + l + k], an immediate offset with no index arithmetic.  The warps'
// sums meet in shared memory and are added in warp order.  The grid holds the
// band's unordered tile pairs alone (CTA x takes pair q by nbt::tile_pair, in
// 64 bits), not a square of which half would exit; a band's pairs stay within
// the grid's x extent, 2^31 - 1 (sym_kernel.sym_band caps the band).
//
// Bound.  Compute-bound like Kernel A, at half the pair evaluations: per
// unordered pair 20 FP32 operations (3 deltas, |d|^2 + eps^2 as 3 FMAs, the
// inverse cube as rsqrt.approx plus one Newton step, nbt::rsqrt_cube, with
// no IEEE divide or square root and no branch, the mass-folded weight and
// one FMA a coordinate on each side), one SFU op, and 3 / R shuffles and
// 1 / R shared-memory reads.  R = 2 takes 13% off R = 1 at N=16384 and
// R = 4 nothing more (scripts/sweep_shapes.py --sym-targets): past R = 2 the
// shuffle and shared-memory pipe is not what sets the pace, the rate of
// FP32 instructions is.
// Device memory traffic is the 12 N^2 / B bytes of partials written once and
// read once, whatever the bands.
//
// The kernels are templates on R and on the pair deltas' precision
// (nbt::Dist): f32, or the bf16 distance mode.
//
// The tile-pair body is the device function nbt::sym_tile_pair_at
// (common.cuh), which the fused rows block (fused.cu) runs too, through
// nbt::sym_tile_pair; every reduce adds its columns through
// nbt::sym_row_sum, as the fused block's does, so the two agree bit for bit.
#include "common.cuh"

namespace {

constexpr nbt::Loads kLoads = nbt::Loads::kFixed;

// Band [r0, r1) of i tiles: CTA x takes unordered tile pair q = (tile pairs
// of the rows before r0) + x, (it, jt) by nbt::tile_pair, so the grid holds
// the band's pairs alone.  `part` holds the band's rows, then its tail.
// B = R blockDim.x.
template <int R, nbt::Dist D>
__global__ void sym_pairs_kernel(const float* __restrict__ pos,
                                 const float* __restrict__ mass, int n, int r0,
                                 int r1, float* __restrict__ part) {
  const int B = blockDim.x * R, T = n / B, nb = r1 - r0;
  int it, jt;
  nbt::tile_pair(1LL * r0 * T - 1LL * r0 * (r0 - 1) / 2 + blockIdx.x, T, it,
                 jt);
  extern __shared__ float4 smem[];
  float4* sj = smem;                                    // the j tile, twice
  float* red = reinterpret_cast<float*>(smem + 2 * B);  // [warp][3][B]
  float4 bi[R];
  nbt::sym_load<R, kLoads>(pos, mass, n, it * B, pos, mass, n, jt * B, sj, bi);
  __syncthreads();
  // P[it][jt] in the rows; P[jt][it] in the rows or, past the band, the
  // tail.  One base pointer and an offset: two pointers cost the sweep 15
  // registers.
  const size_t oj = jt < r1 ? size_t(jt - r0) * T + it
                            : size_t(nb) * T + size_t(jt - r1) * nb + it - r0;
  nbt::sym_tile_pair_at<R, D>(sj, red, bi, it == jt,
                              part + (size_t(it - r0) * T + jt) * 3 * B,
                              part + oj * 3 * B);
}

// The band's share of a = (sum_u P[t][u]) / (G m), u in order, for
// coordinate c = blockIdx.y of the bodies of tiles t >= r0: rows of the band
// add columns r0..T-1 and are divided; later rows add the band's columns
// r0..r1-1 and keep the sum in `out` for the next band.  Band 0 starts each
// sum at 0.  One thread a body and coordinate: the sums are latency-bound.
__global__ void sym_reduce_kernel(const float* __restrict__ part,
                                  const float* __restrict__ mass, int n, int B,
                                  int r0, int r1, float* __restrict__ out) {
  const int idx = r0 * B + blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int T = n / B, nb = r1 - r0, t = idx / B, l = idx - t * B;
  const int c = blockIdx.y;
  const bool done = t < r1;
  // The row of body idx's tile, from its first column of this band.
  const float* row = done ? part + (size_t(t - r0) * T + r0) * 3 * B
                          : part + (size_t(nb) * T + size_t(t - r1) * nb) * 3 * B;
  float* o = out + size_t(c) * n + idx;
  const float s = nbt::sym_row_sum<kLoads>(row + c * B + l, done ? T - r0 : nb,
                                           B, r0 == 0 ? 0.f : *o);
  *o = done ? nbt::sym_divide(s, mass[idx] * nbt::kG) : s;
}

template <int R, nbt::Dist D>
int sym_accel(const float* pos, const float* mass, int n, int block, int band,
              float* part, float* out, cudaStream_t s) {
  const int T = n / block;
  for (int r0 = 0; r0 < T; r0 += band) {
    const int r1 = std::min(T, r0 + band);
    const long long pairs =
        1LL * (r1 - r0) * T - 1LL * (r0 + r1 - 1) * (r1 - r0) / 2;
    if (pairs > INT_MAX)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    sym_pairs_kernel<R, D><<<static_cast<unsigned>(pairs), block / R,
                             nbt::sym_smem(block, R), s>>>(pos, mass, n, r0,
                                                           r1, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sym_reduce_kernel<<<dim3((n - r0 * block + 255) / 256, 3), 256, 0, s>>>(
        part, mass, n, block, r0, r1, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// pos (3,n), mass (n,) -> out (3,n), fp32 and contiguous.  block: a
// multiple of 32, at most 256, dividing n.  band: i tiles a band, 1..n/block,
// with at most INT_MAX tile pairs (else cudaErrorInvalidConfiguration).
// partials: 3 * block * band * (2 * n / block - band) floats of scratch, a
// band's rows and then its tail.  bf16: the bf16 distance mode.  The wrapper
// checks all of it.  Launches two kernels a band on `stream` without
// synchronising and returns cudaGetLastError() after each launch.
extern "C" int nbt_sym_accel(const float* pos, const float* mass, int n,
                             int block, int band, float* partials, float* out,
                             int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nbt::with_r<nbt::kMaxSymTargets>(
      nbt::sym_targets(block), [&](auto r) {
        constexpr int R = decltype(r)::value;
        return bf16 ? sym_accel<R, nbt::Dist::kBF16>(pos, mass, n, block,
                                                     band, partials, out, s)
                    : sym_accel<R, nbt::Dist::kF32>(pos, mass, n, block, band,
                                                    partials, out, s);
      });
}

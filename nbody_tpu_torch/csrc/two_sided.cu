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
// order and divides.  The CTA body is Kernel B's off-diagonal tile pair
// (nbt::sym_tile_cross) with the i tile taken from the targets and the j
// tile from the sources, so two launches on one input agree bit for bit.
//
// Bands.  The partials take 12 Nt Ns / B bytes a side (1.5 MB a side at
// Nt = Ns = 4096, B = 128), so the target tiles are swept in bands of Q, one
// launch pair a band, within the wrapper's scratch budget: 24 Q Ns bytes.
// A band completes its own targets (P_t of its rows, every source column)
// and adds its Q columns of P_s to every source's running sum, which waits
// in out_s for the next band; the last band divides.  Each sum still adds
// its columns in order, so a banded sweep equals the one-band sweep bit for
// bit.  With Q = Nt / B the layout is the one-band P_t (Tt x Ts) and
// P_s (Ts x Tt).
//
// Inside a CTA: Kernel B's tile body, B / R threads with R targets a lane,
// R = nbt::sym_targets(B) as in Kernel B: 2 where B is a multiple of 64,
// else 1.
//
// Bound.  Compute-bound like Kernel B: 20 FP32 operations, one SFU op
// (nbt::rsqrt_cube), and 3 / R shuffles and 1 / R shared-memory reads per
// pair, Nt Ns pairs; device memory traffic is the partials written once
// and read once.  At its path's shapes a wrapper call takes longer on the
// host than its two kernels on the card (PERF.md).  The kernel is a
// template on R and on the pair deltas' precision (nbt::Dist), f32 or the
// bf16 distance mode.
#include "common.cuh"

namespace {

constexpr nbt::Loads kLoads = nbt::Loads::kFixed;

// Band [r0, r0 + gridDim.y) of target tiles: CTA (x, y) takes tile pair
// (it, jt) = (r0 + y, x).  B = R blockDim.x.
template <int R, nbt::Dist D>
__global__ void two_sided_kernel(const float* __restrict__ pos_t,
                                 const float* __restrict__ mass_t, int nt,
                                 const float* __restrict__ pos_s,
                                 const float* __restrict__ mass_s, int ns,
                                 int r0, float* __restrict__ part_t,
                                 float* __restrict__ part_s) {
  const int B = blockDim.x * R, nb = gridDim.y, Ts = gridDim.x;
  const int r = blockIdx.y, it = r0 + r, jt = blockIdx.x;
  extern __shared__ float4 smem[];
  float4* sj = smem;                                    // the sources, twice
  float* red = reinterpret_cast<float*>(smem + 2 * B);  // [warp][3][B]
  float4 bi[R];
  nbt::sym_load<R, kLoads>(pos_t, mass_t, nt, it * B, pos_s, mass_s, ns,
                           jt * B, sj, bi);
  __syncthreads();
  nbt::sym_tile_cross<R, D>(sj, red, bi,
                            part_t + (size_t(r) * Ts + jt) * 3 * B,
                            part_s + (size_t(jt) * nb + r) * 3 * B);
}

// The band's share of a = (sum_u P[t][u]) / (G m), u in order, for
// coordinate c = blockIdx.y: the band's targets first (complete: every
// source column), then every source, whose running sum over the band's Q
// columns waits in out_s until the last band divides it.  One thread a body
// and coordinate: the sums are latency-bound.
__global__ void two_sided_reduce_kernel(
    const float* __restrict__ part_t, const float* __restrict__ mass_t, int nt,
    const float* __restrict__ part_s, const float* __restrict__ mass_s, int ns,
    int B, int r0, int r1, float* __restrict__ out_t,
    float* __restrict__ out_s) {
  const int nb = r1 - r0, band_n = nb * B, Ts = ns / B, c = blockIdx.y;
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < band_n) {
    const int tgt = r0 * B + idx, r = idx / B, l = idx - r * B;
    const float s = nbt::sym_row_sum<kLoads>(
        part_t + size_t(r) * Ts * 3 * B + c * B + l, Ts, B, 0.f);
    out_t[size_t(c) * nt + tgt] = nbt::sym_divide(s, mass_t[tgt] * nbt::kG);
    return;
  }
  idx -= band_n;
  if (idx >= ns) return;
  const int jt = idx / B, l = idx - jt * B;
  float* o = out_s + size_t(c) * ns + idx;
  const float s = nbt::sym_row_sum<kLoads>(
      part_s + size_t(jt) * nb * 3 * B + c * B + l, nb, B, r0 == 0 ? 0.f : *o);
  *o = r1 * B == nt ? nbt::sym_divide(s, mass_s[idx] * nbt::kG) : s;
}

template <int R, nbt::Dist D>
int two_sided(const float* pos_t, const float* mass_t, int nt,
              const float* pos_s, const float* mass_s, int ns, int block,
              int band, float* part_t, float* part_s, float* out_t,
              float* out_s, cudaStream_t s) {
  const int Tt = nt / block;
  for (int r0 = 0; r0 < Tt; r0 += band) {
    const int r1 = std::min(Tt, r0 + band);
    two_sided_kernel<R, D><<<dim3(ns / block, r1 - r0), block / R,
                             nbt::sym_smem(block, R), s>>>(
        pos_t, mass_t, nt, pos_s, mass_s, ns, r0, part_t, part_s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    two_sided_reduce_kernel<<<dim3(((r1 - r0) * block + ns + 255) / 256, 3),
                              256, 0, s>>>(part_t, mass_t, nt, part_s, mass_s,
                                           ns, block, r0, r1, out_t, out_s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// pos_t (3,nt), mass_t (nt,), pos_s (3,ns), mass_s (ns,) -> out_t (3,nt),
// out_s (3,ns), fp32 and contiguous.  block: a multiple of 32, at most 256,
// dividing nt and ns.  band: target tiles a band, 1..nt/block.  part_t and
// part_s: 3 * block * band * (ns / block) floats of scratch each.  bf16: the
// bf16 distance mode.  The wrapper checks all of it.  Launches two kernels
// a band on `stream` without synchronising and returns cudaGetLastError()
// after each launch.
extern "C" int nbt_two_sided(const float* pos_t, const float* mass_t, int nt,
                             const float* pos_s, const float* mass_s, int ns,
                             int block, int band, float* part_t, float* part_s,
                             float* out_t, float* out_s, int bf16,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nbt::with_r<nbt::kMaxSymTargets>(
      nbt::sym_targets(block), [&](auto r) {
        constexpr int R = decltype(r)::value;
        return bf16 ? two_sided<R, nbt::Dist::kBF16>(
                          pos_t, mass_t, nt, pos_s, mass_s, ns, block, band,
                          part_t, part_s, out_t, out_s, s)
                    : two_sided<R, nbt::Dist::kF32>(
                          pos_t, mass_t, nt, pos_s, mass_s, ns, block, band,
                          part_t, part_s, out_t, out_s, s);
      });
}

// The |r|^2-expansion force sweep (`--kernel pallas_mxu`), fp32 results, its
// second matrix product on the tensor cores (3xTF32 mma.sync).
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
// Design.  A CTA of 8 warps owns tile_i = 16 wt targets: warp w takes the
// 16 targets of group w % wt (the mma's M) and source share w / wt of each
// staged source tile, so ws = 8 / wt warps split the sources.  Thread
// (g, t) = (lane / 4, lane % 4) of a warp computes, for every k-step of 8
// sources, the four pairs (targets g, g + 8) x (sources 2t, 2t + 1):
//
//   d2, on the FP32 pipes: the five nonzero augmented terms in JAX's k
//     order, each product and sum rounded on its own (__fmul_rn/__fadd_rn),
//     so d2 equals the plain PyTorch version's bit for bit; the clamp;
//   w = G m_j y^3 with y = nbt::rsqrt_approx(d2), the SFU's rsqrt alone
//     (a few ulp; Kernel A's Newton step would cost four more FP32
//     operations a pair, about a quarter of the rest, and at the
//     approximation's worst error moves a by under 5e-6 of the 1e-5 the
//     kernel is held to, tests/test_torch_mxu.py);
//   m += w P, P_j = [x, y, z, 1], on the tensor cores: one
//     mma.sync.m16n8k8 .tf32 takes the 16 x 8 tile of w as A and the 8
//     sources' P as B.  The four w of thread (g, t) are its A fragment as
//     they stand (rows g and g + 8; k = t and t + 4) once source 2t sits at
//     k index t and 2t + 1 at t + 4, and the CTA stages B in that k order.
//     3xTF32: w = w_hi + w_lo with w_hi cut to tf32 (the bits the tensor
//     core reads) and w_lo = w - w_hi exactly, and B = [P_hi | P_lo] fills
//     the 8 columns (P_hi rounded to tf32 to nearest, ties away, as
//     cvt.rna, P_lo = P - P_hi likewise; the column of ones is exact).
//     So two mmas a k-step, w_lo B and w_hi B, each into its own
//     accumulator (two chains, so neither mma waits on the other), give m
//     in columns 0-3 (the hi parts) plus 4-7 (the lo parts).  The CTA
//     stages B once per source, in the pass that stages the source tile.
//
// The epilogue's difference cancels (|m| is many times |a|), so the error
// of m shows in a.  The accumulators start from zero every 8 k-steps (64
// sources); each chunk, lo first, goes into a sum of 16 chunks, and that
// into the running m, so no fp32 sum runs long.  The tensor core does not
// round each add to nearest: on the card the kernel is about 8e-6 from the
// plain version at N=2000, twice what tests/test_torch_mxu.py's emulation
// of it (each mma's exact sum cut to fp32) gives.  Sources past Ns add exactly zero to every sum, so a padded
// sweep gives the real targets what the unpadded one gives.  The warps' m
// are added in a fixed order (deterministic) and a = m[0:3] - r m[3] is
// rounded as the plain version rounds it.  Ragged edges are masked:
// sources past Ns are staged as zero mass (w = 0 exactly) and targets past
// Nt compute and are never stored, so Nt and Ns need no padding.
//
// Why d2 is not on the tensor cores.  The kernel must stay within 1e-5 of
// the plain version, whose d2 rounds |r|^2-sized terms: an exact d2 already
// differs from it by 7e-6 (relative norm) at N=2000, and at one 500 x 500
// shard pair a three-way tf32 split of the first product (three mmas, d2
// within an ulp of exact) is 1.5e-5 from it, the three-term split 1.2e-5 at
// N=2000 (tests/test_torch_mxu.py, PERF.md).  So d2 keeps the plain
// version's rounding, and the tensor cores take the second product, whose
// roundings average out.
//
// Bound.  The function's least work puts both K=8 products on the tensor
// cores with a 3xTF32 split, 3 x (16 + 16) = 96 flops a pair at 495 TF32
// TFLOP/s, and about 6 fp32 operations a pair at 67 TFLOP/s: at N=16384,
// N^2 ordered pairs, about 0.052 ms (chip_smoke.py computes it).  This
// design issues about 13 FP32 and INT operations and one SFU op a pair
// (seven for d2, the clamp, two for the cube, the weight, two for the
// split), a shared-memory read and half an mma a pair (a thread's k-step
// is four pairs and two mmas): at one instruction a clock per warp
// scheduler, at most about 8 pairs an SM a clock.
#include "common.cuh"

namespace {

constexpr int kThreads = nbt::kTiledThreads;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;       // targets of a warp: the mma's M
constexpr int kStep = 8;        // sources of a k-step: the mma's K
constexpr int kChunkSteps = 8;  // k-steps an accumulator sums (64 sources)
constexpr int kGroupChunks = 16;  // chunks summed before the running m

// x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// Target i's augmented row B_i as JAX builds it: (x^2 + y^2) + z^2, + eps^2.
struct TargetRow {
  float bx, by, bz, b4;
};

__device__ __forceinline__ TargetRow target_row(float x, float y, float z) {
  return {-2.f * x, -2.f * y, -2.f * z,
          __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                              __fmul_rn(z, z)),
                    nbt::kSoftening2)};
}

// w of one pair: d2 over the five nonzero terms in k order, each rounded
// on its own, the clamp, then G m d2^{-3/2} through the SFU's rsqrt.
__device__ __forceinline__ float pair_weight(const TargetRow& b, float4 p,
                                             float gm) {
  float d2 = __fmul_rn(p.x, b.bx);
  d2 = __fadd_rn(d2, __fmul_rn(p.y, b.by));
  d2 = __fadd_rn(d2, __fmul_rn(p.z, b.bz));
  d2 = __fadd_rn(d2, p.w);
  d2 = __fadd_rn(d2, b.b4);
  const float y = nbt::rsqrt_approx(fmaxf(d2, nbt::kSoftening2));
  return gm * (y * y * y);
}

// c += a b: one 16 x 8 x 8 tf32 product, fp32 accumulate (PTX ISA,
// "Matrix Fragments for mma.m16n8k8", .tf32: a0..a3 hold (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) of A; b0, b1 hold (t, g), (t + 4, g) of B;
// c0..c3 hold (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of C).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
mxu_accel_kernel(const float* __restrict__ pos_t, int nt,
                 const float* __restrict__ pos_s,
                 const float* __restrict__ mass_s, int ns,
                 float* __restrict__ out, int tile_i, int tile_j) {
  extern __shared__ float4 smem[];
  float4* sa = smem;  // tile_j sources: (x, y, z, |r|^2)
  // B fragments: k-step q, lane l = 4 g + t holds (P row of source 8q + 2t,
  // P row of source 8q + 2t + 1) at column g of [P_hi | P_lo].
  float* sb = reinterpret_cast<float*>(sa + tile_j);  // tile_j * 8 floats
  float* sg = sb + tile_j * 8;                        // tile_j G m
  __shared__ float part[kWarps * kRows * 8];  // each warp's m, 8 columns
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wt = tile_i / kRows, ws = kWarps / wt;
  const int group = warp % wt, share = warp / wt, per = tile_j / ws;
  const int i0 = blockIdx.x * tile_i + group * kRows + g;
  TargetRow b[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = min(i0 + 8 * h, nt - 1);  // ragged edge: never stored
    b[h] = target_row(pos_t[i], pos_t[nt + i], pos_t[2 * nt + i]);
  }
  // This chunk's mma accumulators, of the w_lo and the w_hi products; the
  // sum of this group's chunks; the running m.
  float c_lo[4] = {0.f, 0.f, 0.f, 0.f}, c_hi[4] = {0.f, 0.f, 0.f, 0.f};
  float group_m[4] = {0.f, 0.f, 0.f, 0.f}, run[4] = {0.f, 0.f, 0.f, 0.f};
  int chunks = 0;
  auto flush = [&]() {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      group_m[q] = __fadd_rn(group_m[q], __fadd_rn(c_lo[q], c_hi[q]));
      c_lo[q] = c_hi[q] = 0.f;
    }
    if (++chunks == kGroupChunks) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        run[q] = __fadd_rn(run[q], group_m[q]);
        group_m[q] = 0.f;
      }
      chunks = 0;
    }
  };
  int steps = 0;
  for (int j0 = 0; j0 < ns; j0 += tile_j) {
    __syncthreads();  // every thread is done with the previous tile
    for (int k = tid; k < tile_j; k += kThreads) {
      const int j = j0 + k;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      float gm = 0.f;
      if (j < ns) {
        a.x = pos_s[j];
        a.y = pos_s[ns + j];
        a.z = pos_s[2 * ns + j];
        a.w = __fadd_rn(__fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)),
                        __fmul_rn(a.z, a.z));
        gm = mass_s[j] * nbt::kG;
      }
      sa[k] = a;
      sg[k] = gm;
      // Source k's row of B = [P_hi | P_lo], P = [x, y, z, 1], at its lane's
      // place: k-step k / 8, lane 4 col + (k / 2) % 4, half k % 2.
      const float p[3] = {a.x, a.y, a.z};
      float* frag = sb + ((k >> 3) * 32 + ((k >> 1) & 3)) * 2 + (k & 1);
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        const float hi = __uint_as_float(tf32_rna(p[col]));
        frag[8 * col] = hi;
        frag[8 * (col + 4)] = __uint_as_float(tf32_rna(p[col] - hi));
      }
      frag[8 * 3] = 1.f;
      frag[8 * 7] = 0.f;
    }
    __syncthreads();
    const int s1 = (share + 1) * per;
    for (int s = share * per; s < s1;) {
      // The k-steps up to the next flush or the end of the share, with no
      // branch inside, so the compiler interleaves several k-steps' pairs.
      const int n = min(kChunkSteps - steps, (s1 - s) / kStep);
#pragma unroll 4
      for (int step = 0; step < n; ++step, s += kStep) {
        const float4 p0 = sa[s + 2 * t], p1 = sa[s + 2 * t + 1];
        const float2 gm = reinterpret_cast<const float2*>(sg)[(s >> 1) + t];
        const float2 bf =
            reinterpret_cast<const float2*>(sb)[(s / kStep) * 32 + lane];
        const float w[4] = {pair_weight(b[0], p0, gm.x),
                            pair_weight(b[1], p0, gm.x),
                            pair_weight(b[0], p1, gm.y),
                            pair_weight(b[1], p1, gm.y)};
        // w_hi: w cut to tf32 (what the tensor core reads of it); w_lo = w -
        // w_hi exactly, of which it reads the top 11 bits.
        unsigned hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          hi[q] = __float_as_uint(w[q]) & 0xffffe000u;
          lo[q] = __float_as_uint(w[q] - __uint_as_float(hi[q]));
        }
        const unsigned b0 = __float_as_uint(bf.x);
        const unsigned b1 = __float_as_uint(bf.y);
        mma_tf32(c_lo, lo, b0, b1);  // two chains: neither waits on the other
        mma_tf32(c_hi, hi, b0, b1);
      }
      steps += n;
      if (steps == kChunkSteps) {
        flush();
        steps = 0;
      }
    }
  }
  if (steps) flush();
#pragma unroll
  for (int q = 0; q < 4; ++q) run[q] = __fadd_rn(run[q], group_m[q]);
  // Thread (g, t) holds columns 2t, 2t + 1 of its warp's rows g and g + 8.
  float* mine = part + warp * kRows * 8;
  mine[g * 8 + 2 * t] = run[0];
  mine[g * 8 + 2 * t + 1] = run[1];
  mine[(g + 8) * 8 + 2 * t] = run[2];
  mine[(g + 8) * 8 + 2 * t + 1] = run[3];
  __syncthreads();
  const int i = blockIdx.x * tile_i + tid;
  if (tid >= tile_i || i >= nt) return;
  float m[4] = {0.f, 0.f, 0.f, 0.f};
  for (int w = 0; w < ws; ++w) {  // the source shares in order
    const float* row =
        part + ((w * wt + tid / kRows) * kRows + tid % kRows) * 8;
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] += row[q] + row[q + 4];  // hi + lo
  }
  const float x = pos_t[i], y = pos_t[nt + i], z = pos_t[2 * nt + i];
  out[i] = __fsub_rn(m[0], __fmul_rn(x, m[3]));
  out[nt + i] = __fsub_rn(m[1], __fmul_rn(y, m[3]));
  out[2 * nt + i] = __fsub_rn(m[2], __fmul_rn(z, m[3]));
}

}  // namespace

// pos_t (3,nt), pos_s (3,ns), mass_s (ns,) -> out (3,nt), all fp32 and
// contiguous.  tile_i targets per CTA: 16, 32, 64 or 128 (16 a warp of
// targets).  tile_j sources per shared-memory tile: a multiple of 8 times
// the 128 / tile_i warps that split it, at most 2048 (52 bytes a source).
// The wrapper checks both.  Launches on `stream` without synchronising and
// returns the first cudaError_t.
extern "C" int nbt_mxu_accel(const float* pos_t, int nt, const float* pos_s,
                             const float* mass_s, int ns, float* out,
                             int tile_i, int tile_j, void* stream) {
  const size_t smem = size_t(tile_j) * (sizeof(float4) + 4 * sizeof(float2) +
                                        sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mxu_accel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((nt + tile_i - 1) / tile_i);
  mxu_accel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pos_t, nt, pos_s, mass_s, ns, out, tile_i, tile_j);
  return static_cast<int>(cudaGetLastError());
}

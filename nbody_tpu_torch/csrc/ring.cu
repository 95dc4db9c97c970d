// The fused ring: the K-hop source ring of the particle decomposition in one
// kernel launch, fp32.
//
// Replaces nbody_tpu/parallel/ring_kernel.py::_kernel (comm "rdma").  There
// each of K chips runs one kernel: its packed source block [x, y, z, G m]
// goes round a double-buffered ring, each hop's block is streamed by remote
// DMA into the right neighbour's other ring slot while the local pair sweep
// consumes the block in hand, an entry barrier with both neighbours comes
// first, and per-slot "free" semaphores keep a fast neighbour from
// overwriting a slot the slow one still sweeps.  This is a port of that
// protocol, not only of the sum.
//
// Here one launch covers all K shards of one card.  The grid is K groups of
// g CTAs; group k owns shard k's targets and stands in for chip k.  Each
// shard has two ring slots of nl float4 (x, y, z, G m) in device memory,
// reached through a table of slot base pointers, so a later port can point
// them at another card's memory without changing the kernel.  Per group k:
//
//   entry: the group packs its own block into its slot 0; each CTA adds one
//          to ready[k]; the group waits until its own and both neighbours'
//          CTAs have all packed (the entry barrier);
//   hop h: for h < K - 1, the group copies its in-hand slot h % 2 into the
//          right neighbour's slot (h + 1) % 2, split among its CTAs, each of
//          which then adds one to recv[right][h]; for h >= 1 it first waits
//          until the right neighbour has swept that slot at hop h - 1
//          (free[right][h - 1] = g, the WAR guard).  Then every CTA sweeps
//          the in-hand slot for its target tiles (nbt::tiled_source_sweep,
//          Kernel A's source loop: shared-memory staging, R targets a
//          thread, rsqrt_cube), adds one to free[k][h] (when a writer will
//          wait for it), and waits until its next slot is whole
//          (recv[k][h] = g).
//
// Flags are counters in device memory, one per shard and hop, zeroed on the
// stream before each launch: a producer CTA synchronises its threads,
// fences, and adds with release at GPU scope; a consumer's first thread
// spins with an acquire load, and the CTA synchronises.  One counter a hop,
// not one that rises across hops: the CTAs of a group may be at different
// hops (a CTA with fewer target tiles runs ahead), and a shared count of
// g (h + 1) could then be reached before every CTA had finished hop h.
// Data written inside the launch (the slots) is read with ld.global.cg,
// never through L1, which is not coherent across SMs.  A wait that lasts
// over kWaitNs traps (an error at the next synchronise) instead of hanging
// the card.  The launch is cooperative on a grid sized by occupancy, so
// every CTA that a wait depends on is resident; a card that cannot hold K
// CTAs refuses the launch.
//
// Sums.  A CTA that owns one target tile keeps its targets' sums in
// registers across all K hops (the TPU kernel's VMEM-resident out_ref);
// where the tiles outnumber the group's CTAs, a CTA loops over several and
// keeps their sums in the output rows it alone owns.  Either way each sum
// runs over the hops in order and within a hop over the thread rows in
// order, so two launches agree bit for bit.
//
// Bound and cost.  The sweep is Kernel A's (see tiled.cu): compute-bound,
// N^2 ordered pairs in all, about 17 FP32 operations and one SFU op each.
// On one card the slot copies move (K - 1) N * 16 bytes per call that a
// direct read of the owner's block would not: 0.8 MB at N = 16384, K = 4.
// They stay, because they are what a multi-card ring sends over NVLink.
#include "common.cuh"

namespace {

constexpr int kMaxShards = 64;
constexpr long long kWaitNs = 10LL * 1000 * 1000 * 1000;  // 10 s

// Per-shard pointers, passed by value.
struct RingTables {
  const float* pos[kMaxShards];   // (3, nl) targets
  const float* mass[kMaxShards];  // (nl,)
  float* out[kMaxShards];         // (3, nl)
  float4* slots[kMaxShards];      // two slots of nl (x, y, z, G m)
};

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :
               : "l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool first_thread() {
  return threadIdx.x == 0 && threadIdx.y == 0;
}

// Every thread of the CTA is done writing: publish it, one count on *flag.
__device__ __forceinline__ void cta_signal(unsigned* flag) {
  __syncthreads();
  if (first_thread()) {
    __threadfence();
    add_release(flag, 1u);
  }
}

// Wait until *flag >= target; then the CTA may read what was published.
__device__ __forceinline__ void cta_wait(const unsigned* flag,
                                         unsigned target) {
  if (first_thread()) {
    const long long t0 = global_ns();
    while (load_acquire(flag) < target) {
      if (global_ns() - t0 > kWaitNs) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(nbt::kTiledThreads)
ring_kernel(RingTables tab, int K, int nl, int tile_i, int tile_j,
            unsigned* flags) {
  extern __shared__ float4 src[];  // tile_j sources: x, y, z, G*m
  __shared__ float part[3 * nbt::kTiledThreads * R];
  const int g = gridDim.x / K;  // CTAs a group
  const int k = blockIdx.x / g, c = blockIdx.x - k * g;
  const int right = (k + 1) % K, left = (k + K - 1) % K;
  unsigned* ready = flags;                // [K]
  unsigned* recv = flags + K;             // [K][K]: shard, hop
  unsigned* freed = flags + K + K * K;    // [K][K]
  const int tid = threadIdx.x;
  const int tiles = (nl + tile_i - 1) / tile_i;
  const int first = c * nbt::kTiledThreads + tid;  // the group's copy split
  const int stride = g * nbt::kTiledThreads;
  const nbt::TiledThread<R> th(tile_i);
  // Each table entry is read once, here: a dynamic index into kernel
  // parameters would otherwise go through local memory.
  const float* pos = tab.pos[k];
  float* out = tab.out[k];
  float4* mine = tab.slots[k];
  float4* theirs = tab.slots[right];

  // Entry: pack this shard's block into its slot 0, then the barrier.
  for (int j = first; j < nl; j += stride)
    __stcg(mine + j,
           nbt::load_body<nbt::Loads::kFixed>(pos, tab.mass[k], nl, j));
  cta_signal(&ready[k]);
  cta_wait(&ready[k], g);
  if (K > 1) {
    cta_wait(&ready[left], g);
    cta_wait(&ready[right], g);
  }

  const bool one_tile = g == tiles;  // g <= tiles: the launcher's grid
  float3 acc = make_float3(0.f, 0.f, 0.f);
  for (int h = 0; h < K; ++h) {
    const int cur = h & 1, nxt = cur ^ 1;
    const float4* in_hand = mine + size_t(cur) * nl;
    if (h < K - 1) {
      // WAR guard: the right neighbour has swept its slot nxt (hop h - 1).
      if (h >= 1) cta_wait(&freed[right * K + h - 1], g);
      float4* dst = theirs + size_t(nxt) * nl;
      for (int j = first; j < nl; j += stride)
        __stcg(dst + j, __ldcg(in_hand + j));
      cta_signal(&recv[right * K + h]);
    }
    for (int tile = c; tile < tiles; tile += g) {
      float3 t[R], p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // ragged edge: compute, never store
        const int i = min(tile * tile_i + th.target(r), nl - 1);
        t[r] = make_float3(pos[i], pos[nl + i], pos[2 * nl + i]);
      }
      nbt::tiled_source_sweep<R, nbt::Dist::kF32>(
          src, [=](int j) { return __ldcg(in_hand + j); }, nl, tile_j, th, t,
          p);
      const float3 s = nbt::tiled_row_sum(part, th, p);
      const int i = tile * tile_i + tid;
      if (tid < tile_i && i < nl) {
        if (one_tile) {
          acc = h ? make_float3(acc.x + s.x, acc.y + s.y, acc.z + s.z) : s;
        } else {
          out[i] = h ? out[i] + s.x : s.x;
          out[nl + i] = h ? out[nl + i] + s.y : s.y;
          out[2 * nl + i] = h ? out[2 * nl + i] + s.z : s.z;
        }
      }
    }
    // Slot cur is free for the left neighbour's copy at hop h + 1.
    if (h + 1 < K - 1) cta_signal(&freed[k * K + h]);
    if (h < K - 1) cta_wait(&recv[k * K + h], g);
  }
  const int i = c * tile_i + tid;
  if (one_tile && tid < tile_i && i < nl) {
    out[i] = acc.x;
    out[nl + i] = acc.y;
    out[2 * nl + i] = acc.z;
  }
}

}  // namespace

// k shards of nl particles each: pos[s] (3,nl), mass[s] (nl,) -> out[s]
// (3,nl), fp32 and contiguous; slots[s]: 2 * nl float4 of scratch, 16-byte
// aligned; flags: k + 2 k^2 unsigned ints of scratch, zeroed here on
// `stream`.
// The four are host arrays of k device pointers.  tile_i and tile_j as for
// nbt_tiled_accel.  The wrapper checks all of it.  One cooperative launch on
// `stream`, without synchronising; returns the first cudaError_t.
extern "C" int nbt_ring_accel(const float* const* pos, const float* const* mass,
                              float* const* out, float* const* slots, int k,
                              int nl, unsigned* flags, int tile_i, int tile_j,
                              void* stream) {
  if (k < 1 || k > kMaxShards || nl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  RingTables tab{};
  for (int s = 0; s < k; ++s) {
    tab.pos[s] = pos[s];
    tab.mass[s] = mass[s];
    tab.out[s] = out[s];
    tab.slots[s] = reinterpret_cast<float4*>(slots[s]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(flags, 0, (k + 2 * k * k) * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (nl + tile_i - 1) / tile_i;
  return static_cast<int>(nbt::with_targets(tile_i, tile_j, [&](auto r) {
    return nbt::launch_persistent(
        ring_kernel<decltype(r)::value>, k * tiles, k,
        dim3(nbt::kTiledThreads), size_t(tile_j) * sizeof(float4), s, tab, k,
        nl, tile_i, tile_j, flags);
  }));
}

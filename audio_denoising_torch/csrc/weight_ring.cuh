// The weight ring: plan_cell.cuh's small-GEMM scheme fed from shared
// memory, for the fused cell (fused_cell.cu). The fused hop and
// webrtc_hop.cu keep the L2-streaming `gemm` (PERF.md says why).
//
// What it is for: with the weights read from L2 by the threads, each
// thread's chain of dependent weight loads waits out an L2 round trip per
// step, and every block of kTile streams reads every weight (at B = 256
// streams, 128 blocks each read the fused cell's 2.84 MB per step). Here
// the hardware copies the weights into shared memory ahead of use, and
// one copy from L2 feeds a cluster of blocks.
//
// Design, for one block of kTile streams in a cluster of C blocks:
// - The weights do not depend on the activations, so the wrapper
//   (ops/kernels/weight_ring.py) lists them once as a slab schedule: every
//   weight matrix the kernel uses, in the order the kernel consumes them,
//   cut into k-slabs of whole rows. Rows are padded to round4(n) floats,
//   so a slab is one contiguous 16-byte-aligned run of bytes, a multiple
//   of 16 long, and one thread moves it with a 1-D bulk async copy.
// - The slabs stream through a ring of S stages in dynamic shared memory,
//   after the kernel's own layout. The block's last warp is the producer:
//   one thread copies the slabs j = r (mod C) of block r of the cluster,
//   multicast to all C blocks (`cp.async.bulk ... .multicast::cluster`),
//   running ahead of the consumers across matmul boundaries as far as the
//   ring lets it.
// - Each stage has two mbarriers in every block. `full` completes when
//   the slab has landed: the issuer arms it in every block of the cluster
//   (a remote `arrive.expect_tx` with the slab's bytes), and the copy
//   completes the bytes. `empty` counts C x 15 arrivals: each consumer
//   warp of the cluster, once it has read slab j - S from stage s, arrives
//   on `empty` of the block that issues slab j (`mapa` + a remote
//   arrive), which copies slab j after all of them. The remote arrivals
//   carry no cluster-scope release: with one they cost 0.62 us a slab.
// - The consumers (the block's other 15 warps) run plan_cell.cuh's
//   column-quad scheme over the slab in shared memory: a thread owns four
//   output columns of all kTile rows, and narrow matmuls split each slab's
//   rows over ks_n threads per column quad (the schedule cuts slabs of a
//   multiple of 4 ks_n rows, so the splits get the same rows). The
//   partial sums stay in registers across the slabs of a matmul and meet
//   in the scratch in a fixed order (deterministic sums, no atomics). A
//   matmul wider than 4 x 15 x 32 columns keeps its running sums in C.
//   Biases stay __ldg, prefetched into L1 as a matmul starts. Every
//   consumer thread waits on every slab's `full` barrier, so no warp frees
//   a stage ahead of its turn.
// - A wait that lasts seconds traps (the launch then fails and the
//   wrapper raises) instead of hanging the card.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W, B = 256; chip_ab.py):
// the copies. They bring 56 GB/s into each SM at C = 2 (39 at C = 1,
// where 128 SMs pull 5.0 TB/s from L2), so the cell's 2.84 MB take
// 50.5 us with no arithmetic at all, and the arithmetic hides behind
// them but for 8 us; 58.4 us in all against the L2-streaming routine's
// 71. Larger clusters do not fit the 128-block grid in one wave (30
// clusters of 4, 15 of 8 at once), and tile 4 (64 blocks) takes 78 us at
// C = 2, 4 or 8.

#pragma once

#include <cuda_runtime.h>

#include "plan_cell.cuh"

// One slab of the schedule: `rows` whole rows of one weight matrix,
// `bytes` contiguous bytes from `src`. Mirrored by RingSlab in
// ops/kernels/weight_ring.py.
struct AdtSlab {
  const float* src;
  int bytes;
  int rows;
};

// The schedule and the ring's shape; mirrored by RingArgs.
struct AdtRing {
  const AdtSlab* slabs;  // one pass, in the kernel's order of consumption
  int n_slabs;
  int stages;            // S, 2 to 32
  int stage_bytes;       // a multiple of 16, at least the largest slab
  int cluster;           // C: blocks per cluster, 1 to 8
};

namespace {

constexpr int kConsumers = kThreads - 32;  // the last warp is the producer
constexpr int kRingBarrier = 1;            // the consumers' named barrier
constexpr int kMbarriers = 2;              // full and empty per stage
constexpr long long kWatchdogCycles = 1ll << 33;  // about 5 s

using Mbar = unsigned long long;  // an mbarrier's 8 bytes of shared memory

__host__ __device__ inline bool ring_ok(const AdtRing& r) {
  return r.slabs != nullptr && r.n_slabs >= 1 && r.stages >= 2 &&
         r.stages <= 32 &&  // ring_produce keeps a parity bit per stage
         r.stage_bytes >= 16 && r.stage_bytes % 16 == 0 && r.cluster >= 1 &&
         r.cluster <= 8;
}

// Shared memory the ring takes after the kernel's own layout (the layout
// ends 16-byte aligned).
__host__ __device__ inline long long ring_smem_bytes(const AdtRing& r) {
  return (long long)r.stages * (r.stage_bytes + kMbarriers * 8);
}

__device__ __forceinline__ Lanes consumer_lanes() {
  return Lanes{(int)threadIdx.x, kConsumers, kRingBarrier};
}

__device__ __forceinline__ bool is_producer() {
  return threadIdx.x >= kConsumers;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(Mbar* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// An arrival on the barrier at the same offset in block `cta` of the
// cluster.
__device__ __forceinline__ void mbar_arrive_remote(Mbar* bar,
                                                   unsigned cta) {
  asm volatile(
      "{\n\t.reg .b32 remote;\n\t"
      "mapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n\t}"
      ::"r"(smem_u32(bar)), "r"(cta)
      : "memory");
}

// One arrival on the barrier at the same offset in block `cta`, which
// also expects `bytes` more of the phase's copies.
__device__ __forceinline__ void mbar_arrive_expect_remote(Mbar* bar,
                                                          unsigned cta,
                                                          unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b32 remote;\n\t"
      "mapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mbarrier.arrive.expect_tx.shared::cluster.b64 _, "
      "[remote], %2;\n\t}" ::"r"(smem_u32(bar)),
      "r"(cta), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(Mbar* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  long long t0 = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > kWatchdogCycles)
      __trap();
  }
}

// `bytes` from global `src` to `dst` and its barrier `bar` in every block
// of `mask`, at the same offsets as in this block.
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src,
                                                    unsigned bytes,
                                                    Mbar* bar,
                                                    unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;" ::: "memory");
}

// The ring's stages and barriers, laid out from `off` floats into the
// dynamic shared memory.
struct RingSmem {
  float* stage0;
  int stage_floats;
  Mbar* full;
  Mbar* empty;
};

__device__ inline RingSmem ring_smem(const AdtRing& r, float* smem, int off) {
  RingSmem m;
  m.stage0 = smem + off;
  m.stage_floats = r.stage_bytes / 4;
  m.full = reinterpret_cast<Mbar*>(m.stage0 + r.stages * m.stage_floats);
  m.empty = m.full + r.stages;
  return m;
}

// Thread 0 initialises the barriers; a cluster_sync must follow before
// any block of the cluster copies or arrives.
__device__ inline void ring_init(const AdtRing& r, const RingSmem& m) {
  if (threadIdx.x != 0) return;
  for (int s = 0; s < r.stages; ++s) {
    mbar_init(m.full + s, 1);
    mbar_init(m.empty + s, r.cluster * (kConsumers / 32));
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The producer thread: this block's slabs j = rank (mod C) of `passes`
// passes over the schedule. Slab j goes to stage j mod S once every
// consumer warp of the cluster has read slab j - S there.
__device__ void ring_produce(const AdtRing& r, const RingSmem& m,
                             int passes) {
  const int rank = (int)cluster_rank();
  const int C = r.cluster, S = r.stages, n = r.n_slabs;
  const unsigned short mask = (unsigned short)((1u << C) - 1);
  const int total = passes * n;
  unsigned empty_parity = 0;  // bit s: the parity of this block's next wait
  for (int j = rank; j < total; j += C) {
    const int s = j % S;
    const AdtSlab* slab = r.slabs + j % n;
    const unsigned bytes = (unsigned)slab->bytes;
    if (j >= S) {
      mbar_wait(m.empty + s, (empty_parity >> s) & 1);
      empty_parity ^= 1u << s;
    }
    for (int c = 0; c < C; ++c) mbar_arrive_expect_remote(m.full + s, c, bytes);
    bulk_copy_multicast(m.stage0 + (size_t)s * m.stage_floats, slab->src,
                        bytes, m.full + s, mask);
  }
}

// The consumers' side of the ring, as plan_cell's weight source: `run`
// computes one Gemm from the next slabs of the schedule. Every consumer
// thread holds the same position (slab, stage, parity, the block that
// fills the stage next).
struct RingWeights {
  const AdtSlab* __restrict__ slabs;
  int n_slabs;
  int stages;
  int cluster;
  RingSmem m;
  int j;            // the next slab of the pass
  int s;            // its stage
  unsigned parity;  // the phase parity of its `full` barrier
  int refill;       // the block that issues slab j + S, into stage s
  int rows;         // slab j's table entry, loaded a slab ahead
  const float* src;

  __device__ RingWeights(const AdtRing& r, const RingSmem& ms)
      : slabs(r.slabs), n_slabs(r.n_slabs), stages(r.stages),
        cluster(r.cluster), m(ms), j(0), s(0), parity(0),
        refill(r.stages % r.cluster), rows(r.slabs[0].rows),
        src(r.slabs[0].src) {}

  // Calls body(r0, rows, slab) for each slab of the k x round4(n) matrix
  // w, in order, once it is in shared memory; each warp frees each slab
  // after, to the block that refills its stage.
  template <class Body>
  __device__ __forceinline__ void each_slab(const float* w, int k, int ldw,
                                            const Lanes& t, Body&& body) {
    for (int r0 = 0; r0 < k;) {
      const int n_rows = rows;
      if (src != w + (size_t)r0 * ldw) __trap();  // not the walk's order
      j = j + 1 == n_slabs ? 0 : j + 1;
      rows = slabs[j].rows;
      src = slabs[j].src;
      mbar_wait(m.full + s, parity);
      body(r0, n_rows, m.stage0 + (size_t)s * m.stage_floats);
      __syncwarp();
      if ((t.id & 31) == 0) mbar_arrive_remote(m.empty + s, refill);
      r0 += n_rows;
      refill = refill + 1 == cluster ? 0 : refill + 1;
      if (++s == stages) {
        s = 0;
        parity ^= 1;
      }
    }
  }

  __device__ void run(const Gemm& g, const Lanes& t) {
    const int ldw = round4(g.n);
    const int n4 = ldw / 4;
    // the epilogue's biases into L1 while the slabs stream: a line a thread
    if (g.bias != nullptr && t.id * 32 < g.n)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(g.bias + t.id * 32));
    if (n4 > t.n) {
      run_wide(g, t, ldw, n4);
      return;
    }
    // one item (q, ks) a thread; ks_n splits each slab's rows, at least 4
    // a split, with the partial sums within the scratch
    const int ks_n = max(1, min(min(t.n / n4, 4 * kThreads / ldw),
                                (slabs[j].rows + 3) / 4));
    const bool active = t.id < n4 * ks_n;
    const int q = t.id % n4, ks = t.id / n4;
    float acc[kTile][4];
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    auto body = [&](const float* a, int lda) {
      return [&, a, lda](int r0, int rows, const float* slab) {
        if (!active) return;
        const int sub = round4((rows + ks_n - 1) / ks_n);
        const int lo = min(rows, ks * sub), hi = min(rows, lo + sub);
        if (lo < hi)  // rows k of the matrix at slab + (k - r0) ldw
          accumulate<true>(acc, a, lda, slab - (size_t)r0 * ldw, ldw, q,
                           r0 + lo, r0 + hi);
      };
    };
    each_slab(g.w1, g.k1, ldw, t, body(g.a1, g.lda1));
    if (g.a2 != nullptr) each_slab(g.w2, g.k2, ldw, t, body(g.a2, g.lda2));
    if (active) store_item(g, acc, q, ks, ks_n, ldw);
    reduce_partials(g, t, ks_n, ldw);
  }

  // More column quads than threads: a thread owns quads t.id + i t.n and
  // keeps their running sums in C between slabs (k is not split).
  __device__ void run_wide(const Gemm& g, const Lanes& t, int ldw, int n4) {
    bool first = true;
    auto body = [&](const float* a, int lda) {
      return [&, a, lda](int r0, int rows, const float* slab) {
        for (int q = t.id; q < n4; q += t.n) {
          float acc[kTile][4];
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            const float4 v =
                first ? make_float4(0.f, 0.f, 0.f, 0.f)
                      : *reinterpret_cast<const float4*>(g.c + r * g.ldc +
                                                         4 * q);
            acc[r][0] = v.x;
            acc[r][1] = v.y;
            acc[r][2] = v.z;
            acc[r][3] = v.w;
          }
          accumulate<true>(acc, a, lda, slab - (size_t)r0 * ldw, ldw, q, r0,
                           r0 + rows);
#pragma unroll
          for (int r = 0; r < kTile; ++r)
            *reinterpret_cast<float4*>(g.c + r * g.ldc + 4 * q) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
        first = false;
      };
    };
    each_slab(g.w1, g.k1, ldw, t, body(g.a1, g.lda1));
    if (g.a2 != nullptr) each_slab(g.w2, g.k2, ldw, t, body(g.a2, g.lda2));
    for (int q = t.id; q < n4; q += t.n)
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* v = g.c + r * g.ldc + 4 * q + c;
          *v = epilogue(g, *v, 4 * q + c);
        }
  }
};

// Launches `kernel(args)` on ceil(blocks / C) clusters of C blocks of
// kThreads threads with `smem` bytes of dynamic shared memory.
template <class Args>
cudaError_t launch_clusters(void (*kernel)(Args), const Args& args,
                            int blocks, int cluster, size_t smem,
                            cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + cluster - 1) / cluster * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `cluster` blocks of `kernel` the card holds at
// once (cudaOccupancyMaxActiveClusters), or -1 on an error.
template <class Args>
int max_active_clusters(void (*kernel)(Args), int blocks, int cluster,
                        size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + cluster - 1) / cluster * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

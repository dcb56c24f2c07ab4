// The plan cell shared by the port's serving kernels: one step of the
// matrixized GRUUNet2 or MOMO cell (ops/pallas/common.py::plan_cell_math
// in the JAX package; plain PyTorch version
// ops/kernels/common.py::plan_cell_math) for a tile of kTile streams per
// block, on one small-GEMM routine. A delta (MOMO3) plan's level 0 reads
// cat(x, prev): the callers stage the previous feature beside x in d[0],
// which is then 2 n_feat wide, and level 0 is one matmul of depth
// 2 n_feat over W0's rows in their natural order, so the weight ring
// streams W0 as it streams any matrix (JAX splits the product as
// x @ W0[:F] + prev @ W0[F:]; the sums agree to fp32 round-off).
//
// Included by fused_hop.cu, webrtc_hop.cu and (through weight_ring.cuh)
// fused_cell.cu, each a separate shared library: everything here has
// internal linkage.
//
// Design: one block of kThreads threads owns kTile streams and walks the
// cell's matmuls in order, with every activation in dynamic shared memory.
// The weights stay in global memory and are served from the 50 MB L2;
// each block reads each weight once per cell step. All matmuls go through
// `gemm`: a thread owns four output columns for all kTile rows, streams
// those columns of the weight matrix from L2 as float4 loads (neighbouring
// threads read neighbouring columns, so the loads coalesce) and reads the
// activations as float4 broadcasts from shared memory, so each weight load
// feeds 16 kTile FMAs. Narrow stages split k across threads to shorten
// each thread's chain of dependent steps, and add the partial sums in
// shared memory in a fixed order. The epilogue adds the bias and applies
// the stage's activation. Rows past the batch (the ragged edge) compute on
// zeros and are never stored by the callers. `gemm` and `plan_cell` run on
// the whole block, or on a group of its threads (`Lanes`) that waits at a
// named barrier of its own, as webrtc_hop.cu's K-hop kernel runs them on
// kThreads of its threads. `plan_cell` is one walk, parametrised on how
// the weights arrive: `L2Weights` runs `gemm` (the fused hop and the
// WebRTC hop); weight_ring.cuh's `RingWeights` reads them from slabs that
// a producer warp copies into shared memory ahead of use (the fused
// cell).

#pragma once

#include <cuda_runtime.h>

#define ADT_MAX_LEVELS 8

// The plan's matrices, mirrored field by field by PlanArgs in
// ops/kernels/common.py. Rows are padded to round4(columns) floats.
struct AdtPlan {
  const float* down_w[ADT_MAX_LEVELS];  // (down_n[i], down_n[i+1])
  const float* down_b[ADT_MAX_LEVELS];
  const float* reset_w;                 // (n_hidden, 3 n_hidden)
  const float* reset_b;
  const float* up_w[ADT_MAX_LEVELS];    // (up_n[i], up_n[i+1])
  const float* up_s[ADT_MAX_LEVELS];    // (down_n[levels-i], up_n[i+1]) or null
  const float* up_b[ADT_MAX_LEVELS];
  int down_n[ADT_MAX_LEVELS + 1];       // [n_in, level widths..., 3 n_hidden]
  int up_n[ADT_MAX_LEVELS + 1];         // [n_hidden, level widths..., n_feat]
  int levels;
  int n_hidden;
  int delta;  // MOMO3: n_in = 2 n_feat, level 0 reads cat(x, prev)
};

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 2;  // streams per block

enum Epilogue { kNone = 0, kRelu = 1, kLog1p = 2, kLinGain = 3 };

// The threads that run a stage together: this thread's lane, the group's
// size, and the barrier the group waits at: 0 is the whole block
// (__syncthreads), any other id a named barrier of exactly n threads.
struct Lanes {
  int id;
  int n;
  int bar;
};

__device__ __forceinline__ Lanes block_lanes() {
  return Lanes{(int)threadIdx.x, (int)blockDim.x, 0};
}

__device__ __forceinline__ void group_sync(const Lanes& g) {
  if (g.bar == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(g.bar), "r"(g.n) : "memory");
}

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline int take(int* off, int rows, int ld) {
  const int o = *off;
  *off += rows * ld;
  return o;
}

// Offsets (in floats) of the cell's shared-memory buffers; every buffer
// holds kTile rows of a leading dimension rounded up to 4 floats, so each
// row starts 16-byte aligned for float4 reads.
struct CellLayout {
  int ld_n, ld_pp;
  int ld_d[ADT_MAX_LEVELS + 1];
  int d[ADT_MAX_LEVELS + 1];  // d[0] is the cell's input: x, or x | prev
  int gh, hx, hi, pp0, pp1, scratch;
};

// n_feat: the features x and y carry (mel bins, or raw bins).
__host__ __device__ inline bool plan_ok(const AdtPlan& p, int n_feat) {
  return p.levels >= 1 && p.levels <= ADT_MAX_LEVELS &&
         p.down_n[0] == (p.delta ? 2 : 1) * n_feat &&
         p.down_n[p.levels] == 3 * p.n_hidden && p.up_n[0] == p.n_hidden &&
         p.up_n[p.levels] == n_feat;
}

// Lays the cell's buffers out from *off on and advances it.
__host__ __device__ inline void make_cell_layout(const AdtPlan& p,
                                                 CellLayout* l, int* off) {
  l->ld_n = round4(p.n_hidden);
  int widest = 0;
  for (int i = 1; i <= p.levels; ++i)
    widest = p.up_n[i] > widest ? p.up_n[i] : widest;
  l->ld_pp = round4(widest);
  for (int i = 0; i <= p.levels; ++i) {
    l->ld_d[i] = round4(p.down_n[i]);
    l->d[i] = take(off, kTile, l->ld_d[i]);
  }
  l->gh = take(off, kTile, round4(3 * p.n_hidden));
  l->hx = take(off, kTile, l->ld_n);
  l->hi = take(off, kTile, l->ld_n);
  l->pp0 = take(off, kTile, l->ld_pp);
  l->pp1 = take(off, kTile, l->ld_pp);
  l->scratch = take(off, kTile, 4 * kThreads);
}

// C[kTile, n] = epilogue(A1[kTile, k1] @ W1 + A2[kTile, k2] @ W2 + bias);
// A and C in shared memory, W row-major in global memory with rows padded
// to round4(n) floats (the wrapper pads), so a thread reads four columns
// as one float4. A2 may be null. C's rows hold round4(n) floats; the padding
// columns come out as the epilogue of 0.
struct Gemm {
  const float* a1;
  int lda1, k1;
  const float* w1;
  const float* a2;
  int lda2, k2;
  const float* w2;
  int n;
  const float* bias;
  int epi;
  float gain;
  float* c;
  int ldc;
  float* scratch;  // split-K partial sums, 4 * kThreads * kTile floats
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// A row's column quad of W: from global memory through L2 (kShared false)
// or from a slab already in shared memory (weight_ring.cuh).
template <bool kShared>
__device__ __forceinline__ float4 load_w4(const float* p) {
  if (kShared) return *reinterpret_cast<const float4*>(p);
  return ldg4(p);
}

__device__ __forceinline__ void fma_row(float (&acc)[kTile][4],
                                        const float* a, int lda, int k,
                                        float4 w) {
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    const float v = a[r * lda + k];
    acc[r][0] = fmaf(v, w.x, acc[r][0]);
    acc[r][1] = fmaf(v, w.y, acc[r][1]);
    acc[r][2] = fmaf(v, w.z, acc[r][2]);
    acc[r][3] = fmaf(v, w.w, acc[r][3]);
  }
}

// acc[r][c] += sum_{k in [lo, hi)} a[r][k] * w[k][4q + c]
template <bool kShared = false>
__device__ __forceinline__ void accumulate(float (&acc)[kTile][4],
                                           const float* a, int lda,
                                           const float* __restrict__ w,
                                           int ldw, int q, int lo, int hi) {
  const float* wq = w + 4 * q;
  int k = lo;
  for (; k < hi && (k & 3); ++k)
    fma_row(acc, a, lda, k, load_w4<kShared>(wq + (size_t)k * ldw));
#pragma unroll 2
  for (; k + 4 <= hi; k += 4) {
    const float4 w0 = load_w4<kShared>(wq + (size_t)(k + 0) * ldw);
    const float4 w1 = load_w4<kShared>(wq + (size_t)(k + 1) * ldw);
    const float4 w2 = load_w4<kShared>(wq + (size_t)(k + 2) * ldw);
    const float4 w3 = load_w4<kShared>(wq + (size_t)(k + 3) * ldw);
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(a + r * lda + k);
      acc[r][0] = fmaf(v.x, w0.x, acc[r][0]);
      acc[r][1] = fmaf(v.x, w0.y, acc[r][1]);
      acc[r][2] = fmaf(v.x, w0.z, acc[r][2]);
      acc[r][3] = fmaf(v.x, w0.w, acc[r][3]);
      acc[r][0] = fmaf(v.y, w1.x, acc[r][0]);
      acc[r][1] = fmaf(v.y, w1.y, acc[r][1]);
      acc[r][2] = fmaf(v.y, w1.z, acc[r][2]);
      acc[r][3] = fmaf(v.y, w1.w, acc[r][3]);
      acc[r][0] = fmaf(v.z, w2.x, acc[r][0]);
      acc[r][1] = fmaf(v.z, w2.y, acc[r][1]);
      acc[r][2] = fmaf(v.z, w2.z, acc[r][2]);
      acc[r][3] = fmaf(v.z, w2.w, acc[r][3]);
      acc[r][0] = fmaf(v.w, w3.x, acc[r][0]);
      acc[r][1] = fmaf(v.w, w3.y, acc[r][1]);
      acc[r][2] = fmaf(v.w, w3.z, acc[r][2]);
      acc[r][3] = fmaf(v.w, w3.w, acc[r][3]);
    }
  }
  for (; k < hi; ++k)
    fma_row(acc, a, lda, k, load_w4<kShared>(wq + (size_t)k * ldw));
}

__device__ __forceinline__ float epilogue(const Gemm& g, float v, int col) {
  if (g.bias != nullptr && col < g.n) v += __ldg(g.bias + col);
  if (g.epi == kRelu) v = fmaxf(v, 0.f);
  else if (g.epi == kLog1p) v = logf(1.f + v);
  else if (g.epi == kLinGain) v = fmaxf(v, 0.f) * g.gain;
  return v;
}

// A work item's sums: C through the epilogue when k is not split
// (ks_n == 1), else its partial sums into the scratch.
__device__ __forceinline__ void store_item(const Gemm& g,
                                           const float (&acc)[kTile][4],
                                           int q, int ks, int ks_n, int ldw) {
#pragma unroll
  for (int r = 0; r < kTile; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 4 * q + c;
      if (ks_n == 1)
        g.c[r * g.ldc + col] = epilogue(g, acc[r][c], col);
      else
        g.scratch[(ks * kTile + r) * ldw + col] = acc[r][c];
    }
}

// With k split (ks_n > 1): C = epilogue(the partial sums added in the
// order ks = 0, 1, ...), after the group's barrier.
__device__ __forceinline__ void reduce_partials(const Gemm& g, const Lanes& t,
                                                int ks_n, int ldw) {
  if (ks_n > 1) {
    group_sync(t);
    for (int e = t.id; e < kTile * ldw; e += t.n) {
      const int r = e / ldw, col = e % ldw;
      float v = 0.f;
      for (int ks = 0; ks < ks_n; ++ks)
        v += g.scratch[(ks * kTile + r) * ldw + col];
      g.c[r * g.ldc + col] = epilogue(g, v, col);
    }
    group_sync(t);  // the scratch is free for the next gemm
  }
}

// A work item is four output columns (q) for all kTile rows over one of ks_n
// contiguous k ranges of the two sources laid end to end. Narrow stages
// split k (ks_n > 1) until the items fill the block; their partial sums
// meet in shared memory and are added in a fixed order.
__device__ void gemm(const Gemm& g, const Lanes& t) {
  const int ldw = round4(g.n);
  const int n4 = ldw / 4;
  const int ktot = g.k1 + g.k2;
  const int nt = t.n;
  // fewest dependent steps per thread: rounds of items times k per item,
  // with at least 16 k per item and the partial sums within the scratch
  int ks_n = 1;
  int best = 0x7fffffff;
  const int ks_max = max(1, min(ktot / 16, 4 * kThreads / ldw));
  for (int ks = 1; ks <= ks_max; ++ks) {
    const int cost = ((n4 * ks + nt - 1) / nt) * ((ktot + ks - 1) / ks);
    if (cost < best) {
      best = cost;
      ks_n = ks;
    }
  }
  const int chunk = round4((ktot + ks_n - 1) / ks_n);
  const int items = n4 * ks_n;
  for (int it = t.id; it < items; it += nt) {
    const int q = it % n4, ks = it / n4;
    const int lo = ks * chunk, hi = min(ktot, lo + chunk);
    float acc[kTile][4];
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    if (lo < min(hi, g.k1))
      accumulate(acc, g.a1, g.lda1, g.w1, ldw, q, lo, min(hi, g.k1));
    if (g.a2 != nullptr && max(lo, g.k1) < hi)
      accumulate(acc, g.a2, g.lda2, g.w2, ldw, q, max(lo, g.k1) - g.k1,
                    hi - g.k1);
    store_item(g, acc, q, ks, ks_n, ldw);
  }
  reduce_partials(g, t, ks_n, ldw);
}

__device__ __forceinline__ void gemm(const Gemm& g) { gemm(g, block_lanes()); }

__device__ inline Gemm make_gemm(const float* a1, int lda1, int k1,
                                 const float* w1, int n, const float* bias,
                                 int epi, float* c, int ldc, float* scratch) {
  Gemm g;
  g.a1 = a1;
  g.lda1 = lda1;
  g.k1 = k1;
  g.w1 = w1;
  g.a2 = nullptr;
  g.lda2 = 0;
  g.k2 = 0;
  g.w2 = nullptr;
  g.n = n;
  g.bias = bias;
  g.epi = epi;
  g.gain = 1.f;
  g.c = c;
  g.ldc = ldc;
  g.scratch = scratch;
  return g;
}

__device__ inline float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// How the weights reach `gemm` when the threads stream them from L2
// themselves; weight_ring.cuh's RingWeights has them copied into shared
// memory ahead of use. `run` computes one Gemm on the threads `t`.
struct L2Weights {
  __device__ __forceinline__ void run(const Gemm& g, const Lanes& t) {
    gemm(g, t);
  }
};

// One cell step on the threads `t`: reads x (and prev) = smem d[0] and
// hx, leaves hi in smem and returns the buffer holding y (width n_feat,
// leading dimension ld_pp). `w` runs the matmuls in the order
// weight_ring.cuh's slab schedule lists them: down_w[0], reset_w,
// down_w[1..L-1], then up_w[i] and up_s[i] per decoder level.
template <class Weights>
__device__ float* plan_cell(const AdtPlan& a, const CellLayout& l,
                            float* smem, const Lanes& t, Weights& w) {
  const int L = a.levels;
  const int n = a.n_hidden;
  for (int i = 0; i < L; ++i) {
    w.run(make_gemm(smem + l.d[i], l.ld_d[i], a.down_n[i], a.down_w[i],
                      a.down_n[i + 1], a.down_b[i], kRelu, smem + l.d[i + 1],
                      l.ld_d[i + 1], smem + l.scratch), t);
    if (i == 0)  // the reset gate reads only hx: share the first barrier
      w.run(make_gemm(smem + l.hx, l.ld_n, n, a.reset_w, 3 * n, a.reset_b,
                        kRelu, smem + l.gh, round4(3 * n), smem + l.scratch),
           t);
    group_sync(t);
  }
  const float* gx = smem + l.d[L];
  const float* gh = smem + l.gh;
  const int ld_gx = l.ld_d[L];
  const int ld_gh = round4(3 * n);
  for (int e = t.id; e < kTile * n; e += t.n) {
    const int s = e / n, j = e % n;
    const float* x = gx + s * ld_gx;
    const float* h = gh + s * ld_gh;
    const float inputgate = sigmoidf(x[n + j] + h[n + j]);
    const float resetgate = sigmoidf(x[j] + h[j]);
    const float newgate = tanhf(x[2 * n + j] + resetgate * h[2 * n + j]);
    const float hxv = smem[l.hx + s * l.ld_n + j];
    smem[l.hi + s * l.ld_n + j] = newgate + inputgate * (hxv - newgate);
  }
  group_sync(t);
  const float* h = smem + l.hi;
  int ldh = l.ld_n;
  int kh = n;
  float* dst = smem + l.pp0;
  for (int i = 0; i < L; ++i) {
    dst = smem + ((i & 1) ? l.pp1 : l.pp0);
    Gemm g = make_gemm(h, ldh, kh, a.up_w[i], a.up_n[i + 1], a.up_b[i],
                       i != L - 1 ? kRelu : kNone, dst, l.ld_pp,
                       smem + l.scratch);
    if (a.up_s[i] != nullptr) {  // decoder skip: split matmul, no concat
      g.a2 = smem + l.d[L - i];
      g.lda2 = l.ld_d[L - i];
      g.k2 = a.down_n[L - i];
      g.w2 = a.up_s[i];
    }
    w.run(g, t);
    group_sync(t);
    h = dst;
    ldh = l.ld_pp;
    kh = a.up_n[i + 1];
  }
  return dst;
}

__device__ inline float* plan_cell(const AdtPlan& a, const CellLayout& l,
                                   float* smem, const Lanes& t) {
  L2Weights w;
  return plan_cell(a, l, smem, t, w);
}

__device__ __forceinline__ float* plan_cell(const AdtPlan& a,
                                           const CellLayout& l, float* smem) {
  return plan_cell(a, l, smem, block_lanes());
}

}  // namespace

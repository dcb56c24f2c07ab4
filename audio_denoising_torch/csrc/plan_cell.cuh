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
// each thread's chain of dependent steps (`split_ks`, mirrored on the
// host), and add the partial sums in shared memory in a fixed order. A
// block's 512 threads must still share n / 4 x k steps a matmul, so the
// split cannot shorten a wide stage's chain much: at gruunet2-good's
// decoder level 2 (544 x 544) 182 steps against at least 145. Splitting
// k within a warp and adding by shuffles in place of the scratch took the
// fused hop's fp32 single hop from 95 to 179 us on an H100 (PERF.md).
// `gemm` is a template on its row count
// (kTile by default): webrtc_hop.cu runs the matmuls that read no state
// over the three frames of a tile at once, so each weight load feeds
// three times the FMAs. The epilogue adds the bias and applies the
// stage's activation. Rows past the batch (the ragged edge) compute on
// zeros and are never stored by the callers. `gemm` and `plan_cell` run on
// the whole block, or on a group of its threads (`Lanes`) that waits at a
// named barrier of its own, as webrtc_hop.cu's K-hop kernel runs them on
// kThreads of its threads. `plan_cell` is one walk, parametrised on how
// the weights arrive: `L2Weights` runs `gemm` (the fused hop and the
// WebRTC hop); weight_ring.cuh's `RingWeights` reads them from slabs that
// a producer warp copies into shared memory ahead of use (the fused
// cell).
//
// Compute types (the fused hop's three modes, JAX common.py:56-160): the
// walk and `gemm` are templates on the weight element. `float` is the fp32
// path every kernel runs. `bf16_t`: a thread reads a row's four
// columns as one 8-byte load and widens them, rounds each activation to
// bf16 (round to nearest even) and widens it back, and adds the products
// in fp32 by FMA; a product of two bf16 values is exact in fp32, so this
// differs from the plain version only by the order of addition. `i8`
// (W8A8, `gemm_q`): before each matmul the block finds each stream row's
// |max| over the matmul's input (one reduction per input), stages the
// input quantized to int8 in shared memory (sx = |max| / 127, rint(a / sx)
// clipped to +-127, IEEE division: no --use_fast_math), and each thread
// sums int8 x int8 products into int32 with dp4a, four k at a time (its
// four columns' bytes of four weight rows transposed in registers by byte
// permutes). Integer sums are exact in any order. The epilogue
// dequantizes each input's sums with its own row scale and the matrix's
// column scale, acc * sx * scale, and adds them and the bias in the
// plain version's order, with no FMA contraction (__fmul_rn, __fadd_rn),
// so the int8 matmul equals the plain version's whenever the staged
// int8 inputs do. The plan's AdtPlan is the same struct in every mode:
// its pointers carry bf16 or int8 matrices there, and the int8 column
// scales come in a second struct, AdtPlanScales.

#pragma once

#include <cuda_runtime.h>

#define ADT_MAX_LEVELS 8

// The reduced modes' element types: a bf16 value's bits (the top half of
// a float's), and a signed byte.
struct bf16_t {
  unsigned short bits;
};
using i8 = signed char;

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

// The int8 plan's column scale rows, (1, round4(columns)) fp32 each, one
// per matrix of AdtPlan; mirrored by PlanScaleArgs in ops/kernels/common.py.
// The int8 matrices have their rows padded to a multiple of 4 too, and a
// delta plan's level-0 matrix holds its x rows, padded, then its prev
// rows, padded.
struct AdtPlanScales {
  const float* down[ADT_MAX_LEVELS];  // of down_w[i]
  const float* reset;                 // of reset_w
  const float* up[ADT_MAX_LEVELS];    // of up_w[i]
  const float* skip[ADT_MAX_LEVELS];  // of up_s[i], or null
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
// row starts 16-byte aligned for float4 reads. The int8 plan adds the
// staged quantized inputs of one matmul (q) and their row scales (qsx).
struct CellLayout {
  int ld_n, ld_pp;
  int ld_d[ADT_MAX_LEVELS + 1];
  int d[ADT_MAX_LEVELS + 1];  // d[0] is the cell's input: x, or x | prev
  int gh, hx, hi, pp0, pp1, scratch;
  int q, qsx;                 // int8 only; 0 otherwise
};

// n_feat: the features x and y carry (mel bins, or raw bins).
__host__ __device__ inline bool plan_ok(const AdtPlan& p, int n_feat) {
  return p.levels >= 1 && p.levels <= ADT_MAX_LEVELS &&
         p.down_n[0] == (p.delta ? 2 : 1) * n_feat &&
         p.down_n[p.levels] == 3 * p.n_hidden && p.up_n[0] == p.n_hidden &&
         p.up_n[p.levels] == n_feat;
}

// Bytes of one int8 matmul's staged inputs: kTile rows of its first
// input padded to a multiple of 4, then its second.
__host__ __device__ inline int q_bytes(int k1, int k2) {
  return kTile * (round4(k1) + round4(k2));
}

// The most any matmul of the plan stages (a delta level 0 stages x and
// prev apart; a decoder level its input and its skip).
__host__ __device__ inline int plan_q_bytes(const AdtPlan& p) {
  const int L = p.levels;
  int most = q_bytes(p.n_hidden, 0);
  for (int i = 0; i < L; ++i) {
    const int k = p.down_n[i];
    const int b = (i == 0 && p.delta) ? q_bytes(k / 2, k / 2) : q_bytes(k, 0);
    most = b > most ? b : most;
    const int u = q_bytes(p.up_n[i], p.up_s[i] != nullptr ? p.down_n[L - i]
                                                         : 0);
    most = u > most ? u : most;
  }
  return most;
}

// Lays the cell's buffers out from *off on and advances it; `quant` adds
// the int8 plan's staging buffers.
__host__ __device__ inline void make_cell_layout(const AdtPlan& p,
                                                 CellLayout* l, int* off,
                                                 bool quant = false) {
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
  l->q = l->qsx = 0;
  if (quant) {
    l->q = take(off, 1, round4((plan_q_bytes(p) + 3) / 4));
    l->qsx = take(off, 1, round4(2 * kTile));
  }
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
  const float* pre;  // gemm<W, kRows, true>: the sums C starts from
  int ldpre;
  // the int8 plan (gemm_q): the column scale rows of w1 and w2, the
  // staging buffers, and whether the two dequantized inputs are added
  // before the bias (a delta level 0) or the second after it (a skip)
  const float* s1;
  const float* s2;
  i8* q;
  float* qsx;
  int pair_first;
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// A row's four bf16 weights, widened: a bf16 is the top half of a float.
__device__ __forceinline__ float4 ldg4(const bf16_t* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// The activation as the matmul reads it: as it is against fp32 weights,
// rounded to bf16 against bf16 ones.
__device__ __forceinline__ float act(float v, const float*) { return v; }
__device__ __forceinline__ float act(float v, const bf16_t*) {
  // round to nearest even at bf16's 8 significant bits, as
  // cvt.rn.bf16.f32 (and PyTorch's .bfloat16()) round a finite value
  unsigned u = __float_as_uint(v);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}
template <class W>
__device__ __forceinline__ float4 act4(float4 v, const W* w) {
  return make_float4(act(v.x, w), act(v.y, w), act(v.z, w), act(v.w, w));
}

// A row's column quad of W: from global memory through L2 (kShared false)
// or from a slab already in shared memory (weight_ring.cuh, fp32 only).
template <bool kShared>
__device__ __forceinline__ float4 load_w4(const float* p) {
  if (kShared) return *reinterpret_cast<const float4*>(p);
  return ldg4(p);
}
template <bool kShared>
__device__ __forceinline__ float4 load_w4(const bf16_t* p) {
  static_assert(!kShared, "bf16 weights stream from L2");
  return ldg4(p);
}

template <class W, int kRows>
__device__ __forceinline__ void fma_row(float (&acc)[kRows][4],
                                        const float* a, int lda, int k,
                                        float4 w, const W* wt) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float v = act(a[r * lda + k], wt);
    acc[r][0] = fmaf(v, w.x, acc[r][0]);
    acc[r][1] = fmaf(v, w.y, acc[r][1]);
    acc[r][2] = fmaf(v, w.z, acc[r][2]);
    acc[r][3] = fmaf(v, w.w, acc[r][3]);
  }
}

// acc[r][c] += sum_{k in [lo, hi)} a[r][k] * w[k][4q + c] for the kRows
// rows of acc, W float or bf16 (the activation then rounded to bf16)
template <bool kShared = false, class W = float, int kRows = kTile>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][4],
                                           const float* a, int lda,
                                           const W* __restrict__ w,
                                           int ldw, int q, int lo, int hi) {
  const W* wq = w + 4 * q;
  int k = lo;
  for (; k < hi && (k & 3); ++k)
    fma_row(acc, a, lda, k, load_w4<kShared>(wq + (size_t)k * ldw), w);
#pragma unroll 2
  for (; k + 4 <= hi; k += 4) {
    const float4 w0 = load_w4<kShared>(wq + (size_t)(k + 0) * ldw);
    const float4 w1 = load_w4<kShared>(wq + (size_t)(k + 1) * ldw);
    const float4 w2 = load_w4<kShared>(wq + (size_t)(k + 2) * ldw);
    const float4 w3 = load_w4<kShared>(wq + (size_t)(k + 3) * ldw);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 v =
          act4(*reinterpret_cast<const float4*>(a + r * lda + k), w);
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
    fma_row(acc, a, lda, k, load_w4<kShared>(wq + (size_t)k * ldw), w);
}

__device__ __forceinline__ float epilogue(const Gemm& g, float v, int col) {
  if (g.bias != nullptr && col < g.n) v += __ldg(g.bias + col);
  if (g.epi == kRelu) v = fmaxf(v, 0.f);
  else if (g.epi == kLog1p) v = logf(1.f + v);
  else if (g.epi == kLinGain) v = fmaxf(v, 0.f) * g.gain;
  return v;
}

// What the epilogue starts from: 0, or with kPre the row's precomputed
// sum g.pre (then the products are added to it).
template <bool kPre>
__device__ __forceinline__ float start(const Gemm& g, int r, int col) {
  return kPre ? g.pre[r * g.ldpre + col] : 0.f;
}

// A work item's sums: C through the epilogue when k is not split
// (ks_n == 1), else its partial sums into the scratch.
template <bool kPre = false, int kRows>
__device__ __forceinline__ void store_item(const Gemm& g,
                                           const float (&acc)[kRows][4],
                                           int q, int ks, int ks_n, int ldw) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 4 * q + c;
      if (ks_n == 1)
        g.c[r * g.ldc + col] =
            epilogue(g, kPre ? start<kPre>(g, r, col) + acc[r][c] : acc[r][c],
                     col);
      else
        g.scratch[(ks * kRows + r) * ldw + col] = acc[r][c];
    }
}

// With k split (ks_n > 1): C = epilogue(the partial sums added in the
// order ks = 0, 1, ..., to g.pre with kPre), after the group's barrier.
template <int kRows = kTile, bool kPre = false>
__device__ __forceinline__ void reduce_partials(const Gemm& g, const Lanes& t,
                                                int ks_n, int ldw) {
  if (ks_n > 1) {
    group_sync(t);
    for (int e = t.id; e < kRows * ldw; e += t.n) {
      const int r = e / ldw, col = e % ldw;
      float v = start<kPre>(g, r, col);
      for (int ks = 0; ks < ks_n; ++ks)
        v += g.scratch[(ks * kRows + r) * ldw + col];
      g.c[r * g.ldc + col] = epilogue(g, v, col);
    }
    group_sync(t);  // the scratch is free for the next gemm
  }
}

// The number of contiguous k ranges ks_n that `gemm` splits a matmul of n
// columns and depth ktot into on `lanes` threads: the fewest dependent
// steps a thread, rounds of work items times k an item, with at least 16
// k an item and the partial sums within the scratch (at most 4 kThreads
// floats a row); the fewest ranges among equals. It depends on the
// columns, the depth and the lanes only. `gemm` keeps its own copy of the
// loop (calling this one changed the code of webrtc_hop.cu's cell
// kernels); the host reads this one (adt_fused_hop_split_ks), and
// `split_schedule` in ops/kernels/common.py mirrors both.
__host__ __device__ inline int split_ks(int n, int ktot, int lanes) {
  const int ldw = round4(n);
  const int n4 = ldw / 4;
  int ks_n = 1;
  int best = 0x7fffffff;
  const int cap = ktot / 16 < 4 * kThreads / ldw ? ktot / 16
                                                 : 4 * kThreads / ldw;
  const int ks_max = cap > 1 ? cap : 1;
  for (int ks = 1; ks <= ks_max; ++ks) {
    const int cost = ((n4 * ks + lanes - 1) / lanes) * ((ktot + ks - 1) / ks);
    if (cost < best) {
      best = cost;
      ks_n = ks;
    }
  }
  return ks_n;
}

// A work item is four output columns (q) for all kRows rows over one of
// ks_n contiguous k ranges of the two sources laid end to end. Narrow
// stages split k (ks_n > 1) until the items fill the block; their partial
// sums meet in shared memory and are added in a fixed order. W is the
// weight element, float or bf16 (the Gemm's pointers carry it). kRows is
// the rows of A and C (kTile, or webrtc_hop.cu's three frames of a tile):
// rows add accumulators to an item, not steps to its chain, and ks_n
// depends on the columns and the threads only, so a row's sums are added
// in the same order at any kRows; the scratch holds ks_n kRows rows of
// round4(n) floats, at most 4 kThreads kRows. kPre: C = epilogue(g.pre +
// the products), g.pre's rows holding a sum computed before (a decoder
// level's skip product). kTwo = false: the caller has no second source
// (g.a2 null), which the routine then does not compile in.
template <class W = float, int kRows = kTile, bool kPre = false,
          bool kTwo = true>
__device__ void gemm(const Gemm& g, const Lanes& t) {
  const int ldw = round4(g.n);
  const int n4 = ldw / 4;
  const int ktot = g.k1 + g.k2;
  const int nt = t.n;
  // fewest dependent steps per thread: rounds of items times k per item,
  // with at least 16 k per item and the partial sums within the scratch
  // (the rule split_ks states for the host)
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
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    if (lo < min(hi, g.k1))
      accumulate(acc, g.a1, g.lda1, reinterpret_cast<const W*>(g.w1), ldw,
                 q, lo, min(hi, g.k1));
    if (kTwo && g.a2 != nullptr && max(lo, g.k1) < hi)
      accumulate(acc, g.a2, g.lda2, reinterpret_cast<const W*>(g.w2), ldw,
                 q, max(lo, g.k1) - g.k1, hi - g.k1);
    store_item<kPre>(g, acc, q, ks, ks_n, ldw);
  }
  reduce_partials<kRows, kPre>(g, t, ks_n, ldw);
}

template <class W = float>
__device__ __forceinline__ void gemm(const Gemm& g) {
  gemm<W>(g, block_lanes());
}

// -- the int8 plan (W8A8) ---------------------------------------------------

// Stages a matmul's inputs quantized per row: each row's |max| by warp
// shuffles and one pass over the warps' maxima (the order of a max does
// not matter), sx = |max| / 127 (1 for a zero row) into g.qsx[src kTile +
// r], then rint(a / sx) clipped to +-127 into g.q, kTile rows of
// round4(k1) + round4(k2) bytes, zeros past each input's width. Needs
// whole warps; ends at the group's barrier.
__device__ void quantize_inputs(const Gemm& g, const Lanes& t) {
  const int srcs = g.a2 != nullptr ? 2 : 1;
  const int kp1 = round4(g.k1);
  const int kq = kp1 + (srcs == 2 ? round4(g.k2) : 0);
  float mx[2][kTile];
#pragma unroll
  for (int src = 0; src < 2; ++src)
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      float m = 0.f;
      if (src < srcs) {
        const float* a = src ? g.a2 : g.a1;
        const int lda = src ? g.lda2 : g.lda1, k = src ? g.k2 : g.k1;
        for (int i = t.id; i < k; i += t.n)
          m = fmaxf(m, fabsf(a[r * lda + i]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      mx[src][r] = m;
    }
  float* red = g.scratch;  // [warp][src kTile + r]
  const int warp = t.id >> 5, warps = t.n >> 5;
  if ((t.id & 31) == 0)
#pragma unroll
    for (int src = 0; src < 2; ++src)
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        red[warp * 2 * kTile + src * kTile + r] = mx[src][r];
  group_sync(t);
  if (t.id < 2 * kTile) {
    float m = 0.f;
    for (int w = 0; w < warps; ++w) m = fmaxf(m, red[w * 2 * kTile + t.id]);
    g.qsx[t.id] = m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
  }
  group_sync(t);
  for (int e = t.id; e < kTile * kq; e += t.n) {
    const int r = e / kq, i = e % kq;
    const int src = i >= kp1 ? 1 : 0;
    const int k = i - (src ? kp1 : 0);
    float v = 0.f;
    if (k < (src ? g.k2 : g.k1)) {
      const float a = src ? g.a2[r * g.lda2 + k] : g.a1[r * g.lda1 + k];
      v = fminf(fmaxf(rintf(__fdiv_rn(a, g.qsx[src * kTile + r])), -127.f),
                127.f);
    }
    g.q[r * kq + i] = (i8)(int)v;
  }
  group_sync(t);
}

// acc[r][c] += sum_{k in [lo, hi)} q[r][k] * w[k][4q + c] over int8 rows
// of stride kq (staged) and the int8 matrix of row stride ldw bytes; lo
// and hi multiples of 4, the matrix's rows padded to one.
__device__ __forceinline__ void accumulate_q(int (&acc)[kTile][4],
                                             const i8* a, int kq,
                                             const i8* __restrict__ w,
                                             int ldw, int q, int lo, int hi) {
  const i8* wq = w + 4 * q;
#pragma unroll 2
  for (int k = lo; k < hi; k += 4) {
    const int w0 = __ldg(reinterpret_cast<const int*>(wq + (size_t)k * ldw));
    const int w1 =
        __ldg(reinterpret_cast<const int*>(wq + (size_t)(k + 1) * ldw));
    const int w2 =
        __ldg(reinterpret_cast<const int*>(wq + (size_t)(k + 2) * ldw));
    const int w3 =
        __ldg(reinterpret_cast<const int*>(wq + (size_t)(k + 3) * ldw));
    // column c's bytes of rows k..k+3, one word each
    const int t0 = __byte_perm(w0, w1, 0x5140);
    const int t1 = __byte_perm(w2, w3, 0x5140);
    const int t2 = __byte_perm(w0, w1, 0x7362);
    const int t3 = __byte_perm(w2, w3, 0x7362);
    const int c0 = __byte_perm(t0, t1, 0x5410);
    const int c1 = __byte_perm(t0, t1, 0x7632);
    const int c2 = __byte_perm(t2, t3, 0x5410);
    const int c3 = __byte_perm(t2, t3, 0x7632);
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const int v = *reinterpret_cast<const int*>(a + r * kq + k);
      acc[r][0] = __dp4a(v, c0, acc[r][0]);
      acc[r][1] = __dp4a(v, c1, acc[r][1]);
      acc[r][2] = __dp4a(v, c2, acc[r][2]);
      acc[r][3] = __dp4a(v, c3, acc[r][3]);
    }
  }
}

__device__ __forceinline__ float dequant(int acc, float sx, float scale) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), scale);
}

// C[r][col] from each input's integer sum: the plain version's
// acc * sx * scale per input, added with the bias in its order, then the
// stage's activation; padding columns come out as the epilogue of 0.
__device__ __forceinline__ float epilogue_q(const Gemm& g, int acc1,
                                            int acc2, int r, int col) {
  float v = 0.f;
  if (col < g.n) {
    const float d1 = dequant(acc1, g.qsx[r], __ldg(g.s1 + col));
    const float b = g.bias != nullptr ? __ldg(g.bias + col) : 0.f;
    if (g.a2 == nullptr) {
      v = __fadd_rn(d1, b);
    } else {
      const float d2 = dequant(acc2, g.qsx[kTile + r], __ldg(g.s2 + col));
      v = g.pair_first ? __fadd_rn(__fadd_rn(d1, d2), b)
                       : __fadd_rn(__fadd_rn(d1, b), d2);
    }
  }
  if (g.epi == kRelu) v = fmaxf(v, 0.f);
  return v;
}

// The int8 matmul: quantize_inputs, then work items as `gemm` makes them
// (four columns, one of ks_n k ranges of the staged inputs laid end to
// end), an int32 sum per input; k split, the partial sums go to the
// scratch as integers and are added per input before the epilogue. Ends
// at the group's barrier (the staging and the scratch are free again).
__device__ void gemm_q(const Gemm& g, const Lanes& t) {
  quantize_inputs(g, t);
  const int srcs = g.a2 != nullptr ? 2 : 1;
  const int ldw = round4(g.n);
  const int n4 = ldw / 4;
  const int kp1 = round4(g.k1);
  const int kq = kp1 + (srcs == 2 ? round4(g.k2) : 0);
  const i8* w1 = reinterpret_cast<const i8*>(g.w1);
  const i8* w2 = reinterpret_cast<const i8*>(g.w2);
  int ks_n = 1;
  int best = 0x7fffffff;
  const int ks_max = max(1, min(kq / 16, 4 * kThreads / (srcs * ldw)));
  for (int ks = 1; ks <= ks_max; ++ks) {
    const int cost = ((n4 * ks + t.n - 1) / t.n) * ((kq + ks - 1) / ks);
    if (cost < best) {
      best = cost;
      ks_n = ks;
    }
  }
  const int chunk = round4((kq + ks_n - 1) / ks_n);
  int* part = reinterpret_cast<int*>(g.scratch);  // [ks][src][r][col]
  for (int it = t.id; it < n4 * ks_n; it += t.n) {
    const int q = it % n4, ks = it / n4;
    const int lo = ks * chunk, hi = min(kq, lo + chunk);
    int acc[2][kTile][4];
#pragma unroll
    for (int src = 0; src < 2; ++src)
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        acc[src][r][0] = acc[src][r][1] = acc[src][r][2] = acc[src][r][3] = 0;
    if (lo < min(hi, kp1))
      accumulate_q(acc[0], g.q, kq, w1, ldw, q, lo, min(hi, kp1));
    if (srcs == 2 && max(lo, kp1) < hi)
      accumulate_q(acc[1], g.q + kp1, kq, w2, ldw, q, max(lo, kp1) - kp1,
                   hi - kp1);
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * q + c;
        if (ks_n == 1) {
          g.c[r * g.ldc + col] = epilogue_q(g, acc[0][r][c], acc[1][r][c], r,
                                            col);
        } else {
          for (int src = 0; src < srcs; ++src)
            part[((ks * srcs + src) * kTile + r) * ldw + col] =
                acc[src][r][c];
        }
      }
  }
  if (ks_n > 1) {
    group_sync(t);
    for (int e = t.id; e < kTile * ldw; e += t.n) {
      const int r = e / ldw, col = e % ldw;
      int sum[2] = {0, 0};
      for (int ks = 0; ks < ks_n; ++ks)
        for (int src = 0; src < srcs; ++src)
          sum[src] += part[((ks * srcs + src) * kTile + r) * ldw + col];
      g.c[r * g.ldc + col] = epilogue_q(g, sum[0], sum[1], r, col);
    }
  }
  group_sync(t);
}

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
  g.pre = nullptr;
  g.ldpre = 0;
  g.s1 = g.s2 = nullptr;
  g.q = nullptr;
  g.qsx = nullptr;
  g.pair_first = 0;
  return g;
}

__device__ inline float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// How the weights reach `gemm` when the threads stream them from L2
// themselves, as W (float, bf16, or int8 through gemm_q);
// weight_ring.cuh's RingWeights has them copied into shared memory ahead
// of use. `run` computes one Gemm on the threads `t`.
template <class W = float>
struct L2Weights {
  __device__ __forceinline__ void run(const Gemm& g, const Lanes& t) {
    gemm<W>(g, t);
  }
};
template <>
struct L2Weights<i8> {
  __device__ __forceinline__ void run(const Gemm& g, const Lanes& t) {
    gemm_q(g, t);
  }
};

// The int8 plan's part of a Gemm: column scales s1 (and s2), the
// staging buffers; none without scales (fp32, bf16).
__device__ __forceinline__ Gemm with_scales(Gemm g, const CellLayout& l,
                                            float* smem, const float* s1,
                                            const float* s2) {
  if (s1 != nullptr) {
    g.s1 = s1;
    g.s2 = s2;
    g.q = reinterpret_cast<i8*>(smem + l.q);
    g.qsx = smem + l.qsx;
  }
  return g;
}

// One cell step on the threads `t`: reads x (and prev) = smem d[0] and
// hx, leaves hi in smem and returns the buffer holding y (width n_feat,
// leading dimension ld_pp). `w` runs the matmuls in the order
// weight_ring.cuh's slab schedule lists them: down_w[0], reset_w,
// down_w[1..L-1], then up_w[i] and up_s[i] per decoder level. `sc`, the
// int8 plan's column scales, is null in the other modes; with it, a
// delta level 0 is two inputs, x and prev, each quantized with its own
// row scale (JAX common.py:128-136).
template <class Weights>
__device__ float* plan_cell(const AdtPlan& a, const CellLayout& l,
                            float* smem, const Lanes& t, Weights& w,
                            const AdtPlanScales* sc = nullptr) {
  const int L = a.levels;
  const int n = a.n_hidden;
  for (int i = 0; i < L; ++i) {
    Gemm g = make_gemm(smem + l.d[i], l.ld_d[i], a.down_n[i], a.down_w[i],
                       a.down_n[i + 1], a.down_b[i], kRelu, smem + l.d[i + 1],
                       l.ld_d[i + 1], smem + l.scratch);
    if (sc != nullptr) {
      g = with_scales(g, l, smem, sc->down[i], nullptr);
      if (i == 0 && a.delta) {  // x's rows, then prev's, each padded
        const int f = a.down_n[0] / 2;
        g.k1 = g.k2 = f;
        g.a2 = smem + l.d[0] + f;
        g.lda2 = l.ld_d[0];
        g.w2 = reinterpret_cast<const float*>(
            reinterpret_cast<const i8*>(a.down_w[0]) +
            (size_t)round4(f) * round4(a.down_n[1]));
        g.s2 = sc->down[0];
        g.pair_first = 1;
      }
    }
    w.run(g, t);
    if (i == 0)  // the reset gate reads only hx: share the first barrier
      w.run(with_scales(make_gemm(smem + l.hx, l.ld_n, n, a.reset_w, 3 * n,
                                  a.reset_b, kRelu, smem + l.gh,
                                  round4(3 * n), smem + l.scratch),
                        l, smem, sc != nullptr ? sc->reset : nullptr,
                        nullptr),
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
    if (sc != nullptr) g = with_scales(g, l, smem, sc->up[i], sc->skip[i]);
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
  L2Weights<> w;
  return plan_cell(a, l, smem, t, w);
}

__device__ __forceinline__ float* plan_cell(const AdtPlan& a,
                                           const CellLayout& l, float* smem) {
  return plan_cell(a, l, smem, block_lanes());
}

}  // namespace

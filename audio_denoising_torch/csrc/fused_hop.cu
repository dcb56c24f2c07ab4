// The whole streaming serving hop as one CUDA kernel for Hopper (sm_90a).
//
// Replaces audio_denoising_tpu/ops/pallas/fused_hop.py::make_fused_hop's
// single-hop Pallas kernel (`kernel`, fused_hop.py:242), with the cell
// math of ops/pallas/common.py::plan_cell_math as the `plan_cell` routine
// below. This slice covers its fp32, mel-domain form with no SNR gate and
// no delta carry. The plain PyTorch version of the same function is
// FusedHop.reference in audio_denoising_torch/ops/kernels/fused_hop.py.
//
// Per stream and hop: shift the analysis ring, apply the Hann window,
// take the DFT as cos/sin matmuls and the magnitude, project to mel and
// take log(1 + .), run the plan cell (encoder matmuls with ReLU, the
// reset-gate matmul, GRU gating, decoder matmuls with split skips),
// subtract the residual, leaky-ReLU 0.2, exp - 1 clamped at 0, inverse
// mel clamped at 0 times the output gain, reuse the noisy phase by
// scaling the complex bins, inverse DFT, window, overlap-add divided by
// the window envelope, and decay the hidden state.
//
// What bounds it on an H100 (gruunet2-stream16k, B = 256 streams): the
// function needs about 393 MFLOP per hop (plan cell 364 M, mel pair 21 M,
// and the transform and its inverse at real-FFT cost, 2.5 N log2 N each,
// 7.6 M), 5.9 us against 67 TFLOP/s of fp32 FMA, while its bytes (3.0 MB
// of weights without DFT matrices, 3.4 MB of state in and out) over
// 3.35 TB/s are 1.9 us: the hop is bound by fp32 operations. This kernel
// takes the transforms as dense cos/sin matmuls, as the reference does
// (805 MFLOP), so it does about twice the work the bound counts. Parity
// with the reference needs fp32, so the kernel uses FMA, not TF32 tensor
// cores.
//
// Design: one block of 512 threads owns a tile of kTile = 2 streams and
// walks the chain's stages in order, with every activation in dynamic
// shared memory (about 4.6 k floats per stream, plus a split-K scratch of
// 2 k floats per stream). The weights (6.3 MB) stay in global memory and
// are served from the 50 MB L2; each block reads each weight once per
// hop. All 17 matmuls go through one routine (`gemm`): a thread owns four
// output columns for all kTile rows, streams those columns of the weight
// matrix from L2 as float4 loads (neighbouring threads read neighbouring
// columns, so the loads coalesce) and reads the activations as float4
// broadcasts from shared memory, so each weight load feeds 16 kTile FMAs.
// Narrow stages split k across threads to shorten each thread's chain of
// dependent steps, and add the partial sums in shared memory in a fixed
// order. The epilogue adds the bias and applies the stage's activation.
// Rows past the batch (the ragged edge) compute on zeros and are never
// stored.
//
// The tile trades two limits: a larger tile streams fewer weight bytes
// from L2 in all (each block reads all of them), a smaller one gives each
// thread less dependent work. At B = 256 on an H100, tile 2 measured best
// of tiles 1, 2, 4 and 8 (PERF.md); the kernel then pulls about 800 MB per
// hop from L2.

#include <cuda_runtime.h>

#define ADT_MAX_LEVELS 8

// Mirrored field by field by _Args in ops/kernels/fused_hop.py;
// adt_fused_hop_args_size lets the wrapper check the layouts agree.
struct AdtFusedHopArgs {
  const float* ring;   // (B, n_fft) analysis ring
  const float* ola;    // (B, n_fft) synthesis accumulator
  const float* hx;     // (B, n_hidden) cell state
  const float* chunk;  // (B, hop) new samples
  float* ring_out;
  float* ola_out;
  float* hx_out;
  float* out;          // (B, hop)
  const float* cf;     // (n_fft, n_bins) forward DFT, real part
  const float* sf;     // (n_fft, n_bins) forward DFT, imaginary part
  const float* ic;     // (n_bins, n_fft) inverse DFT from the real part
  const float* is_;    // (n_bins, n_fft) inverse DFT from the imaginary part
  const float* mel;    // (n_bins, n_mels)
  const float* imel;   // (n_mels, n_bins)
  const float* win;    // (n_fft,)
  const float* env;    // (hop,) overlap-add envelope
  const float* down_w[ADT_MAX_LEVELS];  // (down_n[i], down_n[i+1])
  const float* down_b[ADT_MAX_LEVELS];
  const float* reset_w;                 // (n_hidden, 3 n_hidden)
  const float* reset_b;
  const float* up_w[ADT_MAX_LEVELS];    // (up_n[i], up_n[i+1])
  const float* up_s[ADT_MAX_LEVELS];    // (down_n[levels-i], up_n[i+1]) or null
  const float* up_b[ADT_MAX_LEVELS];
  int down_n[ADT_MAX_LEVELS + 1];       // [n_mels, level widths..., 3 n_hidden]
  int up_n[ADT_MAX_LEVELS + 1];         // [n_hidden, level widths..., n_mels]
  int levels;
  int batch;
  int n_fft;
  int hop;
  int n_bins;
  int n_mels;
  int n_hidden;
  float output_gain;
  float state_decay;
};

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 2;  // streams per block

enum Epilogue { kNone = 0, kRelu = 1, kLog1p = 2, kLinGain = 3 };

// Offsets (in floats) of the per-block shared-memory buffers; every
// buffer holds kTile rows of a leading dimension rounded up to 4 floats,
// so each row starts 16-byte aligned for float4 reads.
struct Layout {
  int ld_t, ld_f, ld_n, ld_pp;
  int ld_d[ADT_MAX_LEVELS + 1];
  int frame, re, im, mag, lin, hx, hi, gh, pp0, pp1, scratch;
  int d[ADT_MAX_LEVELS + 1];  // d[0] is the mel feature x
  int total;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline int take(int* off, int rows, int ld) {
  const int o = *off;
  *off += rows * ld;
  return o;
}

__host__ __device__ inline void make_layout(const AdtFusedHopArgs& a,
                                            Layout* l) {
  int off = 0;
  l->ld_t = round4(a.n_fft);
  l->ld_f = round4(a.n_bins);
  l->ld_n = round4(a.n_hidden);
  int widest = 0;
  for (int i = 1; i <= a.levels; ++i)
    widest = a.up_n[i] > widest ? a.up_n[i] : widest;
  l->ld_pp = round4(widest);
  l->frame = take(&off, kTile, l->ld_t);
  l->re = take(&off, kTile, l->ld_f);
  l->im = take(&off, kTile, l->ld_f);
  l->mag = take(&off, kTile, l->ld_f);
  l->lin = take(&off, kTile, l->ld_f);
  for (int i = 0; i <= a.levels; ++i) {
    l->ld_d[i] = round4(a.down_n[i]);
    l->d[i] = take(&off, kTile, l->ld_d[i]);
  }
  l->gh = take(&off, kTile, round4(3 * a.n_hidden));
  l->hx = take(&off, kTile, l->ld_n);
  l->hi = take(&off, kTile, l->ld_n);
  l->pp0 = take(&off, kTile, l->ld_pp);
  l->pp1 = take(&off, kTile, l->ld_pp);
  l->scratch = take(&off, kTile, 4 * kThreads);
  l->total = off;
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
__device__ __forceinline__ void accumulate(float (&acc)[kTile][4],
                                           const float* a, int lda,
                                           const float* __restrict__ w,
                                           int ldw, int q, int lo, int hi) {
  const float* wq = w + 4 * q;
  int k = lo;
  for (; k < hi && (k & 3); ++k)
    fma_row(acc, a, lda, k, ldg4(wq + (size_t)k * ldw));
#pragma unroll 2
  for (; k + 4 <= hi; k += 4) {
    const float4 w0 = ldg4(wq + (size_t)(k + 0) * ldw);
    const float4 w1 = ldg4(wq + (size_t)(k + 1) * ldw);
    const float4 w2 = ldg4(wq + (size_t)(k + 2) * ldw);
    const float4 w3 = ldg4(wq + (size_t)(k + 3) * ldw);
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
    fma_row(acc, a, lda, k, ldg4(wq + (size_t)k * ldw));
}

__device__ __forceinline__ float epilogue(const Gemm& g, float v, int col) {
  if (g.bias != nullptr && col < g.n) v += __ldg(g.bias + col);
  if (g.epi == kRelu) v = fmaxf(v, 0.f);
  else if (g.epi == kLog1p) v = logf(1.f + v);
  else if (g.epi == kLinGain) v = fmaxf(v, 0.f) * g.gain;
  return v;
}

// A work item is four output columns (q) for all kTile rows over one of ks_n
// contiguous k ranges of the two sources laid end to end. Narrow stages
// split k (ks_n > 1) until the items fill the block; their partial sums
// meet in shared memory and are added in a fixed order.
__device__ void gemm(const Gemm& g) {
  const int ldw = round4(g.n);
  const int n4 = ldw / 4;
  const int ktot = g.k1 + g.k2;
  const int nt = blockDim.x;
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
  for (int it = threadIdx.x; it < items; it += nt) {
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
  if (ks_n > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * ldw; e += nt) {
      const int r = e / ldw, col = e % ldw;
      float v = 0.f;
      for (int ks = 0; ks < ks_n; ++ks)
        v += g.scratch[(ks * kTile + r) * ldw + col];
      g.c[r * g.ldc + col] = epilogue(g, v, col);
    }
    __syncthreads();  // the scratch is free for the next gemm
  }
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
  return g;
}

__device__ inline float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// The plan cell (common.plan_cell_math): reads x = smem d[0] and hx,
// leaves hi in smem and returns the buffer holding y (width n_mels).
__device__ float* plan_cell(const AdtFusedHopArgs& a, const Layout& l,
                            float* smem) {
  const int L = a.levels;
  const int n = a.n_hidden;
  for (int i = 0; i < L; ++i) {
    gemm(make_gemm(smem + l.d[i], l.ld_d[i], a.down_n[i], a.down_w[i],
                      a.down_n[i + 1], a.down_b[i], kRelu, smem + l.d[i + 1],
                      l.ld_d[i + 1], smem + l.scratch));
    if (i == 0)  // the reset gate reads only hx: share the first barrier
      gemm(make_gemm(smem + l.hx, l.ld_n, n, a.reset_w, 3 * n, a.reset_b,
                        kRelu, smem + l.gh, round4(3 * n), smem + l.scratch));
    __syncthreads();
  }
  const float* gx = smem + l.d[L];
  const float* gh = smem + l.gh;
  const int ld_gx = l.ld_d[L];
  const int ld_gh = round4(3 * n);
  for (int e = threadIdx.x; e < kTile * n; e += blockDim.x) {
    const int s = e / n, j = e % n;
    const float* x = gx + s * ld_gx;
    const float* h = gh + s * ld_gh;
    const float inputgate = sigmoidf(x[n + j] + h[n + j]);
    const float resetgate = sigmoidf(x[j] + h[j]);
    const float newgate = tanhf(x[2 * n + j] + resetgate * h[2 * n + j]);
    const float hxv = smem[l.hx + s * l.ld_n + j];
    smem[l.hi + s * l.ld_n + j] = newgate + inputgate * (hxv - newgate);
  }
  __syncthreads();
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
    gemm(g);
    __syncthreads();
    h = dst;
    ldh = l.ld_pp;
    kh = a.up_n[i + 1];
  }
  return dst;
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_hop_kernel(const __grid_constant__ AdtFusedHopArgs a) {
  extern __shared__ __align__(16) float smem[];
  Layout l;
  make_layout(a, &l);
  const int b0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.batch - b0);
  const int n_fft = a.n_fft, hop = a.hop, F = a.n_bins, M = a.n_mels;
  const int n = a.n_hidden;
  const int keep = n_fft - hop;

  // ring shift + Hann; the cell state comes in beside it
  for (int e = threadIdx.x; e < kTile * n_fft; e += blockDim.x) {
    const int s = e / n_fft, i = e % n_fft;
    float v = 0.f;
    if (s < rows) {
      const size_t b = b0 + s;
      v = i < keep ? a.ring[b * n_fft + i + hop] : a.chunk[b * hop + i - keep];
      a.ring_out[b * n_fft + i] = v;
    }
    smem[l.frame + s * l.ld_t + i] = v * a.win[i];
  }
  for (int e = threadIdx.x; e < kTile * n; e += blockDim.x) {
    const int s = e / n, j = e % n;
    smem[l.hx + s * l.ld_n + j] =
        s < rows ? a.hx[(size_t)(b0 + s) * n + j] : 0.f;
  }
  __syncthreads();

  // DFT as two matmuls, then the magnitude
  gemm(make_gemm(smem + l.frame, l.ld_t, n_fft, a.cf, F, nullptr, kNone,
                    smem + l.re, l.ld_f, smem + l.scratch));
  gemm(make_gemm(smem + l.frame, l.ld_t, n_fft, a.sf, F, nullptr, kNone,
                    smem + l.im, l.ld_f, smem + l.scratch));
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * F; e += blockDim.x) {
    const int o = (e / F) * l.ld_f + e % F;
    const float re = smem[l.re + o], im = smem[l.im + o];
    smem[l.mag + o] = sqrtf(re * re + im * im);
  }
  __syncthreads();

  // x = log(1 + mag @ mel), the model's feature and first skip
  gemm(make_gemm(smem + l.mag, l.ld_f, F, a.mel, M, nullptr, kLog1p,
                    smem + l.d[0], l.ld_d[0], smem + l.scratch));
  __syncthreads();

  float* y = plan_cell(a, l, smem);

  // the new state: hi decayed
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int s = e / n, j = e % n;
    a.hx_out[(size_t)(b0 + s) * n + j] =
        smem[l.hi + s * l.ld_n + j] * a.state_decay;
  }
  // residual: y <- max(exp(leaky_relu(x - y, 0.2)) - 1, 0)
  for (int e = threadIdx.x; e < kTile * M; e += blockDim.x) {
    const int s = e / M, m = e % M;
    float r = smem[l.d[0] + s * l.ld_d[0] + m] - y[s * l.ld_pp + m];
    r = r >= 0.f ? r : 0.2f * r;
    y[s * l.ld_pp + m] = fmaxf(expf(r) - 1.f, 0.f);
  }
  __syncthreads();

  // lin = max(feat @ imel, 0) * gain
  Gemm gl = make_gemm(y, l.ld_pp, M, a.imel, F, nullptr, kLinGain,
                      smem + l.lin, l.ld_f, smem + l.scratch);
  gl.gain = a.output_gain;
  gemm(gl);
  __syncthreads();

  // phase reuse as complex scaling; at mag ~ 0 the bin becomes lin + 0j
  for (int e = threadIdx.x; e < kTile * F; e += blockDim.x) {
    const int o = (e / F) * l.ld_f + e % F;
    const float mag = smem[l.mag + o], lin = smem[l.lin + o];
    const bool safe = mag > 1e-8f;
    const float scale = lin / (safe ? mag : 1.f);
    smem[l.re + o] = safe ? smem[l.re + o] * scale : lin;
    smem[l.im + o] = safe ? smem[l.im + o] * scale : 0.f;
  }
  __syncthreads();

  // inverse DFT from both parts in one accumulation
  Gemm gs = make_gemm(smem + l.re, l.ld_f, F, a.ic, n_fft, nullptr, kNone,
                      smem + l.frame, l.ld_t, smem + l.scratch);
  gs.a2 = smem + l.im;
  gs.lda2 = l.ld_f;
  gs.k2 = F;
  gs.w2 = a.is_;
  gemm(gs);
  __syncthreads();

  // window, overlap-add, divide the finished hop by the envelope
  for (int e = threadIdx.x; e < rows * n_fft; e += blockDim.x) {
    const int s = e / n_fft, i = e % n_fft;
    const size_t b = b0 + s;
    const float* synth = smem + l.frame + s * l.ld_t;
    if (i < hop)
      a.out[b * hop + i] = (a.ola[b * n_fft + i] + synth[i] * a.win[i]) /
                           a.env[i];
    a.ola_out[b * n_fft + i] =
        i < keep ? a.ola[b * n_fft + i + hop] + synth[i + hop] * a.win[i + hop]
                 : 0.f;
  }
}

cudaError_t launch(const AdtFusedHopArgs& a, size_t smem_bytes,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.batch + kTile - 1) / kTile);
  fused_hop_kernel<<<grid, kThreads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int adt_fused_hop_args_size() { return (int)sizeof(AdtFusedHopArgs); }

// Dynamic shared memory one block of kTile streams needs.
long long adt_fused_hop_smem_bytes(const AdtFusedHopArgs* a) {
  Layout l;
  make_layout(*a, &l);
  return (long long)l.total * (long long)sizeof(float);
}

// Launches the hop on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).
int adt_fused_hop(const AdtFusedHopArgs* a, void* stream) {
  if (a->levels < 1 || a->levels > ADT_MAX_LEVELS ||
      a->down_n[a->levels] != 3 * a->n_hidden ||
      a->up_n[a->levels] != a->n_mels || a->n_fft % a->hop != 0)
    return (int)cudaErrorInvalidValue;
  if (a->batch <= 0) return (int)cudaSuccess;
  return (int)launch(*a, (size_t)adt_fused_hop_smem_bytes(a),
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"

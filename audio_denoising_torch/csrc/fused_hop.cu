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
// hop. All 17 matmuls go through the small-GEMM routine of
// plan_cell.cuh (`gemm`, shared with webrtc_hop.cu), which that header
// describes.
//
// The tile trades two limits: a larger tile streams fewer weight bytes
// from L2 in all (each block reads all of them), a smaller one gives each
// thread less dependent work. At B = 256 on an H100, tile 2 measured best
// of tiles 1, 2, 4 and 8 (PERF.md); the kernel then pulls about 800 MB per
// hop from L2.

#include <cuda_runtime.h>

#include "plan_cell.cuh"

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
  AdtPlan plan;
  int batch;
  int n_fft;
  int hop;
  int n_bins;
  int n_mels;
  float output_gain;
  float state_decay;
};

namespace {

// Offsets (in floats) of the per-block shared-memory buffers: the hop's
// own, then the cell's (plan_cell.cuh), each kTile rows of a leading
// dimension rounded up to 4 floats.
struct Layout {
  int ld_t, ld_f;
  int frame, re, im, mag, lin;
  CellLayout cell;
  int total;
};

__host__ __device__ inline void make_layout(const AdtFusedHopArgs& a,
                                            Layout* l) {
  int off = 0;
  l->ld_t = round4(a.n_fft);
  l->ld_f = round4(a.n_bins);
  l->frame = take(&off, kTile, l->ld_t);
  l->re = take(&off, kTile, l->ld_f);
  l->im = take(&off, kTile, l->ld_f);
  l->mag = take(&off, kTile, l->ld_f);
  l->lin = take(&off, kTile, l->ld_f);
  make_cell_layout(a.plan, &l->cell, &off);
  l->total = off;
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_hop_kernel(const __grid_constant__ AdtFusedHopArgs a) {
  extern __shared__ __align__(16) float smem[];
  Layout l;
  make_layout(a, &l);
  const int b0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.batch - b0);
  const int n_fft = a.n_fft, hop = a.hop, F = a.n_bins, M = a.n_mels;
  const int n = a.plan.n_hidden;
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
    smem[l.cell.hx + s * l.cell.ld_n + j] =
        s < rows ? a.hx[(size_t)(b0 + s) * n + j] : 0.f;
  }
  __syncthreads();

  // DFT as two matmuls, then the magnitude
  gemm(make_gemm(smem + l.frame, l.ld_t, n_fft, a.cf, F, nullptr, kNone,
                    smem + l.re, l.ld_f, smem + l.cell.scratch));
  gemm(make_gemm(smem + l.frame, l.ld_t, n_fft, a.sf, F, nullptr, kNone,
                    smem + l.im, l.ld_f, smem + l.cell.scratch));
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * F; e += blockDim.x) {
    const int o = (e / F) * l.ld_f + e % F;
    const float re = smem[l.re + o], im = smem[l.im + o];
    smem[l.mag + o] = sqrtf(re * re + im * im);
  }
  __syncthreads();

  // x = log(1 + mag @ mel), the model's feature and first skip
  gemm(make_gemm(smem + l.mag, l.ld_f, F, a.mel, M, nullptr, kLog1p,
                    smem + l.cell.d[0], l.cell.ld_d[0],
                    smem + l.cell.scratch));
  __syncthreads();

  float* y = plan_cell(a.plan, l.cell, smem);

  // the new state: hi decayed
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int s = e / n, j = e % n;
    a.hx_out[(size_t)(b0 + s) * n + j] =
        smem[l.cell.hi + s * l.cell.ld_n + j] * a.state_decay;
  }
  // residual: y <- max(exp(leaky_relu(x - y, 0.2)) - 1, 0)
  for (int e = threadIdx.x; e < kTile * M; e += blockDim.x) {
    const int s = e / M, m = e % M;
    const int ldy = l.cell.ld_pp;
    float r = smem[l.cell.d[0] + s * l.cell.ld_d[0] + m] - y[s * ldy + m];
    r = r >= 0.f ? r : 0.2f * r;
    y[s * ldy + m] = fmaxf(expf(r) - 1.f, 0.f);
  }
  __syncthreads();

  // lin = max(feat @ imel, 0) * gain
  Gemm gl = make_gemm(y, l.cell.ld_pp, M, a.imel, F, nullptr, kLinGain,
                      smem + l.lin, l.ld_f, smem + l.cell.scratch);
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
                      smem + l.frame, l.ld_t, smem + l.cell.scratch);
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
  if (!plan_ok(a->plan, a->n_mels) || a->n_fft % a->hop != 0)
    return (int)cudaErrorInvalidValue;
  if (a->batch <= 0) return (int)cudaSuccess;
  return (int)launch(*a, (size_t)adt_fused_hop_smem_bytes(a),
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"

// The whole WebRTC serving hop, warm-start Griffin-Lim included, for
// Hopper (sm_90a).
//
// Replaces audio_denoising_tpu/ops/pallas/webrtc_hop.py::make_webrtc_hop's
// single-hop Pallas kernel (`kernel`, webrtc_hop.py:331) in its fp32 form.
// The plain PyTorch version of the same function is WebRTCHop.reference in
// audio_denoising_torch/ops/kernels/webrtc_hop.py.
//
// Per stream and hop (hop = n_fft / 2, so one analysis window holds
// exactly three centered STFT frames): shift the ring; peak-normalize
// (peak > 1e-6); Hann pre-window; the centered reflect-padded 3-frame
// STFT, magnitude, mel and log(1 + .); three sequential plan-cell steps
// carrying hx, each followed by leaky-ReLU 0.2 of the residual, exp - 1
// and a clamp at 0; inverse mel clamped at 0 times the output gain; the
// warm seed (carried phases shifted one frame, the newest frame the last
// one advanced by one hop, which at hop = n_fft / 2 is bin k times
// (-1)^k); n_iter Griffin-Lim rounds (inverse STFT, STFT,
// u = r - m tprev, a = u / (|u| + 1e-16), with tprev = 0 at the start of
// every hop); the final inverse STFT times the peak; emit ola[:hop], then
// shift the OLA buffer and add the frame; decay hx.
//
// What bounds it on an H100 (gruunet2-dari_tult, n_fft 1536, GL-32,
// B = 256): 198 real 1536-point transforms per stream at FFT cost
// (2.5 N log2 N each) plus three plan-cell steps and the mel pair, about
// 12.9 MFLOP per stream, 3.3 GFLOP per hop, 49 us against 67 TFLOP/s of
// fp32; its bytes (state, chunk, output and the 2.85 MB of cell weights)
// are about 20 MB, 6 us at 3.35 TB/s. The hop is bound by operations,
// most of them in the Griffin-Lim transforms. Parity with the reference
// needs fp32, so the kernel uses FMA, not TF32 tensor cores.
//
// Design: three launches on the caller's stream.
// 1. `analysis_kernel`, one block per stream: ring shift, peak, the
//    3-frame STFT as in-kernel FFTs, mel and log1p; writes the features
//    and the peak to scratch.
// 2. `cell_kernel`, one block per kTile streams: the three plan-cell
//    steps on plan_cell.cuh's small-GEMM routine (the weights come from
//    L2, each block reads them once per step), then the residual; writes
//    the mel magnitudes to scratch and hx.
// 3. `gl_kernel`, one block per stream: inverse mel, the warm seed, the
//    Griffin-Lim loop and the synthesis, with the magnitudes, phases,
//    previous rebuilt spectrum and time signal in shared memory (about
//    87 KB at n_fft 1536, so two blocks share an SM).
// The transforms are real FFTs of n_fft points done as complex FFTs of
// n_fft / 2 points (Stockham autosort, radix 4, 2 and 3 passes, ping-pong
// buffers in shared memory) plus the real-input split; the three frames
// of a window are transformed side by side. The inverse drops the
// imaginary parts of the DC and Nyquist bins, as irfft does. Twiddles come
// from a table of e^{-2 pi i t / n_fft} built in float64 by the wrapper.

#include <cuda_runtime.h>

#include "plan_cell.cuh"

// Mirrored field by field by _Args in ops/kernels/webrtc_hop.py;
// adt_webrtc_hop_args_size lets the wrapper check the layouts agree.
struct AdtWebRTCHopArgs {
  const float* ring;    // (B, n_fft) analysis ring
  const float* ola;     // (B, n_fft) synthesis accumulator
  const float* hx;      // (B, n_hidden) cell state
  const float* ang_re;  // (B, 3 n_bins) carried phases, frame t at t n_bins
  const float* ang_im;  // (B, 3 n_bins)
  const float* chunk;   // (B, hop) new samples
  float* ring_out;
  float* ola_out;
  float* hx_out;
  float* ang_re_out;
  float* ang_im_out;
  float* out;           // (B, hop)
  float* feat;          // (B, 3, n_mels) scratch: log-mel features
  float* mel_mag;       // (B, 3, n_mels) scratch: the cell's mel magnitudes
  float* peak;          // (B,) scratch: each window's peak
  const float* win;     // (n_fft,) Hann window
  const float* env;     // (n_fft,) istft envelope over the trim region
  const float* mel;     // (n_bins, n_mels)
  const float* imel;    // (n_mels, n_bins)
  const float2* twiddle;  // (n_fft,) e^{-2 pi i t / n_fft}
  AdtPlan plan;
  int batch;
  int n_fft;
  int hop;
  int n_bins;
  int n_mels;
  int n_iter;
  float momentum;       // m / (1 + m) of the configured momentum m
  float output_gain;
  float state_decay;
};

namespace {

constexpr int kFrames = 3;
constexpr int kFftThreads = 384;
constexpr int kMaxPasses = 16;

// The radices of the complex FFT of m = n_fft / 2 points.
struct FftPlan {
  int m;
  int passes;
  int radix[kMaxPasses];
};

bool make_fft_plan(int m, FftPlan* p) {
  p->m = m;
  p->passes = 0;
  int rest = m;
  while (rest > 1 && p->passes < kMaxPasses) {
    int r = rest % 4 == 0 ? 4 : rest % 2 == 0 ? 2 : rest % 3 == 0 ? 3 : 0;
    if (r == 0) return false;
    p->radix[p->passes++] = r;
    rest /= r;
  }
  return rest == 1;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 conjf2(float2 a) {
  return make_float2(a.x, -a.y);
}

// multiply by -i (forward) or +i (inverse)
template <bool kInverse>
__device__ __forceinline__ float2 rot90(float2 a) {
  return kInverse ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// e^{-+2 pi i q / m} from the n_fft-point table (n_fft = 2 m)
template <bool kInverse>
__device__ __forceinline__ float2 twiddle_m(const float2* tw, int q) {
  const float2 w = __ldg(tw + 2 * q);
  return kInverse ? conjf2(w) : w;
}

// One Stockham pass of radix R over kFrames complex sequences of m points
// laid end to end: in -> out. ns is the product of the earlier passes'
// radices.
template <bool kInverse, int R>
__device__ void fft_pass(const float2* in, float2* out, int m, int ns,
                         const float2* tw) {
  const int stride = m / R;
  const int L = ns * R;
  for (int e = threadIdx.x; e < kFrames * stride; e += blockDim.x) {
    const int f = e / stride, j = e % stride;
    const float2* src = in + f * m;
    float2* dst = out + f * m;
    const int k = j % ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = src[j + r * stride];
      if (r > 0 && k > 0)
        v[r] = cmul(v[r], twiddle_m<kInverse>(tw, k * r * (m / L)));
    }
    if constexpr (R == 2) {
      const float2 a = v[0], b = v[1];
      v[0] = cadd(a, b);
      v[1] = csub(a, b);
    } else if constexpr (R == 4) {
      const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
      const float2 t2 = cadd(v[1], v[3]);
      const float2 t3 = rot90<kInverse>(csub(v[1], v[3]));
      v[0] = cadd(t0, t2);
      v[1] = cadd(t1, t3);
      v[2] = csub(t0, t2);
      v[3] = csub(t1, t3);
    } else {  // R == 3
      const float2 s = cadd(v[1], v[2]);
      const float2 d = rot90<kInverse>(csub(v[1], v[2]));
      const float2 mid = make_float2(v[0].x - 0.5f * s.x, v[0].y - 0.5f * s.y);
      const float c = 0.86602540378443864676f;  // sqrt(3) / 2
      v[0] = cadd(v[0], s);
      v[1] = make_float2(mid.x + c * d.x, mid.y + c * d.y);
      v[2] = make_float2(mid.x - c * d.x, mid.y - c * d.y);
    }
    const int base = (j / ns) * L + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[base + r * ns] = v[r];
  }
  __syncthreads();
}

// Complex FFT (unnormalized) of the kFrames sequences in buf[0]; returns
// the buffer that holds the result (buf[0] or buf[1]).
template <bool kInverse>
__device__ float2* fft(float2* buf0, float2* buf1, const FftPlan& p,
                       const float2* tw) {
  float2* in = buf0;
  float2* out = buf1;
  int ns = 1;
  for (int i = 0; i < p.passes; ++i) {
    if (p.radix[i] == 4)
      fft_pass<kInverse, 4>(in, out, p.m, ns, tw);
    else if (p.radix[i] == 2)
      fft_pass<kInverse, 2>(in, out, p.m, ns, tw);
    else
      fft_pass<kInverse, 3>(in, out, p.m, ns, tw);
    ns *= p.radix[i];
    float2* t = in;
    in = out;
    out = t;
  }
  return in;
}

// Per-stream shared-memory layout of the FFT kernels, in floats.
struct SpecLayout {
  int n_fft, m, F;
  int time;        // n_fft floats: a window in the time domain
  int buf0, buf1;  // kFrames * m float2 each
  int mag, are, aim, tre, tim;  // kFrames * F floats each
  int total;
};

__host__ __device__ inline SpecLayout make_spec_layout(int n_fft, int F,
                                                       bool gl) {
  SpecLayout l;
  l.n_fft = n_fft;
  l.m = n_fft / 2;
  l.F = F;
  int off = 0;
  l.buf0 = off;
  off += 2 * kFrames * l.m;
  l.buf1 = off;
  off += 2 * kFrames * l.m;
  l.time = off;
  off += round4(n_fft);
  l.mag = off;
  off += round4(kFrames * F);
  l.are = l.aim = l.tre = l.tim = off;
  if (gl) {
    l.are = off;
    off += round4(kFrames * F);
    l.aim = off;
    off += round4(kFrames * F);
    l.tre = off;
    off += round4(kFrames * F);
    l.tim = off;
    off += round4(kFrames * F);
  }
  l.total = off;
  return l;
}

// The centered reflect-padded STFT of the window in `time`: each frame
// windowed and packed as m complex points (even samples real, odd
// imaginary), then the forward FFT. Returns the buffer with the result.
__device__ float2* stft3(const AdtWebRTCHopArgs& a, const FftPlan& p,
                         const SpecLayout& l, float* smem) {
  const float* x = smem + l.time;
  float2* buf0 = reinterpret_cast<float2*>(smem + l.buf0);
  const int n_fft = l.n_fft, hop = a.hop, m = l.m;
  for (int e = threadIdx.x; e < kFrames * m; e += blockDim.x) {
    const int t = e / m, q = e % m;
    float s[2];
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * q + h;
      int src;
      if (t == 0)  // [x[hop] .. x[1], x[0] .. x[hop - 1]]
        src = i < hop ? hop - i : i - hop;
      else if (t == 1)
        src = i;
      else  // [x[hop] .. x[n_fft - 1], x[n_fft - 2] .. x[hop - 1]]
        src = i < hop ? i + hop : n_fft + hop - 2 - i;
      s[h] = x[src] * __ldg(a.win + i);
    }
    buf0[e] = make_float2(s[0], s[1]);
  }
  __syncthreads();
  return fft<false>(buf0, reinterpret_cast<float2*>(smem + l.buf1), p,
                    a.twiddle);
}

// Bin k (0 <= k <= m) of the real FFT from the half-length complex FFT Z
// of one frame.
__device__ __forceinline__ float2 real_bin(const float2* Z, int m, int k,
                                           const float2* tw) {
  const float2 zk = Z[k % m];
  const float2 zc = conjf2(Z[(m - k) % m]);
  const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y + zc.y));
  const float2 o = rot90<false>(
      make_float2(0.5f * (zk.x - zc.x), 0.5f * (zk.y - zc.y)));
  return cadd(e, cmul(__ldg(tw + k), o));
}

// The centered inverse STFT of the three frames mag * (are + i aim) into
// `time`: irfft of each frame (imaginary parts of DC and Nyquist
// dropped), window, overlap-add over the trim region [hop, hop + n_fft),
// divide by the envelope.
__device__ void istft3(const AdtWebRTCHopArgs& a, const FftPlan& p,
                       const SpecLayout& l, float* smem) {
  float2* buf0 = reinterpret_cast<float2*>(smem + l.buf0);
  const float* mag = smem + l.mag;
  const float* are = smem + l.are;
  const float* aim = smem + l.aim;
  const int m = l.m, F = l.F, n_fft = l.n_fft, hop = a.hop;
  for (int e = threadIdx.x; e < kFrames * m; e += blockDim.x) {
    const int t = e / m, k = e % m;
    const int o = t * F;
    float2 xk = make_float2(mag[o + k] * are[o + k], mag[o + k] * aim[o + k]);
    float2 xc = make_float2(mag[o + m - k] * are[o + m - k],
                            -mag[o + m - k] * aim[o + m - k]);
    if (k == 0) {
      xk.y = 0.f;
      xc.y = 0.f;
    }
    const float2 ev = cadd(xk, xc);
    const float2 od = cmul(csub(xk, xc), conjf2(__ldg(a.twiddle + k)));
    buf0[e] = cadd(ev, rot90<true>(od));
  }
  __syncthreads();
  const float* fr = reinterpret_cast<const float*>(
      fft<true>(buf0, reinterpret_cast<float2*>(smem + l.buf1), p,
                a.twiddle));
  const float scale = 1.f / (float)n_fft;
  float* x = smem + l.time;
  for (int j = threadIdx.x; j < n_fft; j += blockDim.x) {
    float v;
    if (j < hop)
      v = fr[j + hop] * __ldg(a.win + j + hop) +
          fr[n_fft + j] * __ldg(a.win + j);
    else
      v = fr[n_fft + j] * __ldg(a.win + j) +
          fr[2 * n_fft + j - hop] * __ldg(a.win + j - hop);
    x[j] = v * scale / __ldg(a.env + j);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kFftThreads)
    analysis_kernel(const __grid_constant__ AdtWebRTCHopArgs a,
                    const __grid_constant__ FftPlan p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kFftThreads];
  const SpecLayout l = make_spec_layout(a.n_fft, a.n_bins, false);
  const size_t b = blockIdx.x;
  const int n_fft = a.n_fft, hop = a.hop, keep = n_fft - hop;
  const int F = a.n_bins, M = a.n_mels;
  float* x = smem + l.time;

  // ring shift and the window's peak
  float peak = 0.f;
  for (int i = threadIdx.x; i < n_fft; i += blockDim.x) {
    const float v = i < keep ? a.ring[b * n_fft + i + hop]
                             : a.chunk[b * hop + i - keep];
    a.ring_out[b * n_fft + i] = v;
    x[i] = v;
    peak = fmaxf(peak, fabsf(v));
  }
  red[threadIdx.x] = peak;
  __syncthreads();
  int half = 1;
  while (2 * half < (int)blockDim.x) half *= 2;
  for (int s = half; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s && (int)threadIdx.x + s < (int)blockDim.x)
      red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  const bool ok = red[0] > 1e-6f;
  peak = ok ? red[0] : 1.f;
  if (threadIdx.x == 0) a.peak[b] = peak;
  // normalize and pre-window
  for (int i = threadIdx.x; i < n_fft; i += blockDim.x)
    x[i] = (ok ? x[i] / peak : x[i]) * __ldg(a.win + i);
  __syncthreads();

  const float2* Z = stft3(a, p, l, smem);
  float* mag = smem + l.mag;
  for (int e = threadIdx.x; e < kFrames * F; e += blockDim.x) {
    const int t = e / F, k = e % F;
    const float2 v = real_bin(Z + t * l.m, l.m, k, a.twiddle);
    mag[e] = sqrtf(v.x * v.x + v.y * v.y);
  }
  __syncthreads();

  // feat = log(1 + mag @ mel), k split over `split` partial sums
  const int outs = kFrames * M;
  const int split = max(1, min((int)blockDim.x / outs, kFftThreads / outs));
  const int chunk = (F + split - 1) / split;
  for (int e = threadIdx.x; e < outs * split; e += blockDim.x) {
    const int s = e / outs, o = e % outs;
    const int t = o / M, mm = o % M;
    const int lo = s * chunk, hi = min(F, lo + chunk);
    float acc = 0.f;
    for (int k = lo; k < hi; ++k)
      acc = fmaf(mag[t * F + k], __ldg(a.mel + (size_t)k * M + mm), acc);
    red[e] = acc;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < outs; o += blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < split; ++s) v += red[s * outs + o];
    a.feat[b * outs + o] = logf(1.f + v);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    cell_kernel(const __grid_constant__ AdtWebRTCHopArgs a) {
  extern __shared__ __align__(16) float smem[];
  CellLayout l;
  int off = 0;
  make_cell_layout(a.plan, &l, &off);
  const int b0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.batch - b0);
  const int M = a.n_mels, n = a.plan.n_hidden;

  for (int e = threadIdx.x; e < kTile * n; e += blockDim.x) {
    const int s = e / n, j = e % n;
    smem[l.hx + s * l.ld_n + j] =
        s < rows ? a.hx[(size_t)(b0 + s) * n + j] : 0.f;
  }
  for (int t = 0; t < kFrames; ++t) {
    for (int e = threadIdx.x; e < kTile * M; e += blockDim.x) {
      const int s = e / M, mm = e % M;
      smem[l.d[0] + s * l.ld_d[0] + mm] =
          s < rows ? a.feat[((size_t)(b0 + s) * kFrames + t) * M + mm] : 0.f;
    }
    __syncthreads();
    const float* y = plan_cell(a.plan, l, smem);
    // mel magnitude: max(exp(leaky_relu(x - y, 0.2)) - 1, 0)
    for (int e = threadIdx.x; e < rows * M; e += blockDim.x) {
      const int s = e / M, mm = e % M;
      float r = smem[l.d[0] + s * l.ld_d[0] + mm] - y[s * l.ld_pp + mm];
      r = r >= 0.f ? r : 0.2f * r;
      a.mel_mag[((size_t)(b0 + s) * kFrames + t) * M + mm] =
          fmaxf(expf(r) - 1.f, 0.f);
    }
    // hi is the next step's hx
    for (int e = threadIdx.x; e < kTile * n; e += blockDim.x) {
      const int s = e / n, j = e % n;
      smem[l.hx + s * l.ld_n + j] = smem[l.hi + s * l.ld_n + j];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int s = e / n, j = e % n;
    a.hx_out[(size_t)(b0 + s) * n + j] =
        smem[l.hx + s * l.ld_n + j] * a.state_decay;
  }
}

__global__ void __launch_bounds__(kFftThreads, 2)
    gl_kernel(const __grid_constant__ AdtWebRTCHopArgs a,
              const __grid_constant__ FftPlan p) {
  extern __shared__ __align__(16) float smem[];
  const SpecLayout l = make_spec_layout(a.n_fft, a.n_bins, true);
  const size_t b = blockIdx.x;
  const int n_fft = a.n_fft, hop = a.hop, F = a.n_bins, M = a.n_mels;
  const int nb = kFrames * F;
  float* mag = smem + l.mag;
  float* are = smem + l.are;
  float* aim = smem + l.aim;
  float* tre = smem + l.tre;
  float* tim = smem + l.tim;

  // inverse mel: the target magnitudes, from the mel magnitudes staged
  // in the time buffer
  float* mm = smem + l.time;
  for (int e = threadIdx.x; e < kFrames * M; e += blockDim.x)
    mm[e] = a.mel_mag[b * kFrames * M + e];
  __syncthreads();
  for (int e = threadIdx.x; e < nb; e += blockDim.x) {
    const int t = e / F, k = e % F;
    float acc = 0.f;
    for (int j = 0; j < M; ++j)
      acc = fmaf(mm[t * M + j], __ldg(a.imel + (size_t)j * F + k), acc);
    mag[e] = fmaxf(acc, 0.f) * a.output_gain;
  }
  // warm seed: shift one frame; the newest is the last advanced one hop
  for (int e = threadIdx.x; e < nb; e += blockDim.x) {
    const int t = e / F, k = e % F;
    const size_t src = b * nb + (t < kFrames - 1 ? e + F : e);
    const float sign = (t == kFrames - 1 && (k & 1)) ? -1.f : 1.f;
    are[e] = sign * a.ang_re[src];
    aim[e] = sign * a.ang_im[src];
    tre[e] = 0.f;
    tim[e] = 0.f;
  }
  __syncthreads();

  for (int it = 0; it < a.n_iter; ++it) {
    istft3(a, p, l, smem);
    const float2* Z = stft3(a, p, l, smem);
    for (int e = threadIdx.x; e < nb; e += blockDim.x) {
      const int t = e / F, k = e % F;
      const float2 r = real_bin(Z + t * l.m, l.m, k, a.twiddle);
      const float ur = r.x - a.momentum * tre[e];
      const float ui = r.y - a.momentum * tim[e];
      const float nrm = sqrtf(ur * ur + ui * ui) + 1e-16f;
      are[e] = ur / nrm;
      aim[e] = ui / nrm;
      tre[e] = r.x;
      tim[e] = r.y;
    }
    __syncthreads();
  }
  istft3(a, p, l, smem);

  const float peak = a.peak[b];
  const float* frame = smem + l.time;
  for (int i = threadIdx.x; i < n_fft; i += blockDim.x) {
    const float prev = a.ola[b * n_fft + i];
    if (i < hop) a.out[b * hop + i] = prev;
    const float shifted = i < n_fft - hop ? a.ola[b * n_fft + i + hop] : 0.f;
    a.ola_out[b * n_fft + i] = shifted + frame[i] * peak;
  }
  for (int e = threadIdx.x; e < nb; e += blockDim.x) {
    a.ang_re_out[b * nb + e] = are[e];
    a.ang_im_out[b * nb + e] = aim[e];
  }
}

size_t spec_bytes(const AdtWebRTCHopArgs& a, bool gl) {
  return (size_t)make_spec_layout(a.n_fft, a.n_bins, gl).total *
         sizeof(float);
}

size_t cell_bytes(const AdtWebRTCHopArgs& a) {
  CellLayout l;
  int off = 0;
  make_cell_layout(a.plan, &l, &off);
  return (size_t)off * sizeof(float);
}

bool args_ok(const AdtWebRTCHopArgs& a, FftPlan* p) {
  return plan_ok(a.plan, a.n_mels) && a.n_fft == 2 * a.hop &&
         a.n_bins == a.hop + 1 && a.n_iter >= 0 &&
         kFrames * a.n_mels <= a.n_fft &&
         kFrames * a.n_mels <= kFftThreads && make_fft_plan(a.hop, p);
}

cudaError_t launch(const AdtWebRTCHopArgs& a, const FftPlan& p,
                   cudaStream_t stream) {
  const size_t sa = spec_bytes(a, false), sc = cell_bytes(a),
               sg = spec_bytes(a, true);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(analysis_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sa)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(cell_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sc)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(gl_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sg)) != cudaSuccess)
    return err;
  analysis_kernel<<<a.batch, kFftThreads, sa, stream>>>(a, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cell_kernel<<<(a.batch + kTile - 1) / kTile, kThreads, sc, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gl_kernel<<<a.batch, kFftThreads, sg, stream>>>(a, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int adt_webrtc_hop_args_size() { return (int)sizeof(AdtWebRTCHopArgs); }

// The largest dynamic shared memory one block of the three kernels needs;
// -1 if the arguments are not ones the kernels take.
long long adt_webrtc_hop_smem_bytes(const AdtWebRTCHopArgs* a) {
  FftPlan p;
  if (!args_ok(*a, &p)) return -1;
  size_t most = spec_bytes(*a, true);
  if (cell_bytes(*a) > most) most = cell_bytes(*a);
  return (long long)most;
}

// Launches the hop on `stream` without synchronising; returns the first
// failing launch's cudaError_t (0 on success).
int adt_webrtc_hop(const AdtWebRTCHopArgs* a, void* stream) {
  FftPlan p;
  if (!args_ok(*a, &p)) return (int)cudaErrorInvalidValue;
  if (a->batch <= 0) return (int)cudaSuccess;
  return (int)launch(*a, p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

// The whole WebRTC serving hop, warm-start Griffin-Lim included, for
// Hopper (sm_90a): one hop per call, or K hops per call with the state
// resident on the card.
//
// Replaces two Pallas kernels of audio_denoising_tpu/ops/pallas/
// webrtc_hop.py::make_webrtc_hop in their fp32 form and their bf16
// Griffin-Lim mode: the single-hop `kernel` (webrtc_hop.py:331) and the
// resident multi-hop `kernel_multi` (webrtc_hop.py:344). The plain
// PyTorch version of the same function is WebRTCHop.reference (one hop)
// and WebRTCHop.plain (a call) in
// audio_denoising_torch/ops/kernels/webrtc_hop.py.
//
// The bf16 GL mode (AdtWebRTCHopArgs.gl_bf16; JAX webrtc_hop.py:144,
// :305-318) rounds each Griffin-Lim round's transform inputs to bf16,
// where JAX's single bf16 matmul pass rounds its activations: the
// inverse STFT's bins mag * phase times the irfft's bin weight (2 / n_fft,
// 1 / n_fft at DC and Nyquist), then unweighted exactly, and the time
// signal the forward STFT reads. The FFTs keep fp32 twiddles and sums (JAX
// also rounds its window-folded DFT matrices); the analysis, the cell and
// the final synthesis are the fp32 mode's. The Griffin-Lim stage reads the
// flag once and runs the loop of its mode (`gl_rounds<kM, kBf16>`), so the
// fp32 mode's loop is the code it was before the flag existed.
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
// most of them in the Griffin-Lim transforms; K hops in one call move the
// weights and the state once, so the call stays bound by operations.
// Parity with the reference needs fp32, so the kernels use FMA, not TF32
// tensor cores.
//
// The hop runs as three stages, each a device function kept out of line so
// that every entry point runs the same instructions, with the same lanes
// per stream; K hops in one call therefore equal K single hops bit for bit
// (warm Griffin-Lim on trained weights is chaotic, so any other rounding
// would part ways within a few hops):
// 1. `analysis_stage`, fft_threads(M) lanes per stream: ring shift, peak,
//    the 3-frame STFT as in-kernel FFTs, mel and log1p; the features and
//    the peak.
// 2. `cell_stage`, kThreads lanes per tile of kTile streams: the three
//    plan-cell steps on plan_cell.cuh's small-GEMM routine (the weights
//    come from L2), each followed by the residual; the mel magnitudes and
//    hx. The three steps read 2.84 MB of gruunet2-dari_tult's weights
//    each, and the 128 tiles of 256 streams pulled them from L2 at about
//    5 TB/s, which bound the launch. The matmuls that read no state run
//    once for the three frames (`cell_stage_frames`, the batched walk):
//    the encoder chain reads only the frame's features and the decoder's
//    skip products only encoder activations (JAX computes the three
//    frames' features before any cell runs, webrtc_hop.py:283-290), so
//    they run over 3 kTile rows per weight load, two thirds of the plan's
//    bytes; then frame by frame the reset gate, the GRU update and each
//    decoder level's h @ up_w added to its skip product. A tile then reads
//    1.87 + 3 x 0.97 MB a hop in place of 3 x 2.84, and the launch took
//    145 us against 210 on an H100 (PERF.md, PR 24). Its buffers are
//    larger; where they do not fit a block in both entry points (plans
//    wider than hidden 17, the 128-mel plans) the host picks the
//    per-frame walk (`cell_stage`, the plan cell three times), in both
//    entry points, by AdtWebRTCHopArgs.cell_batched; the single hop
//    launches `cell_kernel<true>` or `<false>`.
// 3. `gl_stage`, fft_threads(M) lanes per stream: inverse mel, the warm
//    seed, the Griffin-Lim loop and the synthesis, with the magnitudes,
//    phases, previous rebuilt spectrum and time signal in shared memory
//    (about 89 KB at n_fft 1536).
// One hop per call is three launches on the caller's stream, one per
// stage (`analysis_kernel`, `cell_kernel`, `gl_kernel`), with the features,
// mel magnitudes and peaks in scratch. K hops per call are one launch of
// `webrtc_hop_multi_kernel`: a block of kTile * fft_threads(M) threads
// owns a tile of kTile streams (one block per SM at n_fft 1536, about 210
// KB of shared memory); it loads the tile's ring, OLA buffer, hx and both
// phase planes into shared memory once, runs the three stages K times
// (with L = fft_threads(M), threads [L s, L (s + 1)) run stream s's
// transforms and wait at a named barrier of their own; the first kThreads
// run the cell, whose buffers alias stream 0's transform buffers),
// reading chunk k of
// (K, B, hop) and writing output k, and stores the state once: the
// counterpart of the Pallas kernel's VMEM scratch carried across its K
// grid steps. A ragged last tile leaves its missing stream's lanes idle.
// The transforms are real FFTs of n_fft points done as complex FFTs of
// m = n_fft / 2 points plus the real-input split; the three frames of a
// window are transformed side by side, 288 lanes (9 warps) per stream,
// 256 at M = 441 (fft_threads).
// The complex FFT is a Stockham autosort in a few wide passes: each lane
// loads an item's R points from shared memory, twiddles them, runs the
// R-point DFT in registers (5 and 7 pair the points r and R - r; 8, 9 and
// 12 run four- or three-point DFTs and a second level) and stores them;
// ping-pong buffers in shared memory, one barrier per pass. At m = 768
// the passes are 8 x 8 x 12 (a radix-8 pass is one item per lane), at
// m = 512 8 x 8 x 8, at m = 441 (n_fft 882, WebRTC's 10 ms frame at 44.1
// kHz) 9 x 7 x 7 (147, 189 and 189 items: one a lane), at m = 320 (n_fft
// 640) 8 x 8 x 5. In the M = 0 instantiation a prime factor p above 5 is
// a pass of its own (`prime_pass`), whose p-point DFT runs as sums: each
// lane computes one output of an item from its p points, so the pass
// spreads m outputs over the lanes (n_fft 44 runs 2 x 11, n_fft 1018 one
// pass of 509). The first pass reads its points
// through the transform's input: the forward's reflect-indexed, windowed
// frames packed two samples a point, the inverse's real-input pre-twiddle
// of mag * (are + i aim); so a Griffin-Lim round waits at 8 barriers (3
// passes and the overlap-add for the inverse, 3 passes for the forward,
// the phase update). The inverse drops the imaginary parts of the DC and
// Nyquist bins, as irfft does. The passes' twiddles come from a table
// laid out pass by pass (neighbouring lanes read neighbouring entries),
// the real-input split's from a table of e^{-2 pi i t / n_fft}, both
// built in float64 by the wrapper; the in-register DFTs' own twiddles are
// compile-time constants, the prime passes' roots entries of the n_fft-point
// table. The element loops of the transforming stages
// stride by the constant fft_threads(M). The geometry is compiled
// in: the stages that transform are templates on M = n_fft / 2, with
// instantiations for 768, 512, 441 and 32 whose radices, strides and
// counts are constants (no division at run time), and M = 0, the same
// code with the geometry read from FftPlan at run time, for any other m
// (its passes switch on the radix, 12, 8 and 5 and below in registers):
// every even n_fft with hop = n_fft / 2, as JAX's kernel takes.
//
// Any mel count: the analysis's mel outputs (kFrames * n_mels of them) are
// split over the lanes as partial sums where they are fewer than the lanes,
// else each lane loops over outputs and writes them whole; the Griffin-Lim
// stage's inverse mel reads the cell's mel magnitudes where they lie (the
// single hop's scratch, the K-hop kernel's shared memory).

#include <cuda_runtime.h>

#include "fft.cuh"
#include "plan_cell.cuh"

// Mirrored field by field by _Args in ops/kernels/webrtc_hop.py;
// adt_webrtc_hop_args_size lets the wrapper check the layouts agree.
struct AdtWebRTCHopArgs {
  const float* ring;    // (B, n_fft) analysis ring
  const float* ola;     // (B, n_fft) synthesis accumulator
  const float* hx;      // (B, n_hidden) cell state
  const float* ang_re;  // (B, 3 n_bins) carried phases, frame t at t n_bins
  const float* ang_im;  // (B, 3 n_bins)
  const float* chunk;   // (hops, B, hop) new samples
  float* ring_out;
  float* ola_out;
  float* hx_out;
  float* ang_re_out;
  float* ang_im_out;
  float* out;           // (hops, B, hop)
  float* feat;          // (B, 3, n_mels) scratch of one hop: log-mel features
  float* mel_mag;       // (B, 3, n_mels) scratch: the cell's mel magnitudes
  float* peak;          // (B,) scratch: each window's peak
  const float* win;     // (n_fft,) Hann window
  const float* env;     // (n_fft,) istft envelope over the trim region
  const float* mel;     // (n_bins, n_mels)
  const float* imel;    // (n_mels, n_bins)
  // (n_fft + max(m - 1, 1),): e^{-2 pi i t / n_fft} for t < n_fft, then
  // the passes' twiddles of the FFT of m = n_fft / 2 points (pass_twiddle)
  const float2* twiddle;
  AdtPlan plan;
  int batch;
  int n_fft;
  int hop;
  int n_bins;
  int n_mels;
  int n_iter;
  int hops;             // hops per call: 1 (three launches) or K (one)
  float momentum;       // m / (1 + m) of the configured momentum m
  float output_gain;
  float state_decay;
  int gl_bf16;          // the Griffin-Lim rounds' transform inputs in bf16
  int cell_batched;     // the cell stage's walk: 1 batched, 0 per frame
  // where the K-hop kernel's cell layout lies (MultiLayout.cell): set by
  // launch_multi on the host, so that the kernel keeps none of it live
  int cell_d;
  int cell_s;
  int cell_x;
};

namespace {

constexpr int kFrames = 3;
// Lanes per stream of the FFT stages of the instantiation for M: 9 warps,
// so a radix-8 pass over the three frames at M = 768 (3 x 96 items) is one
// item per lane; 8 at M = 441, whose passes have 147, 189 and 189 items,
// so that the K-hop kernel's block of kTile streams is the cell's kThreads
// lanes: ptxas then gives it 128 registers and no spills, where 576 lanes
// left it 96 and spills (the single hop's GL launch takes the same time
// either way).
__host__ __device__ constexpr int fft_threads(int m) {
  return m == 441 ? 256 : 288;
}
// the analysis's partial results: the peak tree's lanes, the mel outputs'
// partial sums where they are split (never more than the lanes); as many
// as the most lanes a stream has
constexpr int kRed = 288;
constexpr int kCellBarrier = 1 + kTile;  // named barriers 1..kTile: streams

// The half-lengths M = n_fft / 2 with an instantiation of their own, whose
// geometry (radices, strides, frame and bin counts) is compile-time
// constant: 768 (n_fft 1536, every 48 kHz WebRTC preset), 512 (n_fft
// 1024), 441 (n_fft 882, WebRTC's 10 ms frame at 44.1 kHz) and 32 (n_fft
// 64, the JAX tests' geometry). Any other M that `args_ok` accepts runs
// the M = 0 instantiation, the same code with the geometry read from
// FftPlan at run time.
__host__ __device__ constexpr int fft_instance(int m) {
  return m == 768 || m == 512 || m == 441 || m == 32 ? m : 0;
}



// n_fft / 2: kM, a compile-time constant, or p.m for kM = 0. hop = m,
// n_fft = 2 m and n_bins = m + 1 follow from it (args_ok).
template <int kM>
__device__ __forceinline__ int half_length(const FftPlan& p) {
  return kM > 0 ? kM : p.m;
}

// Per-stream shared-memory layout of the FFT stages, in floats. The
// analysis uses the buffers up to `mag`; Griffin-Lim all of them.
struct SpecLayout {
  int n_fft, m, F;
  int buf0, buf1;  // kFrames * m float2 each
  int time;        // n_fft floats: a window in the time domain
  int red;         // kRed floats: the analysis's partial results
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
  l.red = off;
  off += kRed;
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
// imaginary), then the forward FFT, whose first pass reads the window
// through that packing. Returns the buffer with the result.
template <int kM>
__device__ __forceinline__ float2* stft3(const AdtWebRTCHopArgs& a,
                                         const FftPlan& p,
                                         const SpecLayout& l, float* smem,
                                         const Lanes& g) {
  const float* x = smem + l.time;
  const int m = half_length<kM>(p), n_fft = 2 * m, hop = m;
  const float* win = a.win;
  const auto frame = [=](int t, int q) {
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * q + h;
      int src;
      if (t == 0)  // [x[hop] .. x[1], x[0] .. x[hop - 1]]
        src = i < hop ? hop - i : i - hop;
      else if (t == 1)
        src = i;
      else  // [x[hop] .. x[n_fft - 1], x[n_fft - 2] .. x[hop - 1]]
        src = i < hop ? i + hop : n_fft + hop - 2 - i;
      s[h] = x[src] * __ldg(win + i);
    }
    return make_float2(s[0], s[1]);
  };
  return fft<false, kM, kFrames>(
      frame, reinterpret_cast<float2*>(smem + l.buf0),
      reinterpret_cast<float2*>(smem + l.buf1), p, a.twiddle, g);
}


// A float rounded to bf16's 8 significant bits (to nearest even), kept as
// a float.
__device__ __forceinline__ float round_bf16(float v) {
  return act(v, static_cast<const bf16_t*>(nullptr));
}

// The centered inverse STFT of the three frames mag * (are + i aim) into
// `time`: irfft of each frame (imaginary parts of DC and Nyquist
// dropped; the inverse FFT's first pass builds its input from the three
// planes), window, overlap-add over the trim region [hop, hop + n_fft),
// divide by the envelope. kBf16: each bin times its irfft weight rounded
// to bf16 and unweighted, and the time signal rounded to bf16 (the bf16
// GL mode's rounds).
template <int kM, bool kBf16>
__device__ __forceinline__ void istft3(const AdtWebRTCHopArgs& a,
                                       const FftPlan& p, const SpecLayout& l,
                                       float* smem, const Lanes& g) {
  const float* mag = smem + l.mag;
  const float* are = smem + l.are;
  const float* aim = smem + l.aim;
  const int m = half_length<kM>(p), F = m + 1, n_fft = 2 * m, hop = m;
  const float *win = a.win, *env = a.env;
  const float2* tw = a.twiddle;
  // the irfft's bin weights (as JAX's float32 row) and their exact inverses
  const float w_mid = __fdiv_rn(2.f, (float)n_fft);
  const float w_edge = __fdiv_rn(1.f, (float)n_fft);
  // point k of frame t of the packed input: the pre-twiddle that makes the
  // half-length inverse FFT an irfft, read by the first pass
  const auto spectrum = [=](int t, int k) {
    const int o = t * F;
    float2 xk = make_float2(mag[o + k] * are[o + k], mag[o + k] * aim[o + k]);
    float2 xc = make_float2(mag[o + m - k] * are[o + m - k],
                            -mag[o + m - k] * aim[o + m - k]);
    if constexpr (kBf16) {  // bins k and m - k: DC and Nyquist, or inside
      const float w = k == 0 ? w_edge : w_mid;
      const float u = k == 0 ? (float)n_fft : (float)hop;
      const auto r = [=](float v) { return round_bf16(v * w) * u; };
      xk = make_float2(r(xk.x), r(xk.y));
      xc = make_float2(r(xc.x), r(xc.y));
    }
    if (k == 0) {
      xk.y = 0.f;
      xc.y = 0.f;
    }
    const float2 ev = cadd(xk, xc);
    const float2 od = cmul(csub(xk, xc), conjf2(__ldg(tw + k)));
    return cadd(ev, rot90<true>(od));
  };
  const float* fr = reinterpret_cast<const float*>(
      fft<true, kM, kFrames>(spectrum,
                             reinterpret_cast<float2*>(smem + l.buf0),
                             reinterpret_cast<float2*>(smem + l.buf1), p,
                             a.twiddle, g));
  const float scale = 1.f / (float)n_fft;
  float* x = smem + l.time;
#pragma unroll
  for (int j = g.id; j < n_fft; j += g.n) {
    float v;
    if (j < hop)
      v = fr[j + hop] * __ldg(win + j + hop) + fr[n_fft + j] * __ldg(win + j);
    else
      v = fr[n_fft + j] * __ldg(win + j) +
          fr[2 * n_fft + j - hop] * __ldg(win + j - hop);
    x[j] = v * scale / __ldg(env + j);
    if constexpr (kBf16) x[j] = round_bf16(x[j]);
  }
  group_sync(g);
}

// Stage 1 for one stream, its layout at dynamic shared memory + base: the
// window (ring_in shifted by one hop, then the chunk) is staged in the
// time buffer and kept in ring_out (which may be ring_in); the window's
// peak; the normalized, pre-windowed 3-frame STFT, its magnitude, mel and
// log1p into feat (kFrames * n_mels). Ends on the group's barrier.
template <int kM>
__device__ __noinline__ void analysis_stage(
    const AdtWebRTCHopArgs& a, const FftPlan& p, int base, Lanes g,
    const float* ring_in, const float* chunk, float* ring_out, float* feat,
    float* peak_out) {
  extern __shared__ __align__(16) float dyn[];
  float* smem = dyn + base;
  g.n = fft_threads(kM);  // what both entry points give a stream: a constant
  const int m = half_length<kM>(p);
  const int n_fft = 2 * m, hop = m, keep = n_fft - hop;
  const int F = m + 1, M = a.n_mels;
  const SpecLayout l = make_spec_layout(n_fft, F, false);
  float* x = smem + l.time;
  float* red = smem + l.red;

  // ring shift and the window's peak
  float peak = 0.f;
  for (int i = g.id; i < n_fft; i += g.n) {
    const float v = i < keep ? ring_in[i + hop] : chunk[i - keep];
    x[i] = v;
    peak = fmaxf(peak, fabsf(v));
  }
  red[g.id] = peak;
  group_sync(g);
  int half = 1;
  while (2 * half < g.n) half *= 2;
  for (int s = half; s > 0; s >>= 1) {
    if (g.id < s && g.id + s < g.n)
      red[g.id] = fmaxf(red[g.id], red[g.id + s]);
    group_sync(g);
  }
  const bool ok = red[0] > 1e-6f;
  peak = ok ? red[0] : 1.f;
  if (g.id == 0) *peak_out = peak;
  // keep the window; normalize and pre-window
  const float* win = a.win;
  for (int i = g.id; i < n_fft; i += g.n) {
    ring_out[i] = x[i];
    x[i] = (ok ? x[i] / peak : x[i]) * __ldg(win + i);
  }
  group_sync(g);

  const float2* Z = stft3<kM>(a, p, l, smem, g);
  float* mag = smem + l.mag;
  const float2* tw = a.twiddle;
  for (int e = g.id; e < kFrames * F; e += g.n) {
    const int t = e / F, k = e % F;
    const float2 v = real_bin(Z + t * m, m, k, tw);
    mag[e] = sqrtf(v.x * v.x + v.y * v.y);
  }
  group_sync(g);

  // feat = log(1 + mag @ mel), k split over `split` partial sums where
  // the outputs are fewer than the lanes; else each lane loops over whole
  // outputs
  const int outs = kFrames * M;
  const int split = max(1, g.n / outs);
  const int span = (F + split - 1) / split;
  const float* mel = a.mel;
  for (int e = g.id; e < outs * split; e += g.n) {
    const int s = e / outs, o = e % outs;
    const int t = o / M, mm = o % M;
    const int lo = s * span, hi = min(F, lo + span);
    float acc = 0.f;
    // the weights come from L2: unrolled, a lane keeps 16 loads in flight
#pragma unroll 16
    for (int k = lo; k < hi; ++k)
      acc = fmaf(mag[t * F + k], __ldg(mel + (size_t)k * M + mm), acc);
    if (split == 1)
      feat[o] = logf(1.f + acc);
    else
      red[e] = acc;
  }
  group_sync(g);
  if (split > 1) {
    for (int o = g.id; o < outs; o += g.n) {
      float v = 0.f;
      for (int s = 0; s < split; ++s) v += red[s * outs + o];
      feat[o] = logf(1.f + v);
    }
    group_sync(g);
  }
}

// Stage 2 in the per-frame walk for a tile of kTile streams (`rows` of
// them real), the cell's layout at dynamic shared memory + base: hx from hx_in (n_hidden a
// stream), the features from feat (kFrames * n_mels a stream), the mel
// magnitudes to mel_mag, hx decayed to hx_out (which may be hx_in). Ends
// on the group's barrier.
__device__ __noinline__ void cell_stage(const AdtWebRTCHopArgs& a, int base,
                                        Lanes g, int rows,
                                        const float* hx_in, const float* feat,
                                        float* mel_mag, float* hx_out) {
  extern __shared__ __align__(16) float dyn[];
  float* smem = dyn + base;
  CellLayout l;
  int off = 0;
  make_cell_layout(a.plan, &l, &off);
  const int M = a.n_mels, n = a.plan.n_hidden;

  for (int e = g.id; e < kTile * n; e += g.n) {
    const int s = e / n, j = e % n;
    smem[l.hx + s * l.ld_n + j] = s < rows ? hx_in[s * n + j] : 0.f;
  }
  for (int t = 0; t < kFrames; ++t) {
    for (int e = g.id; e < kTile * M; e += g.n) {
      const int s = e / M, mm = e % M;
      smem[l.d[0] + s * l.ld_d[0] + mm] =
          s < rows ? feat[(s * kFrames + t) * M + mm] : 0.f;
    }
    group_sync(g);
    const float* y = plan_cell(a.plan, l, smem, g);
    // mel magnitude: max(exp(leaky_relu(x - y, 0.2)) - 1, 0)
    for (int e = g.id; e < rows * M; e += g.n) {
      const int s = e / M, mm = e % M;
      float r = smem[l.d[0] + s * l.ld_d[0] + mm] - y[s * l.ld_pp + mm];
      r = r >= 0.f ? r : 0.2f * r;
      mel_mag[(s * kFrames + t) * M + mm] = fmaxf(expf(r) - 1.f, 0.f);
    }
    // hi is the next step's hx
    for (int e = g.id; e < kTile * n; e += g.n) {
      const int s = e / n, j = e % n;
      smem[l.hx + s * l.ld_n + j] = smem[l.hi + s * l.ld_n + j];
    }
    group_sync(g);
  }
  for (int e = g.id; e < rows * n; e += g.n) {
    const int s = e / n, j = e % n;
    hx_out[s * n + j] = smem[l.hx + s * l.ld_n + j] * a.state_decay;
  }
  group_sync(g);
}

// Rows of the batched walk's matmuls that read no state: the tile's
// streams at each of the three frames, frame-major (row t kTile + s), so
// a frame's kTile rows are contiguous.
constexpr int kFrameRows = kFrames * kTile;

// The batched walk's shared memory, in floats, in three parts that each
// entry point places where it has room: the encoder's activations d[0..L]
// of all kFrameRows rows; the decoder's skip products of those rows, and
// hx; the split-K scratch of those rows' matmuls, and over it (dead while
// they run) the per-frame matmuls' scratch, the reset gate's output, the
// updated state and the decoder's two buffers. A buffer's offset is
// computed from the plan where it is needed: the plan lies in the launch's
// parameter space, where the walk can index it by level, whereas a table
// of offsets indexed at run time would live in each thread's local
// memory, whose writes (65,536 threads' copies a launch) evicted the other
// two launches' data from L2 and cost them about 8 us each.
struct FrameBases {
  int d, s, x;  // where the three parts start
};

// Offset of level i's activations (kFrameRows rows of round4(down_n[i])).
__host__ __device__ inline int frames_d(const AdtPlan& p, int base, int i) {
  for (int j = 0; j < i; ++j) base += kFrameRows * round4(p.down_n[j]);
  return base;
}

// Offset of decoder level i's skip product (kFrameRows rows of
// round4(up_n[i + 1]), where up_s[i] is set); i = levels: of hx.
__host__ __device__ inline int frames_skip(const AdtPlan& p, int base,
                                           int i) {
  for (int j = 0; j < i; ++j)
    if (p.up_s[j] != nullptr) base += kFrameRows * round4(p.up_n[j + 1]);
  return base;
}

// The decoder's buffers' leading dimension: its widest level.
__host__ __device__ inline int frames_ld_pp(const AdtPlan& p) {
  int widest = 0;
  for (int i = 1; i <= p.levels; ++i)
    widest = p.up_n[i] > widest ? p.up_n[i] : widest;
  return round4(widest);
}

// The floats of the three parts.
__host__ __device__ inline void frames_sizes(const AdtPlan& p, int* d,
                                             int* s, int* x) {
  const int n = p.n_hidden;
  *d = frames_d(p, 0, p.levels + 1);
  *s = frames_skip(p, 0, p.levels) + kTile * round4(n);
  const int per_frame = kTile * (4 * kThreads + round4(3 * n) + round4(n) +
                                 2 * frames_ld_pp(p));
  const int batched = kFrameRows * 4 * kThreads;
  *x = per_frame > batched ? per_frame : batched;
}

// The parts laid end to end (the single hop's cell launch); *floats gets
// the floats they take.
__host__ __device__ inline FrameBases frames_contiguous(const AdtPlan& p,
                                                        int* floats) {
  int d, s, x;
  frames_sizes(p, &d, &s, &x);
  *floats = d + s + x;
  return FrameBases{0, d, d + s};
}

// Stage 2 in the batched walk: what `cell_stage` computes, for the same
// tile and hand-offs, with its layout's parts at dynamic shared memory
// + base. The encoder and the skip products run on
// kFrameRows rows (their sums in the per-frame walk's order: `gemm`'s
// split does not depend on rows); each decoder level with a skip adds
// h @ up_w to its skip product (gemm<float, kTile, true>), where the
// per-frame walk adds both products' k ranges laid end to end. Ends on the
// group's barrier.
__device__ __noinline__ void cell_stage_frames(
    const AdtWebRTCHopArgs& a, FrameBases base, Lanes g, int rows,
    const float* hx_in, const float* feat, float* mel_mag, float* hx_out) {
  extern __shared__ __align__(16) float dyn[];
  float* smem = dyn;
  const AdtPlan& p = a.plan;
  const int M = a.n_mels, n = p.n_hidden, L = p.levels;
  const int ld_n = round4(n), ld_gh = round4(3 * n), ld_pp = frames_ld_pp(p);
  const int ld_x = round4(p.down_n[0]);
  float* d0 = smem + base.d;
  float* scratch = smem + base.x;
  float* gh = scratch + kTile * 4 * kThreads;
  float* hc = smem + frames_skip(p, base.s, L);  // this frame's hx
  float* hn = gh + kTile * ld_gh;                 // its update
  float* pp0 = hn + kTile * ld_n;
  float* pp1 = pp0 + kTile * ld_pp;

  for (int e = g.id; e < kTile * n; e += g.n) {
    const int s = e / n, j = e % n;
    hc[s * ld_n + j] = s < rows ? hx_in[s * n + j] : 0.f;
  }
  for (int e = g.id; e < kFrameRows * M; e += g.n) {
    const int r = e / M, mm = e % M;
    const int t = r / kTile, s = r % kTile;
    d0[r * ld_x + mm] = s < rows ? feat[(s * kFrames + t) * M + mm] : 0.f;
  }
  group_sync(g);
  // the matmuls that read no state, once for the three frames: the
  // encoder, level i from d[i] into d[i + 1]
  for (int i = 0, off = base.d; i < L; ++i) {
    const int next = off + kFrameRows * round4(p.down_n[i]);
    gemm<float, kFrameRows>(
        make_gemm(smem + off, round4(p.down_n[i]), p.down_n[i], p.down_w[i],
                  p.down_n[i + 1], p.down_b[i], kRelu, smem + next,
                  round4(p.down_n[i + 1]), scratch),
        g);
    group_sync(g);
    off = next;
  }
  // the skip products (decoder level i's, of d[L - i]) read d[1..L-1],
  // complete by now, and write buffers of their own: no barrier between
  // them (a split one ends on its own)
  for (int i = 0, off = base.s; i < L; ++i) {
    if (p.up_s[i] == nullptr) continue;
    const int k = p.down_n[L - i], w = round4(p.up_n[i + 1]);
    gemm<float, kFrameRows>(
        make_gemm(smem + frames_d(p, base.d, L - i), round4(k), k, p.up_s[i],
                  p.up_n[i + 1], nullptr, kNone, smem + off, w, scratch),
        g);
    off += kFrameRows * w;
  }
  group_sync(g);

  const float* gx_all = smem + frames_d(p, base.d, L);
  const int ld_gx = round4(p.down_n[L]);
  for (int t = 0; t < kFrames; ++t) {
    gemm<float>(make_gemm(hc, ld_n, n, p.reset_w, 3 * n, p.reset_b, kRelu, gh,
                          ld_gh, scratch),
                g);
    group_sync(g);
    const float* gx = gx_all + t * kTile * ld_gx;
    for (int e = g.id; e < kTile * n; e += g.n) {
      const int s = e / n, j = e % n;
      const float* x = gx + s * ld_gx;
      const float* h = gh + s * ld_gh;
      const float inputgate = sigmoidf(x[n + j] + h[n + j]);
      const float resetgate = sigmoidf(x[j] + h[j]);
      const float newgate = tanhf(x[2 * n + j] + resetgate * h[2 * n + j]);
      const float hxv = hc[s * ld_n + j];
      hn[s * ld_n + j] = newgate + inputgate * (hxv - newgate);
    }
    group_sync(g);
    // decoder level i on h into pp0 or pp1, its skip product added
    const float* h = hn;
    int ldh = ld_n;
    for (int i = 0, off = base.s; i < L; ++i) {
      float* dst = (i & 1) ? pp1 : pp0;
      Gemm gm = make_gemm(h, ldh, p.up_n[i], p.up_w[i], p.up_n[i + 1],
                          p.up_b[i], i != L - 1 ? kRelu : kNone, dst, ld_pp,
                          scratch);
      if (p.up_s[i] != nullptr) {
        const int w = round4(p.up_n[i + 1]);
        gm.pre = smem + off + t * kTile * w;
        gm.ldpre = w;
        gemm<float, kTile, true>(gm, g);
        off += kFrameRows * w;
      } else {
        gemm<float>(gm, g);
      }
      group_sync(g);
      h = dst;
      ldh = ld_pp;
    }
    // mel magnitude: max(exp(leaky_relu(x - y, 0.2)) - 1, 0); the next
    // frame's barriers come before anything writes h again
    const float* x = d0 + t * kTile * ld_x;
    for (int e = g.id; e < rows * M; e += g.n) {
      const int s = e / M, mm = e % M;
      float r = x[s * ld_x + mm] - h[s * ld_pp + mm];
      r = r >= 0.f ? r : 0.2f * r;
      mel_mag[(s * kFrames + t) * M + mm] = fmaxf(expf(r) - 1.f, 0.f);
    }
    float* next = hc;  // hn is the next frame's hx
    hc = hn;
    hn = next;
  }
  for (int e = g.id; e < rows * n; e += g.n) {
    const int s = e / n, j = e % n;
    hx_out[s * n + j] = hc[s * ld_n + j] * a.state_decay;
  }
  group_sync(g);
}

// Stage 2 in the walk the host chose (AdtWebRTCHopArgs.cell_batched), its
// layout's parts at dynamic shared memory + base (the per-frame walk's
// one part at base.d).
__device__ __forceinline__ void run_cell_stage(
    const AdtWebRTCHopArgs& a, FrameBases base, const Lanes& g, int rows,
    const float* hx_in, const float* feat, float* mel_mag, float* hx_out) {
  if (a.cell_batched)
    cell_stage_frames(a, base, g, rows, hx_in, feat, mel_mag, hx_out);
  else
    cell_stage(a, base.d, g, rows, hx_in, feat, mel_mag, hx_out);
}

// The Griffin-Lim rounds of stage 3 on the layout's phases (are, aim),
// previous rebuilt spectrum (tre, tim) and target magnitudes: inverse
// STFT, STFT, u = r - m tprev, a = u / (|u| + 1e-16). kBf16: the bf16 GL
// mode's rounded transform inputs.
template <int kM, bool kBf16>
__device__ __forceinline__ void gl_rounds(const AdtWebRTCHopArgs& a,
                                          const FftPlan& p,
                                          const SpecLayout& l, float* smem,
                                          const Lanes& g) {
  const int m = half_length<kM>(p), F = m + 1;
  const int nb = kFrames * F;
  float* are = smem + l.are;
  float* aim = smem + l.aim;
  float* tre = smem + l.tre;
  float* tim = smem + l.tim;
  const float2* tw = a.twiddle;
  const float momentum = a.momentum;
  for (int it = 0; it < a.n_iter; ++it) {
    istft3<kM, kBf16>(a, p, l, smem, g);
    const float2* Z = stft3<kM>(a, p, l, smem, g);
    for (int e = g.id; e < nb; e += g.n) {
      const int t = e / F, k = e % F;
      const float2 r = real_bin(Z + t * m, m, k, tw);
      const float ur = r.x - momentum * tre[e];
      const float ui = r.y - momentum * tim[e];
      const float nrm = sqrtf(ur * ur + ui * ui) + 1e-16f;
      are[e] = ur / nrm;
      aim[e] = ui / nrm;
      tre[e] = r.x;
      tim[e] = r.y;
    }
    group_sync(g);
  }
}

// Stage 3 for one stream, its layout at dynamic shared memory + base: the
// target magnitudes from mel_mag, the warm seed from the carried phases
// (ang_re, ang_im; they may be this layout's are and aim), Griffin-Lim,
// the synthesis times the peak; emits ola_in[:hop] to out and the shifted
// OLA buffer plus the frame to ola_out (which may be ola_in), the
// converged phases to ang_re_out, ang_im_out. Ends on the group's barrier.
template <int kM>
__device__ __noinline__ void gl_stage(
    const AdtWebRTCHopArgs& a, const FftPlan& p, int base, Lanes g,
    const float* mel_mag, float peak, const float* ang_re,
    const float* ang_im, const float* ola_in, float* out, float* ola_out,
    float* ang_re_out, float* ang_im_out) {
  extern __shared__ __align__(16) float dyn[];
  float* smem = dyn + base;
  g.n = fft_threads(kM);  // what both entry points give a stream: a constant
  const int m = half_length<kM>(p);
  const int n_fft = 2 * m, hop = m, F = m + 1, M = a.n_mels;
  const SpecLayout l = make_spec_layout(n_fft, F, true);
  const int nb = kFrames * F;
  float* mag = smem + l.mag;
  float* are = smem + l.are;
  float* aim = smem + l.aim;
  float* tre = smem + l.tre;
  float* tim = smem + l.tim;

  // the carried phases in the previous-spectrum buffers
  for (int e = g.id; e < nb; e += g.n) {
    tre[e] = ang_re[e];
    tim[e] = ang_im[e];
  }
  group_sync(g);
  // inverse mel: the target magnitudes, from the mel magnitudes where
  // they lie (any count of them)
  const float* imel = a.imel;
  const float gain = a.output_gain;
  for (int e = g.id; e < nb; e += g.n) {
    const int t = e / F, k = e % F;
    float acc = 0.f;
#pragma unroll 16
    for (int j = 0; j < M; ++j)
      acc = fmaf(mel_mag[t * M + j], __ldg(imel + (size_t)j * F + k), acc);
    mag[e] = fmaxf(acc, 0.f) * gain;
  }
  // warm seed: shift one frame; the newest is the last advanced one hop
  for (int e = g.id; e < nb; e += g.n) {
    const int t = e / F, k = e % F;
    const int src = t < kFrames - 1 ? e + F : e;
    const float sign = (t == kFrames - 1 && (k & 1)) ? -1.f : 1.f;
    are[e] = sign * tre[src];
    aim[e] = sign * tim[src];
  }
  group_sync(g);
  for (int e = g.id; e < nb; e += g.n) {
    tre[e] = 0.f;
    tim[e] = 0.f;
  }
  group_sync(g);

  if (a.gl_bf16)
    gl_rounds<kM, true>(a, p, l, smem, g);
  else
    gl_rounds<kM, false>(a, p, l, smem, g);
  istft3<kM, false>(a, p, l, smem, g);

  // emit, then the shifted OLA buffer plus the frame, staged in place of
  // the frame
  float* frame = smem + l.time;
  for (int i = g.id; i < n_fft; i += g.n) {
    if (i < hop) out[i] = ola_in[i];
    const float shifted = i < n_fft - hop ? ola_in[i + hop] : 0.f;
    frame[i] = shifted + frame[i] * peak;
  }
  group_sync(g);
  for (int i = g.id; i < n_fft; i += g.n) ola_out[i] = frame[i];
  for (int e = g.id; e < nb; e += g.n) {
    ang_re_out[e] = are[e];
    ang_im_out[e] = aim[e];
  }
  group_sync(g);
}

template <int kM>
__global__ void __launch_bounds__(fft_threads(kM))
    analysis_kernel(const __grid_constant__ AdtWebRTCHopArgs a,
                    const __grid_constant__ FftPlan p) {
  const size_t b = blockIdx.x;
  analysis_stage<kM>(a, p, 0, block_lanes(), a.ring + b * a.n_fft,
                 a.chunk + b * a.hop, a.ring_out + b * a.n_fft,
                 a.feat + b * kFrames * a.n_mels, a.peak + b);
}

// The single hop's cell launch in one walk (kBatched: a.cell_batched),
// so that it holds the code of that walk only.
template <bool kBatched>
__global__ void __launch_bounds__(kThreads, 1)
    cell_kernel(const __grid_constant__ AdtWebRTCHopArgs a) {
  const size_t b0 = (size_t)blockIdx.x * kTile;
  const int rows = min(kTile, a.batch - (int)b0);
  const size_t n = a.plan.n_hidden, nf = kFrames * a.n_mels;
  const float* hx = a.hx + b0 * n;
  const float* feat = a.feat + b0 * nf;
  if (kBatched) {
    int floats;
    cell_stage_frames(a, frames_contiguous(a.plan, &floats), block_lanes(),
                      rows, hx, feat, a.mel_mag + b0 * nf, a.hx_out + b0 * n);
  } else {
    cell_stage(a, 0, block_lanes(), rows, hx, feat, a.mel_mag + b0 * nf,
               a.hx_out + b0 * n);
  }
}

template <int kM>
__global__ void __launch_bounds__(fft_threads(kM), 2)
    gl_kernel(const __grid_constant__ AdtWebRTCHopArgs a,
              const __grid_constant__ FftPlan p) {
  const size_t b = blockIdx.x;
  const size_t nb = kFrames * a.n_bins;
  gl_stage<kM>(a, p, 0, block_lanes(), a.mel_mag + b * kFrames * a.n_mels,
           a.peak[b], a.ang_re + b * nb, a.ang_im + b * nb,
           a.ola + b * a.n_fft, a.out + b * a.hop, a.ola_out + b * a.n_fft,
           a.ang_re_out + b * nb, a.ang_im_out + b * nb);
}

// The K-hop kernel's shared memory, in floats: each stream's SpecLayout
// (its are and aim hold the carried phases), then the tile's state and
// the stages' hand-offs, each kTile rows; the cell's layout aliases
// stream 0's transform buffers where it fits (they are dead while the
// cell runs), else it follows. The batched walk's three parts, largest
// first, each take the first of stream 0's and stream 1's transform
// buffers that still has room for it, else follow.
struct MultiLayout {
  SpecLayout spec;
  int stream[kTile];
  int ld_t;                            // ring and OLA rows
  int ring, ola, hx, feat, mel_mag, peak;
  FrameBases cell;                     // the cell layout's parts
  static_assert(kTile == 2, "the cell's parts fit two streams' buffers");
  int total;
};

__host__ __device__ inline MultiLayout make_multi_layout(
    const AdtWebRTCHopArgs& a) {
  MultiLayout l;
  l.spec = make_spec_layout(a.n_fft, a.n_bins, true);
  int off = 0;
  for (int s = 0; s < kTile; ++s) l.stream[s] = take(&off, 1, l.spec.total);
  l.ld_t = round4(a.n_fft);
  l.ring = take(&off, kTile, l.ld_t);
  l.ola = take(&off, kTile, l.ld_t);
  l.hx = take(&off, 1, round4(kTile * a.plan.n_hidden));
  l.feat = take(&off, 1, round4(kTile * kFrames * a.n_mels));
  l.mel_mag = take(&off, 1, round4(kTile * kFrames * a.n_mels));
  l.peak = take(&off, 1, round4(kTile));
  if (a.cell_batched) {
    // the three parts, largest first (the first of equals), each in the
    // first stream's transform buffers with room left for it, else after
    int size_d, size_s, size_x;
    frames_sizes(a.plan, &size_d, &size_s, &size_x);
    int used0 = 0, used1 = 0, placed = 0;  // placed: a bit a part
    for (int k = 0; k < 3; ++k) {
      int i = -1, size = -1;
      for (int j = 0; j < 3; ++j) {
        const int sj = j == 0 ? size_d : j == 1 ? size_s : size_x;
        if (!(placed >> j & 1) && sj > size) {
          i = j;
          size = sj;
        }
      }
      placed |= 1 << i;
      int at;
      if (used0 + size <= l.spec.are) {
        at = l.stream[0] + used0;
        used0 += size;
      } else if (used1 + size <= l.spec.are) {
        at = l.stream[1] + used1;
        used1 += size;
      } else {
        at = take(&off, 1, size);
      }
      (i == 0 ? l.cell.d : i == 1 ? l.cell.s : l.cell.x) = at;
    }
  } else {
    CellLayout cl;
    int floats = 0;
    make_cell_layout(a.plan, &cl, &floats);
    l.cell.d = floats <= l.spec.are ? l.stream[0] : take(&off, 1, floats);
    l.cell.s = l.cell.x = 0;
  }
  l.total = off;
  return l;
}

// The resident K-hop kernel (webrtc_hop.py:344): a.hops hops of a tile of
// kTile streams with its state in shared memory throughout.
template <int kM>
__global__ void __launch_bounds__(kTile * fft_threads(kM), 1)
    webrtc_hop_multi_kernel(const __grid_constant__ AdtWebRTCHopArgs a,
                            const __grid_constant__ FftPlan p) {
  constexpr int lanes = fft_threads(kM);
  static_assert(kThreads <= kTile * lanes, "the cell's lanes fit the block");
  static_assert(lanes % 32 == 0, "a named barrier counts whole warps");
  static_assert(lanes <= kRed, "a partial result for every lane");
  extern __shared__ __align__(16) float smem[];
  const MultiLayout l = make_multi_layout(a);
  const int b0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.batch - b0);
  const int n_fft = a.n_fft, hop = a.hop, n = a.plan.n_hidden;
  const int nf = kFrames * a.n_mels, nb = kFrames * a.n_bins;
  const int tid = threadIdx.x, s = tid / lanes;
  const Lanes fft_lanes{tid % lanes, lanes, 1 + s};
  const Lanes cell_lanes{tid, kThreads, kCellBarrier};
  float* ring = smem + l.ring + s * l.ld_t;
  float* ola = smem + l.ola + s * l.ld_t;
  float* are = smem + l.stream[s] + l.spec.are;
  float* aim = smem + l.stream[s] + l.spec.aim;
  float* hx = smem + l.hx;
  float* feat = smem + l.feat;
  float* mel_mag = smem + l.mel_mag;
  float* peak = smem + l.peak;

  // the tile's state, once
  for (int e = tid; e < rows * n_fft; e += blockDim.x) {
    const int r = e / n_fft, i = e % n_fft;
    const size_t g = (size_t)(b0 + r) * n_fft + i;
    smem[l.ring + r * l.ld_t + i] = a.ring[g];
    smem[l.ola + r * l.ld_t + i] = a.ola[g];
  }
  for (int e = tid; e < rows * nb; e += blockDim.x) {
    const int r = e / nb, i = e % nb;
    const size_t g = (size_t)(b0 + r) * nb + i;
    smem[l.stream[r] + l.spec.are + i] = a.ang_re[g];
    smem[l.stream[r] + l.spec.aim + i] = a.ang_im[g];
  }
  for (int e = tid; e < rows * n; e += blockDim.x)
    hx[e] = a.hx[(size_t)b0 * n + e];
  __syncthreads();

  const size_t b = b0 + s;  // this thread's stream in the FFT stages
  for (int k = 0; k < a.hops; ++k) {
    const size_t row = ((size_t)k * a.batch + b) * hop;
    if (s < rows)
      analysis_stage<kM>(a, p, l.stream[s], fft_lanes, ring, a.chunk + row,
                         ring, feat + s * nf, peak + s);
    __syncthreads();
    if (tid < kThreads)
      run_cell_stage(a, FrameBases{a.cell_d, a.cell_s, a.cell_x},
                     cell_lanes, rows, hx, feat, mel_mag, hx);
    __syncthreads();
    if (s < rows)
      gl_stage<kM>(a, p, l.stream[s], fft_lanes, mel_mag + s * nf, peak[s],
                   are, aim, ola, a.out + row, ola, are, aim);
    __syncthreads();
  }

  // and back, once
  for (int e = tid; e < rows * n_fft; e += blockDim.x) {
    const int r = e / n_fft, i = e % n_fft;
    const size_t g = (size_t)(b0 + r) * n_fft + i;
    a.ring_out[g] = smem[l.ring + r * l.ld_t + i];
    a.ola_out[g] = smem[l.ola + r * l.ld_t + i];
  }
  for (int e = tid; e < rows * nb; e += blockDim.x) {
    const int r = e / nb, i = e % nb;
    const size_t g = (size_t)(b0 + r) * nb + i;
    a.ang_re_out[g] = smem[l.stream[r] + l.spec.are + i];
    a.ang_im_out[g] = smem[l.stream[r] + l.spec.aim + i];
  }
  for (int e = tid; e < rows * n; e += blockDim.x)
    a.hx_out[(size_t)b0 * n + e] = hx[e];
}

size_t spec_bytes(const AdtWebRTCHopArgs& a, bool gl) {
  return (size_t)make_spec_layout(a.n_fft, a.n_bins, gl).total *
         sizeof(float);
}

size_t cell_bytes(const AdtWebRTCHopArgs& a) {
  if (a.cell_batched) {
    int floats;
    frames_contiguous(a.plan, &floats);
    return (size_t)floats * sizeof(float);
  }
  CellLayout l;
  int off = 0;
  make_cell_layout(a.plan, &l, &off);
  return (size_t)off * sizeof(float);
}

size_t multi_bytes(const AdtWebRTCHopArgs& a) {
  return (size_t)make_multi_layout(a).total * sizeof(float);
}

bool args_ok(const AdtWebRTCHopArgs& a, FftPlan* p) {
  return plan_ok(a.plan, a.n_mels) && a.n_fft == 2 * a.hop &&
         a.n_bins == a.hop + 1 && a.n_iter >= 0 && a.hops >= 1 &&
         a.n_mels >= 1 && (a.cell_batched == 0 || a.cell_batched == 1) &&
         make_fft_plan(a.hop, fft_instance(a.hop) != 0, p);
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int kM>
cudaError_t launch(const AdtWebRTCHopArgs& a, const FftPlan& p,
                   cudaStream_t stream) {
  const size_t sa = spec_bytes(a, false), sc = cell_bytes(a),
               sg = spec_bytes(a, true);
  const auto cell = a.cell_batched ? cell_kernel<true> : cell_kernel<false>;
  cudaError_t err;
  if ((err = set_smem((const void*)analysis_kernel<kM>, sa)) != cudaSuccess ||
      (err = set_smem((const void*)cell, sc)) != cudaSuccess ||
      (err = set_smem((const void*)gl_kernel<kM>, sg)) != cudaSuccess)
    return err;
  analysis_kernel<kM><<<a.batch, fft_threads(kM), sa, stream>>>(a, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cell<<<(a.batch + kTile - 1) / kTile, kThreads, sc, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gl_kernel<kM><<<a.batch, fft_threads(kM), sg, stream>>>(a, p);
  return cudaGetLastError();
}

template <int kM>
cudaError_t launch_multi(const AdtWebRTCHopArgs& a, const FftPlan& p,
                         cudaStream_t stream) {
  const MultiLayout l = make_multi_layout(a);
  AdtWebRTCHopArgs b = a;
  b.cell_d = l.cell.d;
  b.cell_s = l.cell.s;
  b.cell_x = l.cell.x;
  const size_t sm = (size_t)l.total * sizeof(float);
  cudaError_t err = set_smem((const void*)webrtc_hop_multi_kernel<kM>, sm);
  if (err != cudaSuccess) return err;
  const int threads = kTile * fft_threads(kM);
  webrtc_hop_multi_kernel<kM>
      <<<(a.batch + kTile - 1) / kTile, threads, sm, stream>>>(b, p);
  return cudaGetLastError();
}

// The instantiation for a.hop (fft_instance): one hop or a.hops hops.
cudaError_t dispatch(const AdtWebRTCHopArgs& a, const FftPlan& p, bool multi,
                     cudaStream_t stream) {
  switch (fft_instance(a.hop)) {
    case 768:
      return (multi ? launch_multi<768> : launch<768>)(a, p, stream);
    case 512:
      return (multi ? launch_multi<512> : launch<512>)(a, p, stream);
    case 441:
      return (multi ? launch_multi<441> : launch<441>)(a, p, stream);
    case 32:
      return (multi ? launch_multi<32> : launch<32>)(a, p, stream);
    default:
      return (multi ? launch_multi<0> : launch<0>)(a, p, stream);
  }
}

}  // namespace

extern "C" {

int adt_webrtc_hop_args_size() { return (int)sizeof(AdtWebRTCHopArgs); }

// The largest dynamic shared memory one block needs in a call with these
// arguments (the three single-hop kernels for a->hops == 1, the K-hop
// kernel else) in the walk a->cell_batched names; -1 if the arguments are
// not ones the kernels take.
long long adt_webrtc_hop_smem_bytes(const AdtWebRTCHopArgs* a) {
  FftPlan p;
  if (!args_ok(*a, &p)) return -1;
  if (a->hops > 1) return (long long)multi_bytes(*a);
  size_t most = spec_bytes(*a, true);
  if (cell_bytes(*a) > most) most = cell_bytes(*a);
  return (long long)most;
}

// The half-length M = n_fft / 2 whose instantiation runs a call with these
// arguments (768, 512, 441 or 32), 0 for the one that reads the geometry
// at run time, -1 if the arguments are not ones the kernels take.
int adt_webrtc_hop_fft_instance(const AdtWebRTCHopArgs* a) {
  FftPlan p;
  return args_ok(*a, &p) ? fft_instance(a->hop) : -1;
}

// The radices of the passes the kernels run for a complex FFT of m
// points, into radix[0..kMaxPasses); returns their count, -1 for m < 1.
int adt_webrtc_hop_fft_radices(int m, int* radix) {
  FftPlan p;
  if (!make_fft_plan(m, fft_instance(m) != 0, &p)) return -1;
  for (int i = 0; i < p.passes; ++i) radix[i] = p.radix[i];
  return p.passes;
}

// The registers a thread and the local (stack and spill) bytes of the
// M = 0 and M = 441 instantiations' kernels, as cudaFuncGetAttributes
// reads them: which 0 analysis_kernel<0>, 1 cell_kernel<false> (the
// per-frame walk), 2 gl_kernel<0>, 3 webrtc_hop_multi_kernel<0>, 4
// analysis_kernel<441>, 5 gl_kernel<441>, 6 webrtc_hop_multi_kernel<441>,
// 7 cell_kernel<true> (the batched walk). Returns the cudaError_t.
int adt_webrtc_hop_kernel_attrs(int which, int* regs,
                                long long* local_bytes) {
  const void* kernels[] = {(const void*)analysis_kernel<0>,
                           (const void*)cell_kernel<false>,
                           (const void*)gl_kernel<0>,
                           (const void*)webrtc_hop_multi_kernel<0>,
                           (const void*)analysis_kernel<441>,
                           (const void*)gl_kernel<441>,
                           (const void*)webrtc_hop_multi_kernel<441>,
                           (const void*)cell_kernel<true>};
  constexpr int n = sizeof(kernels) / sizeof(kernels[0]);
  if (which < 0 || which >= n) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernels[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (long long)attr.localSizeBytes;
  return (int)cudaSuccess;
}

// Launches one hop (a->hops == 1, three kernels) on `stream` without
// synchronising; returns the first failing launch's cudaError_t (0 on
// success).
int adt_webrtc_hop(const AdtWebRTCHopArgs* a, void* stream) {
  FftPlan p;
  if (!args_ok(*a, &p) || a->hops != 1) return (int)cudaErrorInvalidValue;
  if (a->batch <= 0) return (int)cudaSuccess;
  return (int)dispatch(*a, p, false, static_cast<cudaStream_t>(stream));
}

// Launches a->hops hops as one kernel on `stream` without synchronising.
int adt_webrtc_hop_multi(const AdtWebRTCHopArgs* a, void* stream) {
  FftPlan p;
  if (!args_ok(*a, &p)) return (int)cudaErrorInvalidValue;
  if (a->batch <= 0) return (int)cudaSuccess;
  return (int)dispatch(*a, p, true, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

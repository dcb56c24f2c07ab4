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
// 1. `analysis_stage`, kFftThreads lanes per stream: ring shift, peak, the
//    3-frame STFT as in-kernel FFTs, mel and log1p; the features and the
//    peak.
// 2. `cell_stage`, kThreads lanes per tile of kTile streams: the three
//    plan-cell steps on plan_cell.cuh's small-GEMM routine (the weights
//    come from L2, each tile reads them once per step), then the
//    residual; the mel magnitudes and hx.
// 3. `gl_stage`, kFftThreads lanes per stream: inverse mel, the warm seed,
//    the Griffin-Lim loop and the synthesis, with the magnitudes, phases,
//    previous rebuilt spectrum and time signal in shared memory (about
//    89 KB at n_fft 1536).
// One hop per call is three launches on the caller's stream, one per
// stage (`analysis_kernel`, `cell_kernel`, `gl_kernel`), with the features,
// mel magnitudes and peaks in scratch. K hops per call are one launch of
// `webrtc_hop_multi_kernel`: a block of kTile * kFftThreads threads owns a
// tile of kTile streams (one block per SM at n_fft 1536, about 210 KB of
// shared memory); it loads the tile's ring, OLA buffer, hx and both phase
// planes into shared memory once, runs the three stages K times (threads
// [kFftThreads s, kFftThreads (s + 1)) run stream s's transforms and wait
// at a named barrier of their own; the first kThreads run the cell, whose
// buffers alias stream 0's transform buffers), reading chunk k of
// (K, B, hop) and writing output k, and stores the state once: the
// counterpart of the Pallas kernel's VMEM scratch carried across its K
// grid steps. A ragged last tile leaves its missing stream's lanes idle.
// The transforms are real FFTs of n_fft points done as complex FFTs of
// m = n_fft / 2 points plus the real-input split; the three frames of a
// window are transformed side by side, 288 lanes (9 warps) per stream.
// The complex FFT is a Stockham autosort in a few wide passes: each lane
// loads an item's R points from shared memory, twiddles them, runs the
// R-point DFT in registers (8 and 12 as four-point DFTs and a second
// level) and stores them; ping-pong buffers in shared memory, one barrier
// per pass. At m = 768 the passes are 8 x 8 x 12 (a radix-8 pass is one
// item per lane), at m = 512 8 x 8 x 8, at m = 320 (n_fft 640) 8 x 8 x 5
// (5 runs in registers too). The first pass reads its points
// through the transform's input: the forward's reflect-indexed, windowed
// frames packed two samples a point, the inverse's real-input pre-twiddle
// of mag * (are + i aim); so a Griffin-Lim round waits at 8 barriers (3
// passes and the overlap-add for the inverse, 3 passes for the forward,
// the phase update). The inverse drops the imaginary parts of the DC and
// Nyquist bins, as irfft does. The passes' twiddles come from a table
// laid out pass by pass (neighbouring lanes read neighbouring entries),
// the real-input split's from a table of e^{-2 pi i t / n_fft}, both
// built in float64 by the wrapper; the in-register DFTs' own twiddles are
// compile-time constants. The element loops of the transforming stages
// stride by the constant kFftThreads. The geometry is compiled
// in: the stages that transform are templates on M = n_fft / 2, with
// instantiations for 768, 512 and 32 whose radices, strides and counts
// are constants (no division at run time), and M = 0, the same code with
// the geometry read from FftPlan at run time, for any other m that
// factors into 2, 3 and 5.
//
// Any mel count: the analysis's mel outputs (kFrames * n_mels of them) are
// split over the lanes as partial sums where they are fewer than the lanes,
// else each lane loops over outputs and writes them whole; the Griffin-Lim
// stage's inverse mel reads the cell's mel magnitudes where they lie (the
// single hop's scratch, the K-hop kernel's shared memory).

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
};

namespace {

constexpr int kFrames = 3;
// Lanes per stream of the FFT stages: 9 warps, so a radix-8 pass over the
// three frames at M = 768 (3 x 96 items) is one item per lane.
constexpr int kFftThreads = 288;
// the analysis's partial results: the peak tree's lanes, the mel outputs'
// partial sums where they are split (never more than the lanes)
constexpr int kRed = kFftThreads;
constexpr int kMultiThreads = kTile * kFftThreads;
constexpr int kCellBarrier = 1 + kTile;  // named barriers 1..kTile: streams
constexpr int kMaxPasses = 16;
static_assert(kThreads <= kMultiThreads, "the cell's lanes fit the block");
static_assert(kFftThreads % 32 == 0, "a named barrier counts whole warps");

// The radix of the next pass when `rest` points are left to combine: rest
// itself where the passes take it as one radix (12, 8, 5, 4, 3, 2), else
// the first of 8, 4, 2, 3 and 5 that divides it; 0 if rest has another
// prime factor. M = 768 runs 8 x 8 x 12, M = 512 8 x 8 x 8, M = 320
// 8 x 8 x 5, M = 32 8 x 4.
__host__ __device__ constexpr int next_radix(int rest) {
  return rest == 12 || rest == 8 || rest == 5 || rest == 4 || rest == 3 ||
                 rest == 2
             ? rest
         : rest % 8 == 0 ? 8
         : rest % 4 == 0 ? 4
         : rest % 2 == 0 ? 2
         : rest % 3 == 0 ? 3
         : rest % 5 == 0 ? 5
                         : 0;
}

// The radices of the complex FFT of m = n_fft / 2 points, read at run time
// by the M = 0 instantiation (see `fft`); m = 1 is one pass of radix 1.
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
    const int r = next_radix(rest);
    if (r == 0) return false;
    p->radix[p->passes++] = r;
    rest /= r;
  }
  if (p->passes == 0) p->radix[p->passes++] = 1;
  return rest == 1;
}

// The half-lengths M = n_fft / 2 with an instantiation of their own, whose
// geometry (radices, strides, frame and bin counts) is compile-time
// constant: 768 (n_fft 1536, every 48 kHz WebRTC preset), 512 (n_fft
// 1024) and 32 (n_fft 64, the JAX tests' geometry). Any other M that
// `args_ok` accepts runs the M = 0 instantiation, the same code with the
// geometry read from FftPlan at run time.
int fft_instance(int m) {
  return m == 768 || m == 512 || m == 32 ? m : 0;
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

// Twiddle r of item k of a pass after passes of product ns, span L = ns R:
// e^{-+2 pi i k r / L}, entry r ns + k - 1 of the passes' table (which
// follows the n_fft-point table in AdtWebRTCHopArgs::twiddle). Pass i's
// entries (1 <= r < R, k < ns) fill [ns - 1, L - 1), so the passes of an
// FFT of m points fill m - 1 entries, and the lanes of a pass (k runs
// with the lane) read neighbouring entries.
template <bool kInverse>
__device__ __forceinline__ float2 pass_twiddle(const float2* ptw, int r,
                                               int ns, int k) {
  const float2 w = __ldg(ptw + r * ns + k - 1);
  return kInverse ? conjf2(w) : w;
}

// cos(2 pi t / n), for the compiler to evaluate: the Taylor series in
// double after reducing the angle to [-pi, pi].
__host__ __device__ constexpr double cos_turn(int t, int n) {
  const double pi = 3.14159265358979323846;
  double x = 2 * pi * (double)(((t % n) + n) % n) / n;
  if (x > pi) x -= 2 * pi;
  double term = 1, sum = 1;
  for (int k = 1; k < 24; ++k) {
    term *= -x * x / ((2 * k - 1) * (2 * k));
    sum += term;
  }
  return sum;
}

// v e^{-+2 pi i q / R} for a compile-time q: nothing, a sign change or a
// quarter turn where the factor is 1, -1 or -+i, else a product by
// constants.
template <bool kInverse, int R, int q>
__device__ __forceinline__ float2 rotate(float2 v) {
  constexpr int t = q % R;
  if constexpr (t == 0) {
    return v;
  } else if constexpr (4 * t == R) {
    return rot90<kInverse>(v);
  } else if constexpr (2 * t == R) {
    return make_float2(-v.x, -v.y);
  } else if constexpr (4 * t == 3 * R) {
    return rot90<!kInverse>(v);
  } else {
    constexpr float c = (float)cos_turn(t, R);
    constexpr float s = (float)cos_turn(4 * t - R, 4 * R);  // sin(2 pi t / R)
    return cmul(v, make_float2(c, kInverse ? s : -s));
  }
}

// The DFT of R points in registers, in place and in natural order:
// v[s] <- sum_r v[r] e^{-+2 pi i r s / R}, R = 1, 2, 3, 4, 5, 8 or 12. 5
// pairs the points r and 5 - r (sums and differences) and weights them by
// the cosines and sines of 2 pi / 5 and 4 pi / 5. 8 and
// 12 run four-point DFTs over the R / 4 subsequences v[n2 + (R / 4) n1],
// twiddle them by e^{-+2 pi i n2 k1 / R}, and finish with R / 4-point DFTs
// across the subsequences.
template <bool kInverse, int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 3) {
    const float2 s = cadd(v[1], v[2]);
    const float2 d = rot90<kInverse>(csub(v[1], v[2]));
    const float2 mid = make_float2(v[0].x - 0.5f * s.x, v[0].y - 0.5f * s.y);
    const float c = 0.86602540378443864676f;  // sqrt(3) / 2
    v[0] = cadd(v[0], s);
    v[1] = make_float2(mid.x + c * d.x, mid.y + c * d.y);
    v[2] = make_float2(mid.x - c * d.x, mid.y - c * d.y);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]);
    const float2 t3 = rot90<kInverse>(csub(v[1], v[3]));
    v[0] = cadd(t0, t2);
    v[1] = cadd(t1, t3);
    v[2] = csub(t0, t2);
    v[3] = csub(t1, t3);
  } else if constexpr (R == 5) {
    const float c1 = 0.30901699437494742410f;   // cos(2 pi / 5)
    const float c2 = -0.80901699437494742410f;  // cos(4 pi / 5)
    const float s1 = 0.95105651629515357212f;   // sin(2 pi / 5)
    const float s2 = 0.58778525229247312917f;   // sin(4 pi / 5)
    const float2 a1 = cadd(v[1], v[4]), b1 = csub(v[1], v[4]);
    const float2 a2 = cadd(v[2], v[3]), b2 = csub(v[2], v[3]);
    const float2 t1 = make_float2(v[0].x + c1 * a1.x + c2 * a2.x,
                                  v[0].y + c1 * a1.y + c2 * a2.y);
    const float2 t2 = make_float2(v[0].x + c2 * a1.x + c1 * a2.x,
                                  v[0].y + c2 * a1.y + c1 * a2.y);
    // -+i times these: the odd parts of outputs 1 and 2
    const float2 u1 = rot90<kInverse>(make_float2(s1 * b1.x + s2 * b2.x,
                                                  s1 * b1.y + s2 * b2.y));
    const float2 u2 = rot90<kInverse>(make_float2(s2 * b1.x - s1 * b2.x,
                                                  s2 * b1.y - s1 * b2.y));
    v[0] = cadd(v[0], cadd(a1, a2));
    v[1] = cadd(t1, u1);
    v[2] = cadd(t2, u2);
    v[3] = csub(t2, u2);
    v[4] = csub(t1, u1);
  } else if constexpr (R == 8 || R == 12) {
    constexpr int Q = R / 4;
    float2 y[Q][4];
#pragma unroll
    for (int n2 = 0; n2 < Q; ++n2) {
      float2 u[4] = {v[n2], v[Q + n2], v[2 * Q + n2], v[3 * Q + n2]};
      dft<kInverse, 4>(u);
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1) y[n2][k1] = u[k1];
    }
    y[1][1] = rotate<kInverse, R, 1>(y[1][1]);
    y[1][2] = rotate<kInverse, R, 2>(y[1][2]);
    y[1][3] = rotate<kInverse, R, 3>(y[1][3]);
    if constexpr (Q == 3) {
      y[2][1] = rotate<kInverse, R, 2>(y[2][1]);
      y[2][2] = rotate<kInverse, R, 4>(y[2][2]);
      y[2][3] = rotate<kInverse, R, 6>(y[2][3]);
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      float2 z[Q];
#pragma unroll
      for (int n2 = 0; n2 < Q; ++n2) z[n2] = y[n2][k1];
      dft<kInverse, Q>(z);
#pragma unroll
      for (int k2 = 0; k2 < Q; ++k2) v[k1 + 4 * k2] = z[k2];
    }
  } else {
    static_assert(R == 1, "radices 1, 2, 3, 4, 5, 8 and 12");
  }
}

// A pass's input read from a buffer of kFrames sequences of m points.
struct BufLoad {
  const float2* in;
  int m;
  __device__ __forceinline__ float2 operator()(int f, int q) const {
    return in[f * m + q];
  }
};

// One Stockham pass of radix R over kFrames complex sequences of m points
// laid end to end: each lane loads an item's R points (point q of frame f
// is load(f, q)), twiddles them, runs the R-point DFT in registers and
// stores the R results to out; the group's barrier closes the pass. ns is
// the product of the earlier passes' radices, ptw the passes' twiddles.
template <bool kInverse, int R, class Load>
__device__ __forceinline__ void fft_pass(const Load& load, float2* out,
                                         int m, int ns, const float2* ptw,
                                         const Lanes& g) {
  const int stride = m / R;
  const int L = ns * R;
  for (int e = g.id; e < kFrames * stride; e += g.n) {
    const int f = e / stride, j = e % stride;
    const int k = j % ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = load(f, j + r * stride);
      if (r > 0 && k > 0)
        v[r] = cmul(v[r], pass_twiddle<kInverse>(ptw, r, ns, k));
    }
    dft<kInverse, R>(v);
    float2* dst = out + f * m;
    const int base = (j / ns) * L + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[base + r * ns] = v[r];
  }
  group_sync(g);
}

// The passes of a compile-time M from the one of width kNs on, in -> out
// and back: each pass's radix, stride and span are constants, and the
// recursion unrolls them.
template <bool kInverse, int kM, int kNs>
__device__ __forceinline__ float2* fft_fixed(float2* in, float2* out,
                                             const float2* ptw,
                                             const Lanes& g) {
  if constexpr (kNs == kM) {
    return in;
  } else {
    constexpr int R = next_radix(kM / kNs);
    static_assert(R != 0, "M factors into 2, 3 and 5");
    fft_pass<kInverse, R>(BufLoad{in, kM}, out, kM, kNs, ptw, g);
    return fft_fixed<kInverse, kM, kNs * R>(out, in, ptw, g);
  }
}

// A pass of the radix read at run time (the M = 0 instantiation).
template <bool kInverse, class Load>
__device__ __forceinline__ void runtime_pass(int radix, const Load& load,
                                             float2* out, int m, int ns,
                                             const float2* ptw,
                                             const Lanes& g) {
  switch (radix) {
    case 12:
      return fft_pass<kInverse, 12>(load, out, m, ns, ptw, g);
    case 8:
      return fft_pass<kInverse, 8>(load, out, m, ns, ptw, g);
    case 5:
      return fft_pass<kInverse, 5>(load, out, m, ns, ptw, g);
    case 4:
      return fft_pass<kInverse, 4>(load, out, m, ns, ptw, g);
    case 3:
      return fft_pass<kInverse, 3>(load, out, m, ns, ptw, g);
    case 2:
      return fft_pass<kInverse, 2>(load, out, m, ns, ptw, g);
    default:
      return fft_pass<kInverse, 1>(load, out, m, ns, ptw, g);
  }
}

// Complex FFT (unnormalized) of kFrames sequences of m points whose input
// point q of frame f is first(f, q): the first pass reads its points
// through `first` (the windowing or the real-input pre-twiddle fused into
// it) and writes buf0, the later passes ping-pong between buf0 and buf1.
// Returns the buffer that holds the result. kM = m = n_fft / 2, or 0 to
// read the radices from p.
template <bool kInverse, int kM, class Load>
__device__ __forceinline__ float2* fft(const Load& first, float2* buf0,
                                       float2* buf1, const FftPlan& p,
                                       const float2* ptw, const Lanes& g) {
  if constexpr (kM > 0) {
    constexpr int R = next_radix(kM);
    fft_pass<kInverse, R>(first, buf0, kM, 1, ptw, g);
    return fft_fixed<kInverse, kM, R>(buf0, buf1, ptw, g);
  } else {
    runtime_pass<kInverse>(p.radix[0], first, buf0, p.m, 1, ptw, g);
    float2* in = buf0;
    float2* out = buf1;
    int ns = p.radix[0];
    for (int i = 1; i < p.passes; ++i) {
      runtime_pass<kInverse>(p.radix[i], BufLoad{in, p.m}, out, p.m, ns, ptw,
                             g);
      ns *= p.radix[i];
      float2* t = in;
      in = out;
      out = t;
    }
    return in;
  }
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
  return fft<false, kM>(frame, reinterpret_cast<float2*>(smem + l.buf0),
                        reinterpret_cast<float2*>(smem + l.buf1), p,
                        a.twiddle + n_fft, g);
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
      fft<true, kM>(spectrum, reinterpret_cast<float2*>(smem + l.buf0),
                    reinterpret_cast<float2*>(smem + l.buf1), p,
                    a.twiddle + n_fft, g));
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
  g.n = kFftThreads;  // what both entry points give a stream: a constant
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

// Stage 2 for a tile of kTile streams (`rows` of them real), the cell's
// layout at dynamic shared memory + base: hx from hx_in (n_hidden a
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
  g.n = kFftThreads;  // what both entry points give a stream: a constant
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
__global__ void __launch_bounds__(kFftThreads)
    analysis_kernel(const __grid_constant__ AdtWebRTCHopArgs a,
                    const __grid_constant__ FftPlan p) {
  const size_t b = blockIdx.x;
  analysis_stage<kM>(a, p, 0, block_lanes(), a.ring + b * a.n_fft,
                 a.chunk + b * a.hop, a.ring_out + b * a.n_fft,
                 a.feat + b * kFrames * a.n_mels, a.peak + b);
}

__global__ void __launch_bounds__(kThreads, 1)
    cell_kernel(const __grid_constant__ AdtWebRTCHopArgs a) {
  const size_t b0 = (size_t)blockIdx.x * kTile;
  const int rows = min(kTile, a.batch - (int)b0);
  const size_t n = a.plan.n_hidden, nf = kFrames * a.n_mels;
  cell_stage(a, 0, block_lanes(), rows, a.hx + b0 * n, a.feat + b0 * nf,
             a.mel_mag + b0 * nf, a.hx_out + b0 * n);
}

template <int kM>
__global__ void __launch_bounds__(kFftThreads, 2)
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
// cell runs), else it follows.
struct MultiLayout {
  SpecLayout spec;
  int stream[kTile];
  int ld_t;                            // ring and OLA rows
  int ring, ola, hx, feat, mel_mag, peak;
  int cell;
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
  CellLayout cl;
  int cell = 0;
  make_cell_layout(a.plan, &cl, &cell);
  l.cell = cell <= l.spec.are ? l.stream[0] : take(&off, 1, cell);
  l.total = off;
  return l;
}

// The resident K-hop kernel (webrtc_hop.py:344): a.hops hops of a tile of
// kTile streams with its state in shared memory throughout.
template <int kM>
__global__ void __launch_bounds__(kMultiThreads, 1)
    webrtc_hop_multi_kernel(const __grid_constant__ AdtWebRTCHopArgs a,
                            const __grid_constant__ FftPlan p) {
  extern __shared__ __align__(16) float smem[];
  const MultiLayout l = make_multi_layout(a);
  const int b0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.batch - b0);
  const int n_fft = a.n_fft, hop = a.hop, n = a.plan.n_hidden;
  const int nf = kFrames * a.n_mels, nb = kFrames * a.n_bins;
  const int tid = threadIdx.x, s = tid / kFftThreads;
  const Lanes fft_lanes{tid % kFftThreads, kFftThreads, 1 + s};
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
      cell_stage(a, l.cell, cell_lanes, rows, hx, feat, mel_mag, hx);
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
         a.n_mels >= 1 && make_fft_plan(a.hop, p);
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
  cudaError_t err;
  if ((err = set_smem((const void*)analysis_kernel<kM>, sa)) != cudaSuccess ||
      (err = set_smem((const void*)cell_kernel, sc)) != cudaSuccess ||
      (err = set_smem((const void*)gl_kernel<kM>, sg)) != cudaSuccess)
    return err;
  analysis_kernel<kM><<<a.batch, kFftThreads, sa, stream>>>(a, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cell_kernel<<<(a.batch + kTile - 1) / kTile, kThreads, sc, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gl_kernel<kM><<<a.batch, kFftThreads, sg, stream>>>(a, p);
  return cudaGetLastError();
}

template <int kM>
cudaError_t launch_multi(const AdtWebRTCHopArgs& a, const FftPlan& p,
                         cudaStream_t stream) {
  const size_t sm = multi_bytes(a);
  cudaError_t err = set_smem((const void*)webrtc_hop_multi_kernel<kM>, sm);
  if (err != cudaSuccess) return err;
  webrtc_hop_multi_kernel<kM>
      <<<(a.batch + kTile - 1) / kTile, kMultiThreads, sm, stream>>>(a, p);
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
// kernel else); -1 if the arguments are not ones the kernels take.
long long adt_webrtc_hop_smem_bytes(const AdtWebRTCHopArgs* a) {
  FftPlan p;
  if (!args_ok(*a, &p)) return -1;
  if (a->hops > 1) return (long long)multi_bytes(*a);
  size_t most = spec_bytes(*a, true);
  if (cell_bytes(*a) > most) most = cell_bytes(*a);
  return (long long)most;
}

// The half-length M = n_fft / 2 whose instantiation runs a call with these
// arguments (768, 512 or 32), 0 for the one that reads the geometry at
// run time, -1 if the arguments are not ones the kernels take.
int adt_webrtc_hop_fft_instance(const AdtWebRTCHopArgs* a) {
  FftPlan p;
  return args_ok(*a, &p) ? fft_instance(a->hop) : -1;
}

// The radices of the passes the kernels run for a complex FFT of m
// points, into radix[0..kMaxPasses); returns their count, -1 if m does not
// factor into 2, 3 and 5.
int adt_webrtc_hop_fft_radices(int m, int* radix) {
  FftPlan p;
  if (m < 1 || !make_fft_plan(m, &p)) return -1;
  for (int i = 0; i < p.passes; ++i) radix[i] = p.radix[i];
  return p.passes;
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

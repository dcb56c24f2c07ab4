// The whole streaming serving hop as CUDA kernels for Hopper (sm_90a).
//
// Replaces two Pallas kernels of audio_denoising_tpu/ops/pallas/
// fused_hop.py::make_fused_hop: the single-hop `kernel` (fused_hop.py:242)
// and the resident multi-hop `kernel_multi` (fused_hop.py:384), with the
// cell math of ops/pallas/common.py::plan_cell_math as plan_cell.cuh's
// `plan_cell` routine. This file covers their three compute modes (fp32,
// bf16 and W8A8 int8; fused_hop.py:138-153, :205-223) in the mel and the
// raw-spectrogram domain, with the MOMO3 delta carry, the SNR gate
// (estimators 'removed', 'floor' and 'both') and int16 IO. The plain
// PyTorch version of the same function is FusedHop.reference in
// audio_denoising_torch/ops/kernels/fused_hop.py.
//
// Compute modes (AdtFusedHopArgs.compute): in bf16 the DFT pair, the mel
// pair and the plan's matrices are bf16 and every matmul rounds its
// activation to bf16, with fp32 sums; in int8 the plan's matrices are
// int8 with fp32 column scales (plan_cell.cuh's gemm_q: per-row dynamic
// quantization, dp4a into int32, rank-1 dequant) and the DSP matmuls run
// as in bf16. Windows, biases, scales and every state plane stay fp32.
// Each mode is its own instantiation of both kernels, so the fp32 ones
// run the code they ran before the modes were added. The fp32 walks take
// the transforms as in-kernel FFTs (fft.cuh; AdtFusedHopArgs.transform,
// chosen on the host) where the reduced modes keep the DFT pair as
// matmuls. The weight bytes a block streams per hop fall with the mode:
// at gruunet2-stream16k 3.0 MB in fp32 (6.3 with the dense DFT pair), 3.2
// MB in bf16, 1.8 MB in int8 (the DSP pair stays bf16).
//
// Per stream and hop: shift the analysis ring, apply the Hann window,
// take the DFT (a real FFT, or cos/sin matmuls) and the magnitude,
// project to mel and take log(1 + .) (in the raw domain log(1 + .) of the
// magnitude itself,
// fused_hop.py:164-168), run the plan cell (encoder matmuls with ReLU, the
// reset-gate matmul, GRU gating, decoder matmuls with split skips; a
// delta plan's level 0 over cat(x, prev), with prev the previous hop's
// feature, kept as a state plane), subtract the residual, leaky-ReLU 0.2,
// exp - 1 clamped at 0, inverse mel clamped at 0 (none in the raw domain)
// times the output gain, the SNR gate (ops/noisefloor.py:
// per-stream EMAs of the output and removed power and the per-bin noise
// floor, then the output magnitude blended toward the input's), reuse the
// noisy phase by scaling the complex bins, inverse DFT (an inverse real
// FFT, or matmuls), window,
// overlap-add divided by the window envelope, and decay the hidden state
// (prev' = this hop's feature, not decayed).
//
// What bounds it on an H100 (gruunet2-stream16k, B = 256 streams): the
// function needs about 393 MFLOP per hop (plan cell 364 M, mel pair 21 M,
// and the transform and its inverse at real-FFT cost, 2.5 N log2 N each,
// 7.6 M; the gate adds about 20 per bin), 5.9 us against 67 TFLOP/s of
// fp32 FMA, while its bytes (3.0 MB of weights without DFT matrices,
// 3.4 MB of state in and out) over 3.35 TB/s are 1.9 us: the hop is bound
// by fp32 operations. K hops in one call move the weights and the state
// once and K chunks in and out, so the call stays bound by operations.
// The fp32 walks take the transforms as FFTs of n_fft / 2 points in a few
// passes (their twiddles 7.7 KB at n_fft 640), the work the bound counts;
// as dense cos/sin matmuls (the reduced modes, and fp32 past n_fft 2048)
// they are 420 of 805 MFLOP a hop and 3.3 of 6.3 MB a block streams, and
// each thread's chain of dependent L2 loads doubles. On an H100 the FFTs
// took the stream16k single hop from 141 to 95 us and gruunet2-good's
// (n_fft 1024, 8.4 of 11.5 MB the DFT pair) from 230 to 101, in turns
// (PERF.md). Parity with the reference needs fp32, so the kernel
// uses FMA, not TF32 tensor cores.
//
// Design: one block of 512 threads owns a tile of kTile = 2 streams and
// walks the chain's stages in order, with every activation and the tile's
// whole state (ring, OLA buffer, hx, the gate's planes) in dynamic shared
// memory, except in the int8 mode the gate's two per-bin floor planes,
// which stay in the state tensors in global memory (see make_layout).
// Both entry points load the state once, run the hops, and write the
// state back once: the single-hop kernel runs one hop, the multi-hop
// kernel K, reading chunk k from (K, B, hop) and writing output k, the
// counterpart of the Pallas kernel's VMEM scratch carried across its K
// grid steps. The weights (3.0 MB in fp32 at stream16k) stay in global
// memory and are served from the 50 MB L2. All the matmuls (13 at
// stream16k; 17 with the dense DFT pair) go through the small-GEMM
// routine of plan_cell.cuh (`gemm`, shared with webrtc_hop.cu), which that
// header describes; splitting their k within a warp and adding the
// partial sums by shuffles (in place of the scratch) measured 179 us
// against 95 at stream16k (PERF.md) and is not used. The hops run in one
// of two walks, the same in both entry points of a configuration
// (AdtFusedHopArgs.group, chosen on the host),
// so K hops in one call equal K single hops bit for bit: the per-frame
// walk (`hop_body`, kept out of line: every stage once a hop, each block
// reading each weight once a hop; the bf16 and int8 modes, and fp32 where
// a group does not fit), or in fp32 the frame-group walk (`group_walk`,
// below), which runs the stages that read no state once for a group of
// hops.
//
// The tile trades two limits: a larger tile streams fewer weight bytes
// from L2 in all (each block reads all of them), a smaller one gives each
// thread less dependent work. At B = 256 on an H100, tile 2 measured best
// of tiles 1, 2, 4 and 8 (PERF.md); the kernel then pulled about 800 MB
// per hop from L2 with the dense DFT pair, 390 MB with the FFTs.
//
// MOMO3-4d4ea0 (48 kHz, n_fft 42, hop 21, 22 raw bins, B = 256): the
// plan cell's 80,000 multiply-adds a stream per hop (the transforms add
// 1.1 kFLOP at FFT cost), 41 MFLOP in all, 0.62 us against 67 TFLOP/s;
// its 0.68 MB of weights and state over 3.35 TB/s are 0.20 us: bound by
// operations again. Its plan (0.33 MB) is small: a hop is a chain of
// short dependent stages with most of the 512 threads idle in each (the
// widest matmul has 44 column quads). Its transforms are FFTs too (3 x 7,
// a prime pass of 7): the dense 42 x 22 pair took 74 against 66 us in the
// same build (PERF.md). The real-time budget of one hop is 437.5 us.

#include <cuda_runtime.h>

#include "fft.cuh"
#include "plan_cell.cuh"

// ops/kernels/build.py compiles this source as three objects at once, with
// ADT_FUSED_HOP_PART 0 (the fp32 kernels and the C interface), 1 (the bf16
// kernels) and 2 (the int8 kernels), and links them into one library:
// each mode's kernels are instantiated in its own part only, so three
// nvcc processes share the build. Without the macro one object holds all
// (chip_ab.py builds another source so).
#ifndef ADT_FUSED_HOP_PART
#define ADT_FUSED_HOP_PART -1
#endif
#define ADT_IN_PART(p) (ADT_FUSED_HOP_PART < 0 || ADT_FUSED_HOP_PART == (p))

// One set of per-stream state planes, B rows each. The gate's planes are
// null when the configuration does not carry them.
struct AdtHopState {
  float* ring;       // (B, n_fft) analysis ring
  float* ola;        // (B, n_fft) synthesis accumulator
  float* hx;         // (B, n_hidden) cell state
  float* prev;       // (B, n_mels) delta plans: the previous hop's feature
  float* nf_smooth;  // (B, n_bins) estimator 'floor': smoothed power
  float* nf_floor;   // (B, n_bins) estimator 'floor': tracked floor
  float* nf_total;   // (B,) estimator 'floor': long power EMA
  float* em_out;     // (B,) estimator 'removed': output-power EMA
  float* em_rem;     // (B,) estimator 'removed': removed-power EMA
};

// The SNR gate's constants (ops/noisefloor.py); removed = floor = 0 is no
// gate.
struct AdtGate {
  int removed;            // estimator 'removed' or 'both'
  int floor;              // estimator 'floor' or 'both'
  float gate_db;          // the decision's ramp: gate and width
  float width_db;
  float floor_gate_db;    // the floor part's ramp (the veto under 'both')
  float floor_width_db;
  float beta;             // per-bin power smoothing
  float rise;             // the floor's per-frame rise bound
  float beta_tot;         // the long EMAs
  float floor_bias;
  float eps;
};

// Mirrored field by field by _Args in ops/kernels/fused_hop.py;
// adt_fused_hop_args_size lets the wrapper check the layouts agree.
struct AdtFusedHopArgs {
  AdtHopState in;
  AdtHopState out_state;
  const void* chunk;   // (hops, B, hop) float32, or int16 when pcm16
  void* out;           // (hops, B, hop), the chunk's type
  // the DSP matrices: float32 in the fp32 mode, bf16 in the others
  const void* cf;      // (n_fft, n_bins) forward DFT, real part
  const void* sf;      // (n_fft, n_bins) forward DFT, imaginary part
  const void* ic;      // (n_bins, n_fft) inverse DFT from the real part
  const void* is_;     // (n_bins, n_fft) inverse DFT from the imaginary part
  const void* mel;     // (n_bins, n_mels); null in the raw domain
  const void* imel;    // (n_mels, n_bins); null in the raw domain
  const float* win;    // (n_fft,)
  const float* env;    // (hop,) overlap-add envelope
  AdtPlan plan;        // matrices float32, bf16 or int8, as `compute`
  AdtGate gate;
  int batch;
  int n_fft;
  int hop;
  int n_bins;
  int n_mels;          // the model's features: n_bins in the raw domain
  int raw;             // raw-spectrogram domain: no mel pair
  int hops;            // hops per call (the multi-hop kernel)
  int pcm16;           // chunks and outputs are int16 (the multi-hop kernel)
  int group;           // the fp32 multi-hop kernel's walk: 0 per frame,
                       // kGroup the frame-group walk in groups of kGroup
  // the fp32 walks' transforms: 0 the dense DFT matmuls (cf, sf, ic, is_),
  // 1 in-kernel FFTs (fft.cuh), which read none of those matrices
  int transform;
  // transform 1: e^{-2 pi i t / n_fft} for t < n_fft, then the passes'
  // twiddles of the FFT of n_fft / 2 points (fft.cuh's pass_twiddle)
  const float2* twiddle;
  FftPlan fft;  // the library fills it from n_fft (make_fft_plan)
  float output_gain;
  float state_decay;
  AdtPlanScales scales;  // the int8 plan's column scales
  int compute;           // 0 fp32, 1 bf16, 2 int8 (W8A8)
};

namespace {

enum Compute { kFp32 = 0, kBf16 = 1, kInt8 = 2 };

// The weight elements of each mode: the DSP matrices', the plan's.
template <int kCompute>
struct Types {
  using Dsp = bf16_t;
  using Plan = i8;
};
template <>
struct Types<kFp32> {
  using Dsp = float;
  using Plan = float;
};
template <>
struct Types<kBf16> {
  using Dsp = bf16_t;
  using Plan = bf16_t;
};

// Per-stream scalars in shared memory, and the partial sums of the gate's
// four bin means (32 per mean and stream).
enum Scalar { kTot = 0, kEmo, kEmr, kAlpha, kScalars = 4 };
constexpr int kMeans = 4;  // output, removed and input power; the floor
constexpr int kLanes = 32;
static_assert(kTile * kMeans * kLanes <= kThreads,
              "one thread per partial sum of the gate's means");
constexpr float kDbPerNeper = 4.342944819032518f;  // 10 / ln 10

// Offsets (in floats) of the per-block shared-memory buffers: the hop's
// activations, the tile's state, then the cell's (plan_cell.cuh), each
// kTile rows of a leading dimension rounded up to 4 floats.
//
// The int8 mode keeps the gate's two per-bin floor planes (nf_smooth,
// nf_floor) out of shared memory (floor_in_global): its plan's staging
// buffer brings the quality flagship (n_fft 1024, 128 mels, hidden 64) to
// 231,600 B a block, and the planes' 2 x kTile x 516 floats would take it
// to 239,856, over an H100's 232,448. Each bin's planes are read and
// written once a hop, by the one thread that steps that bin's tracker
// (gate_alphas), so in global memory they cost 8 KB of L2 traffic a block
// per hop against the hop's megabytes of weights, and need no barrier:
// hop 0 reads the input state and writes the output state, later hops of
// the multi-hop kernel read back what the same thread wrote. The fp32 and
// bf16 modes, which fit, keep them in shared memory.
struct Layout {
  int ld_t, ld_f, ld_m;
  int frame, re, im, mag, lin;
  int ring, ola, prev, nfs, nff, sc, red;
  CellLayout cell;
  int total;
};

__host__ __device__ inline bool floor_in_global(const AdtFusedHopArgs& a) {
  return a.compute == kInt8;
}

__host__ __device__ inline void make_layout(const AdtFusedHopArgs& a,
                                            Layout* l) {
  int off = 0;
  l->ld_t = round4(a.n_fft);
  l->ld_f = round4(a.n_bins);
  l->ld_m = round4(a.n_mels);
  l->frame = take(&off, kTile, l->ld_t);
  l->re = take(&off, kTile, l->ld_f);
  l->im = take(&off, kTile, l->ld_f);
  l->mag = take(&off, kTile, l->ld_f);
  l->lin = take(&off, kTile, l->ld_f);
  l->ring = take(&off, kTile, l->ld_t);
  l->ola = take(&off, kTile, l->ld_t);
  l->prev = a.plan.delta ? take(&off, kTile, l->ld_m) : 0;
  const bool floor_smem = a.gate.floor && !floor_in_global(a);
  l->nfs = floor_smem ? take(&off, kTile, l->ld_f) : 0;
  l->nff = floor_smem ? take(&off, kTile, l->ld_f) : 0;
  l->sc = take(&off, kTile, kScalars);
  l->red = take(&off, kTile, kMeans * kLanes);
  make_cell_layout(a.plan, &l->cell, &off, a.compute == kInt8);
  l->total = off;
}

__device__ inline float load_sample(const AdtFusedHopArgs& a, int k,
                                    size_t b, int i) {
  const size_t idx = ((size_t)k * a.batch + b) * a.hop + i;
  if (a.pcm16)  // s16 -> f32, the reference's 1/32768 scale
    return (float)static_cast<const short*>(a.chunk)[idx] * (1.f / 32768.f);
  return static_cast<const float*>(a.chunk)[idx];
}

__device__ inline void store_sample(const AdtFusedHopArgs& a, int k,
                                    size_t b, int i, float v) {
  const size_t idx = ((size_t)k * a.batch + b) * a.hop + i;
  if (a.pcm16)  // clip to [-1, 1], x 32767, truncated toward zero
    static_cast<short*>(a.out)[idx] =
        (short)__float2int_rz(fminf(fmaxf(v, -1.f), 1.f) * 32767.f);
  else
    static_cast<float*>(a.out)[idx] = v;
}

// -- the transforms as in-kernel FFTs (fp32, AdtFusedHopArgs.transform) ----
//
// The forward real DFT of nf windowed frames and the inverse of nf
// phase-reused spectra on fft.cuh's FFT of m = n_fft / 2 points, its
// radices and the frame count read at run time (a.fft, nf), over the
// lanes `g`: in place of the dense DFT matmuls, whose 4 n_fft (n_fft / 2 +
// 1) floats every block read every hop (3.3 MB at n_fft 640, 8.4 MB at
// 1024) and whose 4 n_fft^2 multiply-adds a stream were half the hop's.
// The single hop (nf = kTile) and the frame-group walk (nf = kGroup kTile)
// call the same two functions, so each frame's outputs come from the same
// instructions and each hop gets the same sums in both. Two buffers of nf
// n_fft floats ping-pong: `buf` (the split-K scratch, free around the
// transforms) and the frames' own buffer (dead once the first pass has
// read it; for the inverse, before the overlap-add writes it). The host
// takes them for n_fft <= 4 kThreads, where nf n_fft floats fit the
// scratch of nf rows (transform_ok).

// re, im and the magnitude of bins 0 .. n_fft / 2 of each of nf windowed
// frames (rows of `frames`, leading dimension ld_t) into rows of re, im and
// mag (leading dimension ld_f): the complex FFT of each frame packed two
// samples a point, then the real-input split. Ends on the group's barrier.
__device__ __noinline__ void forward_dft(const AdtFusedHopArgs& a, int nf,
                                         float* frames, int ld_t, float* buf,
                                         float* re, float* im, float* mag,
                                         int ld_f, Lanes g) {
  const int m = a.fft.m, F = m + 1;
  const float2* tw = a.twiddle;
  const auto packed = [=](int f, int q) {
    return *reinterpret_cast<const float2*>(frames + f * ld_t + 2 * q);
  };
  const float2* Z = fft<false, 0, 0>(packed, reinterpret_cast<float2*>(buf),
                                     reinterpret_cast<float2*>(frames), a.fft,
                                     tw, g, nf);
  for (int e = g.id; e < nf * F; e += g.n) {
    const int f = e / F, k = e % F;
    const float2 v = real_bin(Z + f * m, m, k, tw);
    const int o = f * ld_f + k;
    re[o] = v.x;
    im[o] = v.y;
    mag[o] = sqrtf(v.x * v.x + v.y * v.y);
  }
  group_sync(g);
}

// n_fft times the inverse real DFT (irfft) of nf spectra (rows of re and
// im, leading dimension ld_f; the imaginary parts of DC and Nyquist
// dropped, as irfft does) into nf rows of n_fft samples end to end at
// `buf`, with `spare` (nf n_fft floats) the other buffer: the first pass
// reads the real-input pre-twiddle of the bins. Ends on the group's
// barrier.
__device__ __noinline__ void inverse_dft(const AdtFusedHopArgs& a, int nf,
                                         const float* re, const float* im,
                                         int ld_f, float* buf, float* spare,
                                         Lanes g) {
  const int m = a.fft.m;
  const float2* tw = a.twiddle;
  const auto spectrum = [=](int f, int k) {
    const float* r = re + f * ld_f;
    const float* i = im + f * ld_f;
    float2 xk = make_float2(r[k], i[k]);
    float2 xc = make_float2(r[m - k], -i[m - k]);
    if (k == 0) {
      xk.y = 0.f;
      xc.y = 0.f;
    }
    const float2 ev = cadd(xk, xc);
    const float2 od = cmul(csub(xk, xc), conjf2(__ldg(tw + k)));
    return cadd(ev, rot90<true>(od));
  };
  // the passes alternate from the first buffer: an odd count ends there
  const bool odd = a.fft.passes & 1;
  fft<true, 0, 0>(spectrum, reinterpret_cast<float2*>(odd ? buf : spare),
                  reinterpret_cast<float2*>(odd ? spare : buf), a.fft, tw, g,
                  nf);
}

// One synthesised sample: base + (the inverse FFT's sample x 1 / n_fft) x
// the window, in explicit roundings, so that both walks add it alike.
__device__ __forceinline__ float overlap_add(float base, float sample,
                                             float inv_n, float win) {
  return __fmaf_rn(__fmul_rn(sample, inv_n), win, base);
}

// hx's offset and leading dimension in each walk's layout.
__device__ __forceinline__ int hx_of(const Layout& l) { return l.cell.hx; }
__device__ __forceinline__ int ld_n_of(const Layout& l) {
  return l.cell.ld_n;
}

// Copies rows [b0, b0 + rows) of state `st` into the tile's shared
// memory (to = true; rows past the batch are zeros) or back (to = false),
// at the offsets of the walk's layout L (Layout or GroupLayout).
template <class L>
__device__ inline void move_state(const AdtFusedHopArgs& a, const L& l,
                                  float* smem, const AdtHopState& st, int b0,
                                  int rows, bool to) {
  const int n_fft = a.n_fft, F = a.n_bins, n = a.plan.n_hidden;
  auto move = [&](float* g, int width, int off, int ld) {
    for (int e = threadIdx.x; e < kTile * width; e += blockDim.x) {
      const int s = e / width, i = e % width;
      float* sv = smem + off + s * ld + i;
      if (to)
        *sv = s < rows ? g[(size_t)(b0 + s) * width + i] : 0.f;
      else if (s < rows)
        g[(size_t)(b0 + s) * width + i] = *sv;
    }
  };
  move(st.ring, n_fft, l.ring, l.ld_t);
  move(st.ola, n_fft, l.ola, l.ld_t);
  move(st.hx, n, hx_of(l), ld_n_of(l));
  if (a.plan.delta) move(st.prev, a.n_mels, l.prev, l.ld_m);
  if (a.gate.floor) {
    if (!floor_in_global(a)) {
      move(st.nf_smooth, F, l.nfs, l.ld_f);
      move(st.nf_floor, F, l.nff, l.ld_f);
    }
    move(st.nf_total, 1, l.sc + kTot, kScalars);
  }
  if (a.gate.removed) {
    move(st.em_out, 1, l.sc + kEmo, kScalars);
    move(st.em_rem, 1, l.sc + kEmr, kScalars);
  }
}

// The SNR gate's estimators for the tile (noisefloor.removed_step,
// floor_step, their SNRs and gate_alpha) at hop k of the call; leaves each
// stream's denoise weight alpha in the scalars. The bin means run over
// exactly n_bins bins. kFloorGlobal: the floor planes are in the state
// tensors (the int8 mode, make_layout), not in shared memory. L: Layout,
// or the frame-group walk's GateRows (one hop's rows of mag and lin).
template <bool kFloorGlobal, class L>
__device__ void gate_alphas(const AdtFusedHopArgs& a, const L& l,
                            float* smem, int k, int b0, int rows) {
  const AdtGate& g = a.gate;
  const int F = a.n_bins;
  // one thread per (stream, mean, lane): partial sums over bins lane + 32j;
  // the floor's thread also steps the per-bin tracker of its bins
  const int t = threadIdx.x;
  if (t < kTile * kMeans * kLanes) {
    const int s = t / (kMeans * kLanes), q = t / kLanes % kMeans,
              lane = t % kLanes;
    const float* mag = smem + l.mag + s * l.ld_f;
    const float* lin = smem + l.lin + s * l.ld_f;
    float sum = 0.f;
    if (q < 2 && g.removed) {
      for (int f = lane; f < F; f += kLanes) {
        const float p_lin = lin[f] * lin[f];
        sum += q == 0 ? p_lin : fmaxf(mag[f] * mag[f] - p_lin, 0.f);
      }
    } else if (q == 2 && g.floor) {
      for (int f = lane; f < F; f += kLanes) sum += mag[f] * mag[f];
    } else if (q == 3 && g.floor && !kFloorGlobal) {
      float* nfs = smem + l.nfs + s * l.ld_f;
      float* nff = smem + l.nff + s * l.ld_f;
      for (int f = lane; f < F; f += kLanes) {
        const float smooth =
            g.beta * nfs[f] + (1.f - g.beta) * (mag[f] * mag[f]);
        const float fl =
            nff[f] <= 0.f ? smooth : fminf(smooth, nff[f] * g.rise);
        nfs[f] = smooth;
        nff[f] = fl;
        sum += fl;
      }
    } else if (q == 3 && g.floor && s < rows) {  // kFloorGlobal
      const AdtHopState& src = k == 0 ? a.in : a.out_state;
      const size_t row = (size_t)(b0 + s) * F;
      const float* nfs_in = src.nf_smooth + row;
      const float* nff_in = src.nf_floor + row;
      float* nfs = a.out_state.nf_smooth + row;
      float* nff = a.out_state.nf_floor + row;
      for (int f = lane; f < F; f += kLanes) {
        const float smooth =
            g.beta * nfs_in[f] + (1.f - g.beta) * (mag[f] * mag[f]);
        const float fl =
            nff_in[f] <= 0.f ? smooth : fminf(smooth, nff_in[f] * g.rise);
        nfs[f] = smooth;
        nff[f] = fl;
        sum += fl;
      }
    }
    smem[l.red + t] = sum;
  }
  __syncthreads();
  if (t < kTile) {
    float* sc = smem + l.sc + t * kScalars;
    const float* red = smem + l.red + t * kMeans * kLanes;
    float mean[kMeans];
    for (int q = 0; q < kMeans; ++q) {
      float sum = 0.f;
      for (int lane = 0; lane < kLanes; ++lane) sum += red[q * kLanes + lane];
      mean[q] = sum / (float)F;
    }
    const float bt = g.beta_tot;
    float alpha = 0.f;
    if (g.removed) {  // a zero pair (a fresh slot) latches
      const bool fresh = sc[kEmo] + sc[kEmr] <= 0.f;
      const float o = fresh ? mean[0] : bt * sc[kEmo] + (1.f - bt) * mean[0];
      const float r = fresh ? mean[1] : bt * sc[kEmr] + (1.f - bt) * mean[1];
      sc[kEmo] = o;
      sc[kEmr] = r;
      const float snr = kDbPerNeper * (logf(o + g.eps) - logf(r + g.eps));
      alpha = fminf(fmaxf((g.gate_db + g.width_db - snr) / (2.f * g.width_db),
                          0.f), 1.f);
    }
    if (g.floor) {  // the floor part; the veto under 'both'
      const float total = sc[kTot] <= 0.f
                              ? mean[2]
                              : bt * sc[kTot] + (1.f - bt) * mean[2];
      sc[kTot] = total;
      const float nfm = g.floor_bias * mean[3];
      const float sig = fmaxf(total - nfm, 0.f);
      const float snr = kDbPerNeper * (logf(sig + g.eps) - logf(nfm + g.eps));
      const float af = fminf(
          fmaxf((g.floor_gate_db + g.floor_width_db - snr) /
                    (2.f * g.floor_width_db),
                0.f),
          1.f);
      alpha = g.removed ? fmaxf(alpha, af) : af;
    }
    sc[kAlpha] = alpha;
  }
  __syncthreads();
}

// One hop of the tile on its state in shared memory: chunk k in, output k
// out. Kept out of line so both kernels run the same instructions; the
// domain and the delta carry are template parameters, so each
// configuration runs only its own stages (read at run time, they made
// the GRUUNet K-hop 2% slower: 128.5 against 125.9 us a hop on an H100,
// chip_ab.py), and so is the compute mode.
template <bool kRaw, bool kDelta, int kCompute>
__device__ __noinline__ void hop_body(const AdtFusedHopArgs& a,
                                      const Layout& l, float* smem, int k,
                                      int b0, int rows) {
  using Dsp = typename Types<kCompute>::Dsp;
  using PlanW = typename Types<kCompute>::Plan;
  const float* cf = static_cast<const float*>(a.cf);
  const float* sf = static_cast<const float*>(a.sf);
  const float* ic = static_cast<const float*>(a.ic);
  const float* is = static_cast<const float*>(a.is_);
  const float* mel = static_cast<const float*>(a.mel);
  const float* imel = static_cast<const float*>(a.imel);
  const int n_fft = a.n_fft, hop = a.hop, F = a.n_bins, M = a.n_mels;
  const int n = a.plan.n_hidden;
  const int keep = n_fft - hop;
  const bool gated = a.gate.removed || a.gate.floor;
  float* frame = smem + l.frame;
  float* ring = smem + l.ring;
  float* ola = smem + l.ola;

  // the shifted ring, staged in the frame buffer, then kept and windowed
  for (int e = threadIdx.x; e < kTile * n_fft; e += blockDim.x) {
    const int s = e / n_fft, i = e % n_fft;
    float v = 0.f;
    if (i < keep)
      v = ring[s * l.ld_t + i + hop];
    else if (s < rows)
      v = load_sample(a, k, b0 + s, i - keep);
    frame[s * l.ld_t + i] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * n_fft; e += blockDim.x) {
    const int o = (e / n_fft) * l.ld_t + e % n_fft;
    ring[o] = frame[o];
    frame[o] = frame[o] * a.win[e % n_fft];
  }
  __syncthreads();

  // the DFT and the magnitude: in-kernel FFTs (fp32, a.transform), or two
  // matmuls
  if (kCompute == kFp32 && a.transform) {
    forward_dft(a, kTile, frame, l.ld_t, smem + l.cell.scratch, smem + l.re,
                smem + l.im, smem + l.mag, l.ld_f, block_lanes());
  } else {
    gemm<Dsp>(make_gemm(frame, l.ld_t, n_fft, cf, F, nullptr, kNone,
                        smem + l.re, l.ld_f, smem + l.cell.scratch));
    gemm<Dsp>(make_gemm(frame, l.ld_t, n_fft, sf, F, nullptr, kNone,
                        smem + l.im, l.ld_f, smem + l.cell.scratch));
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * F; e += blockDim.x) {
      const int o = (e / F) * l.ld_f + e % F;
      const float re = smem[l.re + o], im = smem[l.im + o];
      smem[l.mag + o] = sqrtf(re * re + im * im);
    }
    __syncthreads();
  }

  // x = log(1 + mag @ mel), or log(1 + mag) in the raw domain: the
  // model's feature, in the cell's input d[0]
  float* x = smem + l.cell.d[0];
  const int ldx = l.cell.ld_d[0];
  if (kRaw) {
    for (int e = threadIdx.x; e < kTile * F; e += blockDim.x) {
      const int s = e / F, f = e % F;
      x[s * ldx + f] = logf(1.f + smem[l.mag + s * l.ld_f + f]);
    }
  } else {
    gemm<Dsp>(make_gemm(smem + l.mag, l.ld_f, F, mel, M, nullptr, kLog1p,
                        x, ldx, smem + l.cell.scratch));
  }
  if (kDelta) {  // prev beside x, after the mel gemm's padding columns
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * M; e += blockDim.x) {
      const int s = e / M, m = e % M;
      x[s * ldx + M + m] = smem[l.prev + s * l.ld_m + m];
    }
  }
  __syncthreads();

  L2Weights<PlanW> weights;
  float* y = plan_cell(a.plan, l.cell, smem, block_lanes(), weights,
                       kCompute == kInt8 ? &a.scales : nullptr);

  // the new state: hi decayed
  for (int e = threadIdx.x; e < kTile * n; e += blockDim.x) {
    const int o = (e / n) * l.cell.ld_n + e % n;
    smem[l.cell.hx + o] = smem[l.cell.hi + o] * a.state_decay;
  }
  // residual: max(exp(leaky_relu(x - y, 0.2)) - 1, 0), into y, or in the
  // raw domain times the gain into lin; prev' = x
  const int ldy = l.cell.ld_pp;
  for (int e = threadIdx.x; e < kTile * M; e += blockDim.x) {
    const int s = e / M, m = e % M;
    const float xv = x[s * ldx + m];
    float r = xv - y[s * ldy + m];
    r = r >= 0.f ? r : 0.2f * r;
    const float v = fmaxf(expf(r) - 1.f, 0.f);
    if (kRaw)
      smem[l.lin + s * l.ld_f + m] = v * a.output_gain;
    else
      y[s * ldy + m] = v;
    if (kDelta) smem[l.prev + s * l.ld_m + m] = xv;
  }
  __syncthreads();

  if (!kRaw) {  // lin = max(feat @ imel, 0) * gain
    Gemm gl = make_gemm(y, ldy, M, imel, F, nullptr, kLinGain,
                        smem + l.lin, l.ld_f, smem + l.cell.scratch);
    gl.gain = a.output_gain;
    gemm<Dsp>(gl);
    __syncthreads();
  }

  if (gated) gate_alphas<kCompute == kInt8>(a, l, smem, k, b0, rows);

  // the gate's blend toward the input magnitude, then phase reuse as
  // complex scaling; at mag ~ 0 the bin becomes lin + 0j
  for (int e = threadIdx.x; e < kTile * F; e += blockDim.x) {
    const int s = e / F;
    const int o = s * l.ld_f + e % F;
    const float mag = smem[l.mag + o];
    float lin = smem[l.lin + o];
    if (gated) {
      const float alpha = smem[l.sc + s * kScalars + kAlpha];
      lin = alpha * lin + (1.f - alpha) * mag;
    }
    const bool safe = mag > 1e-8f;
    const float scale = lin / (safe ? mag : 1.f);
    smem[l.re + o] = safe ? smem[l.re + o] * scale : lin;
    smem[l.im + o] = safe ? smem[l.im + o] * scale : 0.f;
  }
  __syncthreads();

  // the inverse DFT: in-kernel FFTs (into the scratch, then times 1 /
  // n_fft), or from both parts in one accumulation; then window and
  // overlap-add
  if (kCompute == kFp32 && a.transform) {
    const float* fr = smem + l.cell.scratch;
    inverse_dft(a, kTile, smem + l.re, smem + l.im, l.ld_f,
                smem + l.cell.scratch, frame, block_lanes());
    const float inv_n = 1.f / (float)n_fft;
    for (int e = threadIdx.x; e < kTile * n_fft; e += blockDim.x) {
      const int s = e / n_fft, i = e % n_fft;
      const int o = s * l.ld_t + i;
      frame[o] = overlap_add(ola[o], fr[s * n_fft + i], inv_n, a.win[i]);
    }
  } else {
    Gemm gs = make_gemm(smem + l.re, l.ld_f, F, ic, n_fft, nullptr, kNone,
                        frame, l.ld_t, smem + l.cell.scratch);
    gs.a2 = smem + l.im;
    gs.lda2 = l.ld_f;
    gs.k2 = F;
    gs.w2 = is;
    gemm<Dsp>(gs);
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * n_fft; e += blockDim.x) {
      const int o = (e / n_fft) * l.ld_t + e % n_fft;
      frame[o] = ola[o] + frame[o] * a.win[e % n_fft];
    }
  }
  __syncthreads();

  // the finished hop divided by the envelope
  for (int e = threadIdx.x; e < kTile * n_fft; e += blockDim.x) {
    const int s = e / n_fft, i = e % n_fft;
    const float* acc = frame + s * l.ld_t;
    if (i < hop && s < rows) store_sample(a, k, b0 + s, i, acc[i] / a.env[i]);
    ola[s * l.ld_t + i] = i < keep ? acc[i + hop] : 0.f;
  }
  __syncthreads();  // the frame buffer is free for the next hop
}

template <bool kRaw, bool kDelta, int kCompute>
__device__ __forceinline__ void hops_of(const AdtFusedHopArgs& a,
                                        const Layout& l, float* smem,
                                        int hops, int b0, int rows) {
  for (int k = 0; k < hops; ++k)
    hop_body<kRaw, kDelta, kCompute>(a, l, smem, k, b0, rows);
}

// -- the frame-group walk (fp32, the multi-hop kernel) ----------------------
//
// Most of a hop reads no state: the analysis (ring shift, window, DFT,
// magnitude, the feature, a delta plan's prev) reads only the audio, the
// encoder chain only the feature, and the inverse mel and inverse DFT
// reach the recurrence only through their inputs. The walk runs those
// stages once for a group of kGroup hops, over kGroup kTile rows
// (frame-major: row t kTile + s), so each weight load feeds kGroup times
// the multiply-adds (at gruunet2-stream16k the DSP matrices' 3.44 MB and
// the encoder's 0.99 of the 6.3 MB a block reads a hop); what reads state
// runs hop by hop in order: the reset gate, the GRU update, each decoder
// level as one matmul over h and its skip input (that hop's rows of the
// encoder's output), the residual and hx decayed; later the gate's
// estimators, the blend and the phase reuse; last the overlap-add.
// `gemm`'s split of k does not depend on its rows, and every other stage
// does the per-frame walk's arithmetic in its order, so each hop gets the
// sums `hop_body` gives it: the single-hop kernel runs `hop_body`, and K
// hops in one call equal K single hops bit for bit. Two designs lost on
// an H100 (NVIDIA H100 80GB HBM3, 700 W, B = 256, in turns against the
// per-frame kernels): the skip products run over the group's rows too,
// as webrtc_hop.cu's batched cell walk runs them, cut the stream16k K-hop
// to 84 us a hop (this walk: 102-104; the per-frame walk 125-127), but
// the single hop has to add in the same order then, and in groups of 1
// it took 144-145 us against 134.5-136; and this walk in groups of 1, as
// the single hop, took 154 us.

// The multi-hop kernel's group (mirrored by GROUP in
// ops/kernels/fused_hop.py); the host takes this walk where its layout
// fits a block. Groups of 8 spilled under the 128 registers of 512
// threads and gained MOMO3 3% over 4.
constexpr int kGroup = 4;

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Offset of level i's activations in a group of `rows` rows (each
// round4(down_n[i]) floats), from `base` on; i = levels + 1: past them.
__host__ __device__ inline int group_d(const AdtPlan& p, int base, int rows,
                                       int i) {
  for (int j = 0; j < i; ++j) base += rows * round4(p.down_n[j]);
  return base;
}

// The walk's shared memory (floats): the tile's state (kTile rows) and
// the reset gate's output; kGroup kTile rows of the spectrum
// (re, im, mag, lin); then two regions that hold several buffers in turn.
// `u`: the windowed frames, then the cell's activations d[0..L] (d[0]
// last holds the residual, the inverse mel's input), then the synthesised
// frames. `x`: the batched matmuls' split-K scratch; over it (dead while
// they run) the per-hop matmuls' scratch, hi and the decoder's two
// buffers; at a group's start the newest frame's samples for the ring.
// Every offset comes from the plan in parameter space: a table indexed at
// run time would live in each thread's local memory.
struct GroupLayout {
  int ld_t, ld_f, ld_m, ld_n, ld_pp;
  int ring, ola, hx, prev, nfs, nff, sc, red, gh;
  int re, im, mag, lin;
  int u, x;
  int total;
};

__host__ __device__ inline void make_group_layout(const AdtFusedHopArgs& a,
                                                  GroupLayout* l) {
  const AdtPlan& p = a.plan;
  const int rows = kGroup * kTile, n = p.n_hidden;
  int off = 0, widest = 0;
  for (int i = 1; i <= p.levels; ++i)
    widest = p.up_n[i] > widest ? p.up_n[i] : widest;
  l->ld_t = round4(a.n_fft);
  l->ld_f = round4(a.n_bins);
  l->ld_m = round4(a.n_mels);
  l->ld_n = round4(n);
  l->ld_pp = round4(widest);
  l->ring = take(&off, kTile, l->ld_t);
  l->ola = take(&off, kTile, l->ld_t);
  l->hx = take(&off, kTile, l->ld_n);
  l->prev = p.delta ? take(&off, kTile, l->ld_m) : 0;
  l->nfs = a.gate.floor ? take(&off, kTile, l->ld_f) : 0;
  l->nff = a.gate.floor ? take(&off, kTile, l->ld_f) : 0;
  l->sc = take(&off, kTile, kScalars);
  l->red = take(&off, kTile, kMeans * kLanes);
  l->gh = take(&off, kTile, round4(3 * n));
  l->re = take(&off, rows, l->ld_f);
  l->im = take(&off, rows, l->ld_f);
  l->mag = take(&off, rows, l->ld_f);
  l->lin = take(&off, rows, l->ld_f);
  l->u = off;
  off += imax(rows * l->ld_t, group_d(p, 0, rows, p.levels + 1));
  l->x = off;
  off += imax(imax(rows * 4 * kThreads, kTile * l->ld_t),
              kTile * (4 * kThreads + l->ld_n + 2 * l->ld_pp));
  l->total = off;
}

__device__ __forceinline__ int hx_of(const GroupLayout& l) { return l.hx; }
__device__ __forceinline__ int ld_n_of(const GroupLayout& l) {
  return l.ld_n;
}

// One hop's rows of the spectrum, for gate_alphas.
struct GateRows {
  int mag, lin, ld_f, nfs, nff, sc, red;
};

// Hops k0 .. k0 + frames - 1 of the call (frames <= kGroup; the last
// group of a call may be shorter) on the tile's state in shared memory.
// Rows of frames past `frames` run on zeros and are never stored. The
// domain and the delta carry are template parameters, as in hop_body.
template <bool kRaw, bool kDelta>
__device__ __noinline__ void group_walk(const AdtFusedHopArgs& a, float* smem,
                                        int k0, int frames, int b0,
                                        int rows) {
  constexpr int kRows = kGroup * kTile;
  GroupLayout l;
  make_group_layout(a, &l);
  const AdtPlan& p = a.plan;
  const Lanes g = block_lanes();
  const float* cf = static_cast<const float*>(a.cf);
  const float* sf = static_cast<const float*>(a.sf);
  const float* ic = static_cast<const float*>(a.ic);
  const float* is = static_cast<const float*>(a.is_);
  const float* mel = static_cast<const float*>(a.mel);
  const float* imel = static_cast<const float*>(a.imel);
  const int n_fft = a.n_fft, hop = a.hop, F = a.n_bins, M = a.n_mels;
  const int n = p.n_hidden, L = p.levels;
  const int keep = n_fft - hop;
  const int ld_t = l.ld_t, ld_f = l.ld_f, ld_n = l.ld_n, ld_pp = l.ld_pp;
  const int ld_x = round4(p.down_n[0]), ld_gh = round4(3 * n);
  const bool gated = a.gate.removed || a.gate.floor;
  float* ring = smem + l.ring;
  float* ola = smem + l.ola;
  float* hx = smem + l.hx;
  float* gh = smem + l.gh;
  float* re = smem + l.re;
  float* im = smem + l.im;
  float* mag = smem + l.mag;
  float* lin = smem + l.lin;
  float* frame = smem + l.u;  // the frames, later the synthesis
  float* x = smem + l.u;      // d[0]: the feature (and prev)
  float* scratch = smem + l.x;

  // frame t: the last n_fft samples of ring ++ chunks[k0 .. k0 + t],
  // windowed; the newest frame's samples staged for the ring
  for (int e = g.id; e < kRows * n_fft; e += g.n) {
    const int r = e / n_fft, i = e % n_fft;
    const int t = r / kTile, s = r % kTile;
    float v = 0.f;
    if (t < frames) {
      const int j = (t + 1) * hop + i;
      if (j < n_fft)
        v = ring[s * ld_t + j];
      else if (s < rows)
        v = load_sample(a, k0 + (j - n_fft) / hop, b0 + s, (j - n_fft) % hop);
      if (t == frames - 1) scratch[s * ld_t + i] = v;
    }
    frame[r * ld_t + i] = v * a.win[i];
  }
  __syncthreads();
  for (int e = g.id; e < kTile * n_fft; e += g.n) {
    const int o = (e / n_fft) * ld_t + e % n_fft;
    ring[o] = scratch[o];
  }
  __syncthreads();

  // the DFT and the magnitude: in-kernel FFTs (a.transform), or two
  // matmuls
  if (a.transform) {
    forward_dft(a, kRows, frame, ld_t, scratch, re, im, mag, ld_f, g);
  } else {
    gemm<float, kRows, false, false>(
        make_gemm(frame, ld_t, n_fft, cf, F, nullptr, kNone, re, ld_f,
                  scratch),
        g);
    gemm<float, kRows, false, false>(
        make_gemm(frame, ld_t, n_fft, sf, F, nullptr, kNone, im, ld_f,
                  scratch),
        g);
    __syncthreads();
    for (int e = g.id; e < kRows * F; e += g.n) {
      const int o = (e / F) * ld_f + e % F;
      mag[o] = sqrtf(re[o] * re[o] + im[o] * im[o]);
    }
    __syncthreads();
  }

  // the feature into d[0]: log(1 + mag @ mel), or log(1 + mag) in the raw
  // domain; a delta plan's prev beside it: the previous frame's feature
  // (the carried plane for the group's first)
  if (kRaw) {
    for (int e = g.id; e < kRows * F; e += g.n) {
      const int r = e / F, f = e % F;
      x[r * ld_x + f] = logf(1.f + mag[r * ld_f + f]);
    }
  } else {
    gemm<float, kRows, false, false>(
        make_gemm(mag, ld_f, F, mel, M, nullptr, kLog1p, x, ld_x, scratch),
        g);
  }
  if (kDelta) {
    __syncthreads();
    for (int e = g.id; e < kRows * M; e += g.n) {
      const int r = e / M, m = e % M;
      x[r * ld_x + M + m] = r < kTile ? smem[l.prev + r * l.ld_m + m]
                                      : x[(r - kTile) * ld_x + m];
    }
  }
  __syncthreads();

  // the encoder, level i from d[i] into d[i + 1]; the first hop's reset
  // gate reads only hx and shares level 0's barrier, as in plan_cell
  for (int i = 0, off = l.u; i < L; ++i) {
    const int next = off + kRows * round4(p.down_n[i]);
    gemm<float, kRows, false, false>(
        make_gemm(smem + off, round4(p.down_n[i]), p.down_n[i], p.down_w[i],
                  p.down_n[i + 1], p.down_b[i], kRelu, smem + next,
                  round4(p.down_n[i + 1]), scratch),
        g);
    if (i == 0)
      gemm<float, kTile, false, false>(
          make_gemm(hx, ld_n, n, p.reset_w, 3 * n, p.reset_b, kRelu, gh,
                    ld_gh, scratch),
          g);
    __syncthreads();
    off = next;
  }

  // hop by hop: the GRU update, the decoder (level i over h and, with a
  // skip, that hop's rows of d[L - i]), hx decayed and the residual:
  // max(exp(leaky_relu(x - y, 0.2)) - 1, 0), in place of x (the inverse
  // mel's input), or in the raw domain times the gain into lin; prev' = x;
  // then the next hop's reset gate
  const int ld_gx = round4(p.down_n[L]);
  const float* gx_all = smem + group_d(p, l.u, kRows, L);
  float* hi = scratch + kTile * 4 * kThreads;
  float* pp0 = hi + kTile * ld_n;
  float* pp1 = pp0 + kTile * ld_pp;
  for (int t = 0; t < frames; ++t) {
    const float* gx = gx_all + t * kTile * ld_gx;
    for (int e = g.id; e < kTile * n; e += g.n) {
      const int s = e / n, j = e % n;
      const float* xs = gx + s * ld_gx;
      const float* h = gh + s * ld_gh;
      const float inputgate = sigmoidf(xs[n + j] + h[n + j]);
      const float resetgate = sigmoidf(xs[j] + h[j]);
      const float newgate = tanhf(xs[2 * n + j] + resetgate * h[2 * n + j]);
      const float hxv = hx[s * ld_n + j];
      hi[s * ld_n + j] = newgate + inputgate * (hxv - newgate);
    }
    __syncthreads();
    const float* h = hi;
    int ldh = ld_n;
    for (int i = 0; i < L; ++i) {
      float* dst = (i & 1) ? pp1 : pp0;
      Gemm gm = make_gemm(h, ldh, p.up_n[i], p.up_w[i], p.up_n[i + 1],
                          p.up_b[i], i != L - 1 ? kRelu : kNone, dst, ld_pp,
                          scratch);
      if (p.up_s[i] != nullptr) {  // decoder skip: split matmul, no concat
        const int ld = round4(p.down_n[L - i]);
        gm.a2 = smem + group_d(p, l.u, kRows, L - i) + t * kTile * ld;
        gm.lda2 = ld;
        gm.k2 = p.down_n[L - i];
        gm.w2 = p.up_s[i];
      }
      gemm<float>(gm, g);
      __syncthreads();
      h = dst;
      ldh = ld_pp;
    }
    for (int e = g.id; e < kTile * n; e += g.n) {
      const int o = (e / n) * ld_n + e % n;
      hx[o] = hi[o] * a.state_decay;
    }
    float* xt = x + t * kTile * ld_x;
    for (int e = g.id; e < kTile * M; e += g.n) {
      const int s = e / M, m = e % M;
      const float xv = xt[s * ld_x + m];
      float r = xv - h[s * ld_pp + m];
      r = r >= 0.f ? r : 0.2f * r;
      const float v = fmaxf(expf(r) - 1.f, 0.f);
      if (kRaw)
        lin[(t * kTile + s) * ld_f + m] = v * a.output_gain;
      else
        xt[s * ld_x + m] = v;
      if (kDelta) smem[l.prev + s * l.ld_m + m] = xv;
    }
    __syncthreads();
    if (t + 1 < frames) {
      gemm<float, kTile, false, false>(
          make_gemm(hx, ld_n, n, p.reset_w, 3 * n, p.reset_b, kRelu, gh,
                    ld_gh, scratch),
          g);
      __syncthreads();
    }
  }

  if (!kRaw) {  // lin = max(feat @ imel, 0) * gain
    Gemm gl = make_gemm(x, ld_x, M, imel, F, nullptr, kLinGain, lin, ld_f,
                        scratch);
    gl.gain = a.output_gain;
    gemm<float, kRows, false, false>(gl, g);
    __syncthreads();
  }

  // the gate's blend toward the input magnitude, then phase reuse as
  // complex scaling (at mag ~ 0 the bin becomes lin + 0j); gated, hop by
  // hop after that hop's estimators (the next hop's estimators pass a
  // barrier before they write the scalars again)
  auto blend = [&](int r0, int n_rows) {
    for (int e = g.id; e < n_rows * F; e += g.n) {
      const int r = r0 + e / F;
      const int o = r * ld_f + e % F;
      const float mg = mag[o];
      float ln = lin[o];
      if (gated) {
        const float alpha = smem[l.sc + (r % kTile) * kScalars + kAlpha];
        ln = alpha * ln + (1.f - alpha) * mg;
      }
      const bool safe = mg > 1e-8f;
      const float scale = ln / (safe ? mg : 1.f);
      re[o] = safe ? re[o] * scale : ln;
      im[o] = safe ? im[o] * scale : 0.f;
    }
  };
  if (gated) {
    for (int t = 0; t < frames; ++t) {
      const int o = t * kTile * ld_f;
      gate_alphas<false>(a,
                         GateRows{l.mag + o, l.lin + o, ld_f, l.nfs, l.nff,
                                  l.sc, l.red},
                         smem, k0 + t, b0, rows);
      blend(t * kTile, kTile);
    }
  } else {
    blend(0, frames * kTile);
  }
  __syncthreads();

  // the inverse DFT: in-kernel FFTs (into the scratch, then times 1 /
  // n_fft), or from both parts in one accumulation into u
  const float* fr = scratch;
  const float inv_n = 1.f / (float)n_fft;
  if (a.transform) {
    inverse_dft(a, kRows, re, im, ld_f, scratch, frame, g);
  } else {
    Gemm gs = make_gemm(re, ld_f, F, ic, n_fft, nullptr, kNone, frame, ld_t,
                        scratch);
    gs.a2 = im;
    gs.lda2 = ld_f;
    gs.k2 = F;
    gs.w2 = is;
    gemm<float, kRows>(gs, g);
    __syncthreads();
  }

  // hop by hop: window and overlap-add onto the previous hop's sums
  // shifted by a hop (the carried ola for the first), in u; the finished
  // hop divided by the envelope
  for (int t = 0; t < frames; ++t) {
    for (int e = g.id; e < kTile * n_fft; e += g.n) {
      const int s = e / n_fft, i = e % n_fft;
      float* acc = frame + (t * kTile + s) * ld_t;
      const float base =
          t == 0 ? ola[s * ld_t + i]
                 : (i < keep ? acc[i + hop - kTile * ld_t] : 0.f);
      const float v =
          a.transform ? overlap_add(base, fr[(t * kTile + s) * n_fft + i],
                                    inv_n, a.win[i])
                      : base + acc[i] * a.win[i];
      acc[i] = v;
      if (i < hop && s < rows) store_sample(a, k0 + t, b0 + s, i, v / a.env[i]);
    }
    __syncthreads();
  }
  for (int e = g.id; e < kTile * n_fft; e += g.n) {
    const int s = e / n_fft, i = e % n_fft;
    const float* acc = frame + ((frames - 1) * kTile + s) * ld_t;
    ola[s * ld_t + i] = i < keep ? acc[i + hop] : 0.f;
  }
  __syncthreads();  // u is free for the next group's frames
}

// The frame-group walk's whole call on the tile: the state in, `hops`
// hops in groups of kGroup (the last one shorter), the state out. Inline
// in the kernel: out of line (a call between the kernel and group_walk),
// a single-hop launch of the walk came out wrong on an H100 while K-hop
// launches of the same code were right.
template <bool kRaw, bool kDelta>
__device__ __forceinline__ void run_groups(const AdtFusedHopArgs& a,
                                           float* smem, int hops, int b0,
                                           int rows) {
  GroupLayout l;
  make_group_layout(a, &l);
  move_state(a, l, smem, a.in, b0, rows, true);
  __syncthreads();
  for (int k0 = 0; k0 < hops; k0 += kGroup)
    group_walk<kRaw, kDelta>(a, smem, k0, min(kGroup, hops - k0), b0, rows);
  move_state(a, l, smem, a.out_state, b0, rows, false);
}

// Loads the tile's state, runs `hops` hops and writes the state back.
template <int kCompute>
__device__ __forceinline__ void run_hops(const AdtFusedHopArgs& a, int hops) {
  extern __shared__ __align__(16) float smem[];
  Layout l;
  make_layout(a, &l);
  const int b0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.batch - b0);
  move_state(a, l, smem, a.in, b0, rows, true);
  __syncthreads();
  if (a.raw && a.plan.delta)
    hops_of<true, true, kCompute>(a, l, smem, hops, b0, rows);
  else if (a.raw)
    hops_of<true, false, kCompute>(a, l, smem, hops, b0, rows);
  else if (a.plan.delta)
    hops_of<false, true, kCompute>(a, l, smem, hops, b0, rows);
  else
    hops_of<false, false, kCompute>(a, l, smem, hops, b0, rows);
  move_state(a, l, smem, a.out_state, b0, rows, false);
}

// The single-hop kernel (fused_hop.py:242): one hop, float32 IO.
template <int kCompute>
__global__ void __launch_bounds__(kThreads, 1)
    fused_hop_kernel(const __grid_constant__ AdtFusedHopArgs a) {
  run_hops<kCompute>(a, 1);
}

// The resident multi-hop kernel (fused_hop.py:384): a.hops hops with the
// state in shared memory throughout.
template <int kCompute>
__global__ void __launch_bounds__(kThreads, 1)
    fused_hop_multi_kernel(const __grid_constant__ AdtFusedHopArgs a) {
  run_hops<kCompute>(a, a.hops);
}

#if ADT_IN_PART(0)
// The fp32 resident multi-hop kernel in the frame-group walk (a.group ==
// kGroup): a kernel of its own, so the per-frame one keeps its registers
// and stack (sharing one kernel, the walk's layout cost the 128-mel
// plans' per-frame K-hop 1% on an H100).
__global__ void __launch_bounds__(kThreads, 1)
    fused_hop_group_kernel(const __grid_constant__ AdtFusedHopArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.batch - b0);
  if (a.raw && a.plan.delta)
    run_groups<true, true>(a, smem, a.hops, b0, rows);
  else if (a.raw)
    run_groups<true, false>(a, smem, a.hops, b0, rows);
  else if (a.plan.delta)
    run_groups<false, true>(a, smem, a.hops, b0, rows);
  else
    run_groups<false, false>(a, smem, a.hops, b0, rows);
}
#endif

cudaError_t launch(void (*kernel)(AdtFusedHopArgs), const AdtFusedHopArgs& a,
                   size_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.batch + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// The FFTs (transform 1): fp32, the twiddles given, and kF n_fft floats
// within the scratch of kF rows (4 kThreads floats a row).
bool transform_ok(const AdtFusedHopArgs& a) {
  if (a.transform == 0) return true;
  return a.transform == 1 && a.compute == kFp32 && a.twiddle != nullptr &&
         a.n_fft % 2 == 0 && a.n_fft <= 4 * kThreads &&
         a.n_bins == a.n_fft / 2 + 1;
}

bool args_ok(const AdtFusedHopArgs& a) {
  const bool state_ok =
      (!a.plan.delta || (a.in.prev && a.out_state.prev)) &&
      (!a.gate.floor || (a.in.nf_smooth && a.in.nf_floor && a.in.nf_total &&
                         a.out_state.nf_smooth && a.out_state.nf_floor &&
                         a.out_state.nf_total)) &&
      (!a.gate.removed || (a.in.em_out && a.in.em_rem &&
                           a.out_state.em_out && a.out_state.em_rem));
  const bool domain_ok =
      a.raw ? a.n_mels == a.n_bins : (a.mel != nullptr && a.imel != nullptr);
  bool scales_ok = a.compute >= kFp32 && a.compute <= kInt8;
  if (a.compute == kInt8) {
    const AdtPlanScales& s = a.scales;
    scales_ok = s.reset != nullptr;
    for (int i = 0; i < a.plan.levels; ++i)
      scales_ok = scales_ok && s.down[i] != nullptr && s.up[i] != nullptr &&
                  (a.plan.up_s[i] == nullptr) == (s.skip[i] == nullptr);
  }
  // the frame-group walk: fp32, the compiled-in group
  const bool walk_ok =
      a.group == 0 || (a.compute == kFp32 && a.group == kGroup);
  return plan_ok(a.plan, a.n_mels) && a.n_fft % a.hop == 0 && state_ok &&
         domain_ok && scales_ok && walk_ok && transform_ok(a) && a.hops >= 1;
}

// The launch's arguments with the FFT plan filled in where a.transform
// asks for the FFTs (the M = 0 schedule of n_fft / 2 points); false if
// n_fft / 2 has no plan.
bool with_fft_plan(const AdtFusedHopArgs& a, AdtFusedHopArgs* out) {
  *out = a;
  out->fft.m = out->fft.passes = 0;
  return !a.transform || make_fft_plan(a.n_fft / 2, false, &out->fft);
}

}  // namespace

// Each compute mode's kernels launched (the single-hop or the multi-hop
// kernel; in fp32 the frame-group kernel where a.group asks for it), and
// the attributes of one of them (entry 0 the single hop, 1 the multi-hop
// kernel, 2 fp32's frame-group kernel): defined in the mode's part,
// external so that part 0's C interface reaches every part.
template <int kCompute>
cudaError_t adt_fused_hop_launch(const AdtFusedHopArgs& a, bool multi,
                                 size_t smem_bytes, cudaStream_t stream);
template <int kCompute>
cudaError_t adt_fused_hop_attrs(int entry, cudaFuncAttributes* attr);
template <>
cudaError_t adt_fused_hop_launch<kFp32>(const AdtFusedHopArgs&, bool, size_t,
                                        cudaStream_t);
template <>
cudaError_t adt_fused_hop_launch<kBf16>(const AdtFusedHopArgs&, bool, size_t,
                                        cudaStream_t);
template <>
cudaError_t adt_fused_hop_launch<kInt8>(const AdtFusedHopArgs&, bool, size_t,
                                        cudaStream_t);
template <>
cudaError_t adt_fused_hop_attrs<kFp32>(int, cudaFuncAttributes*);
template <>
cudaError_t adt_fused_hop_attrs<kBf16>(int, cudaFuncAttributes*);
template <>
cudaError_t adt_fused_hop_attrs<kInt8>(int, cudaFuncAttributes*);

#if ADT_IN_PART(0)
template <>
cudaError_t adt_fused_hop_launch<kFp32>(const AdtFusedHopArgs& a, bool multi,
                                        size_t smem_bytes,
                                        cudaStream_t stream) {
  if (multi && a.group > 0)
    return launch(fused_hop_group_kernel, a, smem_bytes, stream);
  return launch(multi ? fused_hop_multi_kernel<kFp32>
                      : fused_hop_kernel<kFp32>,
                a, smem_bytes, stream);
}
template <>
cudaError_t adt_fused_hop_attrs<kFp32>(int entry, cudaFuncAttributes* attr) {
  return cudaFuncGetAttributes(
      attr, entry == 2 ? fused_hop_group_kernel
                       : entry ? fused_hop_multi_kernel<kFp32>
                               : fused_hop_kernel<kFp32>);
}
#endif
#if ADT_IN_PART(1)
template <>
cudaError_t adt_fused_hop_launch<kBf16>(const AdtFusedHopArgs& a, bool multi,
                                        size_t smem_bytes,
                                        cudaStream_t stream) {
  return launch(multi ? fused_hop_multi_kernel<kBf16>
                      : fused_hop_kernel<kBf16>,
                a, smem_bytes, stream);
}
template <>
cudaError_t adt_fused_hop_attrs<kBf16>(int entry, cudaFuncAttributes* attr) {
  return cudaFuncGetAttributes(attr, entry ? fused_hop_multi_kernel<kBf16>
                                           : fused_hop_kernel<kBf16>);
}
#endif
#if ADT_IN_PART(2)
template <>
cudaError_t adt_fused_hop_launch<kInt8>(const AdtFusedHopArgs& a, bool multi,
                                        size_t smem_bytes,
                                        cudaStream_t stream) {
  return launch(multi ? fused_hop_multi_kernel<kInt8>
                      : fused_hop_kernel<kInt8>,
                a, smem_bytes, stream);
}
template <>
cudaError_t adt_fused_hop_attrs<kInt8>(int entry, cudaFuncAttributes* attr) {
  return cudaFuncGetAttributes(attr, entry ? fused_hop_multi_kernel<kInt8>
                                           : fused_hop_kernel<kInt8>);
}
#endif

#if ADT_IN_PART(0)
namespace {

// The single-hop or the multi-hop kernel of the mode a.compute.
cudaError_t launch_mode(const AdtFusedHopArgs& a, bool multi,
                        size_t smem_bytes, cudaStream_t stream) {
  switch (a.compute) {
    case kBf16:
      return adt_fused_hop_launch<kBf16>(a, multi, smem_bytes, stream);
    case kInt8:
      return adt_fused_hop_launch<kInt8>(a, multi, smem_bytes, stream);
    default:
      return adt_fused_hop_launch<kFp32>(a, multi, smem_bytes, stream);
  }
}

}  // namespace

extern "C" {

int adt_fused_hop_args_size() { return (int)sizeof(AdtFusedHopArgs); }

// Dynamic shared memory one block of kTile streams needs (either kernel)
// in the walk a->group names.
long long adt_fused_hop_smem_bytes(const AdtFusedHopArgs* a) {
  int floats;
  if (a->group > 0) {
    GroupLayout l;
    make_group_layout(*a, &l);
    floats = l.total;
  } else {
    Layout l;
    make_layout(*a, &l);
    floats = l.total;
  }
  return (long long)floats * (long long)sizeof(float);
}

// Registers a thread and local (spill and stack) bytes of kernel `which`
// (cudaFuncGetAttributes), the kernels as (compute mode, entry) in
// chip_smoke.py's order: 0 and 1 the bf16 single-hop and multi-hop
// kernels, 2 and 3 the int8 ones, 4 and 5 the fp32 ones, 6 the fp32
// multi-hop kernel in the frame-group walk. Returns the cudaError_t.
int adt_fused_hop_kernel_attrs(int which, int* regs, long long* local) {
  const int kernels[7][2] = {{kBf16, 0}, {kBf16, 1}, {kInt8, 0}, {kInt8, 1},
                             {kFp32, 0}, {kFp32, 1}, {kFp32, 2}};
  if (which < 0 || which >= 7) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const int mode = kernels[which][0], entry = kernels[which][1];
  const cudaError_t err =
      mode == kBf16   ? adt_fused_hop_attrs<kBf16>(entry, &attr)
      : mode == kInt8 ? adt_fused_hop_attrs<kInt8>(entry, &attr)
                      : adt_fused_hop_attrs<kFp32>(entry, &attr);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local = (long long)attr.localSizeBytes;
  return (int)cudaSuccess;
}

// Launches one hop (float32 IO, a->hops == 1) on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).
int adt_fused_hop(const AdtFusedHopArgs* a, void* stream) {
  AdtFusedHopArgs b;
  if (!args_ok(*a) || a->hops != 1 || a->pcm16 || a->group != 0 ||
      !with_fft_plan(*a, &b))
    return (int)cudaErrorInvalidValue;
  if (a->batch <= 0) return (int)cudaSuccess;
  return (int)launch_mode(b, false, (size_t)adt_fused_hop_smem_bytes(a),
                          static_cast<cudaStream_t>(stream));
}

// Launches a->hops hops in one kernel on `stream` without synchronising.
int adt_fused_hop_multi(const AdtFusedHopArgs* a, void* stream) {
  AdtFusedHopArgs b;
  if (!args_ok(*a) || !with_fft_plan(*a, &b))
    return (int)cudaErrorInvalidValue;
  if (a->batch <= 0) return (int)cudaSuccess;
  return (int)launch_mode(b, true, (size_t)adt_fused_hop_smem_bytes(a),
                          static_cast<cudaStream_t>(stream));
}

// The number of k ranges `gemm` splits a matmul of n columns and depth k
// into on `lanes` threads (plan_cell.cuh's split_ks).
int adt_fused_hop_split_ks(int n, int k, int lanes) {
  return split_ks(n, k, lanes);
}

// The radices of the passes the fp32 walks' FFTs run for n_fft (its
// n_fft / 2 points), into radix[0..kMaxPasses); returns their count, -1
// where n_fft / 2 has no plan.
int adt_fused_hop_fft_radices(int n_fft, int* radix) {
  FftPlan p;
  if (!make_fft_plan(n_fft / 2, false, &p)) return -1;
  for (int i = 0; i < p.passes; ++i) radix[i] = p.radix[i];
  return p.passes;
}

}  // extern "C"
#endif

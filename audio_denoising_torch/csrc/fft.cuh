// The in-kernel FFTs shared by the port's kernels that transform: the
// WebRTC hop (webrtc_hop.cu, its STFTs and Griffin-Lim rounds) and the
// fused hop (fused_hop.cu, the analysis DFT and the synthesis's inverse
// DFT of its fp32 walks). Plain PyTorch mirror: ops/kernels/fft.py
// (fft_radices, twiddle_table, pass_twiddle_table, fft_passes, real_bins,
// inverse_input).
//
// A real FFT of n_fft points is a complex FFT of m = n_fft / 2 points (the
// frame packed two samples a point, even real, odd imaginary) and the
// real-input split (`real_bin`); its inverse is the split's pre-twiddle
// (read by the first pass) and a complex inverse FFT whose points are the
// samples in pairs, n_fft times irfft. The complex FFT is a Stockham
// autosort in a few wide passes over kF sequences laid end to end: each
// lane loads an item's R points from shared memory, twiddles them, runs the
// R-point DFT in registers and stores them; ping-pong buffers in shared
// memory, one barrier of the caller's `Lanes` per pass. The geometry is a
// template parameter M (its radices, strides and counts then constants) or
// M = 0, the radices read from an FftPlan at run time (12, 8, 5, 4, 3, 2
// in registers, any other factor a `prime_pass`). The passes' twiddles
// come from a table laid out pass by pass, the real split's from a table of
// e^{-2 pi i t / n_fft}, both built in float64 by the wrapper and handed
// over as one array: the n_fft-point table, then the passes'.
//
// Included after plan_cell.cuh (Lanes, group_sync); everything here has
// internal linkage.

#pragma once

#include <cuda_runtime.h>

#include "plan_cell.cuh"

namespace {

constexpr int kMaxPasses = 16;

// The radix of the next pass when `rest` > 1 points are left to combine:
// rest itself where the passes take it as one radix (12, 8, 5, 4, 3, 2),
// else the first of 8, 4, 2, 3 and 5 that divides it (for a compiled-in M,
// 9 before 3), else rest's smallest prime factor (for a compiled-in M, 7
// runs in registers; in the M = 0 instantiation it, and any prime above
// it, is a prime pass). M = 768 runs 8 x 8 x 12, M = 512 8 x 8 x 8, M =
// 441 9 x 7 x 7, M = 32 8 x 4; at run time 320 runs 8 x 8 x 5, 22 2 x 11.
__host__ __device__ constexpr int next_radix(int rest, bool compiled) {
  if (rest == 12 || rest == 8 || rest == 5 || rest == 4 || rest == 3 ||
      rest == 2)
    return rest;
  if (rest % 8 == 0) return 8;
  if (rest % 4 == 0) return 4;
  if (rest % 2 == 0) return 2;
  if (compiled && rest % 9 == 0) return 9;
  if (rest % 3 == 0) return 3;
  if (rest % 5 == 0) return 5;
  for (int q = 7; q * q <= rest; q += 2)  // 2, 3 and 5 divide it no more
    if (rest % q == 0) return q;
  return rest;
}

// A radix a compiled-in M runs as an in-register DFT (`dft`); M = 0 runs
// 12, 8 and 5 and below so, any other as a prime pass.
__host__ __device__ constexpr bool fixed_radix(int r) {
  return r == 12 || r == 9 || r == 8 || r == 7 || r <= 5;
}

// The radices of the complex FFT of m = n_fft / 2 points, read at run time
// by the M = 0 instantiation (see `fft`); m = 1 is one pass of radix 1.
// make_fft_plan fills it; `compiled`: m is a compiled-in M (9 before 3, 7
// in registers; see next_radix).
struct FftPlan {
  int m;
  int passes;
  int radix[kMaxPasses];
};

bool make_fft_plan(int m, bool compiled, FftPlan* p) {
  p->m = m;
  p->passes = 0;
  if (m < 1) return false;
  int rest = m;
  while (rest > 1 && p->passes < kMaxPasses) {
    const int r = next_radix(rest, compiled);
    p->radix[p->passes++] = r;
    rest /= r;
  }
  if (p->passes == 0) p->radix[p->passes++] = 1;
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

// Twiddle r of item k of a pass after passes of product ns, span L = ns R:
// e^{-+2 pi i k r / L}, entry r ns + k - 1 of the passes' table (which
// follows the n_fft-point table in the caller's twiddle table). Pass i's
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

// The terms r = kR .. H of outputs s and R - s of an odd R-point DFT, H =
// (R - 1) / 2, from the sums a[r - 1] = v[r] + v[R - r] and differences
// b[r - 1] = v[r] - v[R - r]: t += cos(2 pi r s / R) a and u += sin(2 pi r
// s / R) b, each cosine and sine a compile-time constant.
template <int R, int s, int kR>
__device__ __forceinline__ void odd_terms(const float2 (&a)[(R - 1) / 2],
                                          const float2 (&b)[(R - 1) / 2],
                                          float2& t, float2& u) {
  if constexpr (kR <= (R - 1) / 2) {
    constexpr int q = kR * s % R;
    constexpr float c = (float)cos_turn(q, R);
    constexpr float sn = (float)cos_turn(4 * q - R, 4 * R);
    t = make_float2(t.x + c * a[kR - 1].x, t.y + c * a[kR - 1].y);
    u = make_float2(u.x + sn * b[kR - 1].x, u.y + sn * b[kR - 1].y);
    odd_terms<R, s, kR + 1>(a, b, t, u);
  }
}

// Outputs kS .. H and R - H .. R - kS of an odd R-point DFT into v: t +-
// (-+i) u, t = v0 + sum_r cos a_r, u = sum_r sin b_r (odd_terms).
template <bool kInverse, int R, int kS>
__device__ __forceinline__ void odd_outputs(float2 (&v)[R], float2 v0,
                                            const float2 (&a)[(R - 1) / 2],
                                            const float2 (&b)[(R - 1) / 2]) {
  if constexpr (kS <= (R - 1) / 2) {
    constexpr int q = kS % R;
    constexpr float c = (float)cos_turn(q, R);
    constexpr float sn = (float)cos_turn(4 * q - R, 4 * R);
    float2 t = make_float2(v0.x + c * a[0].x, v0.y + c * a[0].y);
    float2 u = make_float2(sn * b[0].x, sn * b[0].y);
    odd_terms<R, kS, 2>(a, b, t, u);
    u = rot90<kInverse>(u);
    v[kS] = cadd(t, u);
    v[R - kS] = csub(t, u);
    odd_outputs<kInverse, R, kS + 1>(v, v0, a, b);
  }
}

// The DFT of R points in registers, in place and in natural order:
// v[s] <- sum_r v[r] e^{-+2 pi i r s / R}, R = 1, 2, 3, 4, 5, 7, 8, 9 or
// 12. 5 and 7 pair the points r and R - r (sums and differences) and
// weight them by the cosines and sines of 2 pi r s / R (7 by compile-time
// constants from `odd_outputs`, which takes any odd R), so each output
// pair costs (R - 1) / 2 products a part; 7 and 9 serve the compiled-in
// M = 441 (the M = 0 instantiation runs 7 and any larger prime as a prime
// pass). 8 and 12 run four-point DFTs
// over the R / 4 subsequences v[n2 + (R / 4) n1], twiddle them by
// e^{-+2 pi i n2 k1 / R}, and finish with R / 4-point DFTs across the
// subsequences; 9 does the same with three-point DFTs over v[n2 + 3 n1].
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
  } else if constexpr (R == 7) {
    constexpr int H = (R - 1) / 2;
    float2 a[H], b[H];
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      a[r - 1] = cadd(v[r], v[R - r]);
      b[r - 1] = csub(v[r], v[R - r]);
    }
    const float2 v0 = v[0];
    float2 sum = v0;
#pragma unroll
    for (int r = 0; r < H; ++r) sum = cadd(sum, a[r]);
    odd_outputs<kInverse, R, 1>(v, v0, a, b);
    v[0] = sum;
  } else if constexpr (R == 9) {
    float2 y[3][3];
#pragma unroll
    for (int n2 = 0; n2 < 3; ++n2) {
      float2 u[3] = {v[n2], v[3 + n2], v[6 + n2]};
      dft<kInverse, 3>(u);
#pragma unroll
      for (int k1 = 0; k1 < 3; ++k1) y[n2][k1] = u[k1];
    }
    y[1][1] = rotate<kInverse, 9, 1>(y[1][1]);
    y[1][2] = rotate<kInverse, 9, 2>(y[1][2]);
    y[2][1] = rotate<kInverse, 9, 2>(y[2][1]);
    y[2][2] = rotate<kInverse, 9, 4>(y[2][2]);
#pragma unroll
    for (int k1 = 0; k1 < 3; ++k1) {
      float2 z[3] = {y[0][k1], y[1][k1], y[2][k1]};
      dft<kInverse, 3>(z);
#pragma unroll
      for (int k2 = 0; k2 < 3; ++k2) v[k1 + 3 * k2] = z[k2];
    }
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
    static_assert(R == 1, "radices 1, 2, 3, 4, 5, 7, 8, 9 and 12");
  }
}

// A pass's input read from a buffer of sequences of m points laid end to
// end.
struct BufLoad {
  const float2* in;
  int m;
  __device__ __forceinline__ float2 operator()(int f, int q) const {
    return in[f * m + q];
  }
};

// One Stockham pass of radix R over kF complex sequences of m points
// laid end to end: each lane loads an item's R points (point q of frame f
// is load(f, q)), twiddles them, runs the R-point DFT in registers and
// stores the R results to out; the group's barrier closes the pass. ns is
// the product of the earlier passes' radices, ptw the passes' twiddles.
template <bool kInverse, int R, int kF, class Load>
__device__ __forceinline__ void fft_pass(const Load& load, float2* out,
                                         int m, int ns, const float2* ptw,
                                         const Lanes& g, int frames = 0) {
  const int stride = m / R;
  const int L = ns * R;
  const int nf = kF > 0 ? kF : frames;
  for (int e = g.id; e < nf * stride; e += g.n) {
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

// One Stockham pass of a prime radix p > 5 read at run time (the M = 0
// instantiation only), with `fft_pass`'s layout and the p-point DFT as
// sums: lane e computes output s of item j of frame f, the sum over r of
// point r (load(f, j + r stride)) times its pass twiddle times w^{r s},
// w = e^{-+2 pi i / p}: w^t is entry t n_fft / p of the n_fft-point table
// `tw`, since p divides m. Only the sum and one point are live (the loop
// over r is left rolled: unrolled, the K-hop kernel's M = 0 instantiation
// ran 2% slower at n_fft 640, where no prime pass runs), and the pass
// spreads kF m outputs over the lanes; each point is loaded p
// times. Where it is the first pass (m with no factor 2, 3 or 5: 49, 77,
// a prime such as 509), every load goes through `first`'s windowing or
// pre-twiddle: the slow case.
template <bool kInverse, int kF, class Load>
__device__ __forceinline__ void prime_pass(const Load& load, float2* out,
                                           int m, int ns, int p,
                                           const float2* ptw,
                                           const float2* tw,
                                           const Lanes& g, int frames = 0) {
  const int stride = m / p;
  const int L = ns * p;
  const int items = (kF > 0 ? kF : frames) * stride;
  const int step = 2 * m / p;
  for (int e = g.id; e < items * p; e += g.n) {
    const int s = e / items, i = e % items;
    const int f = i / stride, j = i % stride;
    const int k = j % ns;
    float2 acc = load(f, j);
    int t = 0;  // r s mod p
#pragma unroll 1
    for (int r = 1; r < p; ++r) {
      float2 v = load(f, j + r * stride);
      if (k > 0) v = cmul(v, pass_twiddle<kInverse>(ptw, r, ns, k));
      t += s;
      if (t >= p) t -= p;
      const float2 w = __ldg(tw + t * step);
      acc = cadd(acc, cmul(v, kInverse ? conjf2(w) : w));
    }
    out[f * m + (j / ns) * L + k + s * ns] = acc;
  }
  group_sync(g);
}

// The passes of a compile-time M from the one of width kNs on, in -> out
// and back: each pass's radix, stride and span are constants, and the
// recursion unrolls them.
template <bool kInverse, int kM, int kNs, int kF>
__device__ __forceinline__ float2* fft_fixed(float2* in, float2* out,
                                             const float2* ptw,
                                             const Lanes& g) {
  if constexpr (kNs == kM) {
    return in;
  } else {
    constexpr int R = next_radix(kM / kNs, true);
    static_assert(fixed_radix(R), "a compiled-in M factors into 2, 3, 5, 7");
    fft_pass<kInverse, R, kF>(BufLoad{in, kM}, out, kM, kNs, ptw, g);
    return fft_fixed<kInverse, kM, kNs * R, kF>(out, in, ptw, g);
  }
}

// A pass of the radix read at run time (the M = 0 instantiation); ptw
// and tw as in `fft`.
template <bool kInverse, int kF, class Load>
__device__ __forceinline__ void runtime_pass(int radix, const Load& load,
                                             float2* out, int m, int ns,
                                             const float2* ptw,
                                             const float2* tw,
                                             const Lanes& g,
                                             int frames = 0) {
  switch (radix) {
    case 12:
      return fft_pass<kInverse, 12, kF>(load, out, m, ns, ptw, g, frames);
    case 8:
      return fft_pass<kInverse, 8, kF>(load, out, m, ns, ptw, g, frames);
    case 5:
      return fft_pass<kInverse, 5, kF>(load, out, m, ns, ptw, g, frames);
    case 4:
      return fft_pass<kInverse, 4, kF>(load, out, m, ns, ptw, g, frames);
    case 3:
      return fft_pass<kInverse, 3, kF>(load, out, m, ns, ptw, g, frames);
    case 2:
      return fft_pass<kInverse, 2, kF>(load, out, m, ns, ptw, g, frames);
    case 1:
      return fft_pass<kInverse, 1, kF>(load, out, m, ns, ptw, g, frames);
    default:
      return prime_pass<kInverse, kF>(load, out, m, ns, radix, ptw, tw, g,
                                     frames);
  }
}

// Complex FFT (unnormalized) of kF sequences of m points (kF = 0: of
// `frames` sequences, a count read at run time, with kM = 0) whose input
// point q of frame f is first(f, q): the first pass reads its points
// through `first` (the windowing or the real-input pre-twiddle fused into
// it) and writes buf0, the later passes ping-pong between buf0 and buf1.
// Returns the buffer that holds the result. kM = m = n_fft / 2, or 0 to
// read the radices from p. tw: the caller's twiddle table, the n_fft-point
// table followed by the passes' (pass_twiddle).
template <bool kInverse, int kM, int kF, class Load>
__device__ __forceinline__ float2* fft(const Load& first, float2* buf0,
                                       float2* buf1, const FftPlan& p,
                                       const float2* tw, const Lanes& g,
                                       int frames = 0) {
  if constexpr (kM > 0) {
    constexpr int R = next_radix(kM, true);
    const float2* ptw = tw + 2 * kM;
    fft_pass<kInverse, R, kF>(first, buf0, kM, 1, ptw, g);
    return fft_fixed<kInverse, kM, R, kF>(buf0, buf1, ptw, g);
  } else {
    const float2* ptw = tw + 2 * p.m;
    runtime_pass<kInverse, kF>(p.radix[0], first, buf0, p.m, 1, ptw, tw, g,
                               frames);
    float2* in = buf0;
    float2* out = buf1;
    int ns = p.radix[0];
    for (int i = 1; i < p.passes; ++i) {
      runtime_pass<kInverse, kF>(p.radix[i], BufLoad{in, p.m}, out, p.m, ns,
                                 ptw, tw, g, frames);
      ns *= p.radix[i];
      float2* t = in;
      in = out;
      out = t;
    }
    return in;
  }
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

}  // namespace

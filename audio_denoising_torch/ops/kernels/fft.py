"""The in-kernel FFTs of ``csrc/fft.cuh`` (shared by the WebRTC hop and
the fused hop's fp32 walks): their pass schedule, the twiddle tables the
wrappers hand to the kernels, and a plain PyTorch mirror of the passes and
the real-input formulas for the tests.

A real FFT of n_fft points is a complex FFT of m = n_fft / 2 points (the
frame packed two samples a point) and the real-input split
(``real_bins``); its inverse is the split's pre-twiddle
(``inverse_input``) and an inverse complex FFT whose points are the
samples in pairs. The complex FFT runs in a few wide Stockham passes
(``fft_radices``, ``fft_passes``) whose twiddles come from
``pass_twiddle_table``; the real split's from ``twiddle_table``.
"""

import math
from typing import List, Optional

import numpy as np
import torch

PASS_RADICES = (12, 8, 5, 4, 3, 2)   # a rest the kernels take as one pass
MAX_PASSES = 16                   # kMaxPasses in csrc/fft.cuh
# the M = n_fft / 2 that csrc/webrtc_hop.cu compiles into an instantiation
# of their own (its fft_instance): the schedule's default `compiled`; any
# other M, and every M of csrc/fused_hop.cu, runs the M = 0 one
FFT_INSTANCES = (768, 512, 441, 32)


def _compiled(m: int, compiled: Optional[bool]) -> bool:
    return m in FFT_INSTANCES if compiled is None else compiled


def fft_radices(m: int, compiled: Optional[bool] = None) -> List[int]:
    """The radices of the passes ``csrc/fft.cuh`` runs for a complex FFT
    of ``m = n_fft / 2`` points (its ``next_radix``): the rest itself where
    it is one of PASS_RADICES, else the first of 8, 4, 2, 3 and 5 that
    divides it (9 before 3 where m is compiled in), else its smallest prime
    factor (7 in registers where m is compiled in, else it and any larger
    prime a prime pass); ``m = 1`` is one pass of radix 1. ``compiled``:
    the M is a compile-time one (by default, one of the WebRTC kernels'
    FFT_INSTANCES; the fused hop's FFTs pass False). 768 gives 8 x 8 x 12,
    441 9 x 7 x 7 compiled (3 x 3 x 7 x 7 not), 320 8 x 8 x 5, 63 3 x 3 x
    7, 22 2 x 11, 509 one pass of 509."""
    if m < 1:
        raise ValueError(f"an FFT of {m} points")
    if m == 1:
        return [1]
    divisors = ((8, 4, 2, 9, 3, 5) if _compiled(m, compiled)
                else (8, 4, 2, 3, 5))
    radices, rest = [], m
    while rest > 1:
        r = rest if rest in PASS_RADICES else next(
            (r for r in divisors if rest % r == 0), None)
        if r is None:
            r = next((q for q in range(7, math.isqrt(rest) + 1, 2)
                      if rest % q == 0), rest)
        radices.append(r)
        rest //= r
    return radices


def twiddle_table(n_fft: int) -> np.ndarray:
    """(n_fft, 2) float64: e^{-2 pi i t / n_fft} as (cos, -sin), the
    table the wrapper hands to the kernels (in float32). Its quarter turns
    are exact: with sin(pi) rounded (1.2e-16) the real split gave the
    Nyquist bin an imaginary part of that order, which Griffin-Lim's
    u / (|u| + 1e-16) turned into a phase of norm between 0 and 1 where
    the bin's real part was 0."""
    t = np.arange(n_fft)
    table = np.stack([np.cos(t * (2 * np.pi / n_fft)),
                      -np.sin(t * (2 * np.pi / n_fft))], axis=1)
    quarter = (4 * t) % n_fft == 0
    table[quarter] = np.rint(table[quarter])
    return table


def pass_twiddle_table(m: int, compiled: Optional[bool] = None
                       ) -> np.ndarray:
    """(max(m - 1, 1), 2) float64: the twiddles of the passes of an FFT of
    m points (``fft_radices(m, compiled)``), as (cos, -sin), the table the
    wrapper hands to the kernels (in float32). A pass of radix R after
    passes of product ns multiplies point r of item k by e^{-2 pi i k r /
    (ns R)}, entry r ns + k - 1 (1 <= r < R, k < ns): pass by pass the
    entries fill [ns - 1, ns R - 1); m = 1 has one unused entry, 1."""
    if m == 1:
        return np.array([[1.0, 0.0]])
    table = np.full((m - 1, 2), np.nan)
    ns = 1
    for R in fft_radices(m, compiled):
        k, r = np.meshgrid(np.arange(ns), np.arange(1, R), indexing="ij")
        angle = 2 * np.pi * k * r / (ns * R)
        table[r * ns + k - 1] = np.stack([np.cos(angle), -np.sin(angle)],
                                         axis=-1)
        ns *= R
    return table


def _complex_table(twiddle: torch.Tensor, dtype) -> torch.Tensor:
    return torch.complex(twiddle[:, 0], twiddle[:, 1]).to(dtype)


def _const(x: float, single: bool) -> float:
    """A compile-time constant of the kernels: rounded to float32 where
    the mirror computes in single precision (as the kernels do), exact in
    float64."""
    return float(np.float32(x)) if single else x


def _turn(t: int, R: int, single: bool) -> complex:
    """(cos, sin) of 2 pi t / R as the kernels' constants (cos_turn), as a
    complex value."""
    a = 2 * np.pi * (t % R) / R
    return complex(_const(np.cos(a), single), _const(np.sin(a), single))


def _rot90(v: torch.Tensor, inverse: bool) -> torch.Tensor:
    """v times -i (forward) or +i (inverse): a swap and a sign, exact."""
    return torch.complex(-v.imag, v.real) if inverse else \
        torch.complex(v.imag, -v.real)


def _rotate(v: torch.Tensor, R: int, q: int, inverse: bool,
            single: bool) -> torch.Tensor:
    """csrc/fft.cuh's rotate: v e^{-+2 pi i q / R}, a quarter or half turn
    exactly, else a product by the constants."""
    t = q % R
    if t == 0:
        return v
    if 4 * t == R:
        return _rot90(v, inverse)
    if 2 * t == R:
        return -v
    if 4 * t == 3 * R:
        return _rot90(v, not inverse)
    w = _turn(t, R, single)
    return v * complex(w.real, w.imag if inverse else -w.imag)


def _dft(v: List[torch.Tensor], inverse: bool,
         single: bool) -> List[torch.Tensor]:
    """csrc/fft.cuh's in-register DFT of R = len(v) points (1, 2, 3, 4, 5,
    7, 8, 9 or 12), its operations in its order: 5 and 7 pair the points
    r and R - r, 8 and 12 run four-point DFTs over the R / 4 subsequences,
    twiddle them and finish with R / 4-point DFTs, 9 does so with three."""
    R = len(v)
    rot = lambda x: _rot90(x, inverse)
    if R == 1:
        return v
    if R == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if R == 3:
        s, d = v[1] + v[2], rot(v[1] - v[2])
        mid = v[0] - 0.5 * s
        c = _const(0.86602540378443864676, single)   # sqrt(3) / 2
        return [v[0] + s, mid + c * d, mid - c * d]
    if R == 4:
        t0, t1 = v[0] + v[2], v[0] - v[2]
        t2, t3 = v[1] + v[3], rot(v[1] - v[3])
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    if R == 5:
        c1, c2, s1, s2 = (_const(x, single) for x in (
            0.30901699437494742410, -0.80901699437494742410,
            0.95105651629515357212, 0.58778525229247312917))
        a1, b1 = v[1] + v[4], v[1] - v[4]
        a2, b2 = v[2] + v[3], v[2] - v[3]
        t1 = v[0] + c1 * a1 + c2 * a2
        t2 = v[0] + c2 * a1 + c1 * a2
        u1, u2 = rot(s1 * b1 + s2 * b2), rot(s2 * b1 - s1 * b2)
        return [v[0] + (a1 + a2), t1 + u1, t2 + u2, t2 - u2, t1 - u1]
    if R == 7:
        H = (R - 1) // 2
        a = [v[r] + v[R - r] for r in range(1, H + 1)]
        b = [v[r] - v[R - r] for r in range(1, H + 1)]
        total = v[0]
        for x in a:
            total = total + x
        out = [total] + [None] * (R - 1)
        for s in range(1, H + 1):
            w = _turn(s, R, single)
            t, u = v[0] + w.real * a[0], w.imag * b[0]
            for k in range(2, H + 1):
                w = _turn(k * s, R, single)
                t, u = t + w.real * a[k - 1], u + w.imag * b[k - 1]
            u = rot(u)
            out[s], out[R - s] = t + u, t - u
        return out
    if R in (8, 9, 12):
        P = 3 if R == 9 else 4          # the first level's DFT
        Q = R // P
        y = [_dft([v[n2 + Q * n1] for n1 in range(P)], inverse, single)
             for n2 in range(Q)]
        for n2 in range(1, Q):
            for k1 in range(1, P):
                y[n2][k1] = _rotate(y[n2][k1], R, n2 * k1, inverse, single)
        out = [None] * R
        for k1 in range(P):
            z = _dft([y[n2][k1] for n2 in range(Q)], inverse, single)
            for k2 in range(Q):
                out[k1 + P * k2] = z[k2]
        return out
    raise ValueError(f"no in-register DFT of {R} points")


def fft_passes(z: torch.Tensor, pass_twiddle: torch.Tensor,
               inverse: bool = False, compiled: Optional[bool] = None,
               twiddle: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' complex FFT (unnormalized; conjugate twiddles for the
    inverse) of each row of ``z`` (frames, m), pass by pass as the kernels
    run it: Stockham autosort over ``fft_radices(m, compiled)``, item j of
    a pass of radix R after passes of product ns reading points j + r m /
    R, point r > 0 twiddled by entry r ns + k - 1 (k = j mod ns) of
    ``pass_twiddle`` (``pass_twiddle_table(m, compiled)``), an R-point
    DFT in the kernels' operations (``_dft``; a radix the instantiation
    does not hold in registers, a prime pass: point r's product by w^{r
    s}, w^t entry t n_fft / R of ``twiddle``, the n_fft-point table,
    added in order of r), and the results stored at (j div ns) ns R + k +
    s ns. Each output comes from its own points alone, so a row's results
    do not depend on how many rows the call has."""
    m, dev = z.shape[-1], z.device
    ptw = _complex_table(pass_twiddle, z.dtype)
    if inverse:
        ptw = ptw.conj()
    in_registers = (1, 2, 3, 4, 5, 7, 8, 9, 12) if _compiled(m, compiled) \
        else (1, 2, 3, 4, 5, 8, 12)
    x, ns = z, 1
    for R in fft_radices(m, compiled):
        stride, L = m // R, ns * R
        j = torch.arange(stride, device=dev)
        k = j % ns
        pts = []
        for r in range(R):
            p = x[:, j + r * stride]
            if r > 0:   # k > 0: the pass's twiddle; k = 0 none
                p = torch.where(k > 0, p * ptw[(r * ns + k - 1).clamp(min=0)],
                                p)
            pts.append(p)
        if R in in_registers:
            y = _dft(pts, inverse, z.dtype == torch.complex64)
        else:
            table = _complex_table(
                twiddle if twiddle is not None else torch.from_numpy(
                    twiddle_table(2 * m)).to(dev, pass_twiddle.dtype),
                z.dtype)
            step = 2 * m // R
            y = []
            for s in range(R):
                acc = pts[0]
                for r in range(1, R):
                    w = table[(r * s % R) * step]
                    acc = acc + pts[r] * (w.conj() if inverse else w)
                y.append(acc)
        out = torch.empty_like(x)
        base = (j // ns) * L + k
        for s in range(R):
            out[:, base + s * ns] = y[s]
        x, ns = out, L
    return x


def real_bins(z: torch.Tensor, twiddle: torch.Tensor) -> torch.Tensor:
    """Bins 0..m of the real FFT of each frame from ``z`` (frames, m), the
    complex FFT of the frame packed as m points (even samples real, odd
    imaginary): the kernels' ``real_bin``."""
    m = z.shape[-1]
    tw = _complex_table(twiddle, z.dtype)
    k = torch.arange(m + 1, device=z.device)
    zk, zc = z[:, k % m], z[:, (m - k) % m].conj()
    return 0.5 * (zk + zc) + tw[k] * (-0.5j * (zk - zc))


def inverse_input(spec: torch.Tensor, twiddle: torch.Tensor
                  ) -> torch.Tensor:
    """The m packed points the kernels' inverse transform starts from,
    given bins 0..m of each frame (frames, m + 1): the imaginary parts of
    DC and Nyquist dropped, the real-input pre-twiddle that the inverse
    FFT's first pass applies. Their inverse complex FFT, its points read
    as (even, odd) sample pairs, is n_fft times ``irfft(spec)``."""
    m = spec.shape[-1] - 1
    tw = _complex_table(twiddle, spec.dtype)
    k = torch.arange(m, device=spec.device)
    xk, xc = spec[:, k].clone(), spec[:, m - k].conj()
    # copies: a one-row view's .real shares its memory with the target
    xk[:, 0], xc[:, 0] = xk[:, 0].real.clone(), xc[:, 0].real.clone()
    return (xk + xc) + 1j * ((xk - xc) * tw[k].conj())

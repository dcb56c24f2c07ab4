"""Griffin-Lim phase reconstruction (JAX counterpart ops/griffinlim.py).

Momentum-accelerated fast Griffin-Lim with torchaudio's functional
griffinlim structure, as torchaudio's ``GriffinLim(power=1.0, n_iter=32,
momentum=0.99)`` runs on the reference WebRTC path (app2.py:156-160).
Unit phase (``init='ones'``) is the deterministic default;
``init='random'`` draws torchaudio's init (uniform real and imaginary
parts) from an explicit ``torch.Generator``.
"""

from typing import Optional

import torch

from audio_denoising_torch.ops.stft import istft, stft


def griffin_lim(magnitude: torch.Tensor, n_fft: int, hop_length: int,
                win_length: Optional[int] = None,
                window: Optional[torch.Tensor] = None,
                n_iter: int = 32, momentum: float = 0.99,
                length: Optional[int] = None, init: str = "ones",
                generator: Optional[torch.Generator] = None,
                init_angles: Optional[torch.Tensor] = None,
                return_angles: bool = False):
    """magnitude: (..., freq, T) non-negative -> waveform (..., L).

    ``init_angles`` (complex, the magnitude's shape) seeds the phase
    estimate: the streaming warm start passes the previous hop's
    converged angles. ``return_angles`` also returns the final angles."""
    if not 0 <= momentum < 1:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    mom = momentum / (1 + momentum)
    # float32 unless given float64 (a double-precision witness)
    wide = magnitude.dtype == torch.float64
    mag = magnitude.to(torch.float64 if wide else torch.float32)
    cplx = torch.complex128 if wide else torch.complex64

    if init_angles is not None:
        angles = init_angles.to(cplx)
    elif init == "random":
        if generator is None:
            raise ValueError("init='random' takes an explicit generator")
        re = torch.rand(mag.shape, generator=generator,
                        device=generator.device)
        im = torch.rand(mag.shape, generator=generator,
                        device=generator.device)
        angles = torch.complex(re, im).to(mag.device, cplx)
    elif init == "ones":
        angles = torch.ones(mag.shape, dtype=cplx,
                            device=mag.device)
    else:
        raise ValueError(f"unknown init {init!r}: 'ones' or 'random'")

    tprev = torch.zeros_like(angles)
    for _ in range(n_iter):
        inverse = istft(mag * angles, n_fft, hop_length, win_length,
                        window=window, length=length)
        rebuilt = stft(inverse, n_fft, hop_length, win_length, window=window)
        upd = rebuilt - mom * tprev
        angles = upd / (upd.abs() + 1e-16)
        tprev = rebuilt
    out = istft(mag * angles, n_fft, hop_length, win_length, window=window,
                length=length)
    if return_angles:
        return out, angles
    return out

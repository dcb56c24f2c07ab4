"""STFT / iSTFT with torch.stft / torch.istft semantics (JAX counterpart
ops/stft.py).

Centered reflect padding (numpy's, which also takes a pad longer than
the signal), a window zero-padded to ``n_fft``, one-sided
spectra, and an inverse that overlap-adds windowed ``irfft`` frames and
divides by the window-square envelope, guarded where the envelope is ~0
(torch raises there). Shapes follow the JAX package: spectra are
``(..., n_fft // 2 + 1, T)`` complex.
"""

from typing import Optional

import torch

from audio_denoising_torch.ops.windows import hann_window


def num_frames(length: int, n_fft: int, hop_length: int,
               center: bool = True) -> int:
    """Number of STFT frames torch.stft produces for a signal of ``length``."""
    if center:
        length = length + 2 * (n_fft // 2)
    return 1 + (length - n_fft) // hop_length


def _full_window(window: Optional[torch.Tensor], n_fft: int, win_length: int,
                 like: torch.Tensor) -> torch.Tensor:
    """Zero-pad a win_length window to n_fft, centered (torch.stft rule)."""
    if window is None:
        window = hann_window(win_length)
    window = window.to(device=like.device, dtype=like.dtype)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        window = torch.nn.functional.pad(
            window, (left, n_fft - win_length - left))
    return window


def _reflect_index(length: int, pad: int, device) -> torch.Tensor:
    """Indices of numpy's (and the JAX package's) 'reflect' padding of a
    length-``length`` axis by ``pad`` on both sides; unlike
    ``F.pad(mode="reflect")`` it takes ``pad >= length`` (a server-step
    chunk of one hop is shorter than the n_fft // 2 padding)."""
    idx = torch.arange(-pad, length + pad, device=device)
    if length == 1:
        return torch.zeros_like(idx)
    period = 2 * (length - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx < length, idx, period - idx)


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """Slice (..., L) into overlapping frames (..., T, n_fft)."""
    if center:
        x = x[..., _reflect_index(x.shape[-1], n_fft // 2, x.device)]
    return x.unfold(-1, n_fft, hop_length)


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: Optional[int] = None,
         window: Optional[torch.Tensor] = None,
         center: bool = True) -> torch.Tensor:
    """Complex STFT of (..., L) -> (..., n_fft // 2 + 1, T)."""
    win_length = win_length or n_fft
    window = _full_window(window, n_fft, win_length, x)
    frames = frame_signal(x, n_fft, hop_length, center=center)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    return spec.transpose(-1, -2)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          win_length: Optional[int] = None,
          window: Optional[torch.Tensor] = None, center: bool = True,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT of (..., freq, T) -> (..., L), matching torch.istft.

    ``irfft`` ignores the imaginary parts of the DC and Nyquist bins, as
    torch.istft does."""
    win_length = win_length or n_fft
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    window = _full_window(window, n_fft, win_length, frames)
    frames = frames * window                                 # (..., T, n_fft)

    t = spec.shape[-1]
    out_len = n_fft + hop_length * (t - 1)
    idx = (torch.arange(t, device=frames.device)[:, None] * hop_length
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    batch_shape = frames.shape[:-2]
    flat = frames.reshape(-1, t * n_fft)
    out = torch.zeros((flat.shape[0], out_len), dtype=frames.dtype,
                      device=frames.device)
    out.index_add_(1, idx, flat)
    out = out.reshape(*batch_shape, out_len)

    env = torch.zeros(out_len, dtype=frames.dtype, device=frames.device)
    env.index_add_(0, idx, (window * window).repeat(t))
    out = out / torch.where(env.abs() > 1e-11, env, torch.ones_like(env))

    # torch.istft trimming: with center, drop n_fft // 2 from the start;
    # the end is trimmed to out_len - n_fft // 2 only when no length is
    # given; a given length is taken from the start offset directly
    start = n_fft // 2 if center else 0
    if length is None:
        end = out_len - start if center else out_len
    else:
        end = start + length
    if end > out_len:
        out = torch.nn.functional.pad(out, (0, end - out_len))
    return out[..., start:end]

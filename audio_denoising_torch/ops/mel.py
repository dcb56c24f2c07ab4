"""Mel filterbank and its minimum-norm inverse (host-side constants).

torchaudio ``melscale_fbanks(norm=None, mel_scale='htk')`` semantics, as
the reference uses them (app2.py:147-155, server.py:175-176): HTK mel
scale, no filterbank norm, f_min=0, f_max=sr/2. The inverse is the
precomputed pseudo-inverse of ``fb.T`` — one matmul per frame in place of
torchaudio's per-call least-squares solve. Built in float64, then cast.
"""

from functools import lru_cache

import numpy as np
import torch


def hz_to_mel(f):
    """HTK mel scale (torchaudio default for MelScale)."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=32)
def _mel_filterbank_np(n_stft: int, n_mels: int, sample_rate: int,
                       f_min: float = 0.0, f_max=None) -> np.ndarray:
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_stft)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                       # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_stft, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))          # float64


def mel_filterbank(n_stft: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max=None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Triangular mel filterbank, shape (n_stft, n_mels)."""
    fb = _mel_filterbank_np(n_stft, n_mels, sample_rate, f_min, f_max)
    return torch.from_numpy(fb.copy()).to(dtype)


def inverse_mel_matrix(n_stft: int, n_mels: int, sample_rate: int,
                       f_min: float = 0.0, f_max=None,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Minimum-norm right-inverse of ``fb.T``, shape (n_stft, n_mels):
    ``X = inv @ mel`` solves ``fb.T X = mel`` exactly on the filterbank's
    row space. The reference package builds the pseudo-inverse from the
    float32 filterbank, so this does too."""
    fb = _mel_filterbank_np(n_stft, n_mels, sample_rate, f_min, f_max)
    inv = np.linalg.pinv(fb.astype(np.float32).T.astype(np.float64),
                         rcond=1e-8)
    return torch.from_numpy(inv).to(dtype)

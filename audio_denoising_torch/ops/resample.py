"""Polyphase sinc resampling, torchaudio ``Resample`` semantics (JAX
counterpart ops/resample.py).

The standard windowed-sinc polyphase algorithm (``sinc_interp_hann``): a
bank of ``new_freq / gcd`` FIR phases built once in numpy (float64, cast
to float32) and applied as one strided ``F.conv1d`` on the signal's
device, whose output channels interleave into the resampled signal. On
the card the conv runs in full fp32 when the caller scopes it under
``pipeline.fp32_convs()`` (cuDNN takes TF32 for fp32 convs by default).
"""

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=32)
def _sinc_kernel_np(orig_freq: int, new_freq: int,
                    lowpass_filter_width: int = 6,
                    rolloff: float = 0.99) -> Tuple[np.ndarray, int]:
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))

    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * (base_freq / orig)
    return kernel.astype(np.float32)[:, None, :], width  # (new, 1, taps)


def resample_kernel(orig_freq: int, new_freq: int,
                    lowpass_filter_width: int = 6,
                    rolloff: float = 0.99) -> Tuple[torch.Tensor, int]:
    """(the FIR phase bank (new, 1, taps) as a CPU tensor, its half
    width in input samples)."""
    k, w = _sinc_kernel_np(orig_freq, new_freq, lowpass_filter_width, rolloff)
    return torch.from_numpy(k.copy()), w


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99
             ) -> torch.Tensor:
    """x: (..., L) at orig_freq -> (..., ceil(L * new/orig)) at new_freq,
    on x's device."""
    if orig_freq == new_freq:
        return x
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    kernel, width = resample_kernel(orig_freq, new_freq,
                                    lowpass_filter_width, rolloff)
    kernel = kernel.to(device=x.device, dtype=x.dtype)
    shape = x.shape
    length = shape[-1]
    flat = F.pad(x.reshape(-1, 1, length), (width, width + orig))
    out = F.conv1d(flat, kernel, stride=orig)               # (B, new, T')
    out = out.transpose(1, 2).reshape(flat.shape[0], -1)
    target = int(math.ceil(new * length / orig))
    return out[..., :target].reshape(shape[:-1] + (target,))

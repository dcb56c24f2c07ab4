"""Window functions matching torch conventions, and the overlap-add
envelope of the phase-reuse hops (host-side constants)."""

import numpy as np
import torch


def hann_window(window_length: int, periodic: bool = True,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Periodic Hann window, ``torch.hann_window``'s definition, built in
    float64 and cast: w[n] = 0.5 * (1 - cos(2*pi*n / N)) for n in [0, N)
    when periodic (N - 1 in the denominator otherwise)."""
    if window_length == 1:
        return torch.ones(1, dtype=dtype)
    n = np.arange(window_length, dtype=np.float64)
    denom = window_length if periodic else window_length - 1
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom))
    return torch.from_numpy(w).to(dtype)


def wola_envelope(win: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """The sum of the squared window over the overlapping hops, over the
    first hop (constant for a periodic Hann at hop | n_fft); 1 where it
    vanishes. float32, shape (hop,)."""
    env = np.zeros(n_fft, np.float64)
    for k in range(n_fft // hop):
        env += np.roll(win * win, k * hop)
    return np.where(env[:hop] > 1e-8, env[:hop], 1.0).astype(np.float32)

"""Loss metrics (JAX counterpart train/losses.py).

``mse``/``mae`` are the reference contract (the ``loss_metric`` fields of
every shipped checkpoint: {'train': 'MSE', 'test': 'MAE'}, reference
app.py:100-101).

``multi_res_stft`` scores the denoised waveform of the reconstruction
objective (``TrainConfig.objective = 'recon_mrstft'``): spectral
convergence plus log-magnitude L1 (Arik et al. 2018), averaged over
several STFT resolutions (Yamamoto et al. 2020). Every function here is
plain differentiable PyTorch on its inputs' device.
"""

from typing import Sequence, Tuple

import torch

from audio_denoising_torch.ops import hann_window, stft


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


LOSSES = {"MSE": mse, "MAE": mae, "L1": mae, "L2": mse}


# (n_fft, hop) pairs, window = the n_fft Hann; they straddle the serving
# chain's own resolution (1024/512 at 48 kHz) from both sides
DEFAULT_RESOLUTIONS: Tuple[Tuple[int, int], ...] = (
    (512, 128), (1024, 256), (2048, 512))


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    win = hann_window(n_fft).to(device=x.device, dtype=x.dtype)
    return torch.abs(stft(x, n_fft, hop, n_fft, window=win))


def spectral_convergence(est_mag: torch.Tensor, ref_mag: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """|| |S_ref| - |S_est| ||_F / || |S_ref| ||_F (batch-mean)."""
    num = torch.sqrt(torch.sum((ref_mag - est_mag) ** 2, dim=(-2, -1)))
    den = torch.sqrt(torch.sum(ref_mag ** 2, dim=(-2, -1)))
    return torch.mean(num / (den + eps))


def log_mag_l1(est_mag: torch.Tensor, ref_mag: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    return torch.mean(torch.abs(torch.log(est_mag + eps)
                                - torch.log(ref_mag + eps)))


def multi_res_stft(est: torch.Tensor, ref: torch.Tensor,
                   resolutions: Sequence[Tuple[int, int]]
                   = DEFAULT_RESOLUTIONS) -> torch.Tensor:
    """Spectral convergence + log-magnitude L1 over ``resolutions``, est
    and ref (B, L) waveforms -> a scalar, the mean over resolutions (so
    the weight is comparable when the list changes)."""
    total = 0.0
    for n_fft, hop in resolutions:
        e = _stft_mag(est, n_fft, hop)
        r = _stft_mag(ref, n_fft, hop)
        total = total + spectral_convergence(e, r) + log_mag_l1(e, r)
    return total / len(resolutions)

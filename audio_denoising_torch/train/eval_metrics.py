"""Denoising quality metrics (JAX counterpart train/eval_metrics.py):
SNR, SI-SDR and log-spectral distance over the last axis, batched and
differentiable (``si_sdr_db`` is a term of the reconstruction objective
when ``TrainConfig.si_sdr_weight`` is set)."""

import torch

from audio_denoising_torch.ops import hann_window, stft


def snr_db(clean: torch.Tensor, estimate: torch.Tensor,
           eps: float = 1e-8) -> torch.Tensor:
    """Signal-to-noise ratio in dB over the last axis."""
    num = torch.sum(clean ** 2, dim=-1)
    den = torch.sum((estimate - clean) ** 2, dim=-1)
    return 10.0 * torch.log10((num + eps) / (den + eps))


def si_sdr_db(clean: torch.Tensor, estimate: torch.Tensor,
              eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SDR (Le Roux et al. 2019) over the last axis:
    invariant to the pipeline's gain conventions (the reference's x3
    output gain, server.py:213)."""
    clean = clean - clean.mean(dim=-1, keepdim=True)
    estimate = estimate - estimate.mean(dim=-1, keepdim=True)
    dot = torch.sum(clean * estimate, dim=-1, keepdim=True)
    energy = torch.sum(clean ** 2, dim=-1, keepdim=True)
    target = dot / (energy + eps) * clean
    noise = estimate - target
    num = torch.sum(target ** 2, dim=-1)
    den = torch.sum(noise ** 2, dim=-1)
    return 10.0 * torch.log10((num + eps) / (den + eps))


def log_spectral_distance(clean: torch.Tensor, estimate: torch.Tensor,
                          n_fft: int = 512, hop: int = 256,
                          eps: float = 1e-5) -> torch.Tensor:
    """RMS distance between log-magnitude spectrograms."""
    win = hann_window(n_fft).to(device=clean.device, dtype=clean.dtype)
    a = torch.log(torch.abs(stft(clean, n_fft, hop, n_fft, window=win))
                  + eps)
    b = torch.log(torch.abs(stft(estimate, n_fft, hop, n_fft, window=win))
                  + eps)
    return torch.sqrt(torch.mean((a - b) ** 2, dim=(-2, -1)))

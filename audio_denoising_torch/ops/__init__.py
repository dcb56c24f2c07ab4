"""Host-side DSP ops (windows, mel pair, STFT, Griffin-Lim, spectral
compression) and conv wrappers; kernels live in ``ops.kernels``."""

from audio_denoising_torch.ops.compress import (
    denormalize_stds, expm1_expand, log1p_compress, normalize_stds,
    STDS, signed_log_clamp, signed_log_unclamp, unwrap_complex, wrap_complex)
from audio_denoising_torch.ops.griffinlim import griffin_lim
from audio_denoising_torch.ops.mel import (
    inverse_mel_matrix, inverse_mel_scale, mel_filterbank, mel_scale)
from audio_denoising_torch.ops.stft import istft, num_frames, spec_phase, stft
from audio_denoising_torch.ops.windows import hann_window

__all__ = ["hann_window", "mel_filterbank", "inverse_mel_matrix",
           "mel_scale", "inverse_mel_scale", "stft", "istft", "num_frames",
           "spec_phase", "griffin_lim", "signed_log_clamp", "signed_log_unclamp",
           "log1p_compress", "expm1_expand", "unwrap_complex",
           "wrap_complex", "normalize_stds", "denormalize_stds", "STDS"]

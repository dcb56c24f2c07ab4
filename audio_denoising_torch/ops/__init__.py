"""Host-side DSP ops (windows, mel pair, STFT, Griffin-Lim) and conv
wrappers; kernels live in ``ops.kernels``."""

from audio_denoising_torch.ops.griffinlim import griffin_lim
from audio_denoising_torch.ops.mel import (
    inverse_mel_matrix, inverse_mel_scale, mel_filterbank, mel_scale)
from audio_denoising_torch.ops.stft import istft, num_frames, stft
from audio_denoising_torch.ops.windows import hann_window

__all__ = ["hann_window", "mel_filterbank", "inverse_mel_matrix",
           "mel_scale", "inverse_mel_scale", "stft", "istft", "num_frames",
           "griffin_lim"]

"""Host-side DSP constants and conv wrappers; kernels live in ``ops.kernels``."""

from audio_denoising_torch.ops.mel import inverse_mel_matrix, mel_filterbank
from audio_denoising_torch.ops.windows import hann_window

__all__ = ["hann_window", "mel_filterbank", "inverse_mel_matrix"]

"""Training (JAX counterpart train/): AdamW with an exponential LR decay,
the residual-MSE and reconstruction objectives on mixture-synthesized
batches, the contract reconstructed from the reference's TrainingContext
and checkpoint metadata (SURVEY §3.5)."""

from audio_denoising_torch.train.context import TrainingContext, TrainState
from audio_denoising_torch.train.data import MixtureSampler
from audio_denoising_torch.train.losses import mse, mae

__all__ = ["TrainingContext", "TrainState", "MixtureSampler", "mse", "mae"]

"""Model registry of the port: the GRUUNet and MOMO families."""

from typing import Optional

from audio_denoising_torch.config import ModelConfig
from audio_denoising_torch.models.gruunet import GRUUNet2
from audio_denoising_torch.models.momo import MOMO, MOMO2, MOMO3

# each class with its reference bin count, taken where none is given
_RECURRENT = {"GRUUNet2": (GRUUNet2, 64), "GRUUNet": (GRUUNet2, 64),
              "MOMO3": (MOMO3, 22), "MOMO2": (MOMO2, 22), "MOMO": (MOMO, 22)}


def build_model(config: ModelConfig, num_bins: Optional[int] = None):
    """Build a model from a (checkpoint-derived) ModelConfig. GRUUNet v1
    computes the same as GRUUNet2 for batched input, as in the JAX
    package."""
    if config.arch not in _RECURRENT:
        raise NotImplementedError(
            f"arch {config.arch!r} is not ported yet; the port has "
            f"{sorted(_RECURRENT)}")
    cls, default_bins = _RECURRENT[config.arch]
    return cls(config, num_bins=num_bins or default_bins)


__all__ = ["GRUUNet2", "MOMO", "MOMO2", "MOMO3", "build_model"]

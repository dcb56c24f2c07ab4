"""Model registry of the port (GRUUNet2 only in this slice)."""

from typing import Optional

from audio_denoising_torch.config import ModelConfig
from audio_denoising_torch.models.gruunet import GRUUNet2

_RECURRENT = {"GRUUNet2": GRUUNet2, "GRUUNet": GRUUNet2}


def build_model(config: ModelConfig, num_bins: Optional[int] = None):
    """Build a model from a (checkpoint-derived) ModelConfig. GRUUNet v1
    computes the same as GRUUNet2 for batched input, as in the JAX
    package."""
    if config.arch not in _RECURRENT:
        raise NotImplementedError(
            f"arch {config.arch!r} is not ported yet; the port has "
            f"{sorted(_RECURRENT)}")
    return _RECURRENT[config.arch](config, num_bins=num_bins or 64)


__all__ = ["GRUUNet2", "build_model"]

"""Model registry of the port (JAX counterpart models/__init__.py): the
recurrent GRUUNet and MOMO families, which expose ``cell`` and
``apply(x, hx) -> (y, hx')``, and the stateless segment family, the 2-D
U-Nets and TRUNet, which expose ``compatible_frames`` and ``apply(image)
-> residual``."""

from typing import Optional

from audio_denoising_torch.config import ModelConfig
from audio_denoising_torch.models.gru import GRU
from audio_denoising_torch.models.gruunet import GRUUNet2
from audio_denoising_torch.models.momo import MOMO, MOMO2, MOMO3
from audio_denoising_torch.models.trunet import TRUNet, TRUNetDenoiser
from audio_denoising_torch.models.unet2d import SPECS as UNET_SPECS, UNet2d

# each class with its reference bin count, taken where none is given
_RECURRENT = {"GRUUNet2": (GRUUNet2, 64), "GRUUNet": (GRUUNet2, 64),
              "MOMO3": (MOMO3, 22), "MOMO2": (MOMO2, 22), "MOMO": (MOMO, 22)}


def build_model(config: ModelConfig, num_bins: Optional[int] = None):
    """Build a model from a (checkpoint-derived) ModelConfig. GRUUNet v1
    computes the same as GRUUNet2 for batched input, as in the JAX
    package; the U-Nets default to 241 bins, TRUNetDenoiser to 257."""
    arch = config.arch
    if arch in _RECURRENT:
        cls, default_bins = _RECURRENT[arch]
        return cls(config, num_bins=num_bins or default_bins)
    if arch in UNET_SPECS:
        return UNet2d(arch=arch, chnls_in=config.chnls_in,
                      chnls_out=config.chnls_out, chnls_gs=config.chnls_gs,
                      bins=num_bins or 241)
    if arch == "TRUNet":
        return TRUNet()
    if arch == "TRUNetDenoiser":
        return TRUNetDenoiser(num_bins or 257)
    raise ValueError(f"unknown arch {arch!r}")


__all__ = ["GRU", "GRUUNet2", "MOMO", "MOMO2", "MOMO3", "TRUNet",
           "TRUNetDenoiser", "UNet2d", "build_model"]

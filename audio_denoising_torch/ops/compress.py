"""Spectral dynamic-range compression and complex packing (JAX counterpart
ops/compress.py): the signed-log clamp and unclamp (reference
utils.py:82-95), complex wrap and unwrap (utils.py:70-80), the 241-bin
per-bin standardization table (utils.py:401-437) and the log1p / expm1
mel compression of the WebRTC path (app2.py:200,214), on tensors.
"""

import numpy as np
import torch

# Per-bin stds for the legacy raw-spectrogram path (241 = 480 // 2 + 1
# bins, the n_fft = 480 era's config; reference utils.py:401-427).
STDS = np.array([
    0.3922, 0.2043, 0.2245, 0.1914, 0.1832, 0.1889, 0.1823, 0.1581, 0.1304,
    0.1081, 0.0921, 0.0825, 0.0775, 0.0758, 0.0749, 0.0713, 0.0643, 0.0567,
    0.0501, 0.0443, 0.0398, 0.0376, 0.0366, 0.0371, 0.0376, 0.0372, 0.0356,
    0.0324, 0.0289, 0.0254, 0.0231, 0.0221, 0.0214, 0.0218, 0.0223, 0.0227,
    0.0227, 0.0221, 0.0209, 0.0192, 0.0173, 0.0159, 0.0150, 0.0141, 0.0130,
    0.0123, 0.0119, 0.0112, 0.0107, 0.0101, 0.0098, 0.0097, 0.0095, 0.0095,
    0.0097, 0.0096, 0.0098, 0.0099, 0.0096, 0.0094, 0.0092, 0.0090, 0.0088,
    0.0086, 0.0084, 0.0081, 0.0079, 0.0077, 0.0075, 0.0073, 0.0072, 0.0072,
    0.0070, 0.0068, 0.0067, 0.0066, 0.0067, 0.0066, 0.0065, 0.0064, 0.0065,
    0.0066, 0.0068, 0.0068, 0.0068, 0.0067, 0.0067, 0.0066, 0.0065, 0.0065,
    0.0064, 0.0063, 0.0063, 0.0063, 0.0063, 0.0063, 0.0062, 0.0062, 0.0061,
    0.0062, 0.0062, 0.0062, 0.0061, 0.0061, 0.0062, 0.0062, 0.0063, 0.0062,
    0.0062, 0.0061, 0.0060, 0.0059, 0.0060, 0.0061, 0.0060, 0.0061, 0.0061,
    0.0062, 0.0063, 0.0063, 0.0063, 0.0062, 0.0061, 0.0061, 0.0059, 0.0059,
    0.0057, 0.0056, 0.0056, 0.0055, 0.0056, 0.0056, 0.0055, 0.0055, 0.0054,
    0.0052, 0.0051, 0.0051, 0.0050, 0.0049, 0.0048, 0.0048, 0.0048, 0.0047,
    0.0047, 0.0045, 0.0044, 0.0043, 0.0043, 0.0040, 0.0029, 0.0024, 0.0021,
    0.0019, 0.0018, 0.0017, 0.0016, 0.0015, 0.0015, 0.0014, 0.0014, 0.0014,
    0.0013, 0.0013, 0.0013, 0.0012, 0.0012, 0.0012, 0.0012, 0.0012, 0.0011,
    0.0011, 0.0011, 0.0011, 0.0011, 0.0011, 0.0011, 0.0011, 0.0010, 0.0010,
    0.0010, 0.0010, 0.0010, 0.0010, 0.0010, 0.0010, 0.0010, 0.0010, 0.0010,
    0.0010, 0.0009, 0.0009, 0.0009, 0.0009, 0.0009, 0.0009, 0.0009, 0.0009,
    0.0009, 0.0009, 0.0009, 0.0009, 0.0009, 0.0009, 0.0009, 0.0009, 0.0009,
    0.0009, 0.0009, 0.0009, 0.0009, 0.0009, 0.0009, 0.0008, 0.0008, 0.0008,
    0.0008, 0.0008, 0.0008, 0.0008, 0.0008, 0.0008, 0.0008, 0.0008, 0.0008,
    0.0008, 0.0008, 0.0008, 0.0008, 0.0008, 0.0008, 0.0008, 0.0008, 0.0008,
    0.0008, 0.0008, 0.0008, 0.0008, 0.0008, 0.0008, 0.0008,
], dtype=np.float32)


def signed_log_clamp(x: torch.Tensor) -> torch.Tensor:
    """(|x| + 1).log() * sign(x), reference utils.py:88."""
    return torch.log1p(x.abs()) * torch.sign(x)


def signed_log_unclamp(y: torch.Tensor) -> torch.Tensor:
    """sign(y) * (exp(|y|) - 1), reference utils.py:95."""
    return torch.sign(y) * torch.expm1(y.abs())


def log1p_compress(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(x)


def expm1_expand(y: torch.Tensor) -> torch.Tensor:
    return torch.expm1(y)


def unwrap_complex(z: torch.Tensor) -> torch.Tensor:
    """Complex (B, F, T) -> real (B, 2, F, T) (utils.py:70-72 stacks, then
    transposes the batch and part axes)."""
    return torch.stack([z.real, z.imag], dim=1)


def wrap_complex(x: torch.Tensor) -> torch.Tensor:
    """Real (B, 2, F, T) -> complex (B, F, T)."""
    return torch.complex(x[:, 0], x[:, 1])


def _stds(x: torch.Tensor, stds) -> torch.Tensor:
    s = torch.as_tensor(STDS if stds is None else stds, device=x.device)
    return s.reshape((1, -1, 1) if x.dim() == 3 else (1, 1, -1, 1))


def normalize_stds(x: torch.Tensor, stds=None) -> torch.Tensor:
    """Divide by the per-bin std over the frequency axis (-2 of a 3-D
    (B, F, T), -2 of a 4-D (B, 2, F, T)); utils.py:429-432."""
    return x / _stds(x, stds)


def denormalize_stds(x: torch.Tensor, stds=None) -> torch.Tensor:
    return x * _stds(x, stds)

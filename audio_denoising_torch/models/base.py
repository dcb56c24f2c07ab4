"""Shared model building blocks (host-side constants, checkpoint
loading)."""

from typing import List, Mapping, Sequence

import numpy as np
import torch
from torch import nn


def gaussian_smearing(num_bins: int, num_gaussians: int = 6,
                      start: float = 0.0, stop: float = 1.0,
                      sqrt_positions: bool = False) -> np.ndarray:
    """RBF embedding of the normalized bin index, (num_gaussians, num_bins)
    float32. The reference recomputes it every frame at every level
    (gruunet2.py:139-143); it depends only on the shape, so it is a
    constant here. ``sqrt_positions`` is the 2-D U-Nets' variant over
    ``linspace(0, 1, bins).sqrt()`` (unet4.py:158)."""
    offset = np.linspace(start, stop, num_gaussians)
    coeff = -0.5 / float(offset[1] - offset[0]) ** 2
    pos = np.linspace(0.0, 1.0, num_bins)
    if sqrt_positions:
        pos = np.sqrt(pos)
    dist = pos[:, None] - offset[None, :]
    return np.exp(coeff * dist * dist).T.astype(np.float32)


def conv_out_len(length: int, kernel: int, stride: int, padding: int) -> int:
    return (length + 2 * padding - (kernel - 1) - 1) // stride + 1


def down_bin_sizes(num_bins: int, kernels: Sequence[int],
                   strides: Sequence[int], paddings: Sequence[int]) -> List[int]:
    """Spatial sizes [input, after level 0, ..., after level L-1]."""
    sizes = [num_bins]
    for k, s, p in zip(kernels, strides, paddings):
        sizes.append(conv_out_len(sizes[-1], k, s, p))
    return sizes


def load_reference_params(module: nn.Module,
                          params: Mapping[str, torch.Tensor],
                          num_gaussians: int) -> nn.Module:
    """Load a reference state dict into ``module``. Its GaussianSmearing
    offsets (``*.gs.offset``) are checked against the constants the port
    computes and not loaded; every other key must match exactly."""
    params = dict(params)
    want = np.linspace(0.0, 1.0, num_gaussians)
    for k in [k for k in params
              if k == "gs.offset" or k.endswith(".gs.offset")]:
        got = np.asarray(params.pop(k), dtype=np.float64)
        if got.shape != want.shape or not np.allclose(got, want, atol=1e-6):
            raise ValueError(f"{k} holds offsets {got}, expected {want}")
    module.load_state_dict(params, strict=True)
    return module

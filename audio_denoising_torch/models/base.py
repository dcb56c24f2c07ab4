"""Shared model building blocks (host-side constants)."""

from typing import List, Sequence

import numpy as np


def gaussian_smearing(num_bins: int, num_gaussians: int = 6,
                      start: float = 0.0, stop: float = 1.0) -> np.ndarray:
    """RBF embedding of the normalized bin index, (num_gaussians, num_bins)
    float32. The reference recomputes it every frame at every level
    (gruunet2.py:139-143); it depends only on the shape, so it is a
    constant here."""
    offset = np.linspace(start, stop, num_gaussians)
    coeff = -0.5 / float(offset[1] - offset[0]) ** 2
    pos = np.linspace(0.0, 1.0, num_bins)
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

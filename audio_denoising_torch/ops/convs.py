"""Convolution wrappers with PyTorch's layouts, used on the host only: by
the GRUUNet2 module and by the plan's probing (runtime/plan.py).

``transpose_output_padding`` is the output padding PyTorch infers from a
ConvTranspose's requested output size; shapes are static per config, so it
is computed once per level.
"""

import torch
import torch.nn.functional as F


def transpose_output_padding(in_size: int, out_size: int, kernel: int,
                             stride: int, padding: int, dilation: int = 1) -> int:
    """The output_padding PyTorch infers from ConvTranspose's output_size."""
    base = (in_size - 1) * stride - 2 * padding + dilation * (kernel - 1) + 1
    op = out_size - base
    if not (0 <= op < max(stride, dilation)):
        raise ValueError(
            f"requested output size {out_size} unreachable from input {in_size} "
            f"(k={kernel}, s={stride}, p={padding}, d={dilation}; base {base})")
    return op


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias=None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """x: (N, C_in, L); weight: (C_out, C_in, K) — nn.Conv1d."""
    return F.conv1d(x, weight, bias, stride=stride, padding=padding)


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor, bias=None,
                     stride: int = 1, padding: int = 0,
                     output_padding: int = 0) -> torch.Tensor:
    """x: (N, C_in, L); weight: (C_in, C_out, K) — nn.ConvTranspose1d."""
    return F.conv_transpose1d(x, weight, bias, stride=stride,
                              padding=padding, output_padding=output_padding)

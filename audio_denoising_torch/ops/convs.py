"""Convolution wrappers with PyTorch's layouts (JAX counterpart
ops/convs.py): the 1-D pair used by GRUUNet2, TRUNet (grouped, for its
depthwise convs) and the plan's probing (runtime/plan.py), and the 2-D
pair of the U-Net segment family (models/unet2d.py). JAX lowers them to
``lax.conv_general_dilated``, outside any Pallas kernel; the port calls
PyTorch's convolutions, which take TF32 on the card unless the caller
scopes them to fp32 (``pipeline.fp32_convs``).

``transpose_output_padding`` is the output padding PyTorch infers from a
ConvTranspose's requested output size; shapes are static per config, so it
is computed once per level.
"""

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

IntOrPair = Union[int, Tuple[int, ...], Sequence[int]]


def _pair(v: IntOrPair) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    t = tuple(int(x) for x in v)
    if len(t) != 2:
        raise ValueError(f"expected an int or a pair, got {v!r}")
    return t


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
           stride: int = 1, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    """x: (N, C_in, L); weight: (C_out, C_in/groups, K) — nn.Conv1d."""
    return F.conv1d(x, weight, bias, stride=stride, padding=padding,
                    groups=groups)


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor, bias=None,
                     stride: int = 1, padding: int = 0,
                     output_padding: int = 0) -> torch.Tensor:
    """x: (N, C_in, L); weight: (C_in, C_out, K) — nn.ConvTranspose1d."""
    return F.conv_transpose1d(x, weight, bias, stride=stride,
                              padding=padding, output_padding=output_padding)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None,
           stride: IntOrPair = 1, padding: IntOrPair = 0) -> torch.Tensor:
    """x: (N, C_in, H, W); weight: (C_out, C_in, KH, KW) — nn.Conv2d."""
    return F.conv2d(x, weight, bias, stride=_pair(stride),
                    padding=_pair(padding))


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, bias=None,
                     stride: IntOrPair = 1, padding: IntOrPair = 0,
                     output_padding: IntOrPair = 0) -> torch.Tensor:
    """x: (N, C_in, H, W); weight: (C_in, C_out, KH, KW) —
    nn.ConvTranspose2d."""
    return F.conv_transpose2d(x, weight, bias, stride=_pair(stride),
                              padding=_pair(padding),
                              output_padding=_pair(output_padding))

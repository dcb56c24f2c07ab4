"""GRUUNet2 — GRU gating whose gate projections are a conv U-Net
(reference gruunet2.py:202-306; JAX counterpart models/gruunet.py).

``cell.input_gate`` is a strided Conv1d encoder whose last level emits 3x
channels for the r/z/n gates, ``cell.reset_gate`` one conv on the
compressed hidden state, and ``cell.output_gate`` a ConvTranspose1d
decoder with skip concatenations. GaussianSmearing bin encodings are
concatenated at every level as precomputed buffers (kept out of the state
dict). Parameter names are the reference's state-dict keys, so the
``.npz`` checkpoints load with ``load_state_dict``.
"""

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from audio_denoising_torch.config import ModelConfig
from audio_denoising_torch.models import base
from audio_denoising_torch.ops.convs import (
    conv1d, conv_transpose1d, transpose_output_padding,
)


class _Level(nn.Module):
    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


class _Stack(nn.Module):
    def __init__(self, name: str, convs):
        super().__init__()
        setattr(self, name, nn.ModuleList(_Level(c) for c in convs))


class GRUUNet2Cell(nn.Module):
    """One frame: ``cell(x_t (B, F), hx (B, hidden, compressed)) ->
    (y_t (B, F), hx')``."""

    def __init__(self, config: ModelConfig, num_bins: int):
        super().__init__()
        c = config
        self.config = c
        L = self.levels = len(c.hidden_sizes)
        self.hidden = c.hidden_sizes[-1]
        self.compressed = c.num_compressed_bins
        gate_ch = 3 * self.hidden
        self.bin_sizes = base.down_bin_sizes(num_bins, c.kernel_sizes,
                                             c.strides, c.paddings)
        if self.bin_sizes[-1] != self.compressed:
            raise ValueError(
                f"config num_compressed_bins={self.compressed} inconsistent "
                f"with encoder output {self.bin_sizes[-1]}")
        g = c.num_gaussians

        def smear(bins):
            return torch.from_numpy(base.gaussian_smearing(bins, g))

        for i, b in enumerate(self.bin_sizes[:-1]):
            self.register_buffer(f"smear_down{i}", smear(b), persistent=False)
        self.register_buffer("smear_hx", smear(self.compressed),
                             persistent=False)
        for i in range(L):
            self.register_buffer(f"smear_up{i}", smear(self.bin_sizes[L - i]),
                                 persistent=False)
        # decoder level i upsamples bin_sizes[L-i] -> bin_sizes[L-1-i]
        self.up_output_paddings = [
            transpose_output_padding(
                self.bin_sizes[L - i], self.bin_sizes[L - 1 - i],
                c.kernel_sizes[::-1][i], c.strides[::-1][i],
                c.paddings[::-1][i])
            for i in range(L)]

        sizes = [c.in_size] + list(c.hidden_sizes[:-1]) + [gate_ch]
        self.input_gate = _Stack("downs", [
            nn.Conv1d(sizes[i] + g, sizes[i + 1], c.kernel_sizes[i])
            for i in range(L)])
        self.reset_gate = _Stack("downs", [
            nn.Conv1d(self.hidden + g, gate_ch, 3)])
        rev = ([1] + list(c.hidden_sizes))[::-1]
        self.output_gate = _Stack("ups", [
            nn.ConvTranspose1d((rev[i] if i == 0 else 2 * rev[i]) + g,
                               rev[i + 1], c.kernel_sizes[::-1][i])
            for i in range(L)])

    def _smear(self, name: str, like: torch.Tensor) -> torch.Tensor:
        s = getattr(self, name).to(like.dtype)
        return s[None].expand(like.shape[0], -1, -1)

    def forward(self, x_t: torch.Tensor, hx: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.config
        L = self.levels
        skips = [x_t[:, None, :]]
        for i in range(L):
            conv = self.input_gate.downs[i].conv
            inp = torch.cat([skips[-1], self._smear(f"smear_down{i}", x_t)],
                            dim=1)
            skips.append(torch.relu(conv1d(inp, conv.weight, conv.bias,
                                           stride=c.strides[i],
                                           padding=c.paddings[i])))
        gate_x = skips[-1]                   # (B, 3*hidden, compressed)
        conv = self.reset_gate.downs[0].conv
        gate_h = torch.relu(conv1d(
            torch.cat([hx, self._smear("smear_hx", hx)], dim=1),
            conv.weight, conv.bias, stride=1, padding=1))

        i_r, i_i, i_n = torch.chunk(gate_x, 3, dim=1)
        h_r, h_i, h_n = torch.chunk(gate_h, 3, dim=1)
        inputgate = torch.sigmoid(i_i + h_i)
        resetgate = torch.sigmoid(i_r + h_r)
        newgate = torch.tanh(i_n + resetgate * h_n)
        hi = newgate + inputgate * (hx - newgate)

        # decoder skips: [x, d1, ..., d_{L-1}]; x itself is never consumed
        ups_in = skips[:-1]
        h = hi
        for i in range(L):
            conv = self.output_gate.ups[i].conv
            informed = torch.cat([h, self._smear(f"smear_up{i}", h)], dim=1)
            h = conv_transpose1d(
                informed, conv.weight, conv.bias,
                stride=c.strides[::-1][i], padding=c.paddings[::-1][i],
                output_padding=self.up_output_paddings[i])
            if i != L - 1:
                h = torch.cat([torch.relu(h), ups_in[L - 1 - i]], dim=1)
        return h[:, 0, :], hi


class GRUUNet2(nn.Module):
    """``model.cell`` is one frame; ``model.apply`` runs it over time."""

    def __init__(self, config: ModelConfig, num_bins: int = 64):
        super().__init__()
        if config.in_size != 1:
            raise ValueError("GRUUNet2 takes in_size == 1")
        self.config = config
        self.num_bins = num_bins
        self.cell = GRUUNet2Cell(config, num_bins)

    def load_params(self, params: Mapping[str, torch.Tensor]) -> "GRUUNet2":
        """Load a reference state dict (``base.load_reference_params``)."""
        return base.load_reference_params(self, params,
                                          self.config.num_gaussians)

    def init_state(self, batch: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
        return torch.zeros((batch, self.cell.hidden, self.cell.compressed),
                           dtype=dtype, device=device)

    def apply(self, x: torch.Tensor, hx: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, T, F) or (T, F) -> (residual prediction, hx')."""
        squeezed = x.dim() == 2
        if squeezed:
            x = x[None]
        if hx is None:
            hx = self.init_state(x.shape[0], x.dtype, x.device)
        ys = []
        for t in range(x.shape[1]):
            y, hx = self.cell(x[:, t], hx)
            ys.append(y)
        y = torch.stack(ys, dim=1)
        return (y[0] if squeezed else y), hx

    def forward(self, x, hx=None):
        return self.apply(x, hx)

"""The MOMO family, the recurrent-U-Net lineage before GRUUNet2 (JAX
counterpart models/momo.py; reference momo.py, momo2.py, momo3.py).

- MOMO3: a compressed-latent GRU whose gate projections are a conv U-Net
  (the design GRUUNet2 reuses), with the GaussianSmearing channels
  concatenated once at the input and a first-order delta feature: the
  cell's input is ``cat([x_t, x_t - prev])``, so its carry is
  ``(hx, prev)``.
- MOMO2: MOMO3 without the delta; its carry is hx.
- MOMO (v1): the hidden state is a full-resolution frame; two whole
  U-Nets emit 3-channel gate maps over it and a third reads the updated
  state.

Parameter names are the reference's state-dict keys, so the ``.npz``
checkpoints load with ``load_params``. The shipped checkpoint is
MOMO3-4d4ea0 (22 bins -> 3, hidden 16).
"""

from typing import Mapping, Optional, Tuple, Union

import torch
from torch import nn

from audio_denoising_torch.config import ModelConfig
from audio_denoising_torch.models import base
from audio_denoising_torch.models.gruunet import _Stack
from audio_denoising_torch.ops.convs import (
    conv1d, conv_transpose1d, transpose_output_padding,
)

Carry = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _output_paddings(c: ModelConfig, sizes):
    """Decoder level i upsamples sizes[L-i] -> sizes[L-1-i]."""
    L = len(c.hidden_sizes)
    return [transpose_output_padding(
        sizes[L - i], sizes[L - 1 - i], c.kernel_sizes[::-1][i],
        c.strides[::-1][i], c.paddings[::-1][i]) for i in range(L)]


def _smear(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.to(like.dtype)[None].expand(like.shape[0], -1, -1)


class MomoCell(nn.Module):
    """One frame of MOMO3 (``delta=True``) or MOMO2: ``cell(x_t (B, F),
    carry) -> (y_t (B, F), carry')``."""

    def __init__(self, config: ModelConfig, num_bins: int, delta: bool):
        super().__init__()
        c = config
        self.config = c
        self.delta = delta
        L = self.levels = len(c.hidden_sizes)
        self.hidden = c.hidden_sizes[-1]
        self.compressed = c.num_compressed_bins
        self.bin_sizes = base.down_bin_sizes(num_bins, c.kernel_sizes,
                                             c.strides, c.paddings)
        if self.bin_sizes[-1] != self.compressed:
            raise ValueError(
                f"config num_compressed_bins={self.compressed} inconsistent "
                f"with encoder output {self.bin_sizes[-1]}")
        g = c.num_gaussians
        self.register_buffer("smear_in", torch.from_numpy(
            base.gaussian_smearing(num_bins, g)), persistent=False)
        self.register_buffer("smear_hx", torch.from_numpy(
            base.gaussian_smearing(self.compressed, g)), persistent=False)
        self.up_output_paddings = _output_paddings(c, self.bin_sizes)

        gate_ch = 3 * self.hidden
        in_ch = c.in_size + (1 if delta else 0)
        sizes = [in_ch + g] + list(c.hidden_sizes[:-1]) + [gate_ch]
        self.input_gate = _Stack("downs", [
            nn.Conv1d(sizes[i], sizes[i + 1], c.kernel_sizes[i])
            for i in range(L)])
        self.reset_gate = _Stack("downs", [
            nn.Conv1d(self.hidden + g, gate_ch, 3)])
        rev = ([1] + list(c.hidden_sizes))[::-1]
        self.output_gate = _Stack("ups", [
            nn.ConvTranspose1d(rev[i] if i == 0 else 2 * rev[i], rev[i + 1],
                               c.kernel_sizes[::-1][i])
            for i in range(L)])

    def forward(self, x_t: torch.Tensor, carry: Carry
                ) -> Tuple[torch.Tensor, Carry]:
        c = self.config
        L = self.levels
        if self.delta:
            hx, prev = carry
            xin = torch.stack([x_t, x_t - prev], dim=1)    # (B, 2, F)
        else:
            hx = carry
            xin = x_t[:, None, :]
        skips = [torch.cat([xin, _smear(self.smear_in, x_t)], dim=1)]
        for i in range(L):
            conv = self.input_gate.downs[i].conv
            skips.append(torch.relu(conv1d(
                skips[-1], conv.weight, conv.bias, stride=c.strides[i],
                padding=c.paddings[i])))
        conv = self.reset_gate.downs[0].conv
        gate_h = torch.relu(conv1d(
            torch.cat([hx, _smear(self.smear_hx, hx)], dim=1),
            conv.weight, conv.bias, stride=1, padding=1))

        i_r, i_i, i_n = torch.chunk(skips[-1], 3, dim=1)
        h_r, h_i, h_n = torch.chunk(gate_h, 3, dim=1)
        inputgate = torch.sigmoid(i_i + h_i)
        resetgate = torch.sigmoid(i_r + h_r)
        newgate = torch.tanh(i_n + resetgate * h_n)
        hi = newgate + inputgate * (hx - newgate)

        # decoder skips: [input, d1, ..., d_{L-1}]; the input is never used
        h = hi
        for i in range(L):
            conv = self.output_gate.ups[i].conv
            h = conv_transpose1d(
                h, conv.weight, conv.bias, stride=c.strides[::-1][i],
                padding=c.paddings[::-1][i],
                output_padding=self.up_output_paddings[i])
            if i != L - 1:
                h = torch.cat([torch.relu(h), skips[L - 1 - i]], dim=1)
        return h[:, 0, :], ((hi, x_t) if self.delta else hi)


class MOMO3(nn.Module):
    """MOMO3, and MOMO2 with ``delta=False``. ``model.cell`` is one frame
    on the full carry; ``model.apply`` runs it over time."""

    def __init__(self, config: ModelConfig, num_bins: int = 22,
                 delta: bool = True):
        super().__init__()
        self.config = config
        self.num_bins = num_bins
        self.delta = delta
        self.cell = MomoCell(config, num_bins, delta)

    def load_params(self, params: Mapping[str, torch.Tensor]) -> "MOMO3":
        return base.load_reference_params(self, params,
                                          self.config.num_gaussians)

    def init_state(self, batch: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
        return torch.zeros((batch, self.cell.hidden, self.cell.compressed),
                           dtype=dtype, device=device)

    def init_carry(self, batch: int, dtype=torch.float32,
                   device=None) -> Carry:
        """The streaming carry: (hx, prev) for MOMO3, prev zeros (the
        analysis ring also starts at zeros, so the first hop's delta
        differs from ``apply``'s prev_0 = x_0 only by that hop's
        feature)."""
        hx = self.init_state(batch, dtype, device)
        if self.delta:
            return hx, torch.zeros((batch, self.num_bins), dtype=dtype,
                                   device=device)
        return hx

    def decay_carry(self, carry: Carry, factor: float) -> Carry:
        """The state decay applies to hx only: prev is the previous input
        frame, not decaying state."""
        if self.delta:
            hx, prev = carry
            return hx * factor, prev
        return carry * factor

    def apply(self, x: torch.Tensor, hx: Optional[torch.Tensor] = None,
              prev: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, T, F) or (T, F) -> (residual prediction, hx'). MOMO3's
        prev defaults to the first frame (a zero delta at t = 0)."""
        squeezed = x.dim() == 2
        if squeezed:
            x = x[None]
        if hx is None:
            hx = self.init_state(x.shape[0], x.dtype, x.device)
        carry = (hx, x[:, 0] if prev is None else prev) if self.delta else hx
        ys = []
        for t in range(x.shape[1]):
            y, carry = self.cell(x[:, t], carry)
            ys.append(y)
        y = torch.stack(ys, dim=1)
        return (y[0] if squeezed else y), (carry[0] if self.delta else carry)

    def forward(self, x, hx=None, prev=None):
        return self.apply(x, hx, prev)


class MOMO2(MOMO3):
    def __init__(self, config: ModelConfig, num_bins: int = 22):
        super().__init__(config, num_bins=num_bins, delta=False)


class _UNet(nn.Module):
    """One of MOMO v1's whole U-Nets: ``downs`` and ``ups`` as in the
    reference's state dict."""

    def __init__(self, c: ModelConfig, out_ch: int):
        super().__init__()
        L = len(c.hidden_sizes)
        sizes = [c.in_size + c.num_gaussians] + list(c.hidden_sizes)
        rev = sizes[::-1]
        self.downs = _Stack("downs", [
            nn.Conv1d(sizes[i], sizes[i + 1], c.kernel_sizes[i])
            for i in range(L)]).downs
        self.ups = _Stack("ups", [
            nn.ConvTranspose1d(rev[i] if i == 0 else 2 * rev[i],
                               out_ch if i == L - 1 else rev[i + 1],
                               c.kernel_sizes[::-1][i])
            for i in range(L)]).ups


class MOMO(nn.Module):
    """MOMO v1: full-resolution state (B, F); ``cell.input_gate`` and
    ``cell.reset_gate`` emit 3-channel gate maps, ``output_gate`` reads
    the updated state. The reference keeps ``output_gate`` outside the
    cell's state dict, so the submodule ``cell`` holds only the two gate
    U-Nets and ``model.cell`` is the one-frame step
    (``cell_step``), as the zoo's other models have it."""

    def __init__(self, config: ModelConfig, num_bins: int = 22):
        super().__init__()
        if config.in_size != 1:
            raise ValueError("MOMO takes in_size == 1")
        c = self.config = config
        self.num_bins = num_bins
        self.levels = len(c.hidden_sizes)
        self.bin_sizes = base.down_bin_sizes(num_bins, c.kernel_sizes,
                                             c.strides, c.paddings)
        self.up_output_paddings = _output_paddings(c, self.bin_sizes)
        self.register_buffer("smear_in", torch.from_numpy(
            base.gaussian_smearing(num_bins, c.num_gaussians)),
            persistent=False)
        gates = nn.Module()
        gates.input_gate = _UNet(c, 3)
        gates.reset_gate = _UNet(c, 3)
        self._modules["cell"] = gates     # the property below shadows it
        self.output_gate = _UNet(c, c.in_size)

    def load_params(self, params: Mapping[str, torch.Tensor]) -> "MOMO":
        return base.load_reference_params(self, params,
                                          self.config.num_gaussians)

    @property
    def cell(self):
        return self.cell_step

    def _unet(self, net: _UNet, x: torch.Tensor) -> torch.Tensor:
        """x: (B, F) -> (B, out_ch, F)."""
        c = self.config
        L = self.levels
        skips = [torch.cat([x[:, None, :], _smear(self.smear_in, x)], dim=1)]
        for i in range(L):
            conv = net.downs[i].conv
            skips.append(torch.relu(conv1d(
                skips[-1], conv.weight, conv.bias, stride=c.strides[i],
                padding=c.paddings[i])))
        h = skips[-1]
        for i in range(L):
            conv = net.ups[i].conv
            h = conv_transpose1d(
                h, conv.weight, conv.bias, stride=c.strides[::-1][i],
                padding=c.paddings[::-1][i],
                output_padding=self.up_output_paddings[i])
            if i != L - 1:
                h = torch.cat([torch.relu(h), skips[L - 1 - i]], dim=1)
        return h

    def cell_step(self, x_t: torch.Tensor, hx: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        gates = self._modules["cell"]
        gate_x = self._unet(gates.input_gate, x_t)         # (B, 3, F)
        gate_h = self._unet(gates.reset_gate, hx)          # (B, 3, F)
        inputgate = torch.sigmoid(gate_x[:, 1] + gate_h[:, 1])
        resetgate = torch.sigmoid(gate_x[:, 0] + gate_h[:, 0])
        newgate = torch.tanh(gate_x[:, 2] + resetgate * gate_h[:, 2])
        hy = newgate + inputgate * (hx - newgate)
        return self._unet(self.output_gate, hy)[:, 0, :], hy

    def init_state(self, batch: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
        return torch.zeros((batch, self.num_bins), dtype=dtype,
                           device=device)

    def apply(self, x: torch.Tensor, hx: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        squeezed = x.dim() == 2
        if squeezed:
            x = x[None]
        if hx is None:
            hx = self.init_state(x.shape[0], x.dtype, x.device)
        ys = []
        for t in range(x.shape[1]):
            y, hx = self.cell_step(x[:, t], hx)
            ys.append(y)
        y = torch.stack(ys, dim=1)
        return (y[0] if squeezed else y), hx

    def forward(self, x, hx=None):
        return self.apply(x, hx)

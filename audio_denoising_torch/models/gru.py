"""A GRU with torch's parameter names and gate order (JAX counterpart
models/gru.py): gates r, z, n; h' = (1 - z) * n + z * h, so ``nn.GRU``
weights load unchanged. JAX runs it as a ``lax.scan`` of two matmuls a
step; here each layer takes its input projections for every step in one
matmul and loops over the steps for the hidden ones, on the device, with
no host round trip. Used alone (``models.GRU``) and by TRUNet's FGRU and
TGRU blocks.
"""

import math
from typing import Optional, Tuple

import torch
from torch import nn


def gru_cell(gx: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor,
             b_hh: torch.Tensor) -> torch.Tensor:
    """One step: gx (B, 3H) the step's input projection ``x_t @ w_ih.T +
    b_ih`` (JAX's gru_cell computes it inside), h (B, H); w_hh in torch's
    layout (3H, H)."""
    gh = h @ w_hh.T + b_hh
    i_r, i_z, i_n = gx.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return n + z * (h - n)


def gru_layer(x: torch.Tensor, h0: torch.Tensor, w_ih, b_ih, w_hh, b_hh,
              reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, I) -> (outputs (B, T, H), h_T (B, H)); ``reverse`` runs
    the steps from the last to the first, outputs in input order."""
    gx = x @ w_ih.T + b_ih                                   # (B, T, 3H)
    steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    h, ys = h0, [None] * x.shape[1]
    for t in steps:
        h = ys[t] = gru_cell(gx[:, t], h, w_hh, b_hh)
    return torch.stack(ys, dim=1), h


class GRU(nn.Module):
    """Multi-layer, optionally bidirectional GRU with torch's parameter
    names (``weight_ih_l{k}``, ``weight_hh_l{k}``, the biases, the
    ``_reverse`` suffix)."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bidirectional: bool = False):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.num_directions = 2 if bidirectional else 1
        h = hidden_size
        bound = 1.0 / math.sqrt(h)         # nn.GRU's default init
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else h * self.num_directions
            for sfx in ("", "_reverse")[:self.num_directions]:
                for name, shape in (("weight_ih", (3 * h, in_sz)),
                                    ("weight_hh", (3 * h, h)),
                                    ("bias_ih", (3 * h,)),
                                    ("bias_hh", (3 * h,))):
                    self.register_parameter(
                        f"{name}_l{layer}{sfx}", nn.Parameter(
                            torch.empty(shape).uniform_(-bound, bound)))

    def _weights(self, layer: int, sfx: str):
        return tuple(getattr(self, f"{n}_l{layer}{sfx}")
                     for n in ("weight_ih", "bias_ih", "weight_hh",
                               "bias_hh"))

    def apply(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, T, I); h0: (num_layers * num_directions, B, H) ->
        (outputs (B, T, H * num_directions), h_T of every layer and
        direction)."""
        nd = self.num_directions
        if h0 is None:
            h0 = x.new_zeros((self.num_layers * nd, x.shape[0],
                              self.hidden_size))
        finals, out = [], x
        for layer in range(self.num_layers):
            ys, h_t = gru_layer(out, h0[layer * nd], *self._weights(layer, ""))
            finals.append(h_t)
            if self.bidirectional:
                ys_r, h_r = gru_layer(out, h0[layer * nd + 1],
                                      *self._weights(layer, "_reverse"),
                                      reverse=True)
                ys = torch.cat([ys, ys_r], dim=-1)
                finals.append(h_r)
            out = ys
        return out, torch.stack(finals, dim=0)

    def forward(self, x, h0=None):
        return self.apply(x, h0)

"""Matrixized serving plan for GRUUNet-family cells (JAX counterpart
runtime/plan.py:31-275).

Serving weights are static, so the whole cell is compiled once per
checkpoint into an affine plan:

- every conv level (weights + bias + the constant GaussianSmearing
  channels) is an affine map on the flattened (C*L) activation vector;
  the dense matrix is recovered by probing the conv ops with a basis
  batch, which keeps padding, strides and output_padding exact;
- decoder skip-concats become split matmuls:
  ``conv_T(cat(h, skip)) = h @ U_h + skip @ U_s + c``.

Probing runs on the CPU in float64 and the plan is cast to float32
afterwards, so no TF32 convolution (cuDNN's default on the card) can leak
into the plan matrices.
"""

import copy
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from audio_denoising_torch.ops.convs import conv1d, conv_transpose1d


class CellPlan(NamedTuple):
    down_mats: Tuple[torch.Tensor, ...]    # [i]: (n_in_i, n_out_i)
    down_biases: Tuple[torch.Tensor, ...]
    reset_mat: torch.Tensor                # (hidden*comp, 3*hidden*comp)
    reset_bias: torch.Tensor
    up_h_mats: Tuple[torch.Tensor, ...]    # [i]: (n_h_i, n_out_i)
    up_s_mats: Tuple[Optional[torch.Tensor], ...]  # skip part (None for i=0)
    up_biases: Tuple[torch.Tensor, ...]
    hidden: int
    compressed: int
    delta: bool = False

    def to(self, device=None, dtype=None) -> "CellPlan":
        def mv(t):
            return None if t is None else t.to(device=device, dtype=dtype)
        return CellPlan(
            tuple(map(mv, self.down_mats)), tuple(map(mv, self.down_biases)),
            mv(self.reset_mat), mv(self.reset_bias),
            tuple(map(mv, self.up_h_mats)), tuple(map(mv, self.up_s_mats)),
            tuple(map(mv, self.up_biases)), self.hidden, self.compressed,
            self.delta)


def _probe_affine(fn: Callable[[torch.Tensor], torch.Tensor], n_in: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fn maps (B, n_in) -> (B, n_out) affinely; recover (matrix, bias)
    from a zero row and the identity, in float64."""
    eye = torch.cat([torch.zeros(1, n_in, dtype=torch.float64),
                     torch.eye(n_in, dtype=torch.float64)], dim=0)
    with torch.no_grad():
        out = fn(eye)
    bias = out[0]
    return out[1:] - bias[None, :], bias


def build_cell_plan(model) -> CellPlan:
    """Compile a GRUUNet2 model into a float32 CellPlan on the CPU."""
    cell = copy.deepcopy(model.cell).to("cpu", torch.float64)
    c = model.config
    L = cell.levels
    sizes = cell.bin_sizes
    chans = [1] + list(c.hidden_sizes[:-1]) + [3 * cell.hidden]

    def smear(name, b):
        s = getattr(cell, name)
        return s[None].expand(b, -1, -1)

    down_mats, down_biases = [], []
    for i in range(L):
        conv = cell.input_gate.downs[i].conv

        def g(v, i=i, C_in=chans[i], L_in=sizes[i], conv=conv):
            x = v.reshape(v.shape[0], C_in, L_in)
            out = conv1d(torch.cat([x, smear(f"smear_down{i}", v.shape[0])],
                                   dim=1),
                         conv.weight, conv.bias,
                         stride=c.strides[i], padding=c.paddings[i])
            return out.reshape(v.shape[0], -1)

        m, b = _probe_affine(g, chans[i] * sizes[i])
        down_mats.append(m)
        down_biases.append(b)

    comp, hidden = cell.compressed, cell.hidden
    rconv = cell.reset_gate.downs[0].conv

    def g_reset(v):
        hx = v.reshape(v.shape[0], hidden, comp)
        out = conv1d(torch.cat([hx, smear("smear_hx", v.shape[0])], dim=1),
                     rconv.weight, rconv.bias, stride=1, padding=1)
        return out.reshape(v.shape[0], -1)

    reset_mat, reset_bias = _probe_affine(g_reset, hidden * comp)

    up_h_mats, up_s_mats, up_biases = [], [], []
    rev = ([1] + list(c.hidden_sizes))[::-1]
    for i in range(L):
        C_h = rev[i]                             # conv-input h channels
        C_s = 0 if i == 0 else rev[i]            # concatenated skip channels
        L_in = sizes[L - i]
        n_h, n_s = C_h * L_in, C_s * L_in
        conv = cell.output_gate.ups[i].conv

        def g(v, i=i, C=C_h + C_s, L_in=L_in, conv=conv):
            x = v.reshape(v.shape[0], C, L_in)
            out = conv_transpose1d(
                torch.cat([x, smear(f"smear_up{i}", v.shape[0])], dim=1),
                conv.weight, conv.bias,
                stride=c.strides[::-1][i], padding=c.paddings[::-1][i],
                output_padding=cell.up_output_paddings[i])
            return out.reshape(v.shape[0], -1)

        m, b = _probe_affine(g, n_h + n_s)
        up_h_mats.append(m[:n_h])
        up_s_mats.append(m[n_h:] if n_s else None)
        up_biases.append(b)

    plan = CellPlan(
        down_mats=tuple(down_mats), down_biases=tuple(down_biases),
        reset_mat=reset_mat, reset_bias=reset_bias,
        up_h_mats=tuple(up_h_mats), up_s_mats=tuple(up_s_mats),
        up_biases=tuple(up_biases), hidden=hidden, compressed=comp)
    return plan.to(dtype=torch.float32)


def plan_from_numpy(plan) -> CellPlan:
    """The JAX package's CellPlan (any object with its fields, leaves
    convertible by ``np.asarray``) as the port's float32 CellPlan, so
    tests can feed both hops the identical plan."""
    def t(a):
        return None if a is None else torch.from_numpy(
            np.array(a, dtype=np.float32))
    return CellPlan(
        down_mats=tuple(map(t, plan.down_mats)),
        down_biases=tuple(map(t, plan.down_biases)),
        reset_mat=t(plan.reset_mat), reset_bias=t(plan.reset_bias),
        up_h_mats=tuple(map(t, plan.up_h_mats)),
        up_s_mats=tuple(map(t, plan.up_s_mats)),
        up_biases=tuple(map(t, plan.up_biases)),
        hidden=int(plan.hidden), compressed=int(plan.compressed),
        delta=bool(plan.delta))


def plan_cell(plan: CellPlan, x_t: torch.Tensor, hx: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame through the plan. x_t: (B, F); hx: (B, hidden*comp)
    flattened. Returns (y (B, F), hx')."""
    if plan.delta:
        raise NotImplementedError("delta (MOMO3) plans are a later slice")
    L = len(plan.down_mats)
    skips = [x_t]
    h = x_t
    for m, b in zip(plan.down_mats, plan.down_biases):
        h = torch.relu(h @ m + b)
        skips.append(h)

    gate_x = h                                        # (B, 3*hidden*comp)
    gate_h = torch.relu(hx @ plan.reset_mat + plan.reset_bias)
    n = plan.hidden * plan.compressed
    i_r, i_i, i_n = gate_x[:, :n], gate_x[:, n:2 * n], gate_x[:, 2 * n:]
    h_r, h_i, h_n = gate_h[:, :n], gate_h[:, n:2 * n], gate_h[:, 2 * n:]
    inputgate = torch.sigmoid(i_i + h_i)
    resetgate = torch.sigmoid(i_r + h_r)
    newgate = torch.tanh(i_n + resetgate * h_n)
    hi = newgate + inputgate * (hx - newgate)

    ups_in = skips[:-1]                               # [x, d1, ..., d_{L-1}]
    h = hi
    for i in range(L):
        out = h @ plan.up_h_mats[i] + plan.up_biases[i]
        if plan.up_s_mats[i] is not None:
            out = out + ups_in[L - i] @ plan.up_s_mats[i]
        h = torch.relu(out) if i != L - 1 else out
    return h, hi

"""Matrixized serving plan for the GRUUNet and MOMO families' cells (JAX
counterpart runtime/plan.py:31-338).

Serving weights are static, so the whole cell is compiled once per
checkpoint into an affine plan:

- every conv level (weights + bias + the constant GaussianSmearing
  channels) is an affine map on the flattened (C*L) activation vector;
  the dense matrix is recovered by probing the conv ops with a basis
  batch, which keeps padding, strides and output_padding exact;
- decoder skip-concats become split matmuls:
  ``conv_T(cat(h, skip)) = h @ U_h + skip @ U_s + c``;
- MOMO2/MOMO3 smear once at the input, and MOMO3's level 0 reads
  ``stack([x_t, x_t - prev])``: affine in ``(x_t, prev)`` jointly, so its
  matrix takes the 2F vector ``cat(x_t, prev)`` (``CellPlan.delta``).

Probing runs on the CPU in float64 and the plan is cast to float32
afterwards, so no TF32 convolution (cuDNN's default on the card) can leak
into the plan matrices. Training builds the plan inside each step instead
(``trainable=True``, JAX train/context.py:101-116): the same probes on
the model's own parameters, in their dtype and on their device, with
autograd on, so the gradient flows through the dense plan back to the
conv weights.

``PlanModel`` (JAX counterpart plan.py:341-455) serves the plan through
the zoo models' interface, one frame at a time through the cell (the
hand-written kernel of ``ops/kernels/fused_cell.py`` with ``fused=True``,
or the W8A8 plan of ``runtime/quant.py`` with ``quantized=True``) and
sequences through ``plan_apply_parallel`` (``plan_apply_parallel_q``).
"""

import copy
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from audio_denoising_torch.device import resolve_device
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
    # MOMO3: down_mats[0] has 2F rows and reads cat(x_t, prev)
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


def _probe_affine(fn: Callable[[torch.Tensor], torch.Tensor], n_in: int,
                  like: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fn maps (B, n_in) -> (B, n_out) affinely; recover (matrix, bias)
    from a zero row and the identity: in float64 under no_grad, or, given
    a parameter ``like``, in its dtype and on its device with autograd
    on."""
    dtype = torch.float64 if like is None else like.dtype
    device = None if like is None else like.device
    eye = torch.cat([torch.zeros(1, n_in, dtype=dtype, device=device),
                     torch.eye(n_in, dtype=dtype, device=device)], dim=0)
    with torch.set_grad_enabled(like is not None):
        out = fn(eye)
    bias = out[0]
    return out[1:] - bias[None, :], bias


def _probe_cell(model, trainable: bool):
    """(the cell the probes read, the probes' ``like``): a float64 copy
    on the CPU for serving, the model's own cell for training."""
    if trainable:
        return model.cell, next(model.cell.parameters())
    return copy.deepcopy(model.cell).to("cpu", torch.float64), None


def build_cell_plan(model, trainable: bool = False) -> CellPlan:
    """Compile a GRUUNet2, MOMO2 or MOMO3 model into a float32 CellPlan on
    the CPU (``build_cell_plan_momo`` for the MOMO family); with
    ``trainable``, a plan in the parameters' dtype and on their device
    that carries the autograd graph back to them."""
    from audio_denoising_torch.models.momo import MOMO, MOMO3
    if isinstance(model, MOMO3):
        return build_cell_plan_momo(model, trainable)
    if isinstance(model, MOMO):
        raise ValueError(
            "MOMO v1 keeps a full-resolution state and has no plan; serve "
            "its zoo model in mode 'fast'")
    cell, like = _probe_cell(model, trainable)
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

        m, b = _probe_affine(g, chans[i] * sizes[i], like)
        down_mats.append(m)
        down_biases.append(b)

    comp, hidden = cell.compressed, cell.hidden
    rconv = cell.reset_gate.downs[0].conv

    def g_reset(v):
        hx = v.reshape(v.shape[0], hidden, comp)
        out = conv1d(torch.cat([hx, smear("smear_hx", v.shape[0])], dim=1),
                     rconv.weight, rconv.bias, stride=1, padding=1)
        return out.reshape(v.shape[0], -1)

    reset_mat, reset_bias = _probe_affine(g_reset, hidden * comp, like)

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

        m, b = _probe_affine(g, n_h + n_s, like)
        up_h_mats.append(m[:n_h])
        up_s_mats.append(m[n_h:] if n_s else None)
        up_biases.append(b)

    plan = CellPlan(
        down_mats=tuple(down_mats), down_biases=tuple(down_biases),
        reset_mat=reset_mat, reset_bias=reset_bias,
        up_h_mats=tuple(up_h_mats), up_s_mats=tuple(up_s_mats),
        up_biases=tuple(up_biases), hidden=hidden, compressed=comp)
    return plan if trainable else plan.to(dtype=torch.float32)


def build_cell_plan_momo(model, trainable: bool = False) -> CellPlan:
    """Compile a MOMO2/MOMO3 model into a float32 CellPlan on the CPU (JAX
    counterpart plan.py:141-234): GRUUNet2's topology, smeared once at the
    input and with no smear on the decoder; MOMO3's level 0 takes the 2F
    vector cat(x_t, prev). ``trainable`` as in ``build_cell_plan``."""
    cell, like = _probe_cell(model, trainable)
    c = model.config
    L = cell.levels
    sizes = cell.bin_sizes
    F = model.num_bins

    def smear(s, b):
        return s[None].expand(b, -1, -1)

    def g0(v):
        if cell.delta:
            x, prev = v[:, :F], v[:, F:]
            xin = torch.stack([x, x - prev], dim=1)
        else:
            xin = v[:, None, :]
        conv = cell.input_gate.downs[0].conv
        out = conv1d(torch.cat([xin, smear(cell.smear_in, v.shape[0])],
                               dim=1),
                     conv.weight, conv.bias, stride=c.strides[0],
                     padding=c.paddings[0])
        return out.reshape(v.shape[0], -1)

    m, b = _probe_affine(g0, 2 * F if cell.delta else F, like)
    down_mats, down_biases = [m], [b]
    chans = list(c.hidden_sizes[:-1]) + [3 * cell.hidden]
    for i in range(1, L):
        conv = cell.input_gate.downs[i].conv

        def g(v, i=i, C_in=chans[i - 1], L_in=sizes[i], conv=conv):
            out = conv1d(v.reshape(v.shape[0], C_in, L_in), conv.weight,
                         conv.bias, stride=c.strides[i],
                         padding=c.paddings[i])
            return out.reshape(v.shape[0], -1)

        m, b = _probe_affine(g, chans[i - 1] * sizes[i], like)
        down_mats.append(m)
        down_biases.append(b)

    comp, hidden = cell.compressed, cell.hidden
    rconv = cell.reset_gate.downs[0].conv

    def g_reset(v):
        hx = v.reshape(v.shape[0], hidden, comp)
        out = conv1d(torch.cat([hx, smear(cell.smear_hx, v.shape[0])],
                               dim=1),
                     rconv.weight, rconv.bias, stride=1, padding=1)
        return out.reshape(v.shape[0], -1)

    reset_mat, reset_bias = _probe_affine(g_reset, hidden * comp, like)

    up_h_mats, up_s_mats, up_biases = [], [], []
    rev = ([1] + list(c.hidden_sizes))[::-1]
    for i in range(L):
        C_h, C_s, L_in = rev[i], 0 if i == 0 else rev[i], sizes[L - i]
        n_h, n_s = C_h * L_in, C_s * L_in
        conv = cell.output_gate.ups[i].conv

        def g(v, i=i, C=C_h + C_s, L_in=L_in, conv=conv):
            out = conv_transpose1d(
                v.reshape(v.shape[0], C, L_in), conv.weight, conv.bias,
                stride=c.strides[::-1][i], padding=c.paddings[::-1][i],
                output_padding=cell.up_output_paddings[i])
            return out.reshape(v.shape[0], -1)

        m, b = _probe_affine(g, n_h + n_s, like)
        up_h_mats.append(m[:n_h])
        up_s_mats.append(m[n_h:] if n_s else None)
        up_biases.append(b)

    plan = CellPlan(
        down_mats=tuple(down_mats), down_biases=tuple(down_biases),
        reset_mat=reset_mat, reset_bias=reset_bias,
        up_h_mats=tuple(up_h_mats), up_s_mats=tuple(up_s_mats),
        up_biases=tuple(up_biases), hidden=hidden, compressed=comp,
        delta=cell.delta)
    return plan if trainable else plan.to(dtype=torch.float32)


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


def _encode(plan: CellPlan, x: torch.Tensor) -> List[torch.Tensor]:
    """The encoder chain over rows of x: [x, d1, ..., d_L]; d_L is the
    gates' input projection (B, 3*hidden*comp)."""
    skips = [x]
    for m, b in zip(plan.down_mats, plan.down_biases):
        skips.append(torch.relu(skips[-1] @ m + b))
    return skips


def gru_update(n: int, gate_x: torch.Tensor, gate_h: torch.Tensor,
               hx: torch.Tensor) -> torch.Tensor:
    """The GRU gating hx' = n + z (hx - n) from the input and reset-gate
    projections (B, 3n); fp32 in every compute dtype."""
    i_r, i_i, i_n = gate_x[:, :n], gate_x[:, n:2 * n], gate_x[:, 2 * n:]
    h_r, h_i, h_n = gate_h[:, :n], gate_h[:, n:2 * n], gate_h[:, 2 * n:]
    inputgate = torch.sigmoid(i_i + h_i)
    resetgate = torch.sigmoid(i_r + h_r)
    newgate = torch.tanh(i_n + resetgate * h_n)
    return newgate + inputgate * (hx - newgate)


def _gate(plan: CellPlan, gate_x: torch.Tensor, hx: torch.Tensor
          ) -> torch.Tensor:
    """The reset-gate matmul on hx and the GRU gating."""
    gate_h = torch.relu(hx @ plan.reset_mat + plan.reset_bias)
    return gru_update(plan.hidden * plan.compressed, gate_x, gate_h, hx)


def _decode(plan: CellPlan, h: torch.Tensor, skips: List[torch.Tensor]
            ) -> torch.Tensor:
    """The decoder chain from hx' with split skip matmuls: no concat."""
    L = len(plan.up_h_mats)
    for i in range(L):
        out = h @ plan.up_h_mats[i] + plan.up_biases[i]
        if plan.up_s_mats[i] is not None:
            out = out + skips[L - i] @ plan.up_s_mats[i]
        h = torch.relu(out) if i != L - 1 else out
    return h


def _level0_input(plan: CellPlan, x: torch.Tensor,
                  prev: Optional[torch.Tensor]) -> torch.Tensor:
    """What level 0 reads: x, or cat(x, prev) for a delta plan."""
    if not plan.delta:
        return x
    if prev is None:
        raise ValueError("a delta (MOMO3) plan needs the previous frame "
                         "(prev)")
    return torch.cat([x, prev], dim=-1)


def plan_cell(plan: CellPlan, x_t: torch.Tensor, hx: torch.Tensor,
              prev: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame through the plan. x_t: (B, F); hx: (B, hidden*comp)
    flattened; prev: the previous frame (B, F), for delta plans only.
    Returns (y (B, F), hx')."""
    skips = _encode(plan, _level0_input(plan, x_t, prev))
    hi = _gate(plan, skips[-1], hx)
    return _decode(plan, hi, skips), hi


def plan_apply_parallel(plan: CellPlan, x: torch.Tensor, hx: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence mode with the recurrence minimized (JAX counterpart
    plan.py:277-339). x: (B, T, F); hx: (B, hidden*comp).

    The encoder depends only on x_t (and, for a delta plan, on prev_t =
    x_{t-1} with prev_0 = x_0, known for the whole sequence) and the
    decoder only on (hi_t, skips_t), so both run as one matmul chain over
    all B*T frames; only the reset-gate matmul and the gating loop over
    T."""
    B, T, F = x.shape
    prev = torch.cat([x[:, :1], x[:, :-1]], dim=1) if plan.delta else None
    flat = _level0_input(plan, x, prev)
    skips = _encode(plan, flat.reshape(B * T, flat.shape[-1]))
    gate_x = skips[-1].reshape(B, T, -1)
    his = []
    for t in range(T):
        hx = _gate(plan, gate_x[:, t], hx)
        his.append(hx)
    h = torch.stack(his, dim=1).reshape(B * T, -1)
    return _decode(plan, h, skips).reshape(B, T, -1), hx


class PlanModel:
    """The zoo models' interface (``init_state``, ``init_carry``,
    ``decay_carry``, ``cell``, ``apply``) on the matrixized plan of a
    GRUUNet2, MOMO2 or MOMO3 ``model``, on ``device`` (the card unless
    ``"cpu"``). A MOMO3 plan carries ``(hx, prev)``.

    ``fused=True`` runs the cell as the hand-written kernel
    (``self.fused_cell``, a ``FusedCell``); on a CPU tensor that wrapper
    runs its plain version. The JAX class falls back to the op-by-op plan
    where the plan outgrows a TPU's VMEM; the kernel streams its weights
    through L2 and has no such limit, and where a tile's activations do
    not fit in a block's shared memory the FusedCell raises here.

    ``quantized=True`` serves the W8A8 plan (``runtime/quant.py``: every
    plan matmul in int8 with per-frame activation scales, in plain
    PyTorch, as JAX runs it outside any kernel); it does not compose with
    ``fused=True``, as in JAX."""

    def __init__(self, model, fused: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 quantized: bool = False):
        if quantized and fused:
            raise ValueError("quantized=True requires fused=False")
        self.num_bins = model.num_bins
        self.device = resolve_device(device)
        self.plan = build_cell_plan(model).to(device=self.device)
        self.is_momo = hasattr(model, "delta")    # MOMO2 or MOMO3
        self.quantized = quantized
        self.fused_cell = None
        if quantized:
            from audio_denoising_torch.runtime.quant import (
                plan_cell_q, quantize_plan)
            self.qplan = quantize_plan(self.plan)
            self._cell = lambda x, hx, prev=None: plan_cell_q(self.qplan, x,
                                                              hx, prev)
        elif fused:
            from audio_denoising_torch.ops.kernels.fused_cell import (
                make_fused_cell)
            self.fused_cell = make_fused_cell(self.plan, self.device)
            self._cell = self.fused_cell
        else:
            self._cell = lambda x, hx, prev=None: plan_cell(self.plan, x, hx,
                                                            prev)

    def init_state(self, batch: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
        return torch.zeros((batch, self.plan.hidden * self.plan.compressed),
                           dtype=dtype,
                           device=self.device if device is None else device)

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        """hx, or (hx, prev) with prev zeros for a delta plan."""
        hx = self.init_state(batch, dtype, device)
        if self.plan.delta:
            return hx, torch.zeros((batch, self.num_bins), dtype=dtype,
                                   device=hx.device)
        return hx

    def decay_carry(self, carry, factor: float):
        """The state decay on hx; prev is the previous frame, kept."""
        if self.plan.delta:
            hx, prev = carry
            return hx * factor, prev
        return carry * factor

    def cell(self, x_t: torch.Tensor, carry):
        """One frame: x_t (B, F), carry hx (B, hidden*comp) or (hx, prev)
        for a delta plan -> (y_t, carry')."""
        if self.plan.delta:
            hx, prev = carry
            y, hx = self._cell(x_t, hx, prev)
            return y, (hx, x_t)
        return self._cell(x_t, carry)

    def apply(self, x: torch.Tensor, hx: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, T, F) or (T, F) -> (y (B, T, F), hx'). A single frame
        of a non-delta plan goes through the cell (and so the kernel when
        fused); longer sequences, and every sequence of a delta plan
        (prev_0 = x_0), through ``plan_apply_parallel``."""
        if x.dim() == 2:
            x = x[None]
        if hx is None:
            hx = self.init_state(x.shape[0], x.dtype, x.device)
        if hx.dim() == 3:                     # accept model-layout state
            hx = hx.reshape(hx.shape[0], -1)
        if x.shape[1] == 1 and not self.plan.delta:
            y, hx = self._cell(x[:, 0], hx)
            return y[:, None], hx
        if self.quantized:
            from audio_denoising_torch.runtime.quant import (
                plan_apply_parallel_q)
            return plan_apply_parallel_q(self.qplan, x, hx)
        return plan_apply_parallel(self.plan, x, hx)

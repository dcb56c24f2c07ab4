"""W8A8 int8 serving plan (JAX counterpart runtime/quant.py), in plain
PyTorch.

The CellPlan's dense matrices quantize to int8 with one symmetric scale
per output column; activations quantize per row (per stream, per frame)
from their live max at serve time, with no calibration set. A matmul is
then an int8 x int8 product summed exactly, and dequantization is the
rank-1 rescale ``acc * row_scale * column_scale``. The GRU gating and the
biases stay fp32; the reset-gate matmul is quantized too.

The integer product is exact: it runs as a float64 matmul of the int8
values, whose sums stay integers below 2^53 (each term is at most 127^2),
on the CPU and on the card alike (the card has no integer matmul), and is
rounded to float32 as JAX's int32 -> float32 cast rounds it. The order of
the elementwise operations is JAX's, since it decides ties:
``sx = where(ax > 0, ax / 127, 1)``, ``round(a / sx)`` half to even,
clip to +-127, then ``acc * sx * scale`` left to right.

Mode ``fast`` with ``serving.dtype="int8"`` serves this plan through
``PlanModel(model, quantized=True)`` (runtime/plan.py); the fused hop's
int8 kernel quantizes a delta plan's level 0 differently (x and prev
each with its own row scale, ops/kernels/common.py).
"""

from typing import NamedTuple, Optional, Tuple

import torch

from audio_denoising_torch.runtime.plan import CellPlan, gru_update


class QuantMat(NamedTuple):
    q: torch.Tensor       # (rows, cols) int8
    scale: torch.Tensor   # (cols,) fp32: dequant = int32 * row_scale * scale


class QuantCellPlan(NamedTuple):
    down_mats: Tuple[QuantMat, ...]
    down_biases: Tuple[torch.Tensor, ...]
    reset_mat: QuantMat
    reset_bias: torch.Tensor
    up_h_mats: Tuple[QuantMat, ...]
    up_s_mats: Tuple[Optional[QuantMat], ...]
    up_biases: Tuple[torch.Tensor, ...]
    hidden: int
    compressed: int
    delta: bool = False


def quantize_mat(m: torch.Tensor) -> QuantMat:
    """Symmetric per-output-column int8 quantization."""
    m = m.to(torch.float32)
    amax = m.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(m / scale[None, :]), -127, 127).to(torch.int8)
    return QuantMat(q=q, scale=scale)


def quantize_plan(plan: CellPlan) -> QuantCellPlan:
    return QuantCellPlan(
        down_mats=tuple(quantize_mat(m) for m in plan.down_mats),
        down_biases=tuple(plan.down_biases),
        reset_mat=quantize_mat(plan.reset_mat),
        reset_bias=plan.reset_bias,
        up_h_mats=tuple(quantize_mat(m) for m in plan.up_h_mats),
        up_s_mats=tuple(None if m is None else quantize_mat(m)
                        for m in plan.up_s_mats),
        up_biases=tuple(plan.up_biases),
        hidden=plan.hidden, compressed=plan.compressed, delta=plan.delta)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row of ``x`` (B, rows) as int8 values (held in float32) and its
    scale (B, 1): the live max over the row over 127."""
    ax = x.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(ax > 0, ax / 127.0, torch.ones_like(ax))
    return torch.clamp(torch.round(x / sx), -127, 127), sx


def int_matmul(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The exact integer product of int-valued (B, rows) and int8 (rows,
    cols), as float32 (each sum rounded once, as an int32 cast rounds)."""
    return (xq.to(torch.float64) @ q.to(torch.float64)).to(torch.float32)


def qdot(x: torch.Tensor, qm: QuantMat) -> torch.Tensor:
    """(B, rows) fp32 @ int8 matrix -> (B, cols) fp32: dynamic per-row
    activation quantization, exact integer accumulation, rank-1 dequant."""
    xq, sx = quantize_rows(x)
    return int_matmul(xq, qm.q) * sx * qm.scale[None, :]


def _gate(qplan: QuantCellPlan, gate_x: torch.Tensor, hx: torch.Tensor
          ) -> torch.Tensor:
    """The quantized reset-gate matmul on hx and the fp32 GRU gating."""
    gate_h = torch.relu(qdot(hx, qplan.reset_mat) + qplan.reset_bias)
    return gru_update(qplan.hidden * qplan.compressed, gate_x, gate_h, hx)


def _encode(qplan: QuantCellPlan, x: torch.Tensor):
    skips = [x]
    for qm, b in zip(qplan.down_mats, qplan.down_biases):
        skips.append(torch.relu(qdot(skips[-1], qm) + b))
    return skips


def _decode(qplan: QuantCellPlan, h: torch.Tensor, skips) -> torch.Tensor:
    L = len(qplan.up_h_mats)
    for i in range(L):
        out = qdot(h, qplan.up_h_mats[i]) + qplan.up_biases[i]
        if qplan.up_s_mats[i] is not None:
            out = out + qdot(skips[L - i], qplan.up_s_mats[i])
        h = torch.relu(out) if i != L - 1 else out
    return h


def plan_cell_q(qplan: QuantCellPlan, x_t: torch.Tensor, hx: torch.Tensor,
                prev: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame through the quantized plan: runtime.plan.plan_cell with
    every dense matmul in W8A8. A delta plan's level 0 quantizes
    cat(x_t, prev) with one row scale."""
    if qplan.delta and prev is None:
        raise ValueError("a delta (MOMO3) plan needs the previous frame "
                         "(prev)")
    x_in = torch.cat([x_t, prev], dim=-1) if qplan.delta else x_t
    skips = _encode(qplan, x_in)
    hi = _gate(qplan, skips[-1], hx)
    return _decode(qplan, hi, skips), hi


def plan_apply_parallel_q(qplan: QuantCellPlan, x: torch.Tensor,
                          hx: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence mode in W8A8 (runtime.plan.plan_apply_parallel): the
    encoder and decoder run over all B*T frames at once (per-row scales
    make this frame-exact against the cell) and only the gating loops over
    T. x: (B, T, F); a delta plan's prev_0 is x_0."""
    B, T, F = x.shape
    if qplan.delta:
        prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
        flat = torch.cat([x, prev], dim=-1).reshape(B * T, 2 * F)
    else:
        flat = x.reshape(B * T, F)
    skips = _encode(qplan, flat)
    gate_x = skips[-1].reshape(B, T, -1)
    his = []
    for t in range(T):
        hx = _gate(qplan, gate_x[:, t], hx)
        his.append(hx)
    h = torch.stack(his, dim=1).reshape(B * T, -1)
    return _decode(qplan, h, skips).reshape(B, T, -1), hx

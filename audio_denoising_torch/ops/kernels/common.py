"""The plan cell shared by the serving kernels (JAX counterpart
ops/pallas/common.py:22-160, fp32 branch, with the delta level 0).

``pack_plan_weights`` flattens a CellPlan into the fixed operand order the
kernels walk; ``plan_cell_math`` is the plain PyTorch version of the cell
step that ``csrc/plan_cell.cuh`` computes in its ``plan_cell`` device
routine; ``plan_args`` fills that header's ``AdtPlan`` for a launch.
"""

import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

import torch

MAX_LEVELS = 8          # ADT_MAX_LEVELS in csrc/plan_cell.cuh


class PlanArgs(ctypes.Structure):
    """Field-for-field mirror of AdtPlan in csrc/plan_cell.cuh."""
    _fields_ = [("down_w", ctypes.c_void_p * MAX_LEVELS),
                ("down_b", ctypes.c_void_p * MAX_LEVELS),
                ("reset_w", ctypes.c_void_p), ("reset_b", ctypes.c_void_p),
                ("up_w", ctypes.c_void_p * MAX_LEVELS),
                ("up_s", ctypes.c_void_p * MAX_LEVELS),
                ("up_b", ctypes.c_void_p * MAX_LEVELS),
                ("down_n", ctypes.c_int * (MAX_LEVELS + 1)),
                ("up_n", ctypes.c_int * (MAX_LEVELS + 1)),
                ("levels", ctypes.c_int), ("n_hidden", ctypes.c_int),
                ("delta", ctypes.c_int)]


def kernel_operand(t: torch.Tensor, keep: List[torch.Tensor],
                   pad_columns: bool = True) -> int:
    """The device pointer of ``t`` as a kernel reads it: unless
    ``pad_columns`` is False, matrices get their columns zero-padded to a
    multiple of 4 (the GEMM reads rows as float4s). The tensor passed is
    appended to ``keep``, which the caller holds for as long as launches
    use the pointer."""
    if pad_columns and t.dim() == 2 and t.shape[1] % 4:
        t = torch.nn.functional.pad(t, (0, 4 - t.shape[1] % 4))
    t = t.contiguous()
    keep.append(t)
    if t.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    return t.data_ptr()


def plan_args(weights: Sequence[torch.Tensor], skip_flags: Sequence[bool],
              n_feat: int, n_hidden: int, keep: List[torch.Tensor],
              delta: bool = False) -> PlanArgs:
    """``AdtPlan`` for weights in pack_plan_weights order (on the card);
    a delta plan's level 0 reads 2 ``n_feat`` columns, cat(x, prev)."""
    levels = len(skip_flags)
    if levels > MAX_LEVELS:
        raise ValueError(f"the kernels take at most {MAX_LEVELS} levels")
    p = PlanArgs()
    it = iter(weights)
    down_n, up_n = [(2 if delta else 1) * n_feat], [n_hidden]
    for i in range(levels):
        m = next(it)
        down_n.append(m.shape[1])
        p.down_w[i] = kernel_operand(m, keep)
        p.down_b[i] = kernel_operand(next(it), keep)
    p.reset_w = kernel_operand(next(it), keep)
    p.reset_b = kernel_operand(next(it), keep)
    for i in range(levels):
        m = next(it)
        up_n.append(m.shape[1])
        p.up_w[i] = kernel_operand(m, keep)
        p.up_b[i] = kernel_operand(next(it), keep)
        p.up_s[i] = kernel_operand(next(it), keep) if skip_flags[i] else None
    for i, v in enumerate(down_n):
        p.down_n[i] = v
    for i, v in enumerate(up_n):
        p.up_n[i] = v
    p.levels, p.n_hidden, p.delta = levels, n_hidden, int(delta)
    return p


def check_plan(plan, n_feat: int) -> None:
    """Raises unless ``plan`` maps ``n_feat`` features to ``n_feat``: level
    0 takes n_feat rows, 2 n_feat (cat(x, prev)) for a delta plan."""
    rows = plan.down_mats[0].shape[0]
    want = (2 if plan.delta else 1) * n_feat
    if rows != want or plan.up_h_mats[-1].shape[1] != n_feat:
        kind = "delta " if plan.delta else ""
        raise ValueError(
            f"a {kind}plan for {n_feat} features needs {want} level-0 rows "
            f"and {n_feat} outputs; this one has {rows} and "
            f"{plan.up_h_mats[-1].shape[1]}")
    if len(plan.down_mats) > MAX_LEVELS:
        raise ValueError(f"the kernels take at most {MAX_LEVELS} levels")


def pack_plan_weights(plan) -> Tuple[List[torch.Tensor], List[bool]]:
    """Operand order: down (mat, bias) per level, reset (mat, bias), then
    up (mat, bias[, skip_mat]) per level; plus the per-level skip flags.
    A delta plan's level-0 matrix keeps its 2F rows in order: x's, then
    prev's."""
    weights: List[torch.Tensor] = []
    for m, b in zip(plan.down_mats, plan.down_biases):
        weights += [m, b]
    weights += [plan.reset_mat, plan.reset_bias]
    skip_flags = []
    for i in range(len(plan.down_mats)):
        weights += [plan.up_h_mats[i], plan.up_biases[i]]
        skip_flags.append(plan.up_s_mats[i] is not None)
        if skip_flags[-1]:
            weights.append(plan.up_s_mats[i])
    return weights, skip_flags


def dense_gemm(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               bias: torch.Tensor) -> torch.Tensor:
    """a_0 @ w_0 + bias + a_1 @ w_1 + ...: the reference's matmuls."""
    (a, w), rest = pairs[0], pairs[1:]
    out = a @ w + bias
    for a, w in rest:
        out = out + a @ w
    return out


def plan_cell_math(w: Sequence[torch.Tensor], skip_flags: Sequence[bool],
                   n: int, x: torch.Tensor, hx: torch.Tensor,
                   gemm: Callable = dense_gemm,
                   prev: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cell step. ``w``: pack_plan_weights order; ``x``: (B, feat);
    ``hx``: (B, n); ``prev``: (B, feat), the previous feature, for a delta
    plan. Returns (y (B, feat), hi (B, n)); the caller applies the state
    decay and carries prev' = x. ``gemm(pairs, bias)`` computes each
    matmul from its (activation, matrix) pairs; weight_ring.ring_gemm
    adds as the kernel's consumers do. A delta plan's level 0 is one
    matmul over cat(x, prev), as the kernels stage it (JAX splits it into
    x @ W0[:feat] + prev @ W0[feat:])."""
    L = len(skip_flags)
    it = iter(w)
    h = x if prev is None else torch.cat([x, prev], dim=-1)
    skips = [h]
    for _ in range(L):
        m, b = next(it), next(it)
        h = torch.relu(gemm([(h, m)], b))
        skips.append(h)
    gate_x = h
    m, b = next(it), next(it)
    gate_h = torch.relu(gemm([(hx, m)], b))
    i_r, i_i, i_n = gate_x[:, :n], gate_x[:, n:2 * n], gate_x[:, 2 * n:]
    h_r, h_i, h_n = gate_h[:, :n], gate_h[:, n:2 * n], gate_h[:, 2 * n:]
    inputgate = torch.sigmoid(i_i + h_i)
    resetgate = torch.sigmoid(i_r + h_r)
    newgate = torch.tanh(i_n + resetgate * h_n)
    hi = newgate + inputgate * (hx - newgate)
    h = hi
    for i in range(L):
        m, b = next(it), next(it)
        pairs = [(h, m)]
        if skip_flags[i]:
            pairs.append((skips[L - i], next(it)))
        out = gemm(pairs, b)
        h = torch.relu(out) if i != L - 1 else out
    return h, hi

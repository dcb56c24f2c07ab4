"""The plan cell shared by the serving kernels (JAX counterpart
ops/pallas/common.py:22-160: the fp32, bf16 and W8A8 int8 branches, with
the delta level 0).

``pack_plan_weights`` flattens a CellPlan into the fixed operand order the
kernels walk (with ``quantize=True`` each matrix as an int8 matrix and its
column scale row); ``plan_cell_math`` is the plain PyTorch version of the
cell step that ``csrc/plan_cell.cuh`` computes in its ``plan_cell``
device routine, in each compute dtype; ``plan_args`` fills that header's
``AdtPlan`` for a launch, and ``plan_args_q`` the int8 plan's ``AdtPlan``
and ``AdtPlanScales``.
"""

import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from audio_denoising_torch.runtime.plan import gru_update
from audio_denoising_torch.runtime.quant import QuantMat, qdot, quantize_mat

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


class PlanScaleArgs(ctypes.Structure):
    """Field-for-field mirror of AdtPlanScales in csrc/plan_cell.cuh: the
    int8 plan's column scale rows, one per matrix of AdtPlan."""
    _fields_ = [("down", ctypes.c_void_p * MAX_LEVELS),
                ("reset", ctypes.c_void_p),
                ("up", ctypes.c_void_p * MAX_LEVELS),
                ("skip", ctypes.c_void_p * MAX_LEVELS)]


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def kernel_operand(t: torch.Tensor, keep: List[torch.Tensor],
                   pad_columns: bool = True, pad_rows: bool = False) -> int:
    """The device pointer of ``t`` as a kernel reads it: unless
    ``pad_columns`` is False, matrices get their columns zero-padded to a
    multiple of 4 (the GEMM reads a row's four columns as one load: a
    float4, four bf16 or four int8); ``pad_rows`` pads the rows so too
    (the int8 GEMM reads four rows at a time). The tensor passed is
    appended to ``keep``, which the caller holds for as long as launches
    use the pointer."""
    if t.dim() == 2:
        cols = _round4(t.shape[1]) - t.shape[1] if pad_columns else 0
        rows = _round4(t.shape[0]) - t.shape[0] if pad_rows else 0
        if cols or rows:
            t = torch.nn.functional.pad(t, (0, cols, 0, rows))
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


def plan_args_q(weights: Sequence[torch.Tensor],
                skip_flags: Sequence[bool], n_feat: int, n_hidden: int,
                keep: List[torch.Tensor], delta: bool = False
                ) -> Tuple[PlanArgs, PlanScaleArgs]:
    """``AdtPlan`` and ``AdtPlanScales`` for weights in
    ``pack_plan_weights(quantize=True)`` order (on the card). Every int8
    matrix has its rows and columns zero-padded to a multiple of 4; a
    delta plan's level-0 matrix is laid out as its x rows, padded, then
    its prev rows, padded, since the kernel quantizes x and prev apart."""
    levels = len(skip_flags)
    p = PlanArgs()
    s = PlanScaleArgs()
    it = iter(weights)

    def mat(split=False):
        q, scale = next(it), next(it)
        if split:
            f = q.shape[0] // 2
            pad = lambda m: torch.nn.functional.pad(
                m, (0, 0, 0, _round4(f) - f))
            q = torch.cat([pad(q[:f]), pad(q[f:])])
        return (kernel_operand(q, keep, pad_rows=True),
                kernel_operand(scale, keep), q.shape[1])

    down_n, up_n = [(2 if delta else 1) * n_feat], [n_hidden]
    for i in range(levels):
        p.down_w[i], s.down[i], cols = mat(split=delta and i == 0)
        down_n.append(cols)
        p.down_b[i] = kernel_operand(next(it), keep)
    p.reset_w, s.reset, _ = mat()
    p.reset_b = kernel_operand(next(it), keep)
    for i in range(levels):
        p.up_w[i], s.up[i], cols = mat()
        up_n.append(cols)
        p.up_b[i] = kernel_operand(next(it), keep)
        if skip_flags[i]:
            p.up_s[i], s.skip[i], _ = mat()
    for i, v in enumerate(down_n):
        p.down_n[i] = v
    for i, v in enumerate(up_n):
        p.up_n[i] = v
    p.levels, p.n_hidden, p.delta = levels, n_hidden, int(delta)
    return p, s


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


def pack_plan_weights(plan, quantize: bool = False
                      ) -> Tuple[List[torch.Tensor], List[bool]]:
    """Operand order: down (mat, bias) per level, reset (mat, bias), then
    up (mat, bias[, skip_mat]) per level; plus the per-level skip flags.
    A delta plan's level-0 matrix keeps its 2F rows in order: x's, then
    prev's. ``quantize=True`` (the int8 kernel variant) emits each matrix
    as the pair (int8 matrix, (1, cols) fp32 column scale row), with
    runtime.quant.quantize_mat's semantics; biases stay fp32."""
    if quantize:
        def mat(m):
            qm = quantize_mat(m)
            return [qm.q, qm.scale[None, :]]
    else:
        mat = lambda m: [m]
    weights: List[torch.Tensor] = []
    for m, b in zip(plan.down_mats, plan.down_biases):
        weights += mat(m) + [b]
    weights += mat(plan.reset_mat) + [plan.reset_bias]
    skip_flags = []
    for i in range(len(plan.down_mats)):
        weights += mat(plan.up_h_mats[i]) + [plan.up_biases[i]]
        skip_flags.append(plan.up_s_mats[i] is not None)
        if skip_flags[-1]:
            weights += mat(plan.up_s_mats[i])
    return weights, skip_flags


def dense_gemm(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               bias: torch.Tensor) -> torch.Tensor:
    """a_0 @ w_0 + bias + a_1 @ w_1 + ...: the reference's matmuls."""
    (a, w), rest = pairs[0], pairs[1:]
    out = a @ w + bias
    for a, w in rest:
        out = out + a @ w
    return out


def bf16_gemm(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              bias: torch.Tensor) -> torch.Tensor:
    """dense_gemm with each activation rounded to bf16 against bf16
    matrices, the products summed in fp32: a product of two bf16 values
    is exact in fp32, so this differs from a bf16 MMA with fp32
    accumulate only by the order of addition."""
    return dense_gemm([(a.bfloat16().float(), m.float()) for a, m in pairs],
                      bias)


def _plan_cell_q(w: Sequence[torch.Tensor], skip_flags: Sequence[bool],
                 n: int, x: torch.Tensor, hx: torch.Tensor,
                 prev: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The W8A8 cell step (JAX common.py:56-160, compute int8) on weights
    in pack_plan_weights(quantize=True) order: every dot quantizes its
    input per row; a delta level 0 is two dots, x and prev each with its
    own row scale, added before the bias; a decoder skip is a second dot
    added after the bias."""
    L = len(skip_flags)
    it = iter(w)
    mat = lambda: QuantMat(next(it), next(it)[0])
    h = x
    skips = [h]
    for i in range(L):
        qm, b = mat(), next(it)
        if i == 0 and prev is not None:
            f = x.shape[-1]
            lin = (qdot(x, QuantMat(qm.q[:f], qm.scale))
                   + qdot(prev, QuantMat(qm.q[f:], qm.scale)))
        else:
            lin = qdot(h, qm)
        h = torch.relu(lin + b)
        skips.append(h)
    gate_x = h
    qm, b = mat(), next(it)
    hi = gru_update(n, gate_x, torch.relu(qdot(hx, qm) + b), hx)
    h = hi
    for i in range(L):
        qm, b = mat(), next(it)
        out = qdot(h, qm) + b
        if skip_flags[i]:
            out = out + qdot(skips[L - i], mat())
        h = torch.relu(out) if i != L - 1 else out
    return h, hi


def plan_cell_math(w: Sequence[torch.Tensor], skip_flags: Sequence[bool],
                   n: int, x: torch.Tensor, hx: torch.Tensor,
                   gemm: Callable = dense_gemm,
                   prev: Optional[torch.Tensor] = None,
                   compute_dtype=torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cell step. ``w``: pack_plan_weights order; ``x``: (B, feat);
    ``hx``: (B, n); ``prev``: (B, feat), the previous feature, for a delta
    plan. Returns (y (B, feat), hi (B, n)); the caller applies the state
    decay and carries prev' = x. ``gemm(pairs, bias)`` computes each
    matmul from its (activation, matrix) pairs; weight_ring.ring_gemm
    adds as the kernel's consumers do. A delta plan's level 0 is one
    matmul over cat(x, prev), as the kernels stage it (JAX splits it into
    x @ W0[:feat] + prev @ W0[feat:]).

    ``compute_dtype=torch.bfloat16``: ``w``'s matrices are bf16 and each
    matmul is ``bf16_gemm`` (``gemm`` is for fp32). ``torch.int8``: ``w``
    is in pack_plan_weights(quantize=True) order and the step is W8A8
    (``_plan_cell_q``)."""
    if compute_dtype == torch.int8:
        return _plan_cell_q(w, skip_flags, n, x, hx, prev)
    if compute_dtype == torch.bfloat16:
        gemm = bf16_gemm
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
    hi = gru_update(n, gate_x, gate_h, hx)
    h = hi
    for i in range(L):
        m, b = next(it), next(it)
        pairs = [(h, m)]
        if skip_flags[i]:
            pairs.append((skips[L - i], next(it)))
        out = gemm(pairs, b)
        h = torch.relu(out) if i != L - 1 else out
    return h, hi

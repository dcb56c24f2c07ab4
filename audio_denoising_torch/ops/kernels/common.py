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
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from audio_denoising_torch.runtime.plan import gru_update
from audio_denoising_torch.runtime.quant import QuantMat, qdot, quantize_mat

MAX_LEVELS = 8          # ADT_MAX_LEVELS in csrc/plan_cell.cuh
KTILE = 2               # streams per block (kTile)
KTHREADS = 512          # threads per block of the plan cell (kThreads)


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


def round4(n: int) -> int:
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
        cols = round4(t.shape[1]) - t.shape[1] if pad_columns else 0
        rows = round4(t.shape[0]) - t.shape[0] if pad_rows else 0
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
                m, (0, 0, 0, round4(f) - f))
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


class PlanShape(NamedTuple):
    """The widths ``AdtPlan`` carries (csrc/plan_cell.cuh), read from a
    CellPlan without building its operands: ``down_n`` = [n_in, level
    widths..., 3 n_hidden], ``up_n`` = [n_hidden, level widths..., n_feat],
    and which decoder levels have a skip matrix."""
    down_n: Tuple[int, ...]
    up_n: Tuple[int, ...]
    skips: Tuple[bool, ...]
    n_hidden: int
    delta: bool

    @property
    def levels(self) -> int:
        return len(self.skips)


def plan_shape(plan, n_feat: int) -> PlanShape:
    return PlanShape(
        down_n=((2 if plan.delta else 1) * n_feat,
                *(m.shape[1] for m in plan.down_mats)),
        up_n=(plan.hidden * plan.compressed,
              *(m.shape[1] for m in plan.up_h_mats)),
        skips=tuple(m is not None for m in plan.up_s_mats),
        n_hidden=plan.hidden * plan.compressed, delta=bool(plan.delta))


def plan_q_floats(p: PlanShape) -> int:
    """Floats of the int8 plan's staging buffer (``plan_q_bytes`` in
    csrc/plan_cell.cuh, rounded up to floats): kTile rows of the widest
    matmul input, each of its inputs padded to a multiple of 4 bytes."""
    def q_bytes(k1: int, k2: int = 0) -> int:
        return KTILE * (round4(k1) + round4(k2))

    L, most = p.levels, q_bytes(p.n_hidden)
    for i in range(L):
        k = p.down_n[i]
        most = max(most, q_bytes(k // 2, k // 2) if i == 0 and p.delta
                   else q_bytes(k),
                   q_bytes(p.up_n[i], p.down_n[L - i] if p.skips[i] else 0))
    return round4((most + 3) // 4)


def cell_layout_floats(p: PlanShape, quant: bool = False) -> int:
    """Floats of ``make_cell_layout`` in csrc/plan_cell.cuh: kTile rows of
    each level's input, the gates, hx and its update, two decoder
    buffers, the split-K scratch; the int8 plan adds its staging buffer
    and kTile row scales."""
    widest = max(p.up_n[1:p.levels + 1])
    floats = KTILE * (sum(round4(n) for n in p.down_n[:p.levels + 1])
                      + round4(3 * p.n_hidden) + 2 * round4(p.n_hidden)
                      + 2 * round4(widest) + 4 * KTHREADS)
    if quant:
        floats += plan_q_floats(p) + round4(2 * KTILE)
    return floats


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


class SplitSchedule(NamedTuple):
    """How ``gemm`` in csrc/plan_cell.cuh splits one matmul's depth
    (``split_schedule``): ``ks_n`` work items a column quad, each over
    one of the contiguous k ranges ``ranges`` ([lo, hi) of the sources
    laid end to end, ``chunk`` k each, a multiple of 4); with more than
    one, their partial sums meet in the shared-memory scratch and are
    added in the order of ``ranges`` (from 0, or the kPre sum), then the
    bias and the activation."""
    ks_n: int
    chunk: int
    ranges: Tuple[Tuple[int, int], ...]


def split_schedule(n: int, k: int, lanes: int = KTHREADS) -> SplitSchedule:
    """The schedule ``gemm`` runs for ``n`` output columns over depth
    ``k`` (both sources) on ``lanes`` threads: a plain mirror of its
    ``split_ks`` rule (the fewest rounds of work items times k an item,
    at least 16 k an item, the partial sums within the scratch of 4
    KTHREADS floats a row; the fewest ranges among equals). It depends on
    n, k and the lanes only, never on the rows, so a row's sums are added
    in the same order in both walks of the fused hop."""
    ldw = round4(n)
    n4 = ldw // 4
    best, ks_n = None, 1
    for ks in range(1, max(1, min(k // 16, 4 * KTHREADS // ldw)) + 1):
        cost = -(-n4 * ks // lanes) * -(-k // ks)
        if best is None or cost < best:
            best, ks_n = cost, ks
    chunk = round4(-(-k // ks_n))
    return SplitSchedule(ks_n, chunk, tuple(
        (min(k, r * chunk), min(k, (r + 1) * chunk)) for r in range(ks_n)))


def split_gemm(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               bias: torch.Tensor) -> torch.Tensor:
    """A ``gemm(pairs, bias)`` for ``plan_cell_math`` that adds as the
    kernels' ``gemm`` does: the sources laid end to end, each k range of
    ``split_schedule`` one product (a float32 matmul), the ranges' sums in
    order from 0, then the bias."""
    a = torch.cat([p[0] for p in pairs], dim=-1)
    w = torch.cat([p[1] for p in pairs], dim=0)
    out = torch.zeros(a.shape[0], w.shape[1], dtype=a.dtype, device=a.device)
    for lo, hi in split_schedule(w.shape[1], w.shape[0]).ranges:
        if hi > lo:
            out = out + a[:, lo:hi] @ w[lo:hi]
    return out + bias


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

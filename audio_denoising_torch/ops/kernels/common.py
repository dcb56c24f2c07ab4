"""The plan cell shared by the serving kernels (JAX counterpart
ops/pallas/common.py:22-160, fp32 branch).

``pack_plan_weights`` flattens a CellPlan into the fixed operand order the
kernels walk; ``plan_cell_math`` is the plain PyTorch version of the cell
step that ``csrc/fused_hop.cu`` computes in its ``plan_cell`` device
routine.
"""

from typing import List, Sequence, Tuple

import torch


def pack_plan_weights(plan) -> Tuple[List[torch.Tensor], List[bool]]:
    """Operand order: down (mat, bias) per level, reset (mat, bias), then
    up (mat, bias[, skip_mat]) per level; plus the per-level skip flags."""
    if plan.delta:
        raise NotImplementedError("delta (MOMO3) plans are a later slice")
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


def plan_cell_math(w: Sequence[torch.Tensor], skip_flags: Sequence[bool],
                   n: int, x: torch.Tensor, hx: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cell step. ``w``: pack_plan_weights order; ``x``: (B, feat);
    ``hx``: (B, n). Returns (y (B, feat), hi (B, n)); the caller applies
    the state decay."""
    L = len(skip_flags)
    it = iter(w)
    h = x
    skips = [h]
    for _ in range(L):
        m, b = next(it), next(it)
        h = torch.relu(h @ m + b)
        skips.append(h)
    gate_x = h
    m, b = next(it), next(it)
    gate_h = torch.relu(hx @ m + b)
    i_r, i_i, i_n = gate_x[:, :n], gate_x[:, n:2 * n], gate_x[:, 2 * n:]
    h_r, h_i, h_n = gate_h[:, :n], gate_h[:, n:2 * n], gate_h[:, 2 * n:]
    inputgate = torch.sigmoid(i_i + h_i)
    resetgate = torch.sigmoid(i_r + h_r)
    newgate = torch.tanh(i_n + resetgate * h_n)
    hi = newgate + inputgate * (hx - newgate)
    h = hi
    for i in range(L):
        m, b = next(it), next(it)
        out = h @ m + b
        if skip_flags[i]:
            out = out + skips[L - i] @ next(it)
        h = torch.relu(out) if i != L - 1 else out
    return h, hi

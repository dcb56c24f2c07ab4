"""Tensor-parallel serving of the matrixized cell plan (JAX counterpart
parallel/tp.py).

Megatron-style sharding of the CellPlan's dense level matrices over the
entries of an in-process mesh (``parallel.make_mesh``):

- **col** levels split the matrix's output columns across entries, with
  no combine; the level's activation comes out feature-sharded;
- **row** levels split the input rows: each entry computes a partial
  product, and one sum over the entries restores the full activation
  (the bias is added once, after the sum);
- alternating col -> row pairs the two, so the intermediate never
  leaves its entry (one sum per pair, the Megatron MLP block).

The U-Net's skips cooperate: for an even level count the skip a
row-sharded decoder level reads is the feature-sharded output of the
matching col-sharded encoder level, and the skip a col level reads is
full. An odd level count (the d5 preset) takes one gather where the
parity breaks. A level whose widths do not divide over the mesh is
computed whole on every entry (``rep``). The GRU gates, the reset-gate
matmul and the carried ``hx`` stay replicated.

The combines run in process. The sum of a row level (JAX's ``psum``)
adds the partial products on the first entry's device in mesh order, so
a run is deterministic, and copies the sum back to every entry
(``torch.cuda.comm.broadcast`` where the entries are distinct cards). A
gather (JAX's ``all_gather``) concatenates the shards in mesh order. The
schedule (``step.modes``) is JAX's for the same plan and mesh size. No
hand-written kernel runs here, as JAX's TP cell reaches no Pallas
kernel.
"""

from typing import List, NamedTuple, Optional

import torch

from audio_denoising_torch.parallel.mesh import Mesh
from audio_denoising_torch.runtime.plan import CellPlan, gru_update


class _Level(NamedTuple):
    mode: str                          # 'col' | 'row' | 'gather-row' | 'rep'
    mats: List[torch.Tensor]           # per entry: its block, or the whole
    biases: List[Optional[torch.Tensor]]   # col: its block; else whole
    s_mats: List[Optional[torch.Tensor]]   # the decoder's skip part


def _split_cols(mat: torch.Tensor, D: int) -> List[torch.Tensor]:
    return list(torch.chunk(mat, D, dim=-1))        # D x (rows, cols/D)


def _split_rows(mat: torch.Tensor, D: int) -> List[torch.Tensor]:
    return list(torch.chunk(mat, D, dim=0))         # D x (rows/D, cols)


def _plan_levels(plan: CellPlan, D: int):
    """Assign col/row/rep modes to the encoder and decoder levels (JAX
    tp.py:73-118): greedy alternation starting with col; a level falls
    back to 'rep' where the split it needs does not divide D, or to
    'gather-row' where its input is sharded and a row split does not
    divide. -> (down modes, up modes, gates_gather, out_gather, the
    parity of each saved skip)."""
    down, state = [], "full"      # parity of the flowing activation
    skip_state = ["full"]         # parity of each saved skip (index 0 = x)
    for m in plan.down_mats:
        rows, cols = int(m.shape[0]), int(m.shape[1])
        if state == "full" and cols % D == 0:
            down.append("col")
            state = "shard"
        elif rows % D == 0:
            # a row split takes a full input (each entry slices its rows)
            # or the matching col-sharded one
            down.append("row")
            state = "full"
        else:
            down.append("gather-row" if state == "shard" else "rep")
            state = "full"
        skip_state.append(state)
    gates_gather = state == "shard"   # the gates need the full (B, 3n)

    up, state = [], "full"            # hi is replicated after gating
    L = len(plan.up_h_mats)
    for i in range(L):
        m, sk = plan.up_h_mats[i], plan.up_s_mats[i]
        rows, cols = int(m.shape[0]), int(m.shape[1])
        skip_par = skip_state[L - i] if sk is not None else "full"
        sk_rows_ok = sk is None or int(sk.shape[0]) % D == 0
        if state == "full" and cols % D == 0 and skip_par == "full" \
                and (sk is None or int(sk.shape[1]) == cols):
            up.append("col")
            state = "shard"
        elif rows % D == 0 and sk_rows_ok and skip_par in ("full", "shard"):
            up.append("row")
            state = "full"
        else:
            up.append("gather-row" if state == "shard" else "rep")
            state = "full"
    out_gather = state == "shard"
    return down, up, gates_gather, out_gather, skip_state


class _Combine:
    """The mesh's two combines, over per-entry lists of tensors."""

    def __init__(self, mesh: Mesh):
        self.devices = mesh.devices
        self.cards = mesh.distinct_cards

    def _spread(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` (on the first entry's device) on every entry's device."""
        if self.cards:
            return list(torch.cuda.comm.broadcast(
                t, [d.index for d in self.devices]))
        return [t.to(d) for d in self.devices]

    def psum(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        total = parts[0]
        for p in parts[1:]:               # mesh order: deterministic
            total = total + p.to(total.device)
        return self._spread(total)

    def all_gather(self, shards: List[torch.Tensor]) -> List[torch.Tensor]:
        dst = shards[0].device
        return self._spread(torch.cat([s.to(dst) for s in shards], dim=1))


def make_tp_plan_cell(plan: CellPlan, mesh: Mesh,
                      axis: Optional[str] = None):
    """``step(x_t (B, F), hx (B, n)[, prev (B, F)]) -> (y (B, F), hx')``
    running ``plan`` tensor-parallel over ``mesh``'s entries; the outputs
    on the first entry's device. The same function as
    ``runtime.plan.plan_cell``; ``step.modes`` is the schedule."""
    axis = axis or mesh.axis_name
    D = int(mesh.shape[axis])
    down_modes, up_modes, gates_gather, out_gather, _ = _plan_levels(plan,
                                                                     D)
    devices = mesh.devices
    comb = _Combine(mesh)
    plan = plan.to(dtype=torch.float32)

    def placed(blocks):
        return [b.to(d).contiguous() for b, d in zip(blocks, devices)]

    def whole(t):
        return [None if t is None else t.to(d) for d in devices]

    def prep(mat, bias, mode):
        if mode == "col":
            return (placed(_split_cols(mat, D)),
                    whole(None) if bias is None
                    else placed(list(torch.chunk(bias, D))))
        if mode in ("row", "gather-row"):
            return placed(_split_rows(mat, D)), whole(bias)
        return whole(mat), whole(bias)

    downs = [_Level(mode, *prep(m, b, mode), whole(None)) for mode, m, b in
             zip(down_modes, plan.down_mats, plan.down_biases)]
    ups = []
    for i, mode in enumerate(up_modes):
        mats, biases = prep(plan.up_h_mats[i], plan.up_biases[i], mode)
        s = plan.up_s_mats[i]
        s_mats = whole(None) if s is None else prep(s, None, mode)[0]
        ups.append(_Level(mode, mats, biases, s_mats))
    reset_mats, reset_biases = whole(plan.reset_mat), whole(plan.reset_bias)
    n = plan.hidden * plan.compressed

    def apply(lvl: _Level, hs, h_par, skips=None, skip_par="full"):
        """One level on every entry -> (activations pre-ReLU, parity)."""
        out = []
        if lvl.mode == "col":
            for i in range(D):
                o = hs[i] @ lvl.mats[i] + lvl.biases[i]
                if skips is not None:
                    o = o + skips[i] @ lvl.s_mats[i]
                out.append(o)
            return out, "shard"
        if lvl.mode == "rep":
            for i in range(D):
                o = hs[i] @ lvl.mats[i] + lvl.biases[i]
                if skips is not None:
                    o = o + skips[i] @ lvl.s_mats[i]
                out.append(o)
            return out, "full"
        if lvl.mode == "gather-row" and h_par == "shard":
            hs, h_par = comb.all_gather(hs), "full"
        parts = []
        for i in range(D):
            mat = lvl.mats[i]
            if h_par == "shard":             # the shards already match
                part = hs[i] @ mat
            else:
                r = mat.shape[0]
                part = hs[i][:, i * r:(i + 1) * r] @ mat
            if skips is not None:
                s = lvl.s_mats[i]
                if skip_par == "shard":
                    part = part + skips[i] @ s
                else:
                    r = s.shape[0]
                    part = part + skips[i][:, i * r:(i + 1) * r] @ s
            parts.append(part)
        return [t + b for t, b in zip(comb.psum(parts), lvl.biases)], "full"

    def step(x_t: torch.Tensor, hx: torch.Tensor,
             prev: Optional[torch.Tensor] = None):
        # a delta (MOMO3) plan's level 0 is affine in (x_t, prev) jointly:
        # the concat is full on every entry and rides the same schedule
        # with 2F input rows; the caller carries prev' = x_t
        if plan.delta:
            if prev is None:
                raise ValueError("delta plan: prev frame required")
            x_t = torch.cat([x_t, prev.to(x_t.device)], dim=-1)
        hs, par = whole(x_t), "full"
        saved = [(hs, par)]
        for lvl in downs:
            hs, par = apply(lvl, hs, par)
            hs = [torch.relu(h) for h in hs]
            saved.append((hs, par))
        gate_x = comb.all_gather(hs) if gates_gather else hs
        hxs = whole(hx)
        his = [gru_update(n, gx, torch.relu(h @ rm + rb), h)
               for gx, h, rm, rb in zip(gate_x, hxs, reset_mats,
                                        reset_biases)]
        L = len(ups)
        hs, par = his, "full"
        for i, lvl in enumerate(ups):
            skips, skip_par = (saved[L - i] if lvl.s_mats[0] is not None
                               else (None, "full"))
            hs, par = apply(lvl, hs, par, skips, skip_par)
            if i != L - 1:
                hs = [torch.relu(h) for h in hs]
        if out_gather or par == "shard":
            hs = comb.all_gather(hs)
        return hs[0], his[0]

    step.modes = {"down": down_modes, "up": up_modes,
                  "gates_gather": gates_gather, "out_gather": out_gather}
    return step

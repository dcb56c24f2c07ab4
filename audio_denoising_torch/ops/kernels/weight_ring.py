"""The weight ring of ``csrc/weight_ring.cuh``: its slab schedule and
shape, computed here once per kernel, and a plain PyTorch mirror of the
order in which its consumers add.

The fused cell (``csrc/fused_cell.cu``) takes its weights through a ring
of ``stages`` stages in each block's shared memory, after the block's own
layout. The weights do not depend on the activations, so the wrapper lists
them once: ``slab_schedule`` cuts every weight matrix the kernel uses, in
the order the kernel consumes them (``cell_matrices``), into k-slabs of
whole rows. Rows are padded to ``round4(n)`` floats
(``common.kernel_operand``), so a slab is one contiguous run of 16-byte
aligned bytes whose length is a multiple of 16: one bulk async copy. Slab
``j`` is issued by block ``j % cluster`` of its cluster and multicast to
all of them.

``ring_geometry`` sizes the ring from what the layout leaves of the
block's shared memory; ``cell_layout_floats`` mirrors the kernel's layout
(the wrapper checks it against the built library on the card).
``ring_matmul`` is the consumers' sum: each slab's rows split over
``ks_n`` partial sums per column quad, each partial added over the slabs
in order, the partials added in the order ks = 0, 1, ...
"""

import ctypes
from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from audio_denoising_torch.ops.kernels.common import (
    KTHREADS, KTILE, cell_layout_floats, round4)

SMEM_LIMIT = 232448      # an H100 block's opt-in shared memory, bytes
CONSUMERS = KTHREADS - 32   # kConsumers: the last warp is the producer
CLUSTER = 2              # blocks per cluster the wrapper launches
STAGE_TARGET = 49152     # bytes a stage aims at; the ring takes the rest
MAX_STAGES = 8
MIN_STAGES = 2
MBARRIER_BYTES = 2 * 8   # full and empty, per stage
SLAB_ALIGN = 4           # rows a slab holds a multiple of, where it can


class RingSlab(ctypes.Structure):
    """Field-for-field mirror of AdtSlab in csrc/weight_ring.cuh."""
    _fields_ = [("src", ctypes.c_void_p), ("bytes", ctypes.c_int),
                ("rows", ctypes.c_int)]


class RingArgs(ctypes.Structure):
    """Field-for-field mirror of AdtRing in csrc/weight_ring.cuh."""
    _fields_ = [("slabs", ctypes.c_void_p)] + [
        (f, ctypes.c_int) for f in ("n_slabs", "stages", "stage_bytes",
                                    "cluster")]


class Matrix(NamedTuple):
    """A weight matrix as the kernel reads it: ``k`` rows of
    ``round4(n)`` floats from ``ptr``."""
    ptr: int
    k: int
    n: int


class Slab(NamedTuple):
    matrix: int     # index into the matrices
    row0: int
    rows: int
    nbytes: int
    src: int        # device address of the slab's first byte
    issuer: int     # the block of the cluster that copies it


def cell_matrices(p) -> List[Matrix]:
    """The plan's matrices of a ``common.PlanArgs`` in the order the
    kernel consumes them: down_w[0], reset_w, down_w[1..L-1], then up_w[i]
    and, where the level has a skip, up_s[i]."""
    L, n = p.levels, p.n_hidden
    down = [Matrix(p.down_w[i], p.down_n[i], p.down_n[i + 1])
            for i in range(L)]
    mats = [down[0], Matrix(p.reset_w, n, 3 * n)] + down[1:]
    for i in range(L):
        mats.append(Matrix(p.up_w[i], p.up_n[i], p.up_n[i + 1]))
        if p.up_s[i]:
            mats.append(Matrix(p.up_s[i], p.down_n[L - i], p.up_n[i + 1]))
    return mats


def consumer_split(n: int) -> int:
    """How many ways the consumers split a slab's rows per column quad
    for a matrix ``n`` wide, before the slab's own rows cap it: as many
    as the column quads leave threads for and the scratch holds partial
    sums for (1 when the quads outnumber the threads)."""
    ldw = round4(n)
    n4 = ldw // 4
    if n4 > CONSUMERS:
        return 1
    return max(1, min(CONSUMERS // n4, 4 * KTHREADS // ldw))


def slab_rows(m: Matrix, stage_bytes: int) -> int:
    """Rows of ``m`` in each of its slabs but the last: as many whole
    rows as a stage holds, rounded down to a multiple of SLAB_ALIGN times
    ``consumer_split`` (every split then gets the same rows), else of
    SLAB_ALIGN, where the stage holds that many; at most ``m.k``."""
    rows = stage_bytes // (4 * round4(m.n))
    for step in (SLAB_ALIGN * consumer_split(m.n), SLAB_ALIGN):
        if rows >= step:
            rows = rows // step * step
            break
    return min(rows, m.k)


def ring_geometry(layout_bytes: int, mats: Sequence[Matrix],
                  limit: int = SMEM_LIMIT) -> Tuple[int, int]:
    """(stages, stage_bytes) of the ring in what ``layout_bytes`` leaves
    of ``limit``: about STAGE_TARGET bytes a stage, MIN_STAGES to
    MAX_STAGES stages. Raises where the ring gets fewer than MIN_STAGES
    stages that each hold a slab of every matrix."""
    free = limit - layout_bytes
    stages = max(MIN_STAGES, min(MAX_STAGES,
                                 free // (STAGE_TARGET + MBARRIER_BYTES)))
    stage_bytes = (free // stages - MBARRIER_BYTES) // 16 * 16
    need = max(4 * round4(m.n) for m in mats)
    if stage_bytes < need:
        raise RuntimeError(
            f"the weight ring needs {MIN_STAGES} stages of at least {need} B "
            f"(a row of the widest matrix) beside a layout of "
            f"{layout_bytes} B; a block has {limit} B of shared memory")
    return stages, stage_bytes


def slab_schedule(mats: Sequence[Matrix], stage_bytes: int,
                  cluster: int = CLUSTER) -> List[Slab]:
    """Each matrix cut into slabs of ``slab_rows`` rows, in order; slab j
    issued by block ``j % cluster``. Raises unless every slab is 16-byte
    aligned and a multiple of 16 bytes long."""
    slabs: List[Slab] = []
    for i, m in enumerate(mats):
        ld_bytes = 4 * round4(m.n)
        step = slab_rows(m, stage_bytes)
        for row0 in range(0, m.k, step):
            rows = min(step, m.k - row0)
            src = m.ptr + row0 * ld_bytes
            nbytes = rows * ld_bytes
            if src % 16 or nbytes % 16:
                raise ValueError(f"slab {len(slabs)} of matrix {i} is not "
                                 f"16-byte aligned")
            slabs.append(Slab(i, row0, rows, nbytes, src,
                              len(slabs) % cluster))
    return slabs


class WeightRing:
    """The ring's launch arguments (``args``, an AdtRing) for ``mats``
    beside a layout of ``layout_bytes``, with the schedule's table on
    ``device``."""

    def __init__(self, mats: Sequence[Matrix], layout_bytes: int,
                 device: torch.device):
        self.layout_bytes = layout_bytes
        self.stages, self.stage_bytes = ring_geometry(layout_bytes, mats)
        self.slabs = slab_schedule(mats, self.stage_bytes)
        table = (RingSlab * len(self.slabs))(
            *(RingSlab(s.src, s.nbytes, s.rows) for s in self.slabs))
        self.table = torch.from_numpy(
            np.frombuffer(bytes(table), dtype=np.uint8).copy()).to(device)
        self.args = RingArgs(self.table.data_ptr(), len(self.slabs),
                             self.stages, self.stage_bytes, CLUSTER)

    @property
    def smem_bytes(self) -> int:
        """The block's whole dynamic shared memory: layout and ring."""
        return self.layout_bytes + self.stages * (self.stage_bytes
                                                  + MBARRIER_BYTES)


# -- the consumers' order of addition, in plain PyTorch ------------------------

def ring_matmul(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                stage_bytes: int) -> torch.Tensor:
    """sum_i a_i @ w_i as the ring's consumers add it: the sources' k
    rows laid end to end in their slabs; ks_n = min(consumer_split(n),
    ceil(rows of the first slab / 4)) splits of each slab, split ks taking
    rows [ks sub, (ks + 1) sub) of every slab with sub = round4(ceil(rows
    / ks_n)); each split's sum runs over its rows in order, and the splits
    are added in the order ks = 0, 1, ..."""
    n = pairs[0][1].shape[1]
    cuts = []   # (source, row0, rows) per slab, in order
    for src, (_, w) in enumerate(pairs):
        step = slab_rows(Matrix(0, w.shape[0], n), stage_bytes)
        cuts += [(src, r0, min(step, w.shape[0] - r0))
                 for r0 in range(0, w.shape[0], step)]
    ks_n = max(1, min(consumer_split(n), (cuts[0][2] + 3) // 4))
    out = None
    for ks in range(ks_n):
        rows = [[] for _ in pairs]
        for src, r0, n_rows in cuts:
            sub = round4(-(-n_rows // ks_n))
            lo = min(n_rows, ks * sub)
            rows[src].extend(range(r0 + lo, r0 + min(n_rows, lo + sub)))
        a = torch.cat([p[0][:, r] for p, r in zip(pairs, rows)], dim=1)
        w = torch.cat([p[1][r] for p, r in zip(pairs, rows)], dim=0)
        part = a @ w
        out = part if out is None else out + part
    return out


def ring_gemm(stage_bytes: int) -> Callable:
    """``common.plan_cell_math``'s ``gemm`` as the ring adds it."""
    def gemm(pairs, bias):
        return ring_matmul(pairs, stage_bytes) + bias
    return gemm

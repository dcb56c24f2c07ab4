"""The fused cell's weight ring (``ops/kernels/weight_ring.py``,
``csrc/weight_ring.cuh``) on the CPU: the slab schedule the wrapper
passes to the kernel, for the plans the port serves, and the plain
PyTorch mirror of the order in which the ring's consumers add, against
``FusedCell.reference`` and against the JAX package's ``plan_cell_math``
and ``make_fused_cell`` kernel in interpret mode. The kernel itself is
held against its plain version on the card by chip_smoke.py."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.ops.pallas.common import (
    pack_plan_weights as jax_pack_plan_weights,
    plan_cell_math as jax_plan_cell_math)
from audio_denoising_tpu.ops.pallas.gruunet_cell import (
    make_fused_cell as jax_make_fused_cell)
from audio_denoising_tpu.runtime.plan import (
    build_cell_plan as jax_build_cell_plan,
    build_cell_plan_momo as jax_build_cell_plan_momo)

from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.ops.kernels import weight_ring as wr
from audio_denoising_torch.ops.kernels.common import (
    plan_args, plan_cell_math)
from audio_denoising_torch.ops.kernels.fused_cell import make_fused_cell
from audio_denoising_torch.runtime.plan import build_cell_plan

HERE = os.path.dirname(os.path.abspath(__file__))
RUNS = os.path.join(HERE, "..", "runs")
ATOL = 1e-5    # tests/test_torch_fused_cell.py's bound on the cell
PLANS = ["gruunet2-good", "gruunet2s16kw40-mrstft-idp-50k.npz",
         "gruunet2mel128d5w64-mrstft-50k.npz", "momo3-4d4ea0"]


def _spec(name):
    return name if not name.endswith(".npz") else os.path.join(RUNS, name)


@pytest.fixture(scope="module")
def served():
    """{plan name: (FusedCell on the CPU, its matrices in consumption
    order, layout bytes, the WeightRing its wrapper builds on the card,
    here on CPU tensors)}."""
    out = {}
    for name in PLANS:
        cell = make_fused_cell(build_cell_plan(load_pretrained(
            _spec(name))[1]), "cpu")
        keep = []
        p = plan_args(cell.weights, cell.skip_flags, cell.n_feat, cell.n,
                      keep, cell.delta)
        mats, layout = wr.cell_matrices(p), 4 * wr.cell_layout_floats(p)
        out[name] = (cell, mats, layout,
                     wr.WeightRing(mats, layout, torch.device("cpu")), keep)
    return out


@pytest.mark.parametrize("name", PLANS)
def test_slab_schedule_covers_each_matrix_once_in_order(served, name):
    cell, mats, _, ring, _ = served[name]
    # down_w per level, reset_w, up_w per level, up_s per skip
    assert len(mats) == 2 * len(cell.skip_flags) + 1 + sum(cell.skip_flags)
    covered = [0] * len(mats)
    order = []
    for s in ring.slabs:
        m = mats[s.matrix]
        assert s.row0 == covered[s.matrix], "rows skipped or repeated"
        assert s.src == m.ptr + 4 * wr.round4(m.n) * s.row0
        covered[s.matrix] += s.rows
        if not order or order[-1] != s.matrix:
            order.append(s.matrix)
    assert covered == [m.k for m in mats]
    assert order == list(range(len(mats)))   # consumption order


@pytest.mark.parametrize("name", PLANS)
def test_slabs_are_aligned_and_fit_a_stage(served, name):
    _, mats, _, ring, _ = served[name]
    for s in ring.slabs:
        assert s.src % 16 == 0 and s.nbytes % 16 == 0
        assert 0 < s.nbytes <= ring.stage_bytes
        assert s.nbytes == s.rows * 4 * wr.round4(mats[s.matrix].n)
        # all slabs but a matrix's last hold a multiple of SLAB_ALIGN
        # rows, or as many rows as a stage holds
        last = s.row0 + s.rows == mats[s.matrix].k
        row = s.nbytes // s.rows
        assert last or s.rows % wr.SLAB_ALIGN == 0 or \
            s.nbytes + row > ring.stage_bytes


@pytest.mark.parametrize("name", PLANS)
def test_ring_and_layout_fit_a_block(served, name):
    _, _, layout, ring, _ = served[name]
    assert ring.stages >= 2 and ring.stage_bytes % 16 == 0
    assert layout % 16 == 0
    assert ring.smem_bytes == layout + ring.stages * (ring.stage_bytes + 16)
    assert ring.smem_bytes <= 232448
    args = ring.args
    assert (args.n_slabs, args.stages, args.stage_bytes, args.cluster) == (
        len(ring.slabs), ring.stages, ring.stage_bytes, wr.CLUSTER)
    assert ring.table.numel() == 16 * len(ring.slabs)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("name", PLANS)
def test_issuers_spread_evenly_over_the_cluster(served, name, cluster):
    _, mats, _, ring, _ = served[name]
    slabs = wr.slab_schedule(mats, ring.stage_bytes, cluster)
    counts = np.bincount([s.issuer for s in slabs], minlength=cluster)
    assert len(counts) == cluster and counts.max() - counts.min() <= 1
    assert [s.issuer for s in slabs[:cluster]] == list(range(cluster))


def test_ring_geometry_refuses_too_little_room():
    mats = [wr.Matrix(0, 64, 4096)]      # 16 KiB rows
    stages, stage = wr.ring_geometry(232448 - 2 * (16384 + 16), mats)
    assert (stages, stage) == (2, 16384)
    with pytest.raises(RuntimeError, match="2 stages"):
        wr.ring_geometry(232448 - 2 * (16384 + 16) + 16, mats)


@pytest.mark.parametrize("shape", [
    (3, 300, 64, 0),      # narrow: k split 15 ways within each slab
    (2, 640, 321, 0),     # the DFT's 321 bins
    (2, 64, 8000, 0),     # more column quads than consumer threads
    (3, 136, 272, 68),    # a split matmul: two sources, one sum
])
def test_ring_matmul_is_the_matmul(shape):
    b, k1, n, k2 = shape
    rng = np.random.default_rng(k1 + n)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    pairs = [(t(b, k1), t(k1, n))] + ([(t(b, k2), t(k2, n))] if k2 else [])
    want = sum(a.double() @ w.double() for a, w in pairs)
    for rows in (1, 6, 40):   # slabs of 1, 4 and 40 rows
        got = wr.ring_matmul(pairs, rows * 4 * wr.round4(n))
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   atol=1e-4, rtol=1e-5)


def _cell_inputs(batch, n_feat, n, seed, delta=False):
    """(x, hx), and prev for a delta plan: features >= 0 as the hop makes
    them, a state in (-1, 1)."""
    rng = np.random.default_rng(seed)
    x = np.log1p(4 * rng.random((batch, n_feat))).astype(np.float32)
    hx = (2 * rng.random((batch, n)) - 1).astype(np.float32)
    if not delta:
        return x, hx
    return x, hx, np.log1p(4 * rng.random((batch, n_feat))).astype(
        np.float32)


@pytest.mark.parametrize("name", PLANS)
def test_ring_mirror_matches_the_reference(served, name):
    """The consumers' order of addition (ring_gemm) at the ring the
    wrapper builds, against FusedCell.reference."""
    cell, _, _, ring, _ = served[name]
    for batch in (1, 3, 64):
        x, hx, *prev = map(torch.from_numpy, _cell_inputs(
            batch, cell.n_feat, cell.n, batch, cell.delta))
        prev = prev[0] if prev else None
        y, h = plan_cell_math(cell.weights, cell.skip_flags, cell.n, x, hx,
                              wr.ring_gemm(ring.stage_bytes), prev=prev)
        ry, rh = cell.reference(x, hx, prev)
        torch.testing.assert_close(y, ry, rtol=0, atol=ATOL)
        torch.testing.assert_close(h, rh, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", PLANS)
def test_ring_mirror_matches_jax(served, name):
    """Against the JAX package's plan_cell_math and its fused-cell kernel
    in interpret mode, on numpy inputs (3 streams, the ragged edge of a
    kernel tile)."""
    cell, _, _, ring, _ = served[name]
    _, jmodel, params = jax_load_pretrained(_spec(name))
    jplan = (jax_build_cell_plan_momo if cell.delta
             else jax_build_cell_plan)(jmodel, params)
    jw, jflags = jax_pack_plan_weights(jplan)
    x, hx, *prev = _cell_inputs(3, cell.n_feat, cell.n, 11, cell.delta)
    jprev = [jnp.asarray(p) for p in prev]
    y, h = plan_cell_math(cell.weights, cell.skip_flags, cell.n,
                          torch.from_numpy(x), torch.from_numpy(hx),
                          wr.ring_gemm(ring.stage_bytes),
                          prev=torch.from_numpy(prev[0]) if prev else None)
    jy, jh = jax_plan_cell_math(jw, jflags, cell.n, cell.n_feat, cell.delta,
                                jnp.asarray(x), jnp.asarray(hx), *jprev)
    ky, kh = jax_make_fused_cell(jplan, interpret=True)(
        jnp.asarray(x), jnp.asarray(hx), *jprev)
    for got, want in ((y, jy), (h, jh), (y, ky), (h, kh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_momo3_plan_is_one_pass_of_small_slabs(served):
    """MOMO3-4d4ea0's nine matrices (320 KB padded) against the ring its
    wrapper builds: level 0 reads cat(x, prev), 44 rows, and is streamed
    as any matrix; the whole plan is one pass of slabs that each fit a
    stage."""
    cell, mats, layout, ring, _ = served["momo3-4d4ea0"]
    assert cell.delta and mats[0].k == 2 * cell.n_feat == 44
    assert [(m.k, m.n) for m in mats] == [
        (44, 176), (48, 144), (176, 80), (80, 144), (48, 80), (80, 176),
        (80, 176), (176, 22), (176, 22)]
    plan_bytes = sum(4 * m.k * wr.round4(m.n) for m in mats)
    assert 300_000 < plan_bytes < 340_000
    assert sum(s.nbytes for s in ring.slabs) == plan_bytes
    assert ring.stages == 4 and len(ring.slabs) > ring.stages
    assert layout + ring.stages * (ring.stage_bytes + 16) <= 232448

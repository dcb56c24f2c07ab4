"""The port's fused cell and PlanModel against the JAX package on the CPU:
``FusedCell``'s plain version and ``PlanModel`` (fused and not, one frame
and sequences through ``plan_apply_parallel``) against JAX's
``make_fused_cell`` kernel in interpret mode and its ``PlanModel``, on
the same weights, also with a MOMO3 plan's delta branch (``prev``), and
the wrapper's checks. The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu.config import ModelConfig as JaxModelConfig
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.models import build_model as jax_build_model
from audio_denoising_tpu.ops.pallas.gruunet_cell import (
    make_fused_cell as jax_make_fused_cell)
from audio_denoising_tpu.runtime.plan import (
    PlanModel as JaxPlanModel, build_cell_plan as jax_build_cell_plan,
    build_cell_plan_momo as jax_build_cell_plan_momo)

from audio_denoising_torch.compat import params_from_jax
from audio_denoising_torch.config import ModelConfig
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.models import build_model
from audio_denoising_torch.ops.kernels.fused_cell import (
    FusedCell, make_fused_cell)
from audio_denoising_torch.runtime.plan import (
    PlanModel, build_cell_plan, plan_apply_parallel, plan_cell)

ATOL = 1e-5    # tests/test_torch_model_plan.py's bound on the plan cell
# a five-level plan of small width: 64 -> 32 -> 16 -> 8 -> 4 -> 2 bins
FIVE_LEVELS = dict(arch="GRUUNet2", num_compressed_bins=2,
                   hidden_sizes=(3,) * 5, kernel_sizes=(3,) * 5,
                   strides=(2,) * 5, paddings=(1,) * 5, num_gaussians=3)


def _port_model(jmodel, params, mc):
    return build_model(mc, num_bins=jmodel.num_bins).load_params(
        params_from_jax({k: np.asarray(v) for k, v in params.items()}))


@pytest.fixture(scope="module")
def good():
    jcfg, jmodel, params = jax_load_pretrained("gruunet2-good")
    return jmodel, params, _port_model(jmodel, params, ModelConfig())


@pytest.fixture(scope="module")
def five():
    jmodel = jax_build_model(JaxModelConfig(**FIVE_LEVELS), num_bins=64)
    params = jmodel.init(jax.random.PRNGKey(5))
    return jmodel, params, _port_model(jmodel, params,
                                       ModelConfig(**FIVE_LEVELS))


def _inputs(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, 64)).astype(np.float32),
            rng.standard_normal((batch, n)).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("batch", [1, 3, 130])
def test_plain_cell_matches_jax_kernel(good, batch):
    """130 is a ragged tile of the port's kernel and crosses the JAX
    wrapper's padding to 128-row tiles."""
    jmodel, params, model = good
    jcell = jax_make_fused_cell(jax_build_cell_plan(jmodel, params),
                                interpret=True)
    cell = make_fused_cell(build_cell_plan(model), "cpu")
    x, hx = _inputs(batch, 68, batch)
    jy, jh = jcell(jnp.asarray(x), jnp.asarray(hx))
    y, h = cell(torch.from_numpy(x), torch.from_numpy(hx))
    assert y.shape == (batch, 64) and h.shape == (batch, 68)
    _close(y, jy)
    _close(h, jh)
    assert cell.launches == 0      # the plain version is not a launch


def test_plain_cell_matches_jax_kernel_five_levels(five):
    jmodel, params, model = five
    plan = build_cell_plan(model)
    assert len(plan.down_mats) == 5 and plan.hidden * plan.compressed == 6
    jcell = jax_make_fused_cell(jax_build_cell_plan(jmodel, params),
                                interpret=True)
    cell = make_fused_cell(plan, "cpu")
    x, hx = _inputs(9, 6, 9)
    jy, jh = jcell(jnp.asarray(x), jnp.asarray(hx))
    y, h = cell(torch.from_numpy(x), torch.from_numpy(hx))
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("frames", [1, 7])
def test_plan_model_matches_jax(good, fused, frames):
    """T = 1 goes through the cell (the kernel's plain version when
    fused), T = 7 through plan_apply_parallel; model-layout hx is taken."""
    jmodel, params, model = good
    jpm = JaxPlanModel(jmodel, params, fused=fused, interpret=True)
    pm = PlanModel(model, fused=fused, device="cpu")
    assert (pm.fused_cell is not None) == fused
    rng = np.random.default_rng(frames)
    x = rng.standard_normal((3, frames, 64)).astype(np.float32)
    hx = (0.5 * rng.standard_normal((3, 17, 4))).astype(np.float32)
    jy, jh = jpm.apply(None, jnp.asarray(x), jnp.asarray(hx))
    y, h = pm.apply(torch.from_numpy(x), torch.from_numpy(hx))
    assert y.shape == (3, frames, 64) and h.shape == (3, 68)
    _close(y, jy)
    _close(h, jh)
    flat = hx.reshape(3, -1)
    jy1, jh1 = jpm.cell(None, jnp.asarray(x[:, 0]), jnp.asarray(flat))
    y1, h1 = pm.cell(torch.from_numpy(x[:, 0]), torch.from_numpy(flat))
    _close(y1, jy1)
    _close(h1, jh1)


def test_parallel_apply_equals_the_cell_scanned(good):
    _, _, model = good
    plan = build_cell_plan(model)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 9, 64)).astype(np.float32))
    h = torch.from_numpy((0.1 * rng.standard_normal((2, 68))).astype(
        np.float32))
    ys, h1 = [], h
    for t in range(9):
        y, h1 = plan_cell(plan, x[:, t], h1)
        ys.append(y)
    y2, h2 = plan_apply_parallel(plan, x, h)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y2.numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=ATOL)


def test_plan_model_carry_interface(good):
    _, _, model = good
    pm = PlanModel(model, fused=True, device="cpu")
    assert pm.device.type == "cpu" and pm.num_bins == 64
    h = pm.init_carry(4)
    assert h.shape == (4, 68) and not h.any()
    assert torch.equal(pm.decay_carry(torch.ones(2, 68), 0.9),
                       torch.full((2, 68), 0.9))
    y, h2 = pm.apply(torch.zeros(1, 64))        # (T, F): one frame
    assert y.shape == (1, 1, 64) and h2.shape == (1, 68)


def test_plan_model_needs_a_card_unless_cpu_is_asked(good, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanModel(good[2], fused=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fused_cell(build_cell_plan(good[2]))


def test_fused_cell_refuses_delta_plans(good):
    """A delta plan whose level 0 does not take 2 x its output width
    (cat(x, prev)) is refused; well-formed delta plans are served
    (tests/test_torch_momo.py, test_delta_reference_matches_jax_kernel)."""
    plan = build_cell_plan(good[2])._replace(delta=True)
    with pytest.raises(ValueError, match="needs 128 level-0 rows"):
        make_fused_cell(plan, "cpu")


@pytest.mark.parametrize("case", ["x width", "hx width", "dtype", "device"])
def test_fused_cell_checks_its_inputs(good, case):
    cell = make_fused_cell(build_cell_plan(good[2]), "cpu")
    x, hx = torch.zeros(2, 64), torch.zeros(2, 68)
    err = ValueError
    if case == "x width":
        x = torch.zeros(2, 63)
    elif case == "hx width":
        hx = torch.zeros(2, 67)
    elif case == "dtype":
        x, err = x.double(), TypeError
    else:
        x = x.to("meta")
    with pytest.raises(err):
        cell(x, hx)
    assert isinstance(cell, FusedCell) and cell.launches == 0


# -- the delta (MOMO3) branch ------------------------------------------------

@pytest.fixture(scope="module")
def momo3():
    _, jmodel, params = jax_load_pretrained("momo3-4d4ea0")
    return (jax_build_cell_plan_momo(jmodel, params),
            build_cell_plan(load_pretrained("momo3-4d4ea0")[1]))


@pytest.mark.parametrize("batch", [1, 3, 130])
def test_delta_reference_matches_jax_kernel(momo3, batch):
    """FusedCell.reference with prev against JAX's make_fused_cell in
    interpret mode (gruunet_cell.py:60-83: level 0 split over x and
    prev), 1e-5."""
    jplan, plan = momo3
    assert plan.delta and plan.down_mats[0].shape == (44, 176)
    jcell = jax_make_fused_cell(jplan, interpret=True)
    cell = make_fused_cell(plan, "cpu")
    assert cell.delta and cell.n_feat == 22 and cell.n == 48
    rng = np.random.default_rng(batch)
    x = np.log1p(4 * rng.random((batch, 22))).astype(np.float32)
    prev = np.log1p(4 * rng.random((batch, 22))).astype(np.float32)
    hx = (2 * rng.random((batch, 48)) - 1).astype(np.float32)
    jy, jh = jcell(jnp.asarray(x), jnp.asarray(hx), jnp.asarray(prev))
    y, h = cell(torch.from_numpy(x), torch.from_numpy(hx),
                torch.from_numpy(prev))
    assert y.shape == (batch, 22) and h.shape == (batch, 48)
    _close(y, jy)
    _close(h, jh)
    ry, rh = cell.reference(torch.from_numpy(x), torch.from_numpy(hx),
                            torch.from_numpy(prev))
    assert torch.equal(ry, y) and torch.equal(rh, h)
    assert cell.launches == 0


@pytest.mark.parametrize("case", ["no prev", "prev to a plain plan",
                                  "prev width", "prev dtype"])
def test_delta_cell_checks_prev(momo3, good, case):
    _, plan = momo3
    cell = make_fused_cell(plan, "cpu")
    x, hx, prev = torch.zeros(2, 22), torch.zeros(2, 48), torch.zeros(2, 22)
    err = ValueError
    if case == "no prev":
        prev = None
    elif case == "prev to a plain plan":
        cell = make_fused_cell(build_cell_plan(good[2]), "cpu")
        x, hx, prev = torch.zeros(2, 64), torch.zeros(2, 68), torch.zeros(2,
                                                                          64)
    elif case == "prev width":
        prev = torch.zeros(2, 21)
    else:
        prev, err = prev.double(), TypeError
    with pytest.raises(err):
        cell(x, hx, prev)

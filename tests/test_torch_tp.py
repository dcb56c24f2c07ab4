"""The port's tensor-parallel plan cell (audio_denoising_torch/parallel/
tp.py) against the JAX package's (parallel/tp.py) on the same plan, as
tests/test_tp.py holds JAX's: the schedule (``step.modes``) equal, and
the outputs and hx within 2e-5 over a 4-frame rollout, over meshes of
D = 2, 4 and 8 (JAX's on its virtual CPU devices, the port's over ``cpu``
entries). Cases: the shipped GRUUNet2 (pure col/row alternation), the
5-level d5 preset (the gather where the parity breaks) and MOMO3's delta
plan (the concat with the previous frame)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu.config import PRESETS as JAX_PRESETS
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.models import build_model as jax_build_model
from audio_denoising_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audio_denoising_tpu.parallel.tp import (
    make_tp_plan_cell as jax_make_tp_plan_cell)
from audio_denoising_tpu.runtime.plan import (
    build_cell_plan as jax_build_cell_plan,
    build_cell_plan_momo as jax_build_cell_plan_momo)

from audio_denoising_torch.parallel import make_mesh, make_tp_plan_cell
from audio_denoising_torch.runtime.plan import plan_cell, plan_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small tensors: one intra-op thread, so workers running side by
    side do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 2e-5          # tests/test_tp.py's bound
FRAMES = 4
B = 4


def _plan(case):
    """JAX's CellPlan of the case and its feature width."""
    if case == "d5":
        cfg = JAX_PRESETS["gruunet2-mel128d5"]
        model = jax_build_model(cfg.model, num_bins=cfg.dsp.n_mels)
        return (jax_build_cell_plan(model, model.init(jax.random.PRNGKey(0))),
                cfg.dsp.n_mels)
    spec = "gruunet2-good" if case == "good" else "momo3-4d4ea0"
    _, model, params = jax_load_pretrained(spec)
    build = jax_build_cell_plan_momo if case == "momo3" else \
        jax_build_cell_plan
    return build(model, params), (model.num_bins if case == "momo3" else 64)


@pytest.fixture(scope="module")
def plans():
    return {case: _plan(case) for case in ("good", "d5", "momo3")}


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("case", ["good", "d5", "momo3"])
def test_tp_plan_cell_matches_jax(plans, case, D):
    jplan, F = plans[case]
    plan = plan_from_numpy(jplan)
    jstep_raw = jax_make_tp_plan_cell(jplan, jax_make_mesh(D, "tp"))
    step = make_tp_plan_cell(plan, make_mesh(devices=["cpu"] * D,
                                             axis_name="tp"))
    assert step.modes == jstep_raw.modes
    if case == "good":
        assert step.modes["down"] == step.modes["up"] == \
            ["col", "row", "col", "row"]
    if case == "d5" and D < 8:     # at D = 8 the row splits all divide
        assert "gather-row" in step.modes["down"] + step.modes["up"] \
            or step.modes["gates_gather"] or step.modes["out_gather"]
    jstep = jax.jit(jstep_raw)
    n = plan.hidden * plan.compressed
    rng = np.random.default_rng(D)
    hx = (0.1 * rng.standard_normal((B, n))).astype(np.float32)
    jhx, thx, rhx = jnp.asarray(hx), torch.from_numpy(hx), torch.from_numpy(hx)
    prev = None
    for t in range(FRAMES):
        x = (0.3 * rng.standard_normal((B, F))).astype(np.float32)
        if plan.delta:
            prev = x if t == 0 else prev    # delta 0 at t = 0 (MOMO3)
            jy, jhx = jstep(jnp.asarray(x), jhx, jnp.asarray(prev))
            ty, thx = step(torch.from_numpy(x), thx, torch.from_numpy(prev))
            ry, rhx = plan_cell(plan, torch.from_numpy(x), rhx,
                                torch.from_numpy(prev))
            prev = x
        else:
            jy, jhx = jstep(jnp.asarray(x), jhx)
            ty, thx = step(torch.from_numpy(x), thx)
            ry, rhx = plan_cell(plan, torch.from_numpy(x), rhx)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
        np.testing.assert_allclose(thx.numpy(), np.asarray(jhx), atol=ATOL)
        np.testing.assert_allclose(ty.numpy(), ry.numpy(), atol=ATOL)
        np.testing.assert_allclose(thx.numpy(), rhx.numpy(), atol=ATOL)


def test_tp_delta_plan_needs_prev(plans):
    plan = plan_from_numpy(plans["momo3"][0])
    step = make_tp_plan_cell(plan, make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="prev"):
        step(torch.zeros(1, plans["momo3"][1]),
             torch.zeros(1, plan.hidden * plan.compressed))


def test_tp_non_dividing_mesh_falls_back_to_replicated(plans):
    """D = 3 divides few of the 17-channel widths: those levels run
    whole on every entry, never with wrong numbers (test_tp.py's
    test_parity_non_divisible_falls_back)."""
    plan = plan_from_numpy(plans["good"][0])
    step = make_tp_plan_cell(plan, make_mesh(devices=["cpu"] * 3))
    assert "rep" in step.modes["down"]
    rng = np.random.default_rng(3)
    x = torch.from_numpy((0.3 * rng.standard_normal((2, 64))).astype(
        np.float32))
    hx = torch.from_numpy((0.1 * rng.standard_normal(
        (2, plan.hidden * plan.compressed))).astype(np.float32))
    for got, want in zip(step(x, hx), plan_cell(plan, x, hx)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)

"""The port's GRUUNet2 module and matrixized cell plan against the JAX
package and the reference goldens, on the CPU."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.models import build_model as jax_build_model
from audio_denoising_tpu.runtime.plan import (
    build_cell_plan as jax_build_cell_plan, plan_cell as jax_plan_cell)

from audio_denoising_torch.compat import load_params_npz, params_from_jax
from audio_denoising_torch.config import ModelConfig
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.models import build_model
from audio_denoising_torch.ops.kernels.common import (
    pack_plan_weights, plan_cell_math)
from audio_denoising_torch.runtime.plan import (
    build_cell_plan, plan_cell, plan_from_numpy)

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "..", "checkpoints")
GOLD = os.path.join(HERE, "goldens")
GOLDEN_TOL = dict(atol=5e-5, rtol=1e-4)   # tests/test_models.py's bound
RUNS = os.path.join(HERE, "..", "runs")
CKPTS = [("gruunet2-good.npz", "model_GRUUNet2-good"),
         ("gruunet2-dari_tult.npz", "model_GRUUNet2-dari_tult")]


def _models(name):
    params, meta = load_params_npz(os.path.join(CKPT, name))
    mc = ModelConfig.from_reference_dict(meta["arch"], meta["config"])
    model = build_model(mc, num_bins=64).load_params(params_from_jax(params))
    jax_model = jax_build_model(mc, num_bins=64)
    return model, jax_model, {k: jnp.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def good():
    model, jax_model, jax_params = _models("gruunet2-good.npz")
    return (model, jax_model, jax_params, build_cell_plan(model),
            jax_build_cell_plan(jax_model, jax_params))


@pytest.mark.parametrize("ckpt,golden", CKPTS)
def test_apply_matches_golden(ckpt, golden):
    model = _models(ckpt)[0]
    g = np.load(os.path.join(GOLD, golden + ".npz"))
    with torch.no_grad():
        out, hx = model.apply(torch.from_numpy(g["x"]))
        np.testing.assert_allclose(out.numpy(), g["out"], **GOLDEN_TOL)
        np.testing.assert_allclose(hx.numpy(), g["hx"], **GOLDEN_TOL)
        out2, _ = model.apply(torch.from_numpy(g["x"][:, :3]), hx)
        np.testing.assert_allclose(out2.numpy(), g["out2"], **GOLDEN_TOL)
        o2d, _ = model.apply(torch.from_numpy(g["x"][0]))
        np.testing.assert_allclose(o2d.numpy(), g["out_2d"], **GOLDEN_TOL)


@pytest.mark.parametrize("ckpt,golden", CKPTS)
def test_cell_and_apply_match_jax(ckpt, golden, rng):
    model, jax_model, jax_params = _models(ckpt)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    hx = rng.standard_normal((3, 17, 4)).astype(np.float32)
    with torch.no_grad():
        y, h = model.cell(torch.from_numpy(x[:, 0]), torch.from_numpy(hx))
        ys, hs = model.apply(torch.from_numpy(x), torch.from_numpy(hx))
    jy, jh = jax_model.cell(jax_params, jnp.asarray(x[:, 0]), jnp.asarray(hx))
    jys, jhs = jax_model.apply(jax_params, jnp.asarray(x), jnp.asarray(hx))
    for a, b in ((y, jy), (h, jh), (ys, jys), (hs, jhs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_load_params_checks_smearing_offsets():
    params, meta = load_params_npz(os.path.join(CKPT, "gruunet2-good.npz"))
    mc = ModelConfig.from_reference_dict(meta["arch"], meta["config"])
    params["cell.input_gate.gs.offset"] = params[
        "cell.input_gate.gs.offset"] * 2
    with pytest.raises(ValueError, match="offsets"):
        build_model(mc, 64).load_params(params_from_jax(params))


def test_build_cell_plan_matches_jax(good):
    _, _, _, plan, jplan = good
    ours = plan_from_numpy(jplan)
    assert (plan.hidden, plan.compressed, plan.delta) == \
        (ours.hidden, ours.compressed, ours.delta)
    pairs = list(zip(plan.down_mats + plan.down_biases + plan.up_h_mats
                     + plan.up_biases, ours.down_mats + ours.down_biases
                     + ours.up_h_mats + ours.up_biases))
    pairs += [(plan.reset_mat, ours.reset_mat),
              (plan.reset_bias, ours.reset_bias)]
    pairs += [(a, b) for a, b in zip(plan.up_s_mats, ours.up_s_mats)
              if a is not None or b is not None]
    assert plan.up_s_mats[0] is None and ours.up_s_mats[0] is None
    for a, b in pairs:
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)
    # the gruunet2-good plan's matrices: 0.71 M floats
    assert sum(a.numel() for a, _ in pairs if a.dim() == 2) == 710192


def test_plan_cell_matches_jax_and_the_model(good, rng):
    model, _, _, plan, jplan = good
    x = rng.standard_normal((5, 64)).astype(np.float32)
    hx = rng.standard_normal((5, 68)).astype(np.float32)
    y, h = plan_cell(plan, torch.from_numpy(x), torch.from_numpy(hx))
    jy, jh = jax_plan_cell(jplan, jnp.asarray(x), jnp.asarray(hx))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    with torch.no_grad():
        my, mh = model.cell(torch.from_numpy(x),
                            torch.from_numpy(hx).reshape(5, 17, 4))
    np.testing.assert_allclose(y.numpy(), my.numpy(), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), mh.reshape(5, -1).numpy(),
                               atol=1e-5)


def test_plan_cell_math_matches_plan_cell(good, rng):
    plan = good[3]
    weights, skip_flags = pack_plan_weights(plan)
    assert skip_flags == [False, True, True, True]
    assert len(weights) == 2 * 4 + 2 + 2 * 4 + 3
    x = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))
    hx = torch.from_numpy(rng.standard_normal((6, 68)).astype(np.float32))
    y, h = plan_cell_math(weights, skip_flags, 68, x, hx)
    py, ph = plan_cell(plan, x, hx)
    torch.testing.assert_close(y, py, rtol=0, atol=1e-6)
    torch.testing.assert_close(h, ph, rtol=0, atol=1e-6)


def test_params_from_jax_keeps_reference_keys():
    params, _ = load_params_npz(os.path.join(CKPT, "gruunet2-good.npz"))
    sd = params_from_jax(params)
    assert set(sd) == set(params)
    assert "cell.input_gate.downs.0.conv.weight" in sd
    for k, v in sd.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), params[k])


@pytest.mark.parametrize("name", ["gruunet2-realnoise-50k.npz",
                                  "gruunet2s16kw40-mrstft-idp-50k.npz"])
def test_hub_loads_trained_npz_like_jax(name, rng):
    """Trained checkpoints embed their whole config (the second is
    16 kHz with hidden width 40): both hubs resolve the same config and
    the same model."""
    path = os.path.join(RUNS, name)
    cfg, model = load_pretrained(path)
    jcfg, jmodel, jparams = jax_load_pretrained(path)
    assert cfg.to_json() == jcfg.to_json()
    x = rng.standard_normal((2, 4, cfg.dsp.n_mels)).astype(np.float32)
    with torch.no_grad():
        y, h = model.apply(torch.from_numpy(x))
    jy, jh = jmodel.apply(jparams, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)

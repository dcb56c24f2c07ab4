"""The port's MOMO family and raw-spectrogram domain against the JAX
package on the CPU: MOMO, MOMO2 and MOMO3 against the reference goldens
and JAX's models (cell, carry, apply); the MOMO plan (delta level 0),
``plan_cell``, ``plan_apply_parallel`` and ``PlanModel`` (fused or not)
against JAX's ``runtime/plan.py``; the raw-domain fast step with the
delta carry against JAX's ``make_fast_step``; ``StreamEngine`` modes
'fast' and 'fused' against the JAX engine (its fused hop in interpret
mode), with masked commits that hold back hx and prev; ``load_pretrained``
for both MOMO3 files; and ``EngineDaemon`` serving MOMO3. Each case feeds
both packages the same numpy inputs from a seed."""

import dataclasses
import os
import threading
from multiprocessing.connection import Client

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_denoising_tpu.config import ModelConfig as JaxModelConfig
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.models import build_model as jax_build_model
from audio_denoising_tpu.runtime.engine import (
    StreamEngine as JaxEngine, fast_init_state as jax_fast_init_state,
    make_fast_step as jax_make_fast_step)
from audio_denoising_tpu.runtime.plan import (
    PlanModel as JaxPlanModel, build_cell_plan_momo as jax_build_plan,
    plan_apply_parallel as jax_plan_apply_parallel,
    plan_cell as jax_plan_cell)

from audio_denoising_torch.apps.engine_serve import EngineDaemon
from audio_denoising_torch.compat import load_params_npz, params_from_jax
from audio_denoising_torch.config import ModelConfig, recommended_serving
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.models import MOMO, MOMO2, MOMO3, build_model
from audio_denoising_torch.runtime.engine import (
    StreamEngine, fast_init_state, make_fast_step)
from audio_denoising_torch.runtime.plan import (
    PlanModel, build_cell_plan, build_cell_plan_momo, plan_apply_parallel,
    plan_cell)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "goldens")
REALNOISE = os.path.join(HERE, "..", "runs", "momo3-realnoise.npz")
GOLDEN_TOL = dict(atol=5e-5, rtol=1e-4)   # tests/test_models.py's bound
ATOL = 1e-5          # the models' and the plan cell's bound
OUT_ATOL = 2e-4      # a hop's output (tests/test_fused_hop.py)
HOPS = 8
# the geometry of tests/test_models.py's random-weight goldens
RAND_GEO = dict(num_compressed_bins=3, hidden_sizes=(16, 16, 16),
                kernel_sizes=(3, 3, 3), strides=(2, 2, 2),
                paddings=(1, 0, 1))


def _golden(name):
    return np.load(os.path.join(GOLD, name + ".npz"))


def _golden_params(g):
    return {k[3:]: g[k] for k in g.files if k.startswith("sd.")}


def _models(arch):
    """(port model, JAX model, JAX params) for ``arch``: MOMO3 on the
    shipped checkpoint, MOMO2 and MOMO on the goldens' random weights."""
    if arch == "MOMO3":
        (_, jmodel, jparams), (_, model) = (
            jax_load_pretrained("momo3-4d4ea0"),
            load_pretrained("momo3-4d4ea0"))
        return model, jmodel, jparams
    params = _golden_params(_golden(f"model_{arch}-rand"))
    model = build_model(ModelConfig(arch=arch, **RAND_GEO)).load_params(
        params_from_jax(params))
    jmodel = jax_build_model(JaxModelConfig(arch=arch, **RAND_GEO))
    return model, jmodel, {k: jnp.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def momo3():
    return _models("MOMO3")


@pytest.mark.parametrize("arch,golden", [
    ("MOMO3", "model_MOMO3-4d4ea0"), ("MOMO2", "model_MOMO2-rand"),
    ("MOMO", "model_MOMO-rand")])
def test_apply_matches_golden(arch, golden):
    model = _models(arch)[0]
    assert type(model).__name__ == arch
    g = _golden(golden)
    with torch.no_grad():
        out, hx = model.apply(torch.from_numpy(g["x"]))
        np.testing.assert_allclose(out.numpy(), g["out"], **GOLDEN_TOL)
        np.testing.assert_allclose(hx.numpy(), g["hx"], **GOLDEN_TOL)
        if "out2" in g.files:        # continued from the carried hx
            out2, _ = model.apply(torch.from_numpy(g["x"][:, :3]), hx)
            np.testing.assert_allclose(out2.numpy(), g["out2"],
                                       **GOLDEN_TOL)
            o2d, _ = model.apply(torch.from_numpy(g["x"][0]))
            np.testing.assert_allclose(o2d.numpy(), g["out_2d"],
                                       **GOLDEN_TOL)


@pytest.mark.parametrize("arch", ["MOMO3", "MOMO2", "MOMO"])
def test_cell_carry_and_apply_match_jax(arch, rng):
    model, jmodel, jparams = _models(arch)
    B, T, F = 3, 5, 22
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    state = (B, F) if arch == "MOMO" else (B, 16, 3)
    hx = (0.5 * rng.standard_normal(state)).astype(np.float32)
    prev = rng.standard_normal((B, F)).astype(np.float32)
    carry, jcarry = ((torch.from_numpy(hx), torch.from_numpy(prev)),
                     (jnp.asarray(hx), jnp.asarray(prev))) \
        if arch == "MOMO3" else (torch.from_numpy(hx), jnp.asarray(hx))
    with torch.no_grad():
        y, c2 = model.cell(torch.from_numpy(x[:, 0]), carry)
        ys, hs = model.apply(torch.from_numpy(x), torch.from_numpy(hx))
    jy, jc2 = jmodel.cell(jparams, jnp.asarray(x[:, 0]), jcarry)
    jys, jhs = jmodel.apply(jparams, jnp.asarray(x), jnp.asarray(hx))
    pairs = [(y, jy), (ys, jys), (hs, jhs)]
    if arch == "MOMO3":
        pairs += [(c2[0], jc2[0]), (c2[1], jc2[1])]
        assert torch.equal(c2[1], torch.from_numpy(x[:, 0]))   # prev' = x
        with torch.no_grad():
            yp, _ = model.apply(torch.from_numpy(x), torch.from_numpy(hx),
                                torch.from_numpy(prev))
        jyp, _ = jmodel.apply(jparams, jnp.asarray(x), jnp.asarray(hx),
                              jnp.asarray(prev))
        pairs.append((yp, jyp))
    else:
        pairs.append((c2, jc2))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    if arch != "MOMO":
        c0, jc0 = model.init_carry(B), jmodel.init_carry(B)
        dec, jdec = model.decay_carry(carry, 0.9), jmodel.decay_carry(
            jcarry, 0.9)
        for a, b in zip(*(map(lambda c: c if isinstance(c, tuple) else (c,),
                              (c0, jc0)))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(*(map(lambda c: c if isinstance(c, tuple) else (c,),
                              (dec, jdec)))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_load_params_checks_momo_offsets():
    params, _ = load_params_npz(os.path.join(HERE, "..", "checkpoints",
                                             "momo3-4d4ea0.npz"))
    params["cell.input_gate.gs.offset"] = params[
        "cell.input_gate.gs.offset"] * 2
    model = MOMO3(ModelConfig(arch="MOMO3", **RAND_GEO))
    with pytest.raises(ValueError, match="gs.offset"):
        model.load_params(params_from_jax(params))


@pytest.mark.parametrize("spec", ["momo3-4d4ea0", REALNOISE])
def test_load_pretrained_returns_momo3(spec):
    cfg, model = load_pretrained(spec)
    jcfg, jmodel, jparams = jax_load_pretrained(spec)
    assert isinstance(model, MOMO3) and model.delta
    assert dataclasses.asdict(cfg.dsp) == dataclasses.asdict(jcfg.dsp)
    assert cfg.dsp.domain == "raw"
    assert cfg.model.arch == "MOMO3" and model.num_bins == 22
    # neither the smearing offsets nor a training checkpoint's optimizer
    # state are weights
    assert set(model.state_dict()) == {
        k for k in jparams if "gs.offset" not in k
        and not k.startswith("__opt__")}
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams[k]))


def test_momo_v1_has_no_plan():
    model = _models("MOMO")[0]
    assert isinstance(model, MOMO)
    with pytest.raises(ValueError, match="no plan"):
        build_cell_plan(model)


# -- the plan -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["MOMO3", "MOMO2"])
def test_momo_plan_matches_jax(arch, rng):
    model, jmodel, jparams = _models(arch)
    plan, jplan = build_cell_plan_momo(model), jax_build_plan(jmodel, jparams)
    assert plan.delta == jplan.delta == (arch == "MOMO3")
    assert build_cell_plan(model).delta == plan.delta
    for a, b in zip(plan.down_mats + plan.up_h_mats + (plan.reset_mat,),
                    jplan.down_mats + jplan.up_h_mats + (jplan.reset_mat,)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    B, T, F = 3, 6, 22
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    hx = (0.5 * rng.standard_normal((B, 48))).astype(np.float32)
    prev = rng.standard_normal((B, F)).astype(np.float32) \
        if plan.delta else None
    y, h = plan_cell(plan, torch.from_numpy(x[:, 0]), torch.from_numpy(hx),
                     None if prev is None else torch.from_numpy(prev))
    jy, jh = jax_plan_cell(jplan, jnp.asarray(x[:, 0]), jnp.asarray(hx),
                           None if prev is None else jnp.asarray(prev))
    ys, hs = plan_apply_parallel(plan, torch.from_numpy(x),
                                 torch.from_numpy(hx))
    jys, jhs = jax_plan_apply_parallel(jplan, jnp.asarray(x),
                                       jnp.asarray(hx))
    with torch.no_grad():      # the plan against the model it compiles
        zy, _ = model.apply(torch.from_numpy(x),
                            torch.from_numpy(hx.reshape(B, 16, 3)))
    for a, b in ((y, jy), (h, jh), (ys, jys), (hs, jhs), (ys, zy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    if plan.delta:
        with pytest.raises(ValueError, match="prev"):
            plan_cell(plan, torch.from_numpy(x[:, 0]), torch.from_numpy(hx))


@pytest.mark.parametrize("fused", [False, True])
def test_plan_model_matches_jax(momo3, rng, fused):
    model, jmodel, jparams = momo3
    pm = PlanModel(model, fused=fused, device="cpu")
    jpm = JaxPlanModel(jmodel, jparams, fused=fused, interpret=fused)
    assert pm.is_momo and jpm.is_momo and pm.plan.delta
    assert (pm.fused_cell is not None) == fused
    B, T, F = 3, 5, 22
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    carry, jcarry = pm.init_carry(B), jpm.init_carry(B)
    assert carry[1].shape == (B, F) and not carry[1].any()
    for t in range(T):
        y, carry = pm.cell(torch.from_numpy(x[:, t]), carry)
        jy, jcarry = jpm.cell(jparams, jnp.asarray(x[:, t]), jcarry)
        carry = pm.decay_carry(carry, 0.9)
        jcarry = jpm.decay_carry(jcarry, 0.9)
        for a, b in ((y, jy), (carry[0], jcarry[0]), (carry[1], jcarry[1])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    # sequences, even one frame long, through plan_apply_parallel
    for xs in (x, x[:, :1], x[0]):
        ys, hs = pm.apply(torch.from_numpy(xs))
        jys, jhs = jpm.apply(jparams, jnp.asarray(xs))
        np.testing.assert_allclose(ys.numpy(), np.asarray(jys), atol=ATOL)
        np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), atol=ATOL)
    if fused:
        assert pm.fused_cell.launches == 0   # the plain version ran


# -- the raw-domain fast step and the engines ------------------------------------

def _chunks(rng, T, B, hop):
    return (0.1 * rng.standard_normal((T, B, hop))).astype(np.float32)


@pytest.mark.parametrize("plan_model", [False, True])
def test_raw_fast_step_matches_jax(momo3, rng, plan_model):
    """The raw domain (log1p of the magnitude at n_stft bins, no mel pair)
    with MOMO3's (hx, prev) carry, hop by hop: output, hx and prev."""
    model, jmodel, jparams = momo3
    cfg = load_pretrained("momo3-4d4ea0")[0]
    jcfg = jax_load_pretrained("momo3-4d4ea0")[0]
    B = 4
    served = PlanModel(model, fused=True, device="cpu") if plan_model \
        else model
    step, jstep = make_fast_step(cfg, served, "cpu"), jax_make_fast_step(
        jcfg, jmodel)
    s, js = fast_init_state(cfg, served, B), jax_fast_init_state(jcfg, jmodel,
                                                                B)
    assert s.prev.shape == (B, 22) and not s.prev.any()
    for c in _chunks(rng, HOPS, B, cfg.dsp.hop_length):
        s, out = step(s, torch.from_numpy(c))
        js, jout = jstep(jparams, js, jnp.asarray(c))
        jhx, jprev = js.hx
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=OUT_ATOL)
        np.testing.assert_allclose(s.hx.reshape(B, -1).numpy(),
                                   np.asarray(jhx).reshape(B, -1), atol=ATOL)
        np.testing.assert_allclose(s.prev.numpy(), np.asarray(jprev),
                                   atol=ATOL)


def test_raw_fast_step_needs_stft_width_features(momo3):
    cfg = load_pretrained("momo3-4d4ea0")[0]
    bad = dataclasses.replace(cfg, dsp=dataclasses.replace(cfg.dsp,
                                                           n_mels=21))
    with pytest.raises(ValueError, match="n_mels must equal n_stft"):
        make_fast_step(bad, momo3[0], "cpu")


@pytest.mark.parametrize("mode", ["fast", "fused"])
def test_engine_matches_jax_with_masked_commit(momo3, rng, mode):
    """Stream b skips ticks 1-3: its hx and prev must not move then, and
    every output and plane matches the JAX engine (its fused hop in
    interpret mode)."""
    model, jmodel, jparams = momo3
    cfg = load_pretrained("momo3-4d4ea0")[0]
    jcfg = jax_load_pretrained("momo3-4d4ea0")[0]
    jeng = JaxEngine(jcfg, jmodel, jparams, mode=mode, max_streams=4,
                     pallas_interpret=True)
    eng = StreamEngine(cfg, model, mode=mode, max_streams=4, device="cpu")
    assert eng.state.prev is not None
    for e in (jeng, eng):
        e.add_stream("a")
        e.add_stream("b")
    data = _chunks(rng, 6, 2, cfg.dsp.hop_length)
    for t in range(6):
        chunks = {"a": data[t, 0]}
        if t == 0 or t > 3:
            chunks["b"] = data[t, 1]
        slot = eng.slots["b"]
        before = (eng.state.hx[slot].clone(), eng.state.prev[slot].clone())
        got, want = eng.process(chunks), jeng.process(chunks)
        for sid in chunks:
            np.testing.assert_allclose(got[sid], want[sid], atol=OUT_ATOL)
        if "b" not in chunks:
            assert torch.equal(eng.state.hx[slot], before[0])
            assert torch.equal(eng.state.prev[slot], before[1])
        jhx, jprev = (jeng.state.hx if mode == "fast"
                      else (jeng.state.hx, jeng.state.prev))
        np.testing.assert_allclose(eng.state.hx.reshape(4, -1).numpy(),
                                   np.asarray(jhx).reshape(4, -1), atol=ATOL)
        np.testing.assert_allclose(eng.state.prev.numpy(), np.asarray(jprev),
                                   atol=ATOL)
    if mode == "fused":
        assert eng.plan.delta and eng.hop_step.launches == 0


def test_daemon_serves_momo3_gated_in_mode_fused():
    """The daemon's auto gate (unit gain: 1 dB, width 6, 'both') on the
    MOMO3 training checkpoint: the gated fused hop with the delta carry
    and the raw domain together, replies against the plain hop."""
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    daemon = EngineDaemon(REALNOISE, max_streams=4,
                          address=("127.0.0.1", 0), mode="fused",
                          device="cpu")
    srv = daemon.cfg.serving
    assert (srv.snr_gate_db, srv.snr_gate_width_db,
            srv.snr_gate_estimator) == (1.0, 6.0, "both")
    assert daemon.engine.plan.delta and daemon.cfg.dsp.domain == "raw"
    server = threading.Thread(target=daemon.serve_forever, daemon=True)
    server.start()
    data = _chunks(np.random.default_rng(7), 5, 2, 21)
    try:
        assert daemon.listening.wait(30)
        with Client(daemon.address) as conn:
            for sid in ("x", "y"):
                conn.send(("open", sid))
                assert conn.recv()[0] == "ok"
            got = {"x": [], "y": []}
            for t in range(5):
                for j, sid in enumerate(("x", "y")):
                    conn.send(("chunk", sid, data[t, j]))
                for _ in range(2):
                    assert conn.poll(30)
                    msg = conn.recv()
                    assert msg[0] == "out"
                    got[msg[1]].append(msg[2])
    finally:
        daemon.stop()
        server.join(10)
    hop = make_fused_hop(daemon.cfg, daemon.engine.plan, "cpu")
    state = fused_hop_init_state(daemon.cfg, daemon.engine.plan, 2)
    for t in range(5):
        state, out = hop(state, torch.from_numpy(data[t]))
        for j, sid in enumerate(("x", "y")):
            np.testing.assert_allclose(got[sid][t], out[j].numpy(),
                                       atol=1e-6)


def test_recommended_serving_gates_momo3():
    cfg = recommended_serving(load_pretrained(REALNOISE)[0])
    assert cfg.serving.snr_gate_db == 1.0
    assert isinstance(load_pretrained("momo3-4d4ea0")[1], MOMO3)
    assert MOMO2(ModelConfig(arch="MOMO2", **RAND_GEO)).init_carry(2).shape \
        == (2, 16, 3)

"""The port's op-by-op phase-reuse slice against the JAX package on the
CPU: ``make_fast_step`` hop by hop (the zoo model, PlanModel with the
fused cell's plain version, a small random model), ``make_server_step``
against its golden and JAX, StreamEngine and EngineDaemon in mode
'fast', what the fast step refuses (and the lookahead it now serves),
and the ``profile`` command."""

import dataclasses
import json
import os
import subprocess
import sys
import threading
from multiprocessing.connection import Client

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu.config import (
    Config as JaxConfig, DSPConfig as JaxDSPConfig,
    ModelConfig as JaxModelConfig, ServingConfig as JaxServingConfig)
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.models import build_model as jax_build_model
from audio_denoising_tpu.pipeline import (
    make_server_step as jax_make_server_step)
from audio_denoising_tpu.runtime.engine import (
    StreamEngine as JaxEngine, fast_init_state as jax_fast_init_state,
    make_fast_step as jax_make_fast_step)
from audio_denoising_tpu.runtime.plan import PlanModel as JaxPlanModel

from audio_denoising_torch.apps import profile_app
from audio_denoising_torch.apps.engine_serve import EngineDaemon
from audio_denoising_torch.compat import params_from_jax
from audio_denoising_torch.config import (
    Config, DSPConfig, ModelConfig, ServingConfig)
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.models import build_model
from audio_denoising_torch.pipeline import make_server_step
from audio_denoising_torch.runtime.engine import (
    FastState, StreamEngine, fast_init_state, make_fast_step)
from audio_denoising_torch.runtime.plan import PlanModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
SPEC = "gruunet2-good"
OUT_ATOL = 2e-4      # tests/test_fused_hop.py's bound on a hop's output
HX_ATOL = 1e-5       # the plan cell's bound (tests/test_torch_model_plan.py)
HOPS = 20
RECV_TIMEOUT_S = 30.0
SMALL_DSP = dict(sample_rate=16000, n_fft=256, hop_length=128, n_mels=32,
                 domain="mel", reconstruction="phase")
SMALL_MODEL = dict(arch="GRUUNet2", hidden_sizes=(6, 6, 6),
                   kernel_sizes=(3, 3, 3), strides=(2, 2, 2),
                   paddings=(1, 1, 1), num_compressed_bins=4)
SMALL_SERVING = dict(state_decay=0.9, output_gain=3.0, chunk_samples=128)


@pytest.fixture(scope="module")
def good():
    """The JAX side (cfg, model, params) and the port's (cfg, model), both
    on checkpoints/gruunet2-good.npz."""
    return jax_load_pretrained(SPEC), load_pretrained(SPEC)


def _small():
    """The impairment tests' tiny geometry (tests/test_impairment.py) with
    the x3 gain and 0.9 decay, on random weights from a seed."""
    jcfg = JaxConfig(dsp=JaxDSPConfig(**SMALL_DSP),
                     model=JaxModelConfig(**SMALL_MODEL),
                     serving=JaxServingConfig(**SMALL_SERVING))
    jmodel = jax_build_model(jcfg.model, num_bins=jcfg.dsp.n_mels)
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = Config(dsp=DSPConfig(**SMALL_DSP), model=ModelConfig(**SMALL_MODEL),
                 serving=ServingConfig(**SMALL_SERVING))
    model = build_model(cfg.model, num_bins=cfg.dsp.n_mels).load_params(
        params_from_jax({k: np.asarray(v) for k, v in params.items()}))
    return (jcfg, jmodel, params), (cfg, model)


def _run_against_jax(jax_side, port_side, batch, seed):
    """Both fast steps over HOPS hops of the same chunks; every hop's
    output and hx held."""
    (jcfg, jmodel, params), (cfg, model) = jax_side, port_side
    jstep = jax.jit(jax_make_fast_step(jcfg, jmodel))
    js = jax_fast_init_state(jcfg, jmodel, batch)
    step = make_fast_step(cfg, model, "cpu")
    s = fast_init_state(cfg, model, batch)
    rng = np.random.default_rng(seed)
    hop = cfg.dsp.hop_length
    for t in range(HOPS):
        chunk = (0.1 * rng.standard_normal((batch, hop))).astype(np.float32)
        if t == 3:
            chunk[:] = 0.0              # a silent hop: angle(0) is 0
        js, jout = jstep(params, js, jnp.asarray(chunk))
        s, out = step(s, torch.from_numpy(chunk))
        assert out.shape == (batch, hop) and torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=OUT_ATOL)
        np.testing.assert_allclose(s.hx.numpy(), np.asarray(js.hx),
                                   atol=HX_ATOL)
    for name in ("ring", "ola"):
        np.testing.assert_allclose(getattr(s, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   atol=OUT_ATOL)
    return s


def test_fast_step_matches_jax_zoo_model(good):
    s = _run_against_jax(good[0], good[1], 4, 1)
    assert s.hx.shape == (4, 17, 4)


def test_fast_step_matches_jax_fused_plan_model(good):
    """PlanModel(fused=True) on both sides: JAX's Pallas cell in interpret
    mode, the port's FusedCell on CPU tensors (its plain version); the
    state decay is the PlanModel's decay_carry, applied once per hop."""
    (jcfg, jmodel, params), (cfg, model) = good
    jpm = JaxPlanModel(jmodel, params, fused=True, interpret=True)
    pm = PlanModel(model, fused=True, device="cpu")
    s = _run_against_jax((jcfg, jpm, params), (cfg, pm), 4, 2)
    assert s.hx.shape == (4, 68)
    assert pm.fused_cell.launches == 0


def test_fast_step_matches_jax_small_width():
    s = _run_against_jax(*_small(), 3, 3)
    assert s.hx.shape == (3, 6, 4)


def test_fast_step_zoo_and_plan_model_agree(good):
    """The same hop through the zoo model's convolutions and through the
    plan's matmuls."""
    _, (cfg, model) = good
    pm = PlanModel(model, fused=True, device="cpu")
    steps = [(make_fast_step(cfg, m, "cpu"), fast_init_state(cfg, m, 2))
             for m in (model, pm)]
    rng = np.random.default_rng(4)
    for _ in range(HOPS):
        chunk = torch.from_numpy((0.1 * rng.standard_normal(
            (2, cfg.dsp.hop_length))).astype(np.float32))
        outs = []
        for i, (step, s) in enumerate(steps):
            s, out = step(s, chunk)
            steps[i] = (step, s)
            outs.append(out)
        np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                                   atol=OUT_ATOL)
    np.testing.assert_allclose(steps[0][1].hx.reshape(2, -1).numpy(),
                               steps[1][1].hx.numpy(), atol=HX_ATOL)


# -- the server step ----------------------------------------------------------

@pytest.mark.parametrize("plan", [False, True])
def test_server_step_matches_golden(good, plan):
    """tests/test_pipeline.py's golden and bounds; the plan runs the
    10-frame chunk through plan_apply_parallel."""
    _, (cfg, model) = good
    if plan:
        model = PlanModel(model, device="cpu")
    g = np.load(os.path.join(GOLD, "pipeline_server_GRUUNet2-good.npz"))
    step = make_server_step(cfg, model, "cpu")
    hx, y = step(model.init_state(1), torch.from_numpy(g["x"][None]))
    np.testing.assert_allclose(hx.reshape(g["final_hx"].shape).numpy(),
                               g["final_hx"], atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(y[0].numpy(), g["y"][0], atol=5e-3,
                               rtol=1e-2)


def test_server_step_matches_jax_across_chunks(good):
    """Three chunks with the state carried, one chunk shorter than the
    n_fft // 2 reflect padding (a chunk of one hop)."""
    (jcfg, jmodel, params), (cfg, model) = good
    jstep = jax.jit(jax_make_server_step(jcfg, jmodel))
    step = make_server_step(cfg, model, "cpu")
    jhx, hx = jmodel.init_state(2), model.init_state(2)
    rng = np.random.default_rng(5)
    for length in (4800, 512, 4800):
        chunk = (0.1 * rng.standard_normal((2, length))).astype(np.float32)
        jhx, jy = jstep(params, jhx, jnp.asarray(chunk))
        hx, y = step(hx, torch.from_numpy(chunk))
        assert y.shape == (2, length)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=OUT_ATOL)
        np.testing.assert_allclose(hx.numpy(), np.asarray(jhx),
                                   atol=HX_ATOL)


# -- StreamEngine mode 'fast' -------------------------------------------------

@pytest.fixture(scope="module")
def engines(good):
    (jcfg, jmodel, params), (cfg, model) = good
    return (JaxEngine(jcfg, jmodel, params, mode="fast", max_streams=8),
            StreamEngine(cfg, model, mode="fast", max_streams=8,
                         device="cpu"))


def _jittered(hop):
    """12 ticks of {stream: chunk}: stream 'j' arrives after 0-2 underrun
    ticks each time (tests/test_impairment.py's jitter), 'b' leaves at
    tick 4 and 'e' takes its slot, 'd' sends a NaN/Inf chunk."""
    rng = np.random.default_rng(9)

    def c():
        return (0.1 * rng.standard_normal(hop)).astype(np.float32)

    ticks, wait = [], 0
    for t in range(12):
        live = ["a", "d"] + (["b"] if t < 4 else ["e"] if t > 4 else [])
        chunks = {s: c() for s in live}
        if wait == 0:
            chunks["j"] = c()
            wait = t % 3
        else:
            wait -= 1
        if t == 2:
            chunks["d"][5] = np.nan
            chunks["d"][40] = np.inf
        ticks.append(chunks)
    return ticks


def test_engine_fast_matches_jax_over_12_jittered_ticks(engines):
    jax_engine, engine = engines
    ticks = _jittered(engine.hop)
    for e in engines:
        for s in "abdj":
            e.add_stream(s)
    assert jax_engine.slots == engine.slots
    outs, snap_j, snap_t = [], None, None
    try:
        for t, chunks in enumerate(ticks):
            if t == 4:
                for e in engines:
                    e.remove_stream("b")
                    e.add_stream("e")
                assert engine.slots["e"] == jax_engine.slots["e"]
            if t == 8:
                snap_j, snap_t = jax_engine.snapshot(), engine.snapshot()
            idle = [slot for s, slot in engine.slots.items()
                    if s not in chunks]
            # the state's present planes (the ungated gate planes are None)
            before = [x[idle].clone() for x in engine.state if x is not None]
            oj, ot = jax_engine.process(chunks), engine.process(chunks)
            after = [x for x in engine.state if x is not None]
            for a, b in zip(before, after):
                assert torch.equal(a, b[idle])    # idle slots bit-identical
            assert set(ot) == set(chunks)
            for s in chunks:
                assert np.all(np.isfinite(ot[s]))
                np.testing.assert_allclose(ot[s], oj[s], atol=OUT_ATOL)
            outs.append(ot)
        for name in ("ring", "ola", "hx"):
            np.testing.assert_allclose(
                getattr(engine.state, name).numpy(),
                np.asarray(getattr(jax_engine.state, name)), atol=HX_ATOL
                if name == "hx" else OUT_ATOL)
        jax_engine.restore(snap_j)
        engine.restore(snap_t)
        for t in range(8, 12):
            ot = engine.process(ticks[t])
            for s in ticks[t]:
                np.testing.assert_array_equal(ot[s], outs[t][s])
    finally:
        for e in engines:
            for s in list(e.slots):
                e.remove_stream(s)


def test_engine_fast_is_jitter_invariant(good):
    """The same chunks give bit-identical output whether they arrive on
    consecutive ticks or between underrun ticks (masked commit)."""
    _, (cfg, model) = good
    rng = np.random.default_rng(3)
    frames = (0.2 * rng.standard_normal((8, cfg.dsp.hop_length))).astype(
        np.float32)
    steady = StreamEngine(cfg, model, mode="fast", max_streams=2,
                          device="cpu")
    steady.add_stream("s")
    want = [steady.process({"s": f})["s"] for f in frames]
    jittery = StreamEngine(cfg, model, mode="fast", max_streams=2,
                           device="cpu")
    jittery.add_stream("s")
    jittery.add_stream("other")
    got = []
    for k, f in enumerate(frames):
        for _ in range(k % 3):
            jittery.process({"other": frames[k]})
        got.append(jittery.process({"s": f, "other": f})["s"])
    np.testing.assert_array_equal(np.stack(want), np.stack(got))


def test_engine_fast_latency_matches_jax(engines):
    jax_engine, engine = engines
    assert isinstance(engine.state, FastState)
    assert engine.algorithmic_latency_samples == \
        jax_engine.algorithmic_latency_samples == 512
    assert engine.algorithmic_latency_ms == pytest.approx(
        jax_engine.algorithmic_latency_ms)


# -- the SNR gate -------------------------------------------------------------

GATED_SPEC = "gruunet2-stream16k"   # gruunet2-good's weights at 16 kHz
PLANE_RTOL, PLANE_ATOL = 2e-4, 1e-9
GATE_PLANES = ("nf_smooth", "nf_floor", "nf_total", "em_out", "em_rem")
# (gate, width): tests/test_fused_hop.py's 10 dB / 4, but 'removed' reads
# 15-41 dB on this x3-gain checkpoint, so its ramp sits higher
GATE_POINTS = {"removed": (30.0, 10.0), "floor": (10.0, 4.0),
               "both": (10.0, 4.0)}


def _gated(cfg, estimator):
    gate_db, width_db = GATE_POINTS[estimator]
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, snr_gate_db=gate_db, snr_gate_width_db=width_db,
        snr_gate_estimator=estimator))


def _bursty(rng, B, hop, t):
    """tests/test_fused_hop.py's _bursty: a tone on every other 3 hops
    over per-stream noise levels."""
    t_ax = np.arange(t * hop, (t + 1) * hop) / 16000.0
    base = (0.3 * np.sin(2 * np.pi * 440 * t_ax)
            * (1.0 if (t // 3) % 2 else 0.0))
    lv = np.array([0.001, 0.01, 0.1, 0.3])[:B, None]
    return (base[None, :] + lv * rng.standard_normal((B, hop))
            ).astype(np.float32)


def _assert_planes_close(state, jstate):
    for name in GATE_PLANES:
        got, want = getattr(state, name), getattr(jstate, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=PLANE_RTOL, atol=PLANE_ATOL,
                                       err_msg=name)


@pytest.fixture(scope="module")
def good16k():
    return jax_load_pretrained(GATED_SPEC), load_pretrained(GATED_SPEC)


@pytest.mark.parametrize("estimator", ["removed", "floor", "both"])
def test_gated_fast_step_matches_jax(good16k, estimator):
    """12 bursty hops at B=4 with the gate on both sides: out 2e-4, the
    gate's planes relative 2e-4."""
    (jcfg, jmodel, params), (cfg, model) = good16k
    jcfg, cfg = _gated(jcfg, estimator), _gated(cfg, estimator)
    B, hop = 4, cfg.dsp.hop_length
    jstep = jax.jit(jax_make_fast_step(jcfg, jmodel))
    js = jax_fast_init_state(jcfg, jmodel, B)
    step = make_fast_step(cfg, model, "cpu")
    s = fast_init_state(cfg, model, B)
    rng = np.random.default_rng(21)
    for t in range(12):
        chunk = _bursty(rng, B, hop, t)
        js, jout = jstep(params, js, jnp.asarray(chunk))
        s, out = step(s, torch.from_numpy(chunk))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=OUT_ATOL)
    _assert_planes_close(s, js)
    np.testing.assert_allclose(s.hx.numpy(), np.asarray(js.hx),
                               atol=HX_ATOL)


@pytest.mark.parametrize("estimator", ["removed", "floor", "both"])
def test_fast_state_carries_the_gate_planes(good16k, estimator):
    """fast_init_state creates the planes the estimator uses (zeros, so a
    fresh slot latches), as JAX's does."""
    (jcfg, jmodel, _), (cfg, model) = good16k
    js = jax_fast_init_state(_gated(jcfg, estimator), jmodel, 3)
    s = fast_init_state(_gated(cfg, estimator), model, 3)
    for name in GATE_PLANES:
        want = getattr(js, name)
        got = getattr(s, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert tuple(got.shape) == want.shape and not bool(got.any())


def test_engine_fast_gated_matches_jax_with_masked_commit(good16k):
    """Mode 'fast' with the gate ('both') against the JAX engine, 2
    slots: 'b' idles for 4 ticks and its planes stay bit-identical."""
    (jcfg, jmodel, params), (cfg, model) = good16k
    jcfg, cfg = _gated(jcfg, "both"), _gated(cfg, "both")
    jeng = JaxEngine(jcfg, jmodel, params, mode="fast", max_streams=2)
    eng = StreamEngine(cfg, model, mode="fast", max_streams=2, device="cpu")
    for e in (jeng, eng):
        e.add_stream("a")
        e.add_stream("b")
    rng = np.random.default_rng(22)
    hop = cfg.dsp.hop_length
    for t in range(7):
        both = _bursty(rng, 2, hop, t)
        chunks = {"a": both[0]}
        if t == 0 or t >= 5:
            chunks["b"] = both[1]
        before = {k: getattr(eng.state, k).clone() for k in GATE_PLANES}
        want, got = jeng.process(chunks), eng.process(chunks)
        for sid in chunks:
            np.testing.assert_allclose(got[sid], want[sid], atol=OUT_ATOL)
        if "b" not in chunks:
            slot = eng.slots["b"]
            for k, v in before.items():
                assert torch.equal(getattr(eng.state, k)[slot], v[slot]), k
        _assert_planes_close(eng.state, jeng.state)


# -- what the fast step refuses, and the lookahead it once refused -----------

def _unported(cfg, what):
    """``cfg`` changed to a case the fast step once refused or refuses,
    with the exception and message it raises (None where it now serves
    it): a lookahead checkpoint is served by the delay rings; a
    raw-domain config whose n_mels is not n_stft has no feature width."""
    if what == "lookahead":
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, lookahead_frames=4)), None, None
    return dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, domain="raw")), ValueError, "n_mels must equal n_stft"


@pytest.mark.parametrize("what", ["lookahead", "raw"])
def test_fast_refuses_what_is_not_ported(good, what):
    """The raw case still raises at every entry point; lookahead (ROADMAP
    A10, refused until the delay rings were ported) is served: the step,
    its state and the engine carry (B, 4, F) rings, and a hop runs
    (tests/test_torch_lookahead.py holds it against JAX)."""
    _, (cfg, model) = good
    cfg, err, item = _unported(cfg, what)
    if err is None:
        step = make_fast_step(cfg, model, "cpu")
        state = fast_init_state(cfg, model, 2)
        eng = StreamEngine(cfg, model, mode="fast", max_streams=2,
                           device="cpu")
        state, out = step(state, torch.full((2, cfg.dsp.hop_length), 0.1))
        assert state.la_mag.shape == eng.state.la_phase.shape == \
            (2, 4, cfg.dsp.n_stft)
        assert out.shape == (2, cfg.dsp.hop_length)
        assert torch.isfinite(out).all()
        return
    with pytest.raises(err, match=item):
        make_fast_step(cfg, model, "cpu")
    with pytest.raises(err, match=item):
        fast_init_state(cfg, model, 2)
    with pytest.raises(err, match=item):
        StreamEngine(cfg, model, mode="fast", max_streams=2, device="cpu")


def test_fast_step_needs_a_card_unless_cpu_is_asked(good, monkeypatch):
    _, (cfg, model) = good
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fast_step(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_server_step(cfg, model)


def test_fast_step_refuses_a_plan_model_on_another_device(good):
    _, (cfg, model) = good
    pm = PlanModel(model, device="cpu")
    pm.device = torch.device("meta")
    with pytest.raises(ValueError, match="built for"):
        make_fast_step(cfg, pm, "cpu")


# -- the daemon in mode 'fast' ------------------------------------------------

def _recv(conn):
    if not conn.poll(RECV_TIMEOUT_S):
        raise TimeoutError("no reply from the daemon")
    return conn.recv()


def test_daemon_serves_mode_fast():
    """The JAX daemon's defaults (gruunet2-good, mode fast): each stream's
    replies equal its own sequence through the fast step."""
    daemon = EngineDaemon(SPEC, max_streams=4, address=("127.0.0.1", 0),
                          mode="fast", device="cpu")
    hop = daemon.cfg.dsp.hop_length
    assert daemon.cfg.serving.snr_gate_db is None     # x3 gain: no gate
    server = threading.Thread(target=daemon.serve_forever, daemon=True)
    server.start()
    rng = np.random.default_rng(12)
    data = (0.1 * rng.standard_normal((2, 3, hop))).astype(np.float32)
    got = np.zeros_like(data)
    try:
        assert daemon.listening.wait(RECV_TIMEOUT_S)
        with Client(daemon.address) as conn:
            for j in range(2):
                conn.send(("open", f"s{j}"))
                assert _recv(conn)[0] == "ok"
            for k in range(3):
                for j in range(2):
                    conn.send(("chunk", f"s{j}", data[j, k]))
                for _ in range(2):
                    op, sid, out = _recv(conn)
                    assert op == "out"
                    got[int(sid[1]), k] = out
            conn.send(("stats",))
            op, stats = _recv(conn)
            assert stats["algorithmic_latency_ms"] == pytest.approx(10.667)
    finally:
        daemon.stop()
        server.join(RECV_TIMEOUT_S)
    assert not server.is_alive()
    cfg, model = load_pretrained(SPEC)
    step = make_fast_step(cfg, model, "cpu")
    state = fast_init_state(cfg, model, 2)
    for k in range(3):
        state, out = step(state, torch.from_numpy(data[:, k].copy()))
        np.testing.assert_allclose(got[:, k], out.numpy(), atol=1e-6)


# -- the profile command ------------------------------------------------------

def test_profile_cli_help():
    with pytest.raises(SystemExit) as exc:
        profile_app.main(["--help"])
    assert exc.value.code == 0


REPORT_KEYS = {"device", "streams", "hop_ms", "dispatch_inclusive",
               "amortized_ms_per_hop", "aggregate_realtime_x", "hops_run"}


def test_profile_cli_stages_smoke(capsys):
    """tests/test_profiler.py's smoke of the JAX app, on the CPU."""
    assert profile_app.main(["--device", "cpu", "--streams", "2", "--hops",
                             "3", "--stages"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert REPORT_KEYS <= set(rep) and rep["device"] == "cpu"
    assert set(rep["dispatch_inclusive"]) == {"p50_ms", "p90_ms", "p99_ms",
                                              "n"}
    st = rep["stage_ms_per_hop"]
    assert set(st) == {"frontend", "model", "backend"}
    assert all(v > 0 for v in st.values())
    # 1 warm-up + 3 timed dispatches, (1 warm-up + 10) chains of 3
    assert rep["hops_run"] == 4 + 11 * 3


@pytest.mark.parametrize("argv", [
    ["--mode", "fast", "--fused"], ["--mode", "server", "--plan"],
    ["--mode", "webrtc"]])
def test_profile_cli_modes(capsys, tmp_path, argv):
    assert profile_app.main(["--device", "cpu", "--streams", "2", "--hops",
                             "2", "--trace", str(tmp_path), *argv]) == 0
    out = capsys.readouterr().out
    rep = json.loads(out[out.index("{\n"):])
    assert REPORT_KEYS <= set(rep) and rep["trace_dir"] == str(tmp_path)
    # 1 + 2 dispatches, 11 chains of 2, 5 traced hops
    assert rep["hops_run"] == 3 + 11 * 2 + 5
    if "--fused" in argv:
        assert rep["fused_cell_launches"] == 0    # the CPU runs no kernel
    assert os.path.exists(os.path.join(tmp_path, "trace.json"))


def test_profile_cli_runs_as_a_command():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    proc = subprocess.run(
        [sys.executable, "-m", "audio_denoising_torch", "profile", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    assert "--fused" in proc.stdout and "--device" in proc.stdout

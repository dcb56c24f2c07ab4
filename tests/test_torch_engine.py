"""The port's serving slice against the JAX package on the CPU:
StreamEngine mode 'fused' (masked commit, ingress sanitization, slot
reuse, snapshot/restore), the EngineDaemon's wire protocol and its gate
flags (in modes 'fused', 'fast' and 'webrtc'). Mode 'fast' is held in
tests/test_torch_fast.py, mode 'webrtc' in tests/test_torch_webrtc.py."""

import inspect
import os
import threading
from multiprocessing.connection import Client

import numpy as np
import pytest
import torch

from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.runtime.engine import StreamEngine as JaxEngine

from audio_denoising_torch.apps.engine_serve import (
    EngineDaemon, daemon_from_args, parser)
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.ops.kernels.fused_hop import (
    fused_hop_init_state, make_fused_hop)
from audio_denoising_torch.pipeline import (
    make_webrtc_step, webrtc_init_state)
from audio_denoising_torch.runtime.engine import (
    StreamEngine, fast_init_state, make_fast_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "gruunet2-stream16k"
OUT_ATOL = 2e-4      # tests/test_fused_hop.py's bounds for the fused hop
STATE_ATOL = 2e-5
RECV_TIMEOUT_S = 30.0


@pytest.fixture(scope="module")
def engines():
    jcfg, jmodel, jparams = jax_load_pretrained(SPEC)
    cfg, model = load_pretrained(SPEC)
    jax_engine = JaxEngine(jcfg, jmodel, jparams, mode="fused",
                           max_streams=8, pallas_interpret=True)
    return jax_engine, StreamEngine(cfg, model, mode="fused", max_streams=8,
                                    device="cpu")


def _schedule(hop):
    """12 ticks of {stream: chunk} with skipped ticks, a NaN/Inf chunk and
    a slot reused after a removal (the 'remove'/'add' entries)."""
    rng = np.random.default_rng(7)

    def c():
        return (0.1 * rng.standard_normal(hop)).astype(np.float32)

    ticks = []
    for t in range(12):
        live = ["a", "c", "d"] + (["b"] if t < 4 else ["e"] if t > 4 else [])
        chunks = {s: c() for s in live if not (t % 3 == 1 and s == "c")}
        if t == 2:
            chunks["d"][5] = np.nan
            chunks["d"][17] = np.inf
            chunks["d"][40] = -np.inf
        ticks.append(chunks)
    return ticks


def test_engine_matches_jax_over_12_ticks(engines):
    jax_engine, engine = engines
    ticks = _schedule(engine.hop)
    for e in engines:
        for s in "abcd":
            e.add_stream(s)
    assert jax_engine.slots == engine.slots
    outs, snap_j, snap_t = [], None, None
    for t, chunks in enumerate(ticks):
        if t == 4:
            for e in engines:           # b leaves; e reuses its slot
                e.remove_stream("b")
                e.add_stream("e")
            assert engine.slots["e"] == jax_engine.slots["e"]
        if t == 8:
            snap_j, snap_t = jax_engine.snapshot(), engine.snapshot()
        oj, ot = jax_engine.process(chunks), engine.process(chunks)
        assert set(ot) == set(chunks)
        for s in chunks:
            assert np.all(np.isfinite(ot[s]))
            np.testing.assert_allclose(ot[s], oj[s], atol=OUT_ATOL)
        outs.append(ot)
    for name in ("ring", "ola", "hx"):
        np.testing.assert_allclose(
            getattr(engine.state, name).numpy(),
            np.asarray(getattr(jax_engine.state, name)), atol=STATE_ATOL)
    # restore rewinds both to tick 8; replaying gives the same audio
    jax_engine.restore(snap_j)
    engine.restore(snap_t)
    for t in range(8, 12):
        oj, ot = jax_engine.process(ticks[t]), engine.process(ticks[t])
        for s in ticks[t]:
            np.testing.assert_array_equal(ot[s], outs[t][s])
            np.testing.assert_allclose(ot[s], oj[s], atol=OUT_ATOL)
    for e in engines:
        for s in list(e.slots):
            e.remove_stream(s)


def test_masked_commit_leaves_idle_slots_untouched(engines):
    _, engine = engines
    engine.add_stream("x")
    engine.add_stream("y")
    try:
        hop = engine.hop
        engine.process({"x": np.ones(hop, np.float32),
                        "y": np.ones(hop, np.float32)})
        y_slot = engine.slots["y"]
        # the state's present planes (the ungated gate planes are None)
        before = [t[y_slot].clone() for t in engine.state if t is not None]
        engine.process({"x": np.ones(hop, np.float32)})
        after = [t for t in engine.state if t is not None]
        for a, b in zip(before, after):
            assert torch.equal(a, b[y_slot])
    finally:
        engine.remove_stream("x")
        engine.remove_stream("y")


def test_engine_admission_errors_and_latency(engines):
    jax_engine, engine = engines
    assert engine.algorithmic_latency_ms == jax_engine.algorithmic_latency_ms
    assert engine.algorithmic_latency_ms == pytest.approx(20.0)
    for i in range(engine.n):
        engine.add_stream(f"s{i}")
    try:
        with pytest.raises(RuntimeError, match="engine full"):
            engine.add_stream("one-too-many")
        with pytest.raises(KeyError):
            engine.add_stream("s0")
    finally:
        for i in range(engine.n):
            engine.remove_stream(f"s{i}")


def test_restore_rejects_other_geometry(engines):
    _, engine = engines
    snap = engine.snapshot()
    snap["state"] = {k: v[:4] for k, v in snap["state"].items()}
    with pytest.raises(ValueError, match="do not match"):
        engine.restore(snap)


def test_process_batch_sanitizes_and_advances_all_slots(engines):
    _, engine = engines
    saved = engine.snapshot()
    try:
        batch = torch.zeros(engine.n, engine.hop)
        batch[0, 0] = float("nan")
        out = engine.process_batch(batch)
        assert out.shape == (engine.n, engine.hop)
        assert torch.isfinite(out).all()
    finally:
        engine.restore(saved)


def test_engine_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, model = load_pretrained(SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamEngine(cfg, model, max_streams=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamEngine(cfg, model, max_streams=2, device="cuda")
    assert StreamEngine(cfg, model, max_streams=2,
                        device="cpu").device.type == "cpu"


def test_engine_refuses_unported_modes():
    cfg, model = load_pretrained(SPEC)
    with pytest.raises(ValueError, match="not ported"):
        StreamEngine(cfg, model, mode="unet", device="cpu")


def test_daemon_refuses_a_profile_it_cannot_serve():
    """A bounded-lookahead checkpoint in mode fused: the JAX engine
    downgrades it to mode fast, whose delay rings the port has not ported
    (ROADMAP A10), so the port refuses it, naming A10, rather than serve
    it without its delay. (A gated fused-webrtc, which this test refused
    until the port served JAX's downgrades, is now served in mode webrtc:
    tests/test_torch_serve.py.)"""
    with pytest.raises(NotImplementedError, match="A10"):
        EngineDaemon(os.path.join(REPO, "runs",
                                  "gruunet2mel128w64-mrstft-la4-50k.npz"),
                     max_streams=2, address=("127.0.0.1", 0), mode="fused",
                     device="cpu")


UNIT_GAIN = os.path.join(REPO, "runs", "gruunet2s16kw40-mrstft-idp-50k.npz")


@pytest.mark.parametrize("mode", ["fused", "fast"])
def test_daemon_gates_a_unit_gain_checkpoint(mode):
    """Under auto gate a gain-1 checkpoint serves the tuned gate (1 dB,
    width 6, 'both'), as the JAX daemon does, and its engine carries all
    five planes; a few ticks agree with the gated step run alone."""
    daemon = EngineDaemon(UNIT_GAIN, max_streams=2, address=("127.0.0.1", 0),
                          mode=mode, device="cpu")
    srv = daemon.cfg.serving
    assert (srv.snr_gate_db, srv.snr_gate_width_db,
            srv.snr_gate_estimator) == (1.0, 6.0, "both")
    eng = daemon.engine
    assert eng.mode == mode
    for name in ("nf_smooth", "nf_floor", "nf_total", "em_out", "em_rem"):
        assert getattr(eng.state, name) is not None, name
    if mode == "fused":
        step = make_fused_hop(daemon.cfg, eng.plan, "cpu")
        state = fused_hop_init_state(daemon.cfg, eng.plan, 2)
    else:
        step = make_fast_step(daemon.cfg, daemon.model, "cpu")
        state = fast_init_state(daemon.cfg, daemon.model, 2)
    eng.add_stream("a")
    eng.add_stream("b")
    rng = np.random.default_rng(5)
    for _ in range(3):
        chunks = (0.1 * rng.standard_normal((2, eng.hop))).astype(np.float32)
        got = eng.process({"a": chunks[0], "b": chunks[1]})
        state, want = step(state, torch.from_numpy(chunks))
        np.testing.assert_allclose(np.stack([got["a"], got["b"]]),
                                   want.numpy(), atol=1e-6)


def _daemon(*argv):
    return daemon_from_args(parser().parse_args(
        ["--model", UNIT_GAIN, "--max-streams", "2", "--device", "cpu",
         "--port", "0", *argv]))


@pytest.mark.parametrize("mode", ["fused", "fast"])
def test_cli_no_snr_gate_serves_ungated(mode):
    daemon = _daemon("--mode", mode, "--no-snr-gate")
    assert daemon.cfg.serving.snr_gate_db is None
    assert daemon.engine.state.em_out is None
    assert daemon.engine.state.nf_floor is None


def test_cli_gate_flags_set_all_three():
    daemon = _daemon("--mode", "fused", "--snr-gate", "3",
                     "--snr-gate-width", "4", "--snr-gate-estimator",
                     "removed")
    srv = daemon.cfg.serving
    assert (srv.snr_gate_db, srv.snr_gate_width_db,
            srv.snr_gate_estimator) == (3.0, 4.0, "removed")
    assert daemon.engine.state.em_out.shape == (2, 1)
    assert daemon.engine.state.nf_floor is None


@pytest.mark.parametrize("estimator", ["removed", "floor", "both"])
def test_cli_gate_flags_serve_mode_webrtc(estimator):
    """``--mode webrtc --snr-gate G --snr-gate-width W
    --snr-gate-estimator E`` serves the gated op-by-op Griffin-Lim step:
    the engine carries the estimator's planes, and a few ticks agree with
    the gated step run alone."""
    daemon = _daemon("--mode", "webrtc", "--snr-gate", "3",
                     "--snr-gate-width", "4", "--snr-gate-estimator",
                     estimator)
    srv, eng = daemon.cfg.serving, daemon.engine
    assert (srv.snr_gate_db, srv.snr_gate_width_db,
            srv.snr_gate_estimator) == (3.0, 4.0, estimator)
    assert eng.mode == "webrtc"
    assert (eng.state.em_out is not None) == (estimator != "floor")
    assert (eng.state.nf_floor is not None) == (estimator != "removed")
    step = make_webrtc_step(daemon.cfg, daemon.model, "cpu")
    state = webrtc_init_state(daemon.cfg, daemon.model, 2)
    eng.add_stream("a")
    eng.add_stream("b")
    rng = np.random.default_rng(6)
    for _ in range(3):
        chunks = (0.1 * rng.standard_normal((2, eng.hop))).astype(np.float32)
        got = eng.process({"a": chunks[0], "b": chunks[1]})
        state, want = step(state, torch.from_numpy(chunks))
        np.testing.assert_allclose(np.stack([got["a"], got["b"]]),
                                   want.numpy(), atol=1e-6)


def test_auto_gate_leaves_mode_webrtc_ungated():
    """The JAX daemon's auto gate covers modes fast and fused only
    (engine_serve.py:58): in mode webrtc a unit-gain checkpoint is served
    ungated unless ``--snr-gate`` asks."""
    daemon = _daemon("--mode", "webrtc")
    assert daemon.cfg.serving.snr_gate_db is None
    assert daemon.engine.state.em_out is None
    assert daemon.engine.state.nf_floor is None


def test_bare_engine_serves_the_jax_daemons_defaults():
    """A bare ``engine`` parses to gruunet2-good in mode fast, the JAX
    daemon's defaults; EngineDaemon() with no arguments matches."""
    from audio_denoising_tpu.apps.engine_serve import (
        EngineDaemon as JaxDaemon, main as jax_main)
    args = parser().parse_args([])
    assert (args.model, args.mode) == ("gruunet2-good", "fast")
    ours = inspect.signature(EngineDaemon).parameters
    theirs = inspect.signature(JaxDaemon).parameters
    for name in ("spec", "mode", "max_streams", "snr_gate_db",
                 "snr_gate_width_db", "snr_gate_estimator", "auto_gate"):
        assert ours[name].default == theirs[name].default, name
    assert "gruunet2-good" in inspect.getsource(jax_main)
    daemon = EngineDaemon(max_streams=2, device="cpu")
    assert daemon.engine.mode == "fast"
    assert daemon.cfg.dsp.n_fft == 1024 and daemon.cfg.serving.output_gain \
        == 3.0 and daemon.cfg.serving.snr_gate_db is None


def _recv(conn):
    if not conn.poll(RECV_TIMEOUT_S):
        raise TimeoutError("no reply from the daemon")
    return conn.recv()


def test_daemon_serves_two_clients():
    daemon = EngineDaemon(SPEC, max_streams=8, address=("127.0.0.1", 0),
                          mode="fused", device="cpu")
    server = threading.Thread(target=daemon.serve_forever, daemon=True)
    server.start()
    try:
        assert daemon.listening.wait(RECV_TIMEOUT_S)
        rng = np.random.default_rng(11)
        data = (0.1 * rng.standard_normal((2, 2, 3, daemon.cfg.dsp.hop_length))
                ).astype(np.float32)
        got = np.zeros_like(data)
        with Client(daemon.address) as c0, Client(daemon.address) as c1:
            conns = (c0, c1)
            for ci, conn in enumerate(conns):
                for j in range(2):
                    conn.send(("open", f"c{ci}s{j}"))
                    assert _recv(conn)[0] == "ok"
            c1.send(("close", "c0s0"))
            assert _recv(c1) == ("err", "c0s0", "not your stream")
            for k in range(3):
                for ci, conn in enumerate(conns):
                    for j in range(2):
                        conn.send(("chunk", f"c{ci}s{j}", data[ci, j, k]))
                for ci, conn in enumerate(conns):
                    for _ in range(2):
                        op, sid, out = _recv(conn)
                        assert op == "out"
                        got[ci, int(sid[3]), k] = out
            c0.send(("chunk", "c0s0", np.zeros(7, np.float32)))
            op, sid, reason = _recv(c0)
            assert (op, sid) == ("err", "c0s0") and "bad chunk" in reason
            c0.send(("stats",))
            op, stats = _recv(c0)
            assert op == "stats" and stats["active_streams"] == 4
            assert stats["counters"]["hops"] == 12
            assert stats["algorithmic_latency_ms"] == 20.0
            for ci, conn in enumerate(conns):
                for j in range(2):
                    conn.send(("close", f"c{ci}s{j}"))
                    assert _recv(conn) == ("ok", f"c{ci}s{j}", -1)
    finally:
        daemon.stop()
        server.join(RECV_TIMEOUT_S)
    assert not server.is_alive()
    # each stream's output is its own sequence through the plain hop
    hop = make_fused_hop(daemon.cfg, daemon.engine.plan, "cpu")
    seqs = torch.from_numpy(data.reshape(4, 3, -1))
    state = fused_hop_init_state(daemon.cfg, daemon.engine.plan, 4)
    for k in range(3):
        state, out = hop(state, seqs[:, k].contiguous())
        np.testing.assert_allclose(got.reshape(4, 3, -1)[:, k], out.numpy(),
                                   atol=1e-6)


# -- the serving compute dtype (--dtype) --------------------------------------

@pytest.mark.parametrize("mode,dtype", [("fused", "bfloat16"),
                                        ("fused", "int8"), ("fast", "int8")])
def test_cli_dtype_serves_the_compute_mode(mode, dtype):
    """``engine --dtype D``, the JAX daemon's flag (engine_serve.py:244-249):
    set after the gate profile, so the unit-gain checkpoint keeps its auto
    gate; mode fused runs the fused hop in D, mode fast at int8 the
    quantized plan; a few ticks equal the step run alone."""
    from audio_denoising_torch.runtime.plan import PlanModel
    daemon = _daemon("--mode", mode, "--dtype", dtype)
    srv, eng = daemon.cfg.serving, daemon.engine
    assert srv.dtype == dtype and srv.snr_gate_db == 1.0
    assert eng.mode == mode and eng.state.em_out is not None
    if mode == "fused":
        assert eng.hop_step.compute_dtype == getattr(torch, dtype)
        step = make_fused_hop(daemon.cfg, eng.plan, "cpu",
                              compute_dtype=getattr(torch, dtype))
        state = fused_hop_init_state(daemon.cfg, eng.plan, 2)
    else:
        pm = PlanModel(daemon.model, device="cpu", quantized=True)
        step, state = make_fast_step(daemon.cfg, pm, "cpu"), \
            fast_init_state(daemon.cfg, pm, 2)
    eng.add_stream("a")
    eng.add_stream("b")
    rng = np.random.default_rng(12)
    for _ in range(3):
        chunks = (0.1 * rng.standard_normal((2, eng.hop))).astype(np.float32)
        got = eng.process({"a": chunks[0], "b": chunks[1]})
        state, want = step(state, torch.from_numpy(chunks))
        np.testing.assert_allclose(np.stack([got["a"], got["b"]]),
                                   want.numpy(), atol=1e-6)


def test_dtype_defaults_to_the_checkpoints_own():
    """No ``--dtype``: the checkpoint's serving.dtype (float32), as the
    JAX daemon's default None keeps it; EngineDaemon's default matches."""
    from audio_denoising_tpu.apps.engine_serve import (
        EngineDaemon as JaxDaemon)
    assert parser().parse_args([]).dtype is None
    assert inspect.signature(EngineDaemon).parameters["dtype"].default is \
        inspect.signature(JaxDaemon).parameters["dtype"].default is None
    daemon = _daemon("--mode", "fused")
    assert daemon.cfg.serving.dtype == "float32"
    assert daemon.engine.hop_step.compute_dtype == torch.float32
    with pytest.raises(SystemExit):
        parser().parse_args(["--dtype", "float16"])


def test_dtype_int8_is_refused_outside_fast_and_fused():
    """int8 in mode webrtc: the webrtc modes have no int8 variant, so the
    engine warns and serves mode fast on the quantized plan, as the JAX
    engine does (engine.py:296-308); a few ticks agree with the quantized
    fast step run alone."""
    from audio_denoising_torch.runtime.plan import PlanModel
    with pytest.warns(UserWarning, match="'webrtc' downgraded to 'fast'"):
        daemon = _daemon("--mode", "webrtc", "--dtype", "int8")
    eng = daemon.engine
    assert eng.mode == "fast" and eng.plan is None
    pm = PlanModel(daemon.model, device="cpu", quantized=True)
    step, state = make_fast_step(daemon.cfg, pm, "cpu"), \
        fast_init_state(daemon.cfg, pm, 2)
    eng.add_stream("a")
    eng.add_stream("b")
    rng = np.random.default_rng(14)
    for _ in range(3):
        chunks = (0.1 * rng.standard_normal((2, eng.hop))).astype(np.float32)
        got = eng.process({"a": chunks[0], "b": chunks[1]})
        state, want = step(state, torch.from_numpy(chunks))
        np.testing.assert_allclose(np.stack([got["a"], got["b"]]),
                                   want.numpy(), atol=1e-6)


def test_daemon_serves_int8_over_the_wire():
    """``--dtype int8`` in mode fused through the wire protocol: one
    client, two streams, three chunks, each stream against its own
    sequence through the plain int8 hop."""
    daemon = _daemon("--mode", "fused", "--dtype", "int8", "--no-snr-gate",
                     "--host", "127.0.0.1")
    server = threading.Thread(target=daemon.serve_forever, daemon=True)
    server.start()
    try:
        assert daemon.listening.wait(RECV_TIMEOUT_S)
        rng = np.random.default_rng(13)
        data = (0.1 * rng.standard_normal((2, 3, daemon.cfg.dsp.hop_length))
                ).astype(np.float32)
        got = np.zeros_like(data)
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
    finally:
        daemon.stop()
        server.join(RECV_TIMEOUT_S)
    assert not server.is_alive()
    hop = make_fused_hop(daemon.cfg, daemon.engine.plan, "cpu",
                         compute_dtype=torch.int8)
    state = fused_hop_init_state(daemon.cfg, daemon.engine.plan, 2)
    for k in range(3):
        state, out = hop(state, torch.from_numpy(data[:, k].copy()))
        np.testing.assert_allclose(got[:, k], out.numpy(), atol=1e-6)

"""The port's serving slice against the JAX package on the CPU:
StreamEngine mode 'fused' (masked commit, ingress sanitization, slot
reuse, snapshot/restore) and the EngineDaemon's wire protocol."""

import os
import threading
from multiprocessing.connection import Client

import numpy as np
import pytest
import torch

from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.runtime.engine import StreamEngine as JaxEngine

from audio_denoising_torch.apps.engine_serve import EngineDaemon
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.ops.kernels.fused_hop import (
    fused_hop_init_state, make_fused_hop)
from audio_denoising_torch.runtime.engine import StreamEngine

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
        before = [t[y_slot].clone() for t in engine.state]
        engine.process({"x": np.ones(hop, np.float32)})
        for a, b in zip(before, engine.state):
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
        StreamEngine(cfg, model, mode="fast", device="cpu")


def test_daemon_refuses_a_profile_it_cannot_serve():
    """A unit-gain checkpoint's recommended profile turns the SNR gate on,
    which the port's fused hop lacks: the daemon refuses it rather than
    serve it ungated."""
    path = os.path.join(REPO, "runs", "gruunet2s16kw40-mrstft-idp-50k.npz")
    with pytest.raises(NotImplementedError, match="SNR gate"):
        EngineDaemon(path, max_streams=2, address=("127.0.0.1", 0),
                     device="cpu")


def _recv(conn):
    if not conn.poll(RECV_TIMEOUT_S):
        raise TimeoutError("no reply from the daemon")
    return conn.recv()


def test_daemon_serves_two_clients():
    daemon = EngineDaemon(SPEC, max_streams=8, address=("127.0.0.1", 0),
                          device="cpu")
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

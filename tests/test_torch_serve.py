"""The port's serving surface against the JAX package's, on the CPU: the
WebSocket browser-mic daemon (``apps/ws_serve.py``), the reference-protocol
socket daemon (``apps/serve.py``) and the engine's downgrades.

Every daemon binds port 0 (files run side by side) and runs with
``device="cpu"``, where the kernels' wrappers run their plain versions.
Replies are held against JAX's ``StreamEngine`` or ``SocketDaemon.process``
on the same float inputs."""

import base64
import dataclasses
import filecmp
import hashlib
import importlib.util
import inspect
import json
import os
import socket
import struct
import threading
import time
import warnings
from multiprocessing.connection import Client

import numpy as np
import pytest
import torch
import jax

from audio_denoising_tpu.apps.serve import SocketDaemon as JaxSocketDaemon
from audio_denoising_tpu.apps.ws_serve import WSDaemon as JaxWSDaemon
from audio_denoising_tpu.config import (
    Config as JaxConfig, DSPConfig as JaxDSPConfig,
    ModelConfig as JaxModelConfig, recommended_serving as jax_recommended)
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.io.wavio import (
    float32_to_pcm16 as jax_to_pcm16, pcm_to_float32 as jax_to_float32)
from audio_denoising_tpu.models import build_model as jax_build_model
from audio_denoising_tpu.runtime.engine import StreamEngine as JaxEngine

from audio_denoising_torch.apps import serve, ws_serve
from audio_denoising_torch.apps.serve import SocketDaemon
from audio_denoising_torch.apps.ws_serve import WSDaemon
from audio_denoising_torch.compat import params_from_jax
from audio_denoising_torch.config import Config, DSPConfig, ModelConfig
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.io import websocket as ws
from audio_denoising_torch.models import build_model
from audio_denoising_torch.ops.kernels import webrtc_hop
from audio_denoising_torch.ops.kernels.fused_hop import (
    fused_hop_init_state, fused_hop_smem_bytes, make_fused_hop)
from audio_denoising_torch.runtime import engine as engine_mod
from audio_denoising_torch.runtime.engine import StreamEngine, hop_smem_bytes
from audio_denoising_torch.runtime.plan import build_cell_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_ATOL = 2e-4      # tests/test_fused_hop.py's bound on a hop's output
# a reply in int16: OUT_ATOL in LSB, plus one for the conversion's rounding
PCM_LSB = int(np.ceil(OUT_ATOL * 32767)) + 1
HX_ATOL = 1e-5       # the webrtc step's state (tests/test_torch_webrtc.py)
SNR_DB = 40.0        # Griffin-Lim waveforms of two fp32 versions
SMEM_LIMIT = 232448  # an H100 block's opt-in shared memory, bytes
FLAGSHIP = os.path.join(REPO, "runs", "gruunet2mel128w64-mrstft-50k.npz")
UNET4 = os.path.join(REPO, "runs", "unet4crop2s-mrstft-30k.npz")
UNET4_WIDE = os.path.join(REPO, "runs", "unet4wide-crop2s-mrstft-30k.npz")
TRUNET = os.path.join(REPO, "runs", "trunet-realnoise.npz")
RECV_TIMEOUT_S = 60.0


# -- a browser's side of the WebSocket protocol --------------------------------

def _client_send(sock, payload: bytes, opcode=ws.OP_BINARY):
    """Client frames are masked (RFC 6455 §5.1)."""
    mask = os.urandom(4)
    data = np.frombuffer(payload, np.uint8)
    m = np.frombuffer((mask * (len(data) // 4 + 1))[:len(data)], np.uint8)
    n = len(payload)
    head = bytes([0x80 | opcode])
    if n < 126:
        head += bytes([0x80 | n])
    elif n < (1 << 16):
        head += bytes([0x80 | 126]) + struct.pack(">H", n)
    else:
        head += bytes([0x80 | 127]) + struct.pack(">Q", n)
    sock.sendall(head + mask + (data ^ m).tobytes())


def _connect(address):
    sock = socket.create_connection(address, timeout=RECV_TIMEOUT_S)
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall((f"GET /stream HTTP/1.1\r\nHost: {address[0]}\r\n"
                  "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += sock.recv(4096)
    head, leftover = resp.split(b"\r\n\r\n", 1)
    assert b" 101 " in head.split(b"\r\n", 1)[0]
    accept = base64.b64encode(hashlib.sha1(
        (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest())
    assert accept in head
    return ws.Buffered(sock, leftover)


def _recv_pcm(conn, n_samples):
    got = b""
    while len(got) < 2 * n_samples:
        _, op, payload = ws.recv_frame(conn)
        assert op == ws.OP_BINARY
        got += payload
    return np.frombuffer(got, np.int16)


def _recv_text(conn):
    while True:
        _, op, payload = ws.recv_frame(conn)
        if op == ws.OP_TEXT:
            return json.loads(payload)


def _http(address, path, method="GET"):
    with socket.create_connection(address, timeout=RECV_TIMEOUT_S) as s:
        s.sendall(f"{method} {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        data = b""
        while True:
            part = s.recv(65536)
            if not part:
                break
            data += part
    head, body = data.split(b"\r\n\r\n", 1)
    return head.split(b"\r\n")[0], body


def _pcm(rng, n):
    return (np.clip(0.1 * rng.standard_normal(n), -1, 1)
            * 32767).astype(np.int16)


def _frames(pcm, sizes):
    """``pcm`` cut into frames of ``sizes`` samples (odd ones included,
    so the re-chunker carries residue)."""
    edges = np.cumsum([0, *sizes])
    assert edges[-1] == pcm.size
    return [pcm[a:b] for a, b in zip(edges[:-1], edges[1:])]


def _serving(daemon):
    thread = threading.Thread(target=daemon.serve_forever, daemon=True)
    thread.start()
    assert daemon.listening.wait(RECV_TIMEOUT_S)
    return thread


def _stop(daemon, thread):
    daemon.stop()
    thread.join(RECV_TIMEOUT_S)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ws_daemon():
    daemon = WSDaemon("gruunet2-good", "127.0.0.1", 0, max_streams=4,
                      mode="fast", tick_ms=0.5, device="cpu")
    thread = _serving(daemon)
    yield daemon
    _stop(daemon, thread)


# -- the WebSocket daemon -------------------------------------------------------

def test_ws_replies_match_the_jax_engine(ws_daemon):
    """Two clients send int16 frames of odd sizes; each one's replies, in
    order, against JAX's StreamEngine driven hop by hop on the same float
    chunks, converted to int16 the same way: within PCM_LSB."""
    hop, n_hops = ws_daemon.hop, 6
    rng = np.random.default_rng(21)
    pcm = {c: _pcm(rng, hop * n_hops) for c in "ab"}
    sizes = {"a": (701, 1403, 968), "b": (333, 1999, 740)}
    conns = {c: _connect(ws_daemon.address) for c in "ab"}
    try:
        for c in "ab":
            for frame in _frames(pcm[c], sizes[c]):
                _client_send(conns[c], frame.tobytes())
        got = {c: _recv_pcm(conns[c], hop * n_hops) for c in "ab"}
    finally:
        for conn in conns.values():
            conn.close()
    jcfg, jmodel, jparams = jax_load_pretrained("gruunet2-good")
    jeng = JaxEngine(jax_recommended(jcfg), jmodel, jparams, mode="fast",
                     max_streams=2)
    chunks = {c: jax_to_float32(pcm[c]).reshape(n_hops, hop) for c in "ab"}
    for c in "ab":
        jeng.add_stream(c)
    want = {c: [] for c in "ab"}
    for k in range(n_hops):
        out = jeng.process({c: chunks[c][k] for c in "ab"})
        for c in "ab":
            want[c].append(jax_to_pcm16(np.asarray(out[c])))
    for c in "ab":
        err = np.abs(got[c].astype(np.int32)
                     - np.concatenate(want[c]).astype(np.int32))
        assert err.max() <= PCM_LSB, (c, err.max())
        assert np.abs(got[c]).max() > 0


def test_ws_mode_fused_matches_the_plain_hop():
    """Mode fused on gruunet2-stream16k, int16 frames of odd sizes: the
    replies against the fused hop's plain version on the same float
    chunks (held against JAX's kernel in tests/test_torch_fused_hop.py),
    within PCM_LSB."""
    daemon = WSDaemon("gruunet2-stream16k", "127.0.0.1", 0, max_streams=2,
                      mode="fused", tick_ms=0.5, device="cpu")
    thread = _serving(daemon)
    hop, n_hops = daemon.hop, 5
    pcm = _pcm(np.random.default_rng(22), hop * n_hops)
    try:
        conn = _connect(daemon.address)
        for frame in _frames(pcm, (511, 289, 800)):
            _client_send(conn, frame.tobytes())
        got = _recv_pcm(conn, hop * n_hops)
        conn.close()
    finally:
        _stop(daemon, thread)
    step = make_fused_hop(daemon.cfg, daemon.engine.plan, "cpu")
    state = fused_hop_init_state(daemon.cfg, daemon.engine.plan, 1)
    chunks = jax_to_float32(pcm).reshape(n_hops, 1, hop)
    want = []
    for k in range(n_hops):
        state, out = step(state, torch.from_numpy(chunks[k].copy()))
        want.append(jax_to_pcm16(out.numpy()[0]))
    err = np.abs(got.astype(np.int32) - np.concatenate(want).astype(np.int32))
    assert err.max() <= PCM_LSB


def test_ws_get_root_serves_the_substituted_page(ws_daemon):
    status, body = _http(ws_daemon.address, "/")
    assert status == b"HTTP/1.1 200 OK"
    page = body.decode()
    for placeholder in ("__SAMPLE_RATE__", "__HOP__", "__MODEL__"):
        assert placeholder not in page
    assert f"const SR = {ws_daemon.cfg.dsp.sample_rate};" in page
    assert f"const HOP = {ws_daemon.hop};" in page
    assert "<b>gruunet2-good</b>" in page
    assert _http(ws_daemon.address, "/nope")[0].split()[1] == b"404"
    assert _http(ws_daemon.address, "/", "POST")[0].split()[1] == b"405"


def test_ws_page_is_the_ports_own_copy_of_jax_s():
    ours = os.path.join(os.path.dirname(ws_serve.__file__), "static",
                        "index.html")
    assert os.path.dirname(ours) == ws_serve._STATIC_DIR
    assert "audio_denoising_tpu" not in ws_serve._STATIC_DIR
    assert filecmp.cmp(ours, os.path.join(
        REPO, "audio_denoising_tpu", "apps", "static", "index.html"),
        shallow=False)


def test_ws_stats_and_reaping_after_an_abrupt_close(ws_daemon):
    """``stats`` reports the active streams; a client that vanishes
    without a close frame has its slot reaped."""
    hop = ws_daemon.hop
    conn = _connect(ws_daemon.address)
    _client_send(conn, _pcm(np.random.default_rng(23), hop).tobytes())
    assert _recv_pcm(conn, hop).size == hop
    _client_send(conn, b"stats", ws.OP_TEXT)
    stats = _recv_text(conn)
    assert stats["active_streams"] >= 1
    assert stats["algorithmic_latency_ms"] == round(
        ws_daemon.engine.algorithmic_latency_ms, 3)
    assert stats["counters"]["hops"] >= 1
    conn.close()                     # no close frame
    deadline = time.monotonic() + RECV_TIMEOUT_S
    while ws_daemon.engine.active_streams and time.monotonic() < deadline:
        time.sleep(0.05)
    assert ws_daemon.engine.active_streams == 0


def test_ws_full_engine_closes_with_1013():
    daemon = WSDaemon("gruunet2-good", "127.0.0.1", 0, max_streams=1,
                      tick_ms=0.5, device="cpu")
    thread = _serving(daemon)
    try:
        first = _connect(daemon.address)
        deadline = time.monotonic() + RECV_TIMEOUT_S
        while not daemon.engine.active_streams and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        second = _connect(daemon.address)
        _, op, payload = ws.recv_frame(second)
        assert op == ws.OP_TEXT and "engine full" in json.loads(payload)[
            "error"]
        _, op, payload = ws.recv_frame(second)
        assert op == ws.OP_CLOSE and payload[:2] == b"\x03\xf5"
        first.close()
        second.close()
    finally:
        _stop(daemon, thread)


def test_ws_keeps_the_jax_daemons_defaults():
    ours = inspect.signature(WSDaemon).parameters
    theirs = inspect.signature(JaxWSDaemon).parameters
    for name in ("spec", "host", "port", "max_streams", "mode", "tick_ms",
                 "pipeline_depth", "snr_gate_db", "dtype", "auto_gate"):
        assert ours[name].default == theirs[name].default, name
    args = ws_serve.parser().parse_args([])
    assert (args.model, args.mode, args.max_streams, args.port,
            args.device) == ("gruunet2-good", "fast", 256, 8765, "cuda")
    assert ws_serve.REPLY_QUEUE == 64


@pytest.mark.parametrize("mode,gated", [("fast", True), ("fused", True),
                                        ("webrtc", False)])
def test_ws_gate_rule_and_dtype_order(mode, gated):
    """The tuned gate in modes fast and fused unless a gate flag is given;
    --dtype applied after the gate profile, as in the JAX daemon."""
    spec = os.path.join(REPO, "runs", "gruunet2s16kw40-mrstft-idp-50k.npz")
    daemon = WSDaemon(spec, "127.0.0.1", 0, max_streams=2, mode=mode,
                      device="cpu", dtype="bfloat16")
    assert (daemon.cfg.serving.snr_gate_db is not None) == gated
    assert daemon.cfg.serving.dtype == "bfloat16"
    assert WSDaemon(spec, "127.0.0.1", 0, max_streams=2, mode=mode,
                    device="cpu", auto_gate=False
                    ).cfg.serving.snr_gate_db is None


def test_ws_serves_a_lookahead_checkpoint_in_mode_fast():
    """``ws --mode fused`` on a bounded-lookahead checkpoint (la4): the
    engine warns and serves mode fast with its delay rings, under the
    daemon's gate profile, as JAX's engine does; a client's int16
    replies against JAX's engine in mode fast on the same profile, within
    PCM_LSB."""
    spec = os.path.join(REPO, "runs",
                        "gruunet2mel128w64-mrstft-la4-50k.npz")
    with pytest.warns(UserWarning, match="downgraded to 'fast'"):
        daemon = WSDaemon(spec, "127.0.0.1", 0, max_streams=2,
                          mode="fused", tick_ms=0.5, device="cpu")
    assert daemon.engine.mode == "fast"
    assert daemon.engine.state.la_mag.shape[1] == 4
    hop, n_hops = daemon.hop, 6
    pcm = _pcm(np.random.default_rng(23), hop * n_hops)
    thread = _serving(daemon)
    try:
        conn = _connect(daemon.address)
        for frame in _frames(pcm, (700, 1500, 872)):
            _client_send(conn, frame.tobytes())
        got = _recv_pcm(conn, hop * n_hops)
        conn.close()
    finally:
        _stop(daemon, thread)
    jcfg, jmodel, jparams = jax_load_pretrained(spec)
    jeng = JaxEngine(jax_recommended(jcfg), jmodel, jparams, mode="fast",
                     max_streams=1)
    jeng.add_stream("a")
    chunks = jax_to_float32(pcm).reshape(n_hops, hop)
    want = np.concatenate([jax_to_pcm16(np.asarray(
        jeng.process({"a": chunks[k]})["a"])) for k in range(n_hops)])
    err = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert err.max() <= PCM_LSB
    assert np.abs(got).max() > 0


def test_ws_serves_fused_webrtc_at_bfloat16(tmp_path):
    """``ws --mode fused-webrtc --dtype bfloat16`` on a warm dari_tult
    checkpoint serves the bf16 Griffin-Lim hop in mode fused-webrtc."""
    from audio_denoising_torch.compat import save_params_npz
    cfg, model = load_pretrained("gruunet2-dari_tult")
    warm = dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, griffin_lim_warm_start=True))
    path = str(tmp_path / "dari-warm.npz")
    save_params_npz(path, {k: v.numpy() for k, v in
                           model.state_dict().items()},
                    {"full_config": json.loads(warm.to_json())})
    daemon = WSDaemon(path, "127.0.0.1", 0, max_streams=2,
                      mode="fused-webrtc", dtype="bfloat16", device="cpu")
    assert daemon.engine.mode == "fused-webrtc"
    assert daemon.engine.hop_step.gl_bf16


# the three cases this test refused (naming ROADMAP A8) until the segment
# family was ported, each served now on one of its checkpoints
@pytest.mark.parametrize("argv", [
    ["--mode", "unet", "--model", UNET4],
    ["--mode", "unet", "--model", UNET4_WIDE, "--unet-seg-hops", "2",
     "--unet-ctx", "384", "--unet-xfade", "192", "--unet-ctx-left", "768"],
    ["--mode", "unet", "--model", TRUNET, "--unet-seg-hops", "2",
     "--unet-ctx", "384", "--unet-xfade", "128", "--unet-ctx-left",
     "128"]])
def test_ws_serves_the_unet_family(argv, smoke):
    """``ws --mode unet`` (the recommended window on unet4crop2s; every
    geometry flag on the wide U-Net and on TRUNet) parses and serves:
    two clients stream int16 frames of odd sizes, each one's replies in
    order against JAX's engine replaying the daemon's rounds (cadence
    locked: a client that misses a round gets zeros there, in both),
    within PCM_LSB."""
    args = ws_serve.parser().parse_args(
        [*argv, "--device", "cpu", "--port", "0", "--max-streams", "2",
         "--host", "127.0.0.1"])
    daemon = WSDaemon(args.model, args.host, args.port, args.max_streams,
                      args.mode, device="cpu",
                      unet_seg_hops=args.unet_seg_hops,
                      unet_ctx=args.unet_ctx, unet_xfade=args.unet_xfade,
                      unet_ctx_left=args.unet_ctx_left)
    assert daemon.engine.mode == "unet"
    log = smoke.recorded_rounds(daemon.engine)
    thread = _serving(daemon)
    hop = daemon.hop
    n_hops = 2 * daemon.cfg.serving.unet_seg_hops + 1
    rng = np.random.default_rng(22)
    pcm = {c: _pcm(rng, hop * n_hops) for c in "ab"}
    cut = hop * n_hops // 3
    try:
        conns = {c: _connect(daemon.address) for c in "ab"}
        for c in "ab":
            for frame in _frames(pcm[c], (cut - 1, cut + 1,
                                          hop * n_hops - 2 * cut)):
                _client_send(conns[c], frame.tobytes())
        got = {c: _recv_pcm(conns[c], hop * n_hops) for c in "ab"}
        for conn in conns.values():
            conn.close()
    finally:
        _stop(daemon, thread)
    jcfg, jmodel, jparams = jax_load_pretrained(args.model)
    want = smoke.replay_rounds(log, JaxEngine(
        dataclasses.replace(jcfg, serving=daemon.cfg.serving), jmodel,
        jparams, mode="unet", max_streams=2))
    # the daemon names its streams: a client's is the one its first hop
    # went to
    for c in "ab":
        first = jax_to_float32(pcm[c][:hop])
        sid, = {s for op, arg in log if op == "tick"
                for s, chunk in arg.items() if np.array_equal(chunk, first)}
        w = jax_to_pcm16(want[sid].reshape(-1)).astype(np.int32)
        assert w.size == hop * n_hops
        assert np.abs(got[c].astype(np.int32) - w).max() <= PCM_LSB


@pytest.mark.parametrize("app", [ws_serve, serve])
def test_daemons_need_a_card_unless_cpu_is_asked(app, monkeypatch, capsys):
    """Without a card and without --device cpu, ws and serve exit 1
    before they load a model or bind a socket."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bound = []
    monkeypatch.setattr(socket.socket, "bind",
                        lambda *a: bound.append(a))
    with pytest.raises(SystemExit) as e:
        app.main(["--port", "0"])
    assert e.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not bound


# -- the socket daemon -----------------------------------------------------------

LENGTHS = (512, 1000, 2048, 777)


def _messages(seed):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal((n, 2))).astype(np.float32)
            for n in LENGTHS]


@pytest.fixture(scope="module")
def jax_socket():
    return JaxSocketDaemon("gruunet2-good", ("localhost", 0))


def _jax_replies(jax_socket, messages, hx=None):
    hx = jax_socket.model.init_state(1) if hx is None else hx
    out = []
    for m in messages:
        y, hx = jax_socket.process(m, hx)
        out.append(np.asarray(y))
    return out, hx


@pytest.mark.parametrize("shared", [False, True])
def test_socket_daemon_matches_jax(jax_socket, shared):
    """Two connections, their messages interleaved: each reply the shape
    of its (n, 2) message, within OUT_ATOL of JAX's SocketDaemon.process
    with a state per connection, or one state over both in arrival
    order under --shared-state."""
    daemon = SocketDaemon("gruunet2-good", ("127.0.0.1", 0),
                          shared_state=shared, device="cpu")
    thread = _serving(daemon)
    msgs = {"a": _messages(31), "b": _messages(32)}
    order = [(c, k) for k in range(len(LENGTHS)) for c in "ab"]
    got = {"a": [], "b": []}
    try:
        conns = {c: Client(daemon.address) for c in "ab"}
        for c, k in order:
            conns[c].send(msgs[c][k])
            assert conns[c].poll(RECV_TIMEOUT_S)
            got[c].append(conns[c].recv())
        for conn in conns.values():
            conn.send("close")
            conn.close()
    finally:
        _stop(daemon, thread)
    if shared:
        want_seq, _ = _jax_replies(jax_socket, [msgs[c][k] for c, k in order])
        want = {"a": want_seq[0::2], "b": want_seq[1::2]}
    else:
        want = {c: _jax_replies(jax_socket, msgs[c])[0] for c in "ab"}
    for c in "ab":
        for k, (g, w) in enumerate(zip(got[c], want[c])):
            assert g.shape == msgs[c][k].shape
            np.testing.assert_allclose(g, w, atol=OUT_ATOL)
            np.testing.assert_array_equal(g[:, 0], g[:, 1])
    assert daemon.metrics.summary()["counters"]["messages"] == len(order)


@pytest.mark.parametrize("payload", ["hello", np.zeros((2, 2, 2)),
                                     np.zeros((0, 2))])
def test_socket_daemon_replies_to_a_malformed_payload(payload):
    """An error reply, then this connection closes; another connection
    is served on."""
    daemon = SocketDaemon("gruunet2-good", ("127.0.0.1", 0), device="cpu")
    thread = _serving(daemon)
    try:
        with Client(daemon.address) as bad, Client(daemon.address) as good:
            bad.send(payload)
            assert bad.poll(RECV_TIMEOUT_S)
            reply = bad.recv()
            assert isinstance(reply, str)
            assert reply.startswith("error: malformed payload")
            with pytest.raises(EOFError):
                bad.recv()
            good.send(np.zeros((512, 1), np.float32))
            assert good.poll(RECV_TIMEOUT_S)
            assert good.recv().shape == (512, 1)
    finally:
        _stop(daemon, thread)
    assert daemon.metrics.summary()["counters"]["malformed"] == 1


def test_socket_daemon_keeps_the_jax_daemons_defaults():
    ours = inspect.signature(SocketDaemon).parameters
    theirs = inspect.signature(JaxSocketDaemon).parameters
    for name in ("spec", "address", "shared_state", "snr_gate_db",
                 "auto_gate"):
        assert ours[name].default == theirs[name].default, name
    args = serve.parser().parse_args([])
    assert (args.model, args.port, args.device) == ("gruunet2-good", 6101,
                                                    "cuda")


# -- the engine's downgrades ------------------------------------------------------

SMALL = dict(n_fft=64, hop_length=32, n_mels=16, sample_rate=16000,
             reconstruction="griffin_lim", griffin_lim_iters=2,
             griffin_lim_warm_start=True)
SMALL_MODEL = dict(arch="GRUUNet2", num_compressed_bins=4,
                   hidden_sizes=(5, 5), kernel_sizes=(3, 3), strides=(2, 2),
                   paddings=(1, 1), num_gaussians=3)


def _small(**serving):
    """JAX's (cfg, model, params) and the port's (cfg, model) at the JAX
    webrtc tests' small geometry, on the same random weights."""
    jcfg = JaxConfig(dsp=JaxDSPConfig(**SMALL),
                     model=JaxModelConfig(**SMALL_MODEL))
    jcfg = dataclasses.replace(jcfg, serving=dataclasses.replace(
        jcfg.serving, **serving))
    jmodel = jax_build_model(jcfg.model, num_bins=16)
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = Config(dsp=DSPConfig(**SMALL), model=ModelConfig(**SMALL_MODEL))
    cfg = dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, **serving))
    model = build_model(cfg.model, num_bins=16).load_params(
        params_from_jax({k: np.asarray(v) for k, v in params.items()}))
    return (jcfg, jmodel, params), (cfg, model)


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(max((ref ** 2).sum(), 1e-20)
                         / max(((ref - got) ** 2).sum(), 1e-20))


def _warned(fn, *args, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    return out, [str(w.message) for w in caught]


def _ticks(engines, hop, n, seed, amp=0.2):
    """Both engines over ``n`` ticks of streams 'a' and 'b' ('b' idle on
    the third); -> per engine, per stream, the outputs in order."""
    rng = np.random.default_rng(seed)
    outs = [{"a": [], "b": []} for _ in engines]
    for e in engines:
        for s in "ab":
            e.add_stream(s)
    for t in range(n):
        chunks = {"a": (amp * rng.standard_normal(hop)).astype(np.float32)}
        if t != 2:
            chunks["b"] = (amp * rng.standard_normal(hop)).astype(np.float32)
        for e, o in zip(engines, outs):
            for s, y in e.process(chunks).items():
                o[s].append(np.asarray(y))
    return outs


def test_gated_fused_webrtc_is_served_in_mode_webrtc():
    """Both engines warn and serve mode webrtc with the gate; the outputs
    at SNR_DB after each stream's first two hops and hx within HX_ATOL."""
    (jcfg, jmodel, params), (cfg, model) = _small(snr_gate_db=1.0)
    jeng, jsaid = _warned(JaxEngine, jcfg, jmodel, params,
                          mode="fused-webrtc", max_streams=2,
                          pallas_interpret=True)
    eng, said = _warned(StreamEngine, cfg, model, mode="fused-webrtc",
                        max_streams=2, device="cpu")
    assert jeng.mode == eng.mode == "webrtc" and eng.plan is None
    assert any("'fused-webrtc' downgraded to 'webrtc'" in m for m in said)
    assert any("downgrading to 'webrtc'" in m for m in jsaid)
    assert eng.state.em_out is not None
    want, got = _ticks((jeng, eng), 32, 6, 41)
    for s in "ab":
        assert _snr(np.concatenate(want[s][2:]),
                    np.concatenate(got[s][2:])) > SNR_DB
    np.testing.assert_allclose(eng.state.hx.numpy().reshape(2, -1),
                               np.asarray(jeng.state.hx).reshape(2, -1),
                               atol=HX_ATOL)


@pytest.mark.parametrize("mode", ["webrtc", "fused-webrtc"])
def test_int8_outside_fast_and_fused_is_served_in_mode_fast(mode):
    """Both engines warn and serve mode fast on the quantized plan; the
    outputs within tests/test_torch_quant.py's engine bound."""
    jcfg, jmodel, jparams = jax_load_pretrained("gruunet2-good")
    cfg, model = load_pretrained("gruunet2-good")
    int8 = lambda c: dataclasses.replace(c, serving=dataclasses.replace(
        c.serving, dtype="int8"))
    jeng, jsaid = _warned(JaxEngine, int8(jcfg), jmodel, jparams, mode=mode,
                          max_streams=2)
    eng, said = _warned(StreamEngine, int8(cfg), model, mode=mode,
                        max_streams=2, device="cpu")
    assert jeng.mode == eng.mode == "fast" and eng.plan is None
    assert any(f"{mode!r} downgraded to 'fast'" in m for m in said)
    assert any("downgrading mode" in m for m in jsaid)
    want, got = _ticks((jeng, eng), cfg.dsp.hop_length, 5, 42, amp=0.1)
    for s in "ab":
        np.testing.assert_allclose(np.concatenate(got[s]),
                                   np.concatenate(want[s]), atol=OUT_ATOL)


def _limited(monkeypatch, limit):
    monkeypatch.setattr(engine_mod, "shared_memory_limit",
                        lambda device: limit)


@pytest.fixture(scope="module")
def flagship():
    cfg, model = load_pretrained(FLAGSHIP)
    return cfg, build_cell_plan(model)


@pytest.mark.parametrize("gated,dtype,need", [
    (False, torch.int8, 231600), (True, torch.int8, 231600),
    (True, torch.float32, 223456), (False, torch.float32, 215200)])
def test_capacity_rule_on_the_flagship(flagship, gated, dtype, need):
    """The fused hop's shared memory per block for bench.py's quality
    flagship (128 mels, hidden 64 x 8): int8 takes 231,600 B, the count
    the library gave on an NVIDIA H100 (PERF.md), under the card's
    232,448, gated or not: the int8 kernel keeps the gate's two floor
    planes in global memory (they took it to 239,856 B while they were in
    shared memory); fp32 keeps them in shared memory."""
    cfg, plan = flagship
    if gated:
        cfg = dataclasses.replace(cfg, serving=dataclasses.replace(
            cfg.serving, snr_gate_db=1.0, snr_gate_estimator="both"))
    assert fused_hop_smem_bytes(cfg, plan, dtype) == need
    assert need <= SMEM_LIMIT


@pytest.mark.parametrize("gated,dtype", [(True, "int8"), (False, "int8"),
                                         (True, "float32")])
def test_capacity_rule_serves_the_flagship(flagship, gated, dtype,
                                           monkeypatch):
    """At the card's 232,448 B the flagship stays in mode fused in each
    case, the gated int8 one included (served op by op in mode fast
    until its floor planes left shared memory), as JAX serves it."""
    cfg, plan = flagship
    cfg = dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, dtype=dtype,
        snr_gate_db=1.0 if gated else None))
    _limited(monkeypatch, SMEM_LIMIT)
    served, said = _warned(engine_mod._fit, cfg, plan, "fused", None)
    assert served == "fused"
    assert not said


def test_capacity_downgrades_fused_to_fast(monkeypatch):
    """A fused hop over the stated limit: the engine warns and serves
    mode fast, whose outputs equal JAX's mode fast; at the limit it stays
    fused."""
    cfg, model = load_pretrained("gruunet2-stream16k")
    need = hop_smem_bytes(cfg, build_cell_plan(model), "fused")
    _limited(monkeypatch, need)
    assert StreamEngine(cfg, model, mode="fused", max_streams=2,
                        device="cpu").mode == "fused"
    _limited(monkeypatch, need - 1)
    eng, said = _warned(StreamEngine, cfg, model, mode="fused",
                        max_streams=2, device="cpu")
    assert eng.mode == "fast" and eng.plan is None
    assert any(f"needs {need} B" in m and "'fused' downgraded to 'fast'" in m
               for m in said)
    jcfg, jmodel, jparams = jax_load_pretrained("gruunet2-stream16k")
    jeng = JaxEngine(jcfg, jmodel, jparams, mode="fast", max_streams=2)
    want, got = _ticks((jeng, eng), cfg.dsp.hop_length, 5, 43, amp=0.1)
    for s in "ab":
        np.testing.assert_allclose(np.concatenate(got[s]),
                                   np.concatenate(want[s]), atol=OUT_ATOL)


def test_capacity_downgrades_fused_webrtc_to_webrtc(monkeypatch):
    (jcfg, jmodel, params), (cfg, model) = _small()
    need = hop_smem_bytes(cfg, build_cell_plan(model), "fused-webrtc")
    assert need == webrtc_hop.webrtc_hop_smem_bytes(
        cfg, build_cell_plan(model)) > 0
    _limited(monkeypatch, need - 1)
    eng, said = _warned(StreamEngine, cfg, model, mode="fused-webrtc",
                        max_streams=2, device="cpu")
    assert eng.mode == "webrtc"
    assert any("'fused-webrtc' downgraded to 'webrtc'" in m for m in said)
    jeng = JaxEngine(jcfg, jmodel, params, mode="webrtc", max_streams=2)
    want, got = _ticks((jeng, eng), 32, 6, 44)
    for s in "ab":
        assert _snr(np.concatenate(want[s][2:]),
                    np.concatenate(got[s][2:])) > SNR_DB


def test_cpu_engines_take_no_limit():
    """On the CPU the kernels' plain versions serve any size: no limit,
    so no capacity downgrade."""
    assert engine_mod.shared_memory_limit("cpu") is None
    assert engine_mod.shared_memory_limit(torch.device("cpu")) is None

"""The port's bounded-lookahead serving (``ModelConfig.lookahead_frames``
= k > 0) against the JAX package on the CPU: the fast step's delay
rings (the residual at hop t applies to frame t - k, whose magnitude and
phase waited k hops), the engine's rule for such checkpoints (mode
``fast`` serves them, ``fused`` is downgraded to it, the webrtc modes
refuse them), masked commit, slot reset and snapshot over the rings, the
latency they add, and the daemon serving them. The contract is JAX's
``tests/test_lookahead.py``; the weights are the shipped
``runs/gruunet2mel128w64-mrstft-la{4,10,24,48}-50k.npz`` (the quality
flagship's widths: 48 kHz, n_fft 1024, 128 mels, hidden 64)."""

import dataclasses
import os
import threading
import warnings
from multiprocessing.connection import Client

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu.config import (
    Config as JaxConfig, DSPConfig as JaxDSPConfig,
    ModelConfig as JaxModelConfig, ServingConfig as JaxServingConfig,
    with_snr_gate as jax_with_snr_gate)
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.runtime.engine import (
    StreamEngine as JaxEngine, fast_init_state as jax_fast_init_state,
    make_fast_step as jax_make_fast_step)
from audio_denoising_tpu.runtime.plan import PlanModel as JaxPlanModel

from audio_denoising_torch.apps.engine_serve import EngineDaemon
from audio_denoising_torch.config import (
    Config, DSPConfig, ModelConfig, ServingConfig, with_snr_gate)
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.runtime.engine import (
    StreamEngine, fast_init_state, make_fast_step)
from audio_denoising_torch.runtime.plan import PlanModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = {k: os.path.join(REPO, "runs",
                            f"gruunet2mel128w64-mrstft-la{k}-50k.npz")
            for k in (4, 10, 24, 48)}
OUT_ATOL = 2e-4      # tests/test_torch_offline.py's bound on the output
DELAY_ATOL = 1e-5    # tests/test_lookahead.py's exact-delay bound
HOPS = 20
RECV_TIMEOUT_S = 30.0


@pytest.fixture(scope="module")
def la4():
    """JAX's (cfg, model, params) and the port's (cfg, model) on the la4
    fixture."""
    return jax_load_pretrained(FIXTURES[4]), load_pretrained(FIXTURES[4])


def _chunks(rng, batch, hop, hops):
    """A voiced tone under noise, a different pitch per stream, and one
    silent hop (angle(0) is 0): the tuned gate blends on it."""
    t = np.arange(hops * hop) / 48000.0
    out = np.empty((hops, batch, hop), np.float32)
    for b in range(batch):
        f0 = 140.0 + 35.0 * b
        voice = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 8))
        sig = 0.05 * voice + 0.01 * rng.standard_normal(t.size)
        out[:, b] = sig.reshape(hops, hop)
    out[3] = 0.0
    return out


# -- the delay rings: an exact delay on the zero model ------------------------

class ZeroModel:
    """The residual-zero recurrent stand-in of tests/test_lookahead.py:
    denoise == passthrough, so a misaligned magnitude or phase shows as a
    large waveform error instead of cancelling."""

    device = torch.device("cpu")

    def init_state(self, batch, dtype=torch.float32, device=None):
        return torch.zeros((batch, 4), dtype=dtype, device=device)

    def cell(self, x_t, hx):
        return torch.zeros_like(x_t), hx


def _raw_cfg(lookahead):
    # raw domain: expm1(log1p(mag)) == mag, so the zero model's chain is a
    # pure delay, with no mel round trip in the bound
    return Config(
        dsp=DSPConfig(sample_rate=16000, n_fft=256, hop_length=128,
                      n_mels=129, domain="raw", reconstruction="phase"),
        model=ModelConfig(arch="GRUUNet2", lookahead_frames=lookahead),
        serving=ServingConfig(chunk_samples=128))


def _run_zero(lookahead, chunks):
    cfg, model = _raw_cfg(lookahead), ZeroModel()
    step, state = make_fast_step(cfg, model, "cpu"), fast_init_state(
        cfg, model, 1)
    outs = []
    for chunk in chunks:
        state, out = step(state, torch.from_numpy(chunk[None]))
        outs.append(out[0].numpy())
    return np.stack(outs), state


def test_fast_step_lookahead_is_exact_delay(rng):
    """Zero residual with lookahead k is the causal stream's output
    delayed by exactly k hops, and silence for the first k; the rings
    have shape (B, k, F)."""
    hop, k, n = 128, 3, 24
    chunks = (rng.standard_normal((n, hop)) * 0.3).astype(np.float32)
    base, _ = _run_zero(0, chunks)
    la, state = _run_zero(k, chunks)
    np.testing.assert_allclose(la[k:], base[:-k], rtol=0, atol=DELAY_ATOL)
    np.testing.assert_allclose(la[:k], 0.0, atol=1e-6)
    assert state.la_mag.shape == state.la_phase.shape == (1, k, 129)


# -- the fast step against JAX's on the la4 fixture --------------------------

def _gated(jcfg, cfg):
    """The tuned gate ('both', 1 dB, width 6) on both sides."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (jax_with_snr_gate(jcfg, 1.0, 6.0, "both"),
                with_snr_gate(cfg, 1.0, 6.0, "both"))


@pytest.mark.parametrize("gate", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("kind", ["zoo", "plan"])
def test_fast_step_matches_jax_on_la4(la4, kind, gate):
    """B = 3 over 20 hops: every hop's output within 2e-4 of JAX's, the
    rings and hx carried alike; under the gate its planes too, and the
    gate moves the output (by 1.3e-2 at the last hop)."""
    (jcfg, jmodel, params), (cfg, model) = la4
    if gate:
        jcfg, cfg = _gated(jcfg, cfg)
    if kind == "plan":
        jmodel = JaxPlanModel(jmodel, params)
        model = PlanModel(model, device="cpu")
    jstep = jax.jit(jax_make_fast_step(jcfg, jmodel))
    js = jax_fast_init_state(jcfg, jmodel, 3)
    step = make_fast_step(cfg, model, "cpu")
    s = fast_init_state(cfg, model, 3)
    assert s.la_mag.shape == (3, 4, cfg.dsp.n_stft)
    chunks = _chunks(np.random.default_rng(11), 3, cfg.dsp.hop_length, HOPS)
    for chunk in chunks:
        js, jout = jstep(params, js, jnp.asarray(chunk))
        s, out = step(s, torch.from_numpy(chunk))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=OUT_ATOL)
    for name in ("la_mag", "la_phase", "ring", "ola"):
        np.testing.assert_allclose(getattr(s, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   atol=OUT_ATOL, err_msg=name)
    np.testing.assert_allclose(s.hx.reshape(3, -1).numpy(),
                               np.asarray(js.hx).reshape(3, -1), atol=1e-5)
    if gate:
        for name in ("nf_smooth", "nf_floor", "nf_total", "em_out",
                     "em_rem"):
            got, want = getattr(s, name).numpy(), np.asarray(
                getattr(js, name))
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)
        ungated = make_fast_step(la4[1][0], model, "cpu")
        u = fast_init_state(la4[1][0], model, 3)
        for chunk in chunks:
            u, uout = ungated(u, torch.from_numpy(chunk))
        moved = (uout - out).abs().max().item()
        assert moved > 10 * OUT_ATOL


@pytest.mark.parametrize("k", [4, 10, 24, 48])
def test_engine_fast_matches_jax_on_each_fixture(k, rng):
    """StreamEngine mode 'fast' on each shipped lookahead checkpoint: two
    slots, 'b' idling on ticks 2-3, against JAX's engine (its
    make_fast_step) within 2e-4."""
    jcfg, jmodel, params = jax_load_pretrained(FIXTURES[k])
    cfg, model = load_pretrained(FIXTURES[k])
    assert cfg.model.lookahead_frames == k
    jeng = JaxEngine(jcfg, jmodel, params, mode="fast", max_streams=2)
    eng = StreamEngine(cfg, model, mode="fast", max_streams=2, device="cpu")
    assert eng.state.la_mag.shape == (2, k, cfg.dsp.n_stft)
    for e in (jeng, eng):
        e.add_stream("a")
        e.add_stream("b")
    hop = cfg.dsp.hop_length
    chunks = _chunks(rng, 2, hop, k + 6)
    for t, both in enumerate(chunks):
        tick = {"a": both[0]} if t in (2, 3) else {"a": both[0],
                                                    "b": both[1]}
        want, got = jeng.process(tick), eng.process(tick)
        for sid in tick:
            np.testing.assert_allclose(got[sid], want[sid], atol=OUT_ATOL)
    assert np.abs(got["a"]).max() > 0


def test_fused_cell_serves_lookahead(la4, rng):
    """PlanModel(fused=True) (the fused cell's plain version here; its
    kernel on the card) on la4: the engine against JAX's with its Pallas
    cell in interpret mode, two slots over 8 ticks."""
    (jcfg, jmodel, params), (cfg, model) = la4
    jeng = JaxEngine(jcfg, JaxPlanModel(jmodel, params, fused=True,
                                        interpret=True), params,
                     mode="fast", max_streams=2)
    eng = StreamEngine(cfg, PlanModel(model, fused=True, device="cpu"),
                       mode="fast", max_streams=2, device="cpu")
    for e in (jeng, eng):
        e.add_stream("a")
        e.add_stream("b")
    for both in _chunks(rng, 2, cfg.dsp.hop_length, 8):
        tick = {"a": both[0], "b": both[1]}
        want, got = jeng.process(tick), eng.process(tick)
        for sid in tick:
            np.testing.assert_allclose(got[sid], want[sid], atol=OUT_ATOL)
    assert eng.state.la_mag.shape == (2, 4, cfg.dsp.n_stft)


def test_int8_plan_serves_lookahead(la4, rng):
    """PlanModel(quantized=True) on la4 (mode 'fast' at int8): each hop
    from JAX's state within 2e-4 of JAX's step on its quantized plan (a
    free run is not held there: a value that crosses a rounding tie of
    the next frame's quantization moves one int8 step and spreads through
    hx, tests/test_torch_quant.py), and the int8 engine equals that step
    run alone."""
    (jcfg, jmodel, params), (cfg, model) = la4
    jpm = JaxPlanModel(jmodel, params, quantized=True)
    pm = PlanModel(model, device="cpu", quantized=True)
    jstep = jax.jit(jax_make_fast_step(jcfg, jpm))
    js = jax_fast_init_state(jcfg, jpm, 2)
    step = make_fast_step(cfg, pm, "cpu")
    s = fast_init_state(cfg, pm, 2)
    own = fast_init_state(cfg, pm, 2)
    eng = StreamEngine(dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, dtype="int8")), model, mode="fast", max_streams=2,
        device="cpu")
    eng.add_stream("a")
    eng.add_stream("b")
    for both in _chunks(rng, 2, cfg.dsp.hop_length, 8):
        s = s._replace(**{k: torch.from_numpy(np.array(getattr(js, k)))
                          for k in ("ring", "ola", "hx", "la_mag",
                                    "la_phase")})
        js, jout = jstep(params, js, jnp.asarray(both))
        s, out = step(s, torch.from_numpy(both))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=OUT_ATOL)
        own, want = step(own, torch.from_numpy(both))
        got = eng.process({"a": both[0], "b": both[1]})
        for j, sid in enumerate("ab"):
            np.testing.assert_allclose(got[sid], want[j].numpy(), atol=1e-6)
    assert eng.state.la_mag.shape == (2, 4, cfg.dsp.n_stft)


# -- the engine: mode gating, masked commit, reset, snapshot, latency --------

@pytest.fixture(scope="module")
def tiny_la():
    """tests/test_lookahead.py's tiny lookahead-3 GRUUNet2, random weights
    from a seed, on the port's side."""
    from audio_denoising_torch.models import build_model
    cfg = Config(
        dsp=DSPConfig(sample_rate=16000, n_fft=256, hop_length=128,
                      n_mels=32, domain="mel", reconstruction="phase"),
        model=ModelConfig(arch="GRUUNet2", lookahead_frames=3,
                          hidden_sizes=(6, 6, 6), kernel_sizes=(3, 3, 3),
                          strides=(2, 2, 2), paddings=(1, 1, 1),
                          num_compressed_bins=4),
        serving=ServingConfig(chunk_samples=128, max_streams=4))
    torch.manual_seed(0)
    return cfg, build_model(cfg.model, num_bins=cfg.dsp.n_mels)


def test_engine_mode_gating(tiny_la):
    """As JAX's engine: 'fused' warns and serves 'fast'; the webrtc modes
    raise ValueError naming lookahead."""
    cfg, model = tiny_la
    with pytest.warns(UserWarning, match="downgraded to 'fast'"):
        eng = StreamEngine(cfg, model, mode="fused", max_streams=2,
                           device="cpu")
    assert eng.mode == "fast" and eng.plan is None
    for mode in ("webrtc", "fused-webrtc"):
        with pytest.raises(ValueError, match="lookahead"):
            StreamEngine(cfg, model, mode=mode, max_streams=2, device="cpu")


def test_engine_masked_commit_reset_and_snapshot_cover_the_rings(tiny_la,
                                                                 rng):
    """A slot that misses a tick keeps its rings; ``add_stream`` zeroes a
    reused slot's rings; a snapshot round-trips them."""
    cfg, model = tiny_la
    eng = StreamEngine(cfg, model, mode="fast", max_streams=2, device="cpu")
    eng.add_stream("a")
    eng.add_stream("b")
    chunk = rng.standard_normal(cfg.dsp.hop_length).astype(np.float32)
    eng.process({"a": chunk, "b": chunk})
    slot = eng.slots["b"]
    before = {k: getattr(eng.state, k)[slot].clone()
              for k in ("la_mag", "la_phase")}
    assert before["la_mag"].abs().max() > 0
    eng.process({"a": chunk})            # b underruns this tick
    for k, v in before.items():
        assert torch.equal(getattr(eng.state, k)[slot], v), k
    snap = eng.snapshot()
    assert snap["state"]["la_mag"].shape == (2, 3, cfg.dsp.n_stft)
    eng.process({"a": chunk, "b": chunk})
    eng.restore(snap)
    for k, v in before.items():
        assert torch.equal(getattr(eng.state, k)[slot], v), k
    eng.remove_stream("b")
    assert eng.add_stream("c") == slot
    for k in ("la_mag", "la_phase"):
        assert not getattr(eng.state, k)[slot].abs().max(), k
        assert getattr(eng.state, k)[eng.slots["a"]].abs().max() > 0, k


def test_engine_latency_accounting(tiny_la):
    """Lookahead k adds exactly k * hop samples to the causal overlap-add
    latency, in mode 'fast' and in a 'fused' downgraded to it."""
    cfg, model = tiny_la
    base = cfg.dsp.n_fft - cfg.dsp.hop_length
    eng = StreamEngine(cfg, model, mode="fast", max_streams=2, device="cpu")
    assert eng.algorithmic_latency_samples == base + 3 * cfg.dsp.hop_length
    assert eng.algorithmic_latency_ms == pytest.approx(
        (base + 3 * cfg.dsp.hop_length) / cfg.dsp.sample_rate * 1e3)
    with pytest.warns(UserWarning, match="downgraded to 'fast'"):
        fused = StreamEngine(cfg, model, mode="fused", max_streams=2,
                             device="cpu")
    assert fused.algorithmic_latency_samples == eng.algorithmic_latency_samples
    c0 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, lookahead_frames=0))
    assert StreamEngine(c0, model, mode="fast", max_streams=2,
                        device="cpu").algorithmic_latency_samples == base


def test_engine_latency_matches_jax(la4):
    (jcfg, jmodel, params), (cfg, model) = la4
    jeng = JaxEngine(jcfg, jmodel, params, mode="fast", max_streams=1)
    eng = StreamEngine(cfg, model, mode="fast", max_streams=1, device="cpu")
    assert eng.algorithmic_latency_samples == \
        jeng.algorithmic_latency_samples == 1024 - 512 + 4 * 512


# -- the daemons --------------------------------------------------------------

def _recv(conn):
    if not conn.poll(RECV_TIMEOUT_S):
        raise TimeoutError("no reply from the daemon")
    return conn.recv()


def test_daemon_serves_a_lookahead_checkpoint_in_fused_as_fast(la4):
    """``engine --mode fused`` on la4: the engine warns and serves mode
    'fast' with the daemon's gate profile; two streams' replies equal
    JAX's engine on the same chunks and profile, and ``stats`` counts the
    lookahead in the latency."""
    (jcfg, jmodel, params), _ = la4
    with pytest.warns(UserWarning, match="downgraded to 'fast'"):
        daemon = EngineDaemon(FIXTURES[4], max_streams=2,
                              address=("127.0.0.1", 0), mode="fused",
                              device="cpu")
    assert daemon.engine.mode == "fast"
    jcfg = dataclasses.replace(jcfg, serving=JaxServingConfig(
        **dataclasses.asdict(daemon.cfg.serving)))
    jeng = JaxEngine(jcfg, jmodel, params, mode="fast", max_streams=2)
    hop = daemon.cfg.dsp.hop_length
    data = _chunks(np.random.default_rng(3), 2, hop, 6)
    got = np.zeros_like(data)
    server = threading.Thread(target=daemon.serve_forever, daemon=True)
    server.start()
    try:
        assert daemon.listening.wait(RECV_TIMEOUT_S)
        with Client(daemon.address) as conn:
            for j in range(2):
                conn.send(("open", f"s{j}"))
                assert _recv(conn)[0] == "ok"
            for k in range(len(data)):
                for j in range(2):
                    conn.send(("chunk", f"s{j}", data[k, j]))
                for _ in range(2):
                    op, sid, out = _recv(conn)
                    assert op == "out"
                    got[k, int(sid[1])] = out
            conn.send(("stats",))
            op, stats = _recv(conn)
            assert stats["algorithmic_latency_ms"] == pytest.approx(
                round((1024 - 512 + 4 * 512) / 48, 3))
    finally:
        daemon.stop()
        server.join(RECV_TIMEOUT_S)
    assert not server.is_alive()
    jeng.add_stream("s0")
    jeng.add_stream("s1")
    for k in range(len(data)):
        want = jeng.process({"s0": data[k, 0], "s1": data[k, 1]})
        for j in range(2):
            np.testing.assert_allclose(got[k, j], want[f"s{j}"],
                                       atol=OUT_ATOL)
    assert np.abs(got[-1]).max() > 0


def test_socket_daemon_refuses_a_lookahead_checkpoint_as_jax_does():
    """The socket daemon runs the per-message server step, which carries
    no delay ring: both packages refuse a lookahead checkpoint there."""
    from audio_denoising_tpu.apps.serve import SocketDaemon as JaxSocket
    from audio_denoising_torch.apps.serve import SocketDaemon
    with pytest.raises(ValueError, match="lookahead"):
        JaxSocket(FIXTURES[4], address=("127.0.0.1", 0))
    with pytest.raises(ValueError, match="lookahead"):
        SocketDaemon(FIXTURES[4], address=("127.0.0.1", 0), device="cpu")

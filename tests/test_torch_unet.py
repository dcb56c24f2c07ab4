"""The port's stateless segment family against the JAX package on the
CPU: the 2-D convs, the U-Nets (UNet2d, UNet2d3, UNet2d4 against the
reference goldens, and every arch against JAX's ``UNet2d.apply`` on the
same weights), ``compatible_frames``, ``offline_denoise_stateless``,
``make_unet_stream_step`` (crossfade, asymmetric left context, the SNR
gate's three estimators carried across windows) and
``offline_denoise_streamed`` on ``runs/unet4crop2s-mrstft-30k.npz``;
``StreamEngine`` mode 'unet' (cadence, a missing stream, admission and
snapshot/restore mid-cycle with the phase, the latency, the serving
dtype); the cadence-locked ``BatchingTick``; ``with_unet_geometry`` and
``recommended_streaming_geometry`` and the surfaces that serve them (the
engine and WebSocket daemons, ``denoise --streamed``). The same numpy
inputs, made from a seed, go through both packages at a small geometry
(two-hop segments) so the file stays quick."""

import dataclasses
import importlib.util
import json
import os
import threading
import time
import warnings
from functools import partial
from multiprocessing.connection import Client

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu.apps import offline as jax_offline
from audio_denoising_tpu.apps.engine_serve import EngineDaemon as JaxDaemon
from audio_denoising_tpu.config import (
    PRESETS as JAX_PRESETS,
    recommended_streaming_geometry as jax_recommended_geometry,
    with_unet_geometry as jax_with_geometry)
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.models.base import (
    gaussian_smearing as jax_smearing)
from audio_denoising_tpu.models.unet2d import (
    UNet2d as JaxUNet2d, instance_norm_2d as jax_instance_norm)
from audio_denoising_tpu.ops import convs as jax_convs
from audio_denoising_tpu import pipeline as jax_pipeline
from audio_denoising_tpu.runtime.engine import StreamEngine as JaxEngine

from audio_denoising_torch.apps import engine_serve, offline, ws_serve
from audio_denoising_torch.apps.engine_serve import EngineDaemon
from audio_denoising_torch.compat import params_from_jax
from audio_denoising_torch.config import (
    PRESETS, SEGMENT_ARCHS, ServingConfig, recommended_streaming_geometry,
    with_unet_geometry)
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.io.wavio import read_wav, write_wav
from audio_denoising_torch.models.base import gaussian_smearing
from audio_denoising_torch.models.unet2d import (
    SPECS, UNet2d, instance_norm_2d)
from audio_denoising_torch.ops.convs import conv2d, conv_transpose2d
from audio_denoising_torch.ops.noisefloor import gate_weight
from audio_denoising_torch.pipeline import (
    make_unet_stream_step, offline_denoise_stateless,
    offline_denoise_streamed, unet_stream_init_state)
from audio_denoising_torch.runtime.engine import StreamEngine
from audio_denoising_torch.runtime.metrics import ServingMetrics
from audio_denoising_torch.runtime.tick import BatchingTick

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
UNET4 = os.path.join(REPO, "runs", "unet4crop2s-mrstft-30k.npz")
WIDE = os.path.join(REPO, "runs", "unet4wide-crop2s-mrstft-30k.npz")
TRUNET = os.path.join(REPO, "runs", "trunet-realnoise.npz")
GOLDEN_TOL = dict(atol=5e-4, rtol=1e-3)   # tests/test_models.py's U-Net bound
CONV_ATOL = 1e-5     # one conv or norm layer vs JAX (measured <= 2e-6)
NET_ATOL = 1e-4      # a U-Net's residual against JAX (measured <= 2e-5)
OUT_ATOL = 1e-5      # waveforms against JAX (measured <= 5e-7)
PASS_ATOL = 5e-3     # tests/test_unet_pipeline.py's zero-model bound
# the small streaming geometry of these tests: 2-hop segments, 1 ms of
# right context, 16 ms of left context, a 4 ms crossfade (at 48 kHz)
SMALL = dict(seg_hops=2, ctx=384, xfade=192, ctx_left=768)
RECV_TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def unet4():
    jcfg, jmodel, jparams = jax_load_pretrained(UNET4)
    cfg, model = load_pretrained(UNET4)
    return jcfg, jmodel, jparams, cfg, model


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# each estimator's (gate dB, width dB), where the voiced input under
# stepped noise blends: the tuned 1 dB / 6, 'floor' chip_smoke's point
GATE_POINTS = {"removed": (1.0, 6.0), "floor": (10.0, 4.0),
               "both": (1.0, 6.0)}


def _pair(jcfg, cfg, gate=None, **geometry):
    """Both packages' configs at one geometry, gated by estimator
    ``gate`` at its GATE_POINTS or not."""
    geometry = geometry or SMALL
    jcfg, cfg = (jax_with_geometry(jcfg, **geometry),
                 with_unet_geometry(cfg, **geometry))
    if gate is not None:
        db, width = GATE_POINTS[gate]
        jcfg, cfg = (dataclasses.replace(c, serving=dataclasses.replace(
            c.serving, snr_gate_db=db, snr_gate_width_db=width,
            snr_gate_estimator=gate)) for c in (jcfg, cfg))
    return jcfg, cfg


def _voice(smoke, n, sr, batch, seed):
    """The vowel chip_smoke feeds the gate, under per-stream noise whose
    level steps every quarter (so the estimators move and blend)."""
    rng = np.random.default_rng(seed)
    levels = np.repeat([0.003, 0.1, 0.01, 0.3], -(-n // 4))[:n]
    v = smoke.voiced(n, sr)
    return np.stack([(v + levels * (1 + b) * rng.standard_normal(n))
                     for b in range(batch)]).astype(np.float32)


# -- the 2-D convs ---------------------------------------------------------------

def _conv_cases():
    """Every (kernel, stride, output padding) of SPECS (downs at 0)."""
    cases = set()
    for spec in SPECS.values():
        cases |= {(k, s, 0) for _n, _i, _o, k, s, _nm in spec["downs"]}
        cases |= {(k, s, op) for _n, _i, _o, k, s, op in spec["ups"]}
        cases.add(spec["final"][2:])
    return sorted(cases, key=str)


@pytest.mark.parametrize("k,s,op", _conv_cases(), ids=str)
def test_convs_match_jax(k, s, op):
    """conv2d with every (kernel, stride) of SPECS and conv_transpose2d
    with every output padding, padding 1, against JAX ops/convs.py."""
    rng = np.random.default_rng(3)
    kh, kw = (k, k) if isinstance(k, int) else k
    x = rng.standard_normal((2, 5, 23, 17)).astype(np.float32)
    w = rng.standard_normal((4, 5, kh, kw)).astype(np.float32)
    wt = rng.standard_normal((5, 4, kh, kw)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    got = conv2d(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(b), stride=s, padding=1).numpy()
    want = np.asarray(jax_convs.conv2d(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), stride=s, padding=1))
    np.testing.assert_allclose(got, want, atol=CONV_ATOL, rtol=0)
    got = conv_transpose2d(torch.from_numpy(x), torch.from_numpy(wt),
                           torch.from_numpy(b), stride=s, padding=1,
                           output_padding=op).numpy()
    want = np.asarray(jax_convs.conv_transpose2d(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), stride=s,
        padding=1, output_padding=op))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=CONV_ATOL, rtol=0)


def test_instance_norm_and_smearing_match_jax():
    rng = np.random.default_rng(4)
    x = (3 + rng.standard_normal((2, 3, 11, 7))).astype(np.float32)
    np.testing.assert_allclose(
        instance_norm_2d(torch.from_numpy(x)).numpy(),
        np.asarray(jax_instance_norm(jnp.asarray(x))), atol=CONV_ATOL,
        rtol=0)
    for sqrt in (False, True):
        np.testing.assert_array_equal(
            gaussian_smearing(241, 32, sqrt_positions=sqrt),
            jax_smearing(241, 32, sqrt_positions=sqrt))


# -- the U-Nets --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["UNet2d", "UNet2d3", "UNet2d4"])
def test_unet_matches_golden_and_jax(arch):
    """The reference's random-weight goldens (tests/test_models.py's
    bound), then JAX's UNet2d.apply on the same weights and input."""
    g = np.load(os.path.join(GOLD, f"model_{arch}-rand.npz"))
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    model = UNet2d(arch=arch, bins=int(g["bins"])).load_params(
        params_from_jax(sd))
    with torch.no_grad():
        got = model.apply(torch.from_numpy(g["x"])).numpy()
    assert got.shape == g["out"].shape
    np.testing.assert_allclose(got, g["out"], **GOLDEN_TOL)
    jm = JaxUNet2d(arch=arch, bins=int(g["bins"]))
    want = np.asarray(jax.jit(jm.apply)(
        {k: jnp.asarray(v) for k, v in sd.items()}, jnp.asarray(g["x"])))
    np.testing.assert_allclose(got, want, atol=NET_ATOL, rtol=0)


@pytest.mark.parametrize("path", [UNET4, WIDE], ids=["unet4", "wide"])
def test_trained_unets_match_jax(path):
    """The two trained runs/ checkpoints through both hubs: the residual
    of one padded window (the crop of offline_denoise_stateless) within
    NET_ATOL of JAX's."""
    jcfg, jmodel, jparams = jax_load_pretrained(path)
    cfg, model = load_pretrained(path)
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())
    assert model.arch == jmodel.arch
    rng = np.random.default_rng(5)
    t = model.compatible_frames(40)
    x = np.abs(rng.standard_normal((2, 241, t))).astype(np.float32)
    with torch.no_grad():
        got = model.apply(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=NET_ATOL, rtol=0)


@pytest.mark.parametrize("arch", sorted(SPECS))
def test_compatible_frames_match_jax(arch):
    ours, theirs = UNet2d(arch=arch), JaxUNet2d(arch=arch)
    for t in range(1, 200):
        assert ours.compatible_frames(t) == theirs.compatible_frames(t), t
    assert ours.compatible_frames(127) == theirs.compatible_frames(127)
    with pytest.raises(ValueError):
        ours.compatible_frames(10, max_extra=2)


# -- the offline and streamed paths --------------------------------------------------

def test_offline_denoise_stateless_matches_jax(unet4):
    """A padded whole clip (2 streams, 0.25 s at 48 kHz: 32 frames pad to
    UNet2d4's next compatible count) against JAX."""
    jcfg, jmodel, jparams, cfg, model = unet4
    rng = np.random.default_rng(6)
    audio = (0.1 * rng.standard_normal((2, 12000))).astype(np.float32)
    got = offline_denoise_stateless(cfg, model, torch.from_numpy(audio))
    want = jax.jit(partial(jax_pipeline.offline_denoise_stateless, jcfg,
                           jmodel))(jparams, jnp.asarray(audio))
    assert got.shape == (2, 12000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)


@pytest.mark.parametrize("gate", [None, "both"])
def test_offline_denoise_streamed_matches_jax(unet4, smoke, gate):
    """The window chain over 0.3 s of voiced input under stepped noise,
    with the crossfade and an asymmetric left context, ungated and with
    the tuned gate (both estimators; each alone is held hop by hop in
    test_stream_step_matches_jax_over_cycles), against JAX's
    offline_denoise_streamed."""
    jcfg, jmodel, jparams, cfg, model = unet4
    jcfg, cfg = _pair(jcfg, cfg, gate)
    audio = _voice(smoke, 14400, 48000, 2, 7)
    got = offline_denoise_streamed(cfg, model, torch.from_numpy(audio))
    want = jax.jit(partial(jax_pipeline.offline_denoise_streamed, jcfg,
                           jmodel))(jparams, jnp.asarray(audio))
    assert got.shape == audio.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)


@pytest.mark.parametrize("gate", [None, "removed", "floor", "both"])
def test_stream_step_matches_jax_over_cycles(unet4, smoke, gate):
    """make_unet_stream_step against JAX's step over 4 cycles (8 ticks):
    every hop's output and, after each cycle's boundary, every plane of
    the state (the crossfade tail and the gate's carried estimators);
    with a gate, some stream-cycles blend (0 < alpha < 1)."""
    jcfg, jmodel, jparams, cfg, model = unet4
    jcfg, cfg = _pair(jcfg, cfg, gate)
    hop, seg_hops = cfg.dsp.hop_length, cfg.serving.unet_seg_hops
    audio = _voice(smoke, 10 * seg_hops * hop, 48000, 3, 8)
    step = make_unet_stream_step(cfg, model, "cpu")
    jstep = jax.jit(jax_pipeline.make_unet_stream_step(jcfg, jmodel))
    state = unet_stream_init_state(cfg, model, 3)
    jstate = jax_pipeline.unet_stream_init_state(jcfg, jmodel, 3)
    alphas = []
    for t in range(10 * seg_hops):
        chunk = audio[:, t * hop:(t + 1) * hop]
        phase = t % seg_hops
        state, out = step(state, torch.from_numpy(chunk), phase)
        jstate, jout = jstep(jparams, jstate, jnp.asarray(chunk),
                             jnp.int32(phase))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=OUT_ATOL, rtol=0)
        if phase == seg_hops - 1:
            if gate is not None:
                alphas.append(gate_weight(cfg.serving, state))
            for name, plane in state._asdict().items():
                want = getattr(jstate, name)
                assert (plane is None) == (want is None), name
                if plane is not None:
                    np.testing.assert_allclose(
                        plane.numpy(), np.asarray(want), rtol=2e-4,
                        atol=OUT_ATOL * max(1.0, np.abs(want).max()),
                        err_msg=name)
    if gate is not None:
        assert (state.em_out is None) == (gate == "floor")
        assert (state.nf_floor is None) == (gate == "removed")
        alphas = torch.stack(alphas)
        assert ((alphas > 0) & (alphas < 1)).any(), alphas


def _zero_unet():
    class ZeroUNet(torch.nn.Module):
        def compatible_frames(self, t):
            return t

        def apply(self, x):
            return torch.zeros_like(x)
    return ZeroUNet()


@pytest.mark.parametrize("ctx_left,xfade", [(None, 0), (2880, 0),
                                            (None, 384)])
def test_zero_model_stream_is_the_delayed_input(ctx_left, xfade):
    """A zero residual: the engine's stream is the input delayed by
    exactly seg + ctx samples (tests/test_unet_pipeline.py:226, :346 with
    the left context), and the streamed offline chain realigns it sample
    for sample (:297 with the crossfade)."""
    cfg = with_unet_geometry(PRESETS["unet4-raw480"], seg_hops=4, ctx=960,
                             xfade=xfade, ctx_left=ctx_left)
    hop, seg = cfg.dsp.hop_length, 4 * cfg.dsp.hop_length
    delay = seg + 960
    eng = StreamEngine(cfg, _zero_unet(), mode="unet", max_streams=2,
                       device="cpu")
    eng.add_stream("a")
    assert eng.algorithmic_latency_samples == delay
    n_ticks = 8 * 4
    rng = np.random.default_rng(9)
    t_ax = np.arange(n_ticks * hop, dtype=np.float32)
    audio = (0.2 * np.sin(2 * np.pi * 440 * t_ax / 48000)
             + 0.02 * rng.standard_normal(n_ticks * hop)).astype(np.float32)
    out = np.concatenate([eng.process({"a": audio[t * hop:(t + 1) * hop]})
                          ["a"] for t in range(n_ticks)])
    a, b = delay + 3 * seg, n_ticks * hop - seg
    np.testing.assert_allclose(out[a:b], audio[a - delay:b - delay],
                               atol=PASS_ATOL)
    streamed = offline_denoise_streamed(cfg, _zero_unet(),
                                        torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(streamed[3 * seg:], audio[3 * seg:],
                               atol=PASS_ATOL)


def test_xfade_larger_than_the_context_raises():
    cfg = with_unet_geometry(PRESETS["unet4-raw480"], seg_hops=4, ctx=480,
                             xfade=481)
    with pytest.raises(ValueError, match="unet_xfade_samples"):
        unet_stream_init_state(cfg, _zero_unet(), 1)
    with pytest.raises(ValueError, match="unet_xfade_samples"):
        make_unet_stream_step(cfg, _zero_unet(), "cpu")


def test_window_equivalence(unet4):
    """Each emitted segment is offline_denoise_stateless on the window
    that closed its cycle, its middle slice (tests/test_unet_pipeline.py
    :103, here with the asymmetric window)."""
    _j, _jm, _jp, cfg, model = unet4
    cfg = with_unet_geometry(cfg, seg_hops=2, ctx=384, ctx_left=768)
    hop = cfg.dsp.hop_length
    seg, ctx, ctx_l = 2 * hop, 384, 768
    eng = StreamEngine(cfg, model, mode="unet", max_streams=2, device="cpu")
    eng.add_stream("a")
    rng = np.random.default_rng(10)
    audio = (0.1 * rng.standard_normal(12 * hop)).astype(np.float32)
    out = np.concatenate([eng.process({"a": audio[t * hop:(t + 1) * hop]})
                          ["a"] for t in range(12)])
    ring = np.concatenate([np.zeros(ctx_l + ctx, np.float32), audio])
    for c in range(1, 5):              # the window that closes cycle c
        w = ring[c * seg:(c + 1) * seg + ctx_l + ctx]
        want = offline_denoise_stateless(cfg, model, torch.from_numpy(
            w[None]))[0, ctx_l:ctx_l + seg].numpy()
        np.testing.assert_allclose(out[(c + 1) * seg:(c + 2) * seg], want,
                                   atol=1e-6, rtol=0)


# -- the engine ------------------------------------------------------------------

def _schedule(hop, ticks, seed):
    """{stream: chunk} per tick: 'b' misses every third tick, 'c' joins
    at tick 3 (mid-cycle)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        live = ["a"] + (["b"] if t % 3 != 1 else []) + (["c"] if t >= 3
                                                         else [])
        out.append({s: (0.1 * rng.standard_normal(hop)).astype(np.float32)
                    for s in live})
    return out


@pytest.mark.parametrize("gate", [None, "both"])
def test_engine_matches_jax(unet4, gate):
    """Mode 'unet' against JAX's engine over 5 cycles: cadence (every slot
    advances every tick; 'b' gets zeros where it misses one), admission
    mid-cycle, a snapshot mid-cycle restored into a fresh engine (the
    phase with it), the latency; the outputs within OUT_ATOL."""
    jcfg, jmodel, jparams, cfg, model = unet4
    jcfg, cfg = _pair(jcfg, cfg, gate)
    jeng = JaxEngine(jcfg, jmodel, jparams, mode="unet", max_streams=4)
    eng = StreamEngine(cfg, model, mode="unet", max_streams=4, device="cpu")
    assert eng.mode == "unet"
    assert eng.algorithmic_latency_samples == \
        jeng.algorithmic_latency_samples == 2 * 384 + 384
    hop = cfg.dsp.hop_length
    schedule = _schedule(hop, 10, 11)
    for e in (jeng, eng):
        e.add_stream("a")
        e.add_stream("b")
    for t, chunks in enumerate(schedule):
        if t == 3:
            jeng.add_stream("c")
            eng.add_stream("c")
        if t == 5:
            snap = eng.snapshot()
            assert snap["phase"] == jeng.snapshot()["phase"] == 1
            eng = StreamEngine(cfg, model, mode="unet", max_streams=4,
                               device="cpu")
            eng.restore(snap)
            assert eng._phase == 1
        got, want = eng.process(chunks), jeng.process(chunks)
        for s in chunks:
            np.testing.assert_allclose(got[s], np.asarray(want[s]),
                                       atol=OUT_ATOL, rtol=0)
    batch = torch.zeros(4, hop)
    batch[0, 3] = float("nan")
    out = eng.process_batch(batch)
    assert torch.isfinite(out).all() and eng._phase == 1


def test_engine_serving_dtype_as_jax(unet4):
    """bfloat16 is ignored in mode 'unet', as in JAX (the step runs
    fp32); int8 goes through the downgrade to mode 'fast', which no
    segment model can serve: JAX fails there too."""
    jcfg, jmodel, jparams, cfg, model = unet4
    jcfg, cfg = _pair(jcfg, cfg)
    for dtype in ("bfloat16", "int8"):
        jc, c = (dataclasses.replace(x, serving=dataclasses.replace(
            x.serving, dtype=dtype)) for x in (jcfg, cfg))
        if dtype == "bfloat16":
            jeng = JaxEngine(jc, jmodel, jparams, mode="unet", max_streams=2)
            eng = StreamEngine(c, model, mode="unet", max_streams=2,
                               device="cpu")
            assert (eng.mode, jeng.mode) == ("unet", "unet")
            continue
        with pytest.raises(Exception), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            JaxEngine(jc, jmodel, jparams, mode="unet", max_streams=2)
        with pytest.warns(UserWarning, match="downgraded to 'fast'"), \
                pytest.raises(ValueError, match="segment model"):
            StreamEngine(c, model, mode="unet", max_streams=2, device="cpu")


def test_unet_path_needs_a_card_unless_cpu_is_asked(unet4, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _j, _jm, _jp, cfg, model = unet4
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamEngine(cfg, model, mode="unet", max_streams=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_unet_stream_step(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offline.denoise_array(cfg, model, np.zeros(4800, np.float32), 48000,
                              streamed=True)


# -- the cadence-locked tick ------------------------------------------------------

class _FakeEngine:
    """Records each round's sids; on the first round a chunk for 'b'
    arrives, as one would while the engine works."""

    def __init__(self, cadence, hop=4):
        self.hop = hop
        self._cadence_locked = cadence
        self.slots = {"a": 0, "b": 1}
        self.calls = []
        self.tick = None

    def process_async(self, chunks):
        if not self.calls:
            self.tick.submit("b", np.zeros(self.hop, np.float32),
                             self.tick.answered.append)
        self.calls.append(set(chunks))
        return (torch.zeros(2, self.hop),
                {s: self.slots[s] for s in chunks})


@pytest.mark.parametrize("cadence", [False, True])
def test_tick_runs_one_round_per_tick_when_cadence_locked(cadence):
    """tests/test_tick.py:45-69: a masked engine drains a window's
    duplicate-sid rounds at once ({a, b}, {a}, then the late b); a
    cadence-locked one carries the duplicate 'a' into the next wall
    tick, where the late 'b' joins it ({a, b}, {a, b}), so no round
    misses a chunk that waits; every chunk is answered."""
    eng = _FakeEngine(cadence)
    tick = eng.tick = BatchingTick(eng, ServingMetrics(), tick_s=5e-3)
    tick.answered = []
    c = np.zeros(4, np.float32)
    for sid in ("a", "a", "b"):
        tick.submit(sid, c, tick.answered.append)
    tick.start()
    deadline = time.monotonic() + 10
    while len(tick.answered) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    tick.stop()
    assert len(tick.answered) == 4
    assert eng.calls == ([{"a", "b"}, {"a", "b"}] if cadence
                         else [{"a", "b"}, {"a"}, {"b"}])


# -- geometry and the surfaces that serve it -------------------------------------

_BASES = [dict(), dict(sample_rate=16000, n_fft=256, hop_length=128),
          dict(sample_rate=16000, n_fft=512, hop_length=256)]


@pytest.mark.parametrize("preset", ["unet4-raw480", "unet4wide-raw480",
                                    "trunet16k", "gruunet2-good"])
@pytest.mark.parametrize("base", range(len(_BASES)))
def test_geometry_helpers_match_jax(preset, base):
    """with_unet_geometry (none, some and every field) and
    recommended_streaming_geometry against JAX's on the presets at three
    DSP bases (tests/test_serving_geometry.py:36-56, :212-247)."""
    ours = dataclasses.replace(PRESETS[preset], dsp=dataclasses.replace(
        PRESETS[preset].dsp, **_BASES[base]))
    theirs = dataclasses.replace(JAX_PRESETS[preset],
                                 dsp=dataclasses.replace(
                                     JAX_PRESETS[preset].dsp,
                                     **_BASES[base]))
    assert with_unet_geometry(ours) is ours
    for kw in ({"xfade": 384}, {"seg_hops": 8, "ctx": 960, "xfade": 384,
                                "ctx_left": 41472}):
        assert (dataclasses.asdict(with_unet_geometry(ours, **kw).serving)
                == dataclasses.asdict(jax_with_geometry(theirs,
                                                        **kw).serving))
    rec = recommended_streaming_geometry(ours)
    assert dataclasses.asdict(rec.serving) == dataclasses.asdict(
        jax_recommended_geometry(theirs).serving)
    assert (rec is ours) == (ours.model.arch not in SEGMENT_ARCHS)
    assert recommended_streaming_geometry(
        with_unet_geometry(ours, seg_hops=4)).serving.unet_seg_hops == 4


def _geometry(cfg):
    srv = cfg.serving
    return (srv.unet_seg_hops, srv.unet_ctx_samples, srv.unet_xfade_samples,
            srv.unet_ctx_left_samples)


@pytest.mark.parametrize("kw", [{}, {"auto_gate": False},
                                {"unet_seg_hops": 4},
                                {"unet_seg_hops": 4, "unet_ctx": 480,
                                 "unet_xfade": 192, "unet_ctx_left": 960}],
                         ids=["recommended", "raw", "one-flag", "all-flags"])
def test_daemons_serve_the_geometry_jax_serves(kw):
    """The engine and WebSocket daemons in mode 'unet': no geometry flag
    serves the recommended point (84 ms), --no-snr-gate and any flag opt
    out, the flags set what they name; each as JAX's engine daemon
    (tests/test_serving_geometry.py:58-90, :249-297)."""
    jd = JaxDaemon(UNET4, max_streams=2, mode="unet", **kw)
    try:
        want = _geometry(jd.cfg), jd.engine.algorithmic_latency_samples
    finally:
        jd.tick.stop()
    for d in (EngineDaemon(UNET4, max_streams=2, mode="unet", device="cpu",
                           **kw),
              ws_serve.WSDaemon(UNET4, "127.0.0.1", 0, max_streams=2,
                                mode="unet", device="cpu", **kw)):
        assert d.engine.mode == "unet"
        assert (_geometry(d.cfg),
                d.engine.algorithmic_latency_samples) == want
    if not kw:
        assert want == ((8, 960, 384, 44544), 8 * 384 + 960)


def test_cli_flags_reach_the_daemons():
    argv = ["--model", UNET4, "--mode", "unet", "--max-streams", "2",
            "--device", "cpu", "--port", "0", "--unet-seg-hops", "3",
            "--unet-ctx", "480", "--unet-xfade", "96", "--unet-ctx-left",
            "1152"]
    d = engine_serve.daemon_from_args(engine_serve.parser().parse_args(argv))
    assert _geometry(d.cfg) == (3, 480, 96, 1152)
    args = ws_serve.parser().parse_args(argv)
    assert (args.mode, args.unet_seg_hops, args.unet_ctx_left) == \
        ("unet", 3, 1152)


# -- the engine daemon over the wire -----------------------------------------------

def _recv(conn):
    if not conn.poll(RECV_TIMEOUT_S):
        raise TimeoutError("no reply from the daemon")
    return conn.recv()


@pytest.mark.parametrize("path", [UNET4, WIDE, TRUNET],
                         ids=["unet4", "wide", "trunet"])
def test_engine_daemon_serves_mode_unet_as_jax_engine(path, smoke):
    """``engine --mode unet`` with every geometry flag on each checkpoint,
    one client with three streams sending all their chunks at once (the
    tick carries each stream's later chunks into later rounds): every
    reply against JAX's engine replaying the daemon's rounds, within
    OUT_ATOL; ``stats`` reports the latency."""
    jcfg, jmodel, jparams = jax_load_pretrained(path)
    daemon = engine_serve.daemon_from_args(engine_serve.parser().parse_args(
        ["--model", path, "--mode", "unet", "--max-streams", "4",
         "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--tick-ms", "2", "--unet-seg-hops", "2", "--unet-ctx", "384",
         "--unet-xfade", "192", "--unet-ctx-left", "768"]))
    log = smoke.recorded_rounds(daemon.engine)
    server = threading.Thread(target=daemon.serve_forever, daemon=True)
    server.start()
    hop, n = daemon.engine.hop, 7
    rng = np.random.default_rng(12)
    data = (0.1 * rng.standard_normal((3, n, hop))).astype(np.float32)
    got = {f"s{j}": [] for j in range(3)}
    try:
        assert daemon.listening.wait(RECV_TIMEOUT_S)
        with Client(daemon.address) as conn:
            for j in range(3):
                conn.send(("open", f"s{j}"))
                assert _recv(conn)[0] == "ok"
            for k in range(n):
                for j in range(3):
                    conn.send(("chunk", f"s{j}", data[j, k]))
            for _ in range(3 * n):
                op, sid, out = _recv(conn)
                assert op == "out"
                got[sid].append(out)
            conn.send(("stats",))
            op, stats = _recv(conn)
            assert stats["algorithmic_latency_ms"] == round(
                (2 * hop + 384) / daemon.cfg.dsp.sample_rate * 1e3, 3)
    finally:
        daemon.stop()
        server.join(RECV_TIMEOUT_S)
    jcfg, _ = _pair(jcfg, daemon.cfg)
    want = smoke.replay_rounds(log, JaxEngine(jcfg, jmodel, jparams,
                                              mode="unet", max_streams=4))
    for sid, outs in got.items():
        assert len(outs) == len(want[sid]) == n
        np.testing.assert_allclose(np.stack(outs), want[sid],
                                   atol=OUT_ATOL, rtol=0)


# -- denoise --streamed --------------------------------------------------------------

@pytest.mark.parametrize("path", [UNET4, WIDE, TRUNET],
                         ids=["unet4", "wide", "trunet"])
def test_denoise_file_streamed_matches_jax(path, tmp_path, monkeypatch):
    """``denoise_file(..., streamed=True)`` with no geometry flag serves
    the recommended window on the U-Nets and the class defaults on TRUNet,
    as JAX's does (spied at denoise_array), and --no-snr-gate keeps the
    class defaults; then ``denoise --streamed`` with every --unet-* flag
    on a 0.2 s WAV at 48 kHz, against JAX's command within one LSB."""
    src = str(tmp_path / "in.wav")
    rng = np.random.default_rng(13)
    write_wav(src, (0.1 * rng.standard_normal((1, 9600))).astype(np.float32),
              48000)
    seen = {}
    real = offline.denoise_array

    def spy(cfg, model, samples, sr, device=None, streamed=False):
        seen["geometry"], seen["streamed"] = _geometry(cfg), streamed
        return np.zeros(9600, np.float32)

    monkeypatch.setattr(offline, "denoise_array", spy)
    offline.denoise_file(path, src, str(tmp_path / "r.wav"), streamed=True,
                         device="cpu")
    d = ServingConfig()
    defaults = (d.unet_seg_hops, d.unet_ctx_samples, 0, None)
    assert seen == {"geometry": defaults if path == TRUNET
                    else (8, 960, 384, 44544), "streamed": True}
    offline.denoise_file(path, src, str(tmp_path / "r.wav"), streamed=True,
                         auto_gate=False, device="cpu")
    assert seen["geometry"] == defaults
    monkeypatch.setattr(offline, "denoise_array", real)
    flags = ["--streamed", "--unet-seg-hops", "2", "--unet-ctx", "384",
             "--unet-xfade", "192", "--unet-ctx-left", "768"]
    a, b = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    assert offline.main([src, a, "--model", path, "--device", "cpu",
                         *flags]) == 0
    assert jax_offline.main([src, b, "--model", path, *flags]) == 0
    (got, sr), want = read_wav(a), read_wav(b)[0]
    assert got.shape == want.shape == (1, 9600 * sr // 48000)
    assert np.abs(got - want).max() <= 1 / 32768 + 1e-9

"""The WebRTC hop's bf16 Griffin-Lim mode (``make_webrtc_hop(...,
compute_dtype=torch.bfloat16)``, JAX webrtc_hop.py:144, :305-318) on the
CPU: its plain version against JAX's interpret-mode bf16 kernel fed the
same state and plan, what the mode leaves untouched, and the engine and
the daemon serving ``fused-webrtc`` at ``serving.dtype="bfloat16"``.

The two definitions round the same transform inputs to bf16, but JAX also
rounds its window-folded DFT matrices, where the port keeps fp32 twiddles
in its FFTs: their waveforms differ by as much as each differs from fp32,
so a waveform bound cannot tell the port's bf16 mode from its fp32 hop.
What tells them apart is the mode's own perturbation of the frame a hop
adds: the port's (bf16 minus fp32) against JAX's (bf16 minus fp32), which
share the inverse STFT's rounded inputs. It is held after one Griffin-Lim
round, where that trace is still readable: warm GL with momentum 0.99 is
chaotic, and each further round spreads the twiddles' difference (at the
served 32 rounds one hop's frames of the two bf16 definitions read 15 dB
apart on dari_tult, the port's bf16 and fp32 frames 21 dB)."""

import dataclasses
import json
import math
import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.ops.pallas.webrtc_hop import (
    WebRTCHopState as JaxHopState, _fpad, make_webrtc_hop as jax_make_hop)
from audio_denoising_tpu.runtime.plan import (
    build_cell_plan as jax_build_cell_plan)

from audio_denoising_torch.apps.engine_serve import daemon_from_args, parser
from audio_denoising_torch.compat import save_params_npz
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.ops.kernels.webrtc_hop import (
    make_webrtc_hop, webrtc_hop_init_state)
from audio_denoising_torch.runtime.engine import StreamEngine
from audio_denoising_torch.runtime.plan import plan_from_numpy

SPEC = "gruunet2-dari_tult"
BATCH = 4
HOPS = 3
# The bf16 perturbation of the added frame, the port's against JAX's, one
# GL round, three hops from a shared state at B = 4 (dari_tult), over the
# three hops: their correlation read 0.33-0.83 and their size ratio -4.3
# to +1.2 dB over seeds 0-5 (JAX's is the larger as a rule: it rounds its
# DFT matrices too). The control, the port's fp32 hop in the bf16 mode's
# place, has none (0, and -inf dB); a mode that rounded elsewhere would
# not correlate.
EFFECT_CORR = 0.2
EFFECT_DB = (-8.0, 4.0)
# the frame the bf16 hop adds against JAX's bf16 kernel's, one GL round:
# read 38.8-49.2 dB over the same runs (the control 36.8-49.6: this bound
# holds the mode to JAX's, it does not tell it from fp32)
FRAME_DB = 30.0
HX_ATOL = 5e-4       # tests/test_torch_webrtc.py's KERNEL_HX


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * math.log10((ref ** 2).sum()
                           / max(((ref - got) ** 2).sum(), 1e-30))


def _warm(cfg, n_iter):
    return dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, griffin_lim_warm_start=True, griffin_lim_iters=n_iter))


@pytest.fixture(scope="module")
def dari():
    """JAX's (cfg, plan) and the port's (cfg, plan), the same plan."""
    jcfg, jmodel, params = jax_load_pretrained(SPEC)
    cfg, model = load_pretrained(SPEC)
    jplan = jax_build_cell_plan(jmodel, params)
    return (jcfg, jplan), (cfg, model, plan_from_numpy(jplan))


def _to_jax(state, F):
    """The port's state (frames of F bins) as the JAX kernel's (frames
    padded to FP lanes; the pad bins carry no magnitude)."""
    FP = _fpad(F)

    def pad(a):
        a = a.numpy()
        return jnp.asarray(np.concatenate(
            [np.pad(a[:, t * F:(t + 1) * F], ((0, 0), (0, FP - F)))
             for t in range(3)], axis=1))

    return JaxHopState(*(jnp.asarray(t.numpy()) for t in state[:3]),
                       pad(state.ang_re), pad(state.ang_im))


def _added(state, ola, hop):
    """What a hop added to the OLA buffer: ola' minus the shifted ola."""
    before = np.asarray(state.ola, np.float64)
    shifted = np.roll(before, -hop, axis=1)
    shifted[:, -hop:] = 0
    return np.asarray(ola, np.float64) - shifted


def test_bf16_gl_rounds_where_jax_does(dari, rng):
    """One GL round, each hop from the port's fp32 state: the port's bf16
    perturbation of the added frame correlates with JAX's and is as
    large; the fp32 hop in its place fails both. The frame itself within
    FRAME_DB of JAX's bf16 kernel's, hx as the fp32 hop's."""
    (jcfg, jplan), (cfg, _, plan) = dari
    jcfg, cfg = _warm(jcfg, 1), _warm(cfg, 1)
    hop, F = cfg.dsp.hop_length, cfg.dsp.n_stft
    j16 = jax_make_hop(jcfg, jplan, interpret=True, block_b=8,
                       compute_dtype=jnp.bfloat16)
    j32 = jax_make_hop(jcfg, jplan, interpret=True, block_b=8)
    p16 = make_webrtc_hop(cfg, plan, "cpu", compute_dtype=torch.bfloat16)
    p32 = make_webrtc_hop(cfg, plan, "cpu")
    state = webrtc_hop_init_state(cfg, plan, BATCH)
    chunks = (0.2 * rng.standard_normal((4 + HOPS, BATCH, hop))).astype(
        np.float32)
    for c in chunks[:4]:           # a state with converged phases
        state, _ = p32(state, torch.from_numpy(c))
    d_jax, d_port, d_control = [], [], []
    for c in chunks[4:]:
        js = _to_jax(state, F)
        f = {}
        for name, step in (("j16", j16), ("j32", j32)):
            f[name] = _added(state, step(js, jnp.asarray(c))[0].ola, hop)
        s16, _ = p16(state, torch.from_numpy(c))
        s32, _ = p32(state, torch.from_numpy(c))
        f["p16"], f["p32"] = (_added(state, s.ola, hop) for s in (s16, s32))
        assert _snr(f["j16"], f["p16"]) >= FRAME_DB
        assert torch.equal(s16.hx, s32.hx) and torch.equal(s16.ring,
                                                           s32.ring)
        np.testing.assert_allclose(s16.hx.numpy(), np.asarray(
            j16(js, jnp.asarray(c))[0].hx), atol=HX_ATOL)
        d_jax.append(f["j16"] - f["j32"])
        d_port.append(f["p16"] - f["p32"])
        d_control.append(f["p32"] - f["p32"])
        state = s32

    def effect(d):
        a, b = np.concatenate(d_jax).ravel(), np.concatenate(d).ravel()
        size = float(b @ b)
        if size == 0.0:
            return 0.0, -math.inf
        return (float(a @ b) / math.sqrt(float(a @ a) * size),
                10 * math.log10(size / float(a @ a)))

    def holds(corr, db):
        return corr >= EFFECT_CORR and EFFECT_DB[0] <= db <= EFFECT_DB[1]

    corr, db = effect(d_port)
    assert holds(corr, db), (corr, db)
    assert not holds(*effect(d_control))


def test_bf16_gl_at_zero_rounds_is_the_fp32_hop(dari, rng):
    """With no GL round the mode rounds nothing (the final synthesis is
    fp32 in both packages): the bf16 hop equals the fp32 hop bit for bit
    over a few hops, each carrying its own state."""
    _, (cfg, _, plan) = dari
    cfg = _warm(cfg, 0)
    steps = [make_webrtc_hop(cfg, plan, "cpu", compute_dtype=dt)
             for dt in (torch.float32, torch.bfloat16)]
    states = [webrtc_hop_init_state(cfg, plan, 2) for _ in steps]
    for _ in range(3):
        c = torch.from_numpy((0.2 * rng.standard_normal(
            (2, cfg.dsp.hop_length))).astype(np.float32))
        outs = []
        for i, step in enumerate(steps):
            states[i], out = step(states[i], c)
            outs.append(out)
        assert torch.equal(outs[0], outs[1])
    for a, b in zip(*states):
        assert torch.equal(a, b)


def test_bf16_multi_hop_equals_single_hops(dari, rng):
    """K hops per call in the bf16 mode are K single bf16 hops."""
    _, (cfg, _, plan) = dari
    cfg = _warm(cfg, 2)
    single = make_webrtc_hop(cfg, plan, "cpu", compute_dtype=torch.bfloat16)
    multi = make_webrtc_hop(cfg, plan, "cpu", compute_dtype=torch.bfloat16,
                            hops_per_call=3)
    chunks = torch.from_numpy((0.2 * rng.standard_normal(
        (3, 2, cfg.dsp.hop_length))).astype(np.float32))
    s_m, outs = multi(webrtc_hop_init_state(cfg, plan, 2), chunks)
    s = webrtc_hop_init_state(cfg, plan, 2)
    for k in range(3):
        s, out = single(s, chunks[k])
        assert torch.equal(out, outs[k])
    for a, b in zip(s, s_m):
        assert torch.equal(a, b)


def _bf16(cfg):
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, dtype="bfloat16"))


def test_engine_serves_fused_webrtc_at_bfloat16(dari, rng):
    """StreamEngine mode fused-webrtc at serving.dtype bfloat16 serves the
    bf16 GL hop, with no downgrade: its ticks equal the bf16 hop run
    alone, and differ from the fp32 engine's."""
    _, (cfg, model, plan) = dari
    cfg = _warm(cfg, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = StreamEngine(_bf16(cfg), model, mode="fused-webrtc",
                           max_streams=2, device="cpu")
    f32 = StreamEngine(cfg, model, mode="fused-webrtc", max_streams=2,
                       device="cpu")
    assert eng.mode == "fused-webrtc" and eng.hop_step.gl_bf16
    step = make_webrtc_hop(cfg, eng.plan, "cpu", compute_dtype=torch.bfloat16)
    state = webrtc_hop_init_state(cfg, eng.plan, 2)
    for e in (eng, f32):
        e.add_stream("a")
        e.add_stream("b")
    apart = 0.0
    for _ in range(4):
        c = (0.2 * rng.standard_normal((2, cfg.dsp.hop_length))).astype(
            np.float32)
        got = eng.process({"a": c[0], "b": c[1]})
        ref = f32.process({"a": c[0], "b": c[1]})
        state, want = step(state, torch.from_numpy(c))
        for j, sid in enumerate("ab"):
            np.testing.assert_array_equal(got[sid], want[j].numpy())
            apart = max(apart, float(np.abs(got[sid] - ref[sid]).max()))
    assert apart > 0


def test_daemon_serves_fused_webrtc_dtype_bfloat16(tmp_path):
    """``engine --mode fused-webrtc --dtype bfloat16`` on a warm dari_tult
    checkpoint: mode fused-webrtc, the bf16 GL hop."""
    cfg, model = load_pretrained(SPEC)
    path = str(tmp_path / "dari-warm.npz")
    save_params_npz(path, {k: v.numpy() for k, v in
                           model.state_dict().items()},
                    {"full_config": json.loads(_warm(cfg, 32).to_json())})
    daemon = daemon_from_args(parser().parse_args(
        ["--model", path, "--mode", "fused-webrtc", "--dtype", "bfloat16",
         "--max-streams", "2", "--port", "0", "--device", "cpu"]))
    assert daemon.engine.mode == "fused-webrtc"
    assert daemon.engine.hop_step.gl_bf16
    assert daemon.cfg.serving.dtype == "bfloat16"

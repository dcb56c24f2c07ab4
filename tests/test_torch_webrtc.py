"""The port's WebRTC slice against the JAX package on the CPU: the STFT,
mel and Griffin-Lim ops, the op-by-op webrtc step (also against the
reference goldens) and its SNR gate, the WebRTC hop's plain version
against the JAX kernel (interpret mode) fed the identical plan, one hop
and K hops per call, the engine modes ``webrtc`` (also gated) and
``fused-webrtc``, and the daemon serving them. The CUDA kernels
themselves are held against the plain version on the card by
chip_smoke.py."""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import warnings
from multiprocessing.connection import Client

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu import ops as jax_ops
from audio_denoising_tpu.config import (
    Config as JaxConfig, DSPConfig as JaxDSPConfig,
    ModelConfig as JaxModelConfig)
from audio_denoising_tpu.models import build_model as jax_build_model
from audio_denoising_tpu.ops.pallas.webrtc_hop import (
    _fpad, make_webrtc_hop as jax_make_hop,
    webrtc_hop_init_state as jax_hop_init_state)
from audio_denoising_tpu.pipeline import (
    make_webrtc_step as jax_make_step, webrtc_init_state as jax_step_init)
from audio_denoising_tpu.runtime.engine import StreamEngine as JaxEngine
from audio_denoising_tpu.runtime.plan import (
    build_cell_plan as jax_build_cell_plan)

from audio_denoising_torch import ops
from audio_denoising_torch.apps.engine_serve import EngineDaemon
from audio_denoising_torch.compat import (
    load_params_npz, params_from_jax, save_params_npz)
from audio_denoising_torch.config import (
    Config, DSPConfig, ModelConfig, PRESETS)
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.models import build_model
from audio_denoising_torch.ops.kernels.webrtc_hop import (
    WebRTCHopState, fft_passes, fft_radices, inverse_input, make_webrtc_hop,
    pass_twiddle_table, real_bins, twiddle_table, webrtc_hop_init_state)
from audio_denoising_torch.ops.noisefloor import gate_weight
from audio_denoising_torch.pipeline import (
    make_webrtc_step, webrtc_init_state)
from audio_denoising_torch.runtime.engine import StreamEngine
from audio_denoising_torch.runtime.plan import plan_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
CKPT = os.path.join(REPO, "checkpoints")
OP_REL = 1e-5          # DSP ops: fp32 FFTs of two libraries, relative
SNR_DB = 40.0          # waveform SNR of two fp32 versions of one algorithm
HX_ATOL = 1e-5         # the model state reads no phase: fp32 round-off
# the JAX kernel's bf16 3-pass matmuls carry ~4e-4 relative, so the port
# is held to tests/test_webrtc_hop.py's bounds against it
KERNEL_OUT = dict(rtol=2e-3, atol=1e-3)
KERNEL_HX = 5e-4
KERNEL_PHASES = 2e-3   # zero-iteration path (test_webrtc_hop.py:95-112)
RECV_TIMEOUT_S = 30.0
SMALL = dict(n_fft=64, hop_length=32, n_mels=16)   # _small_setup's sizes
# the gate's planes, relative, as tests/test_torch_fast.py holds them
PLANE_RTOL, PLANE_ATOL = 2e-4, 1e-9
GATE_PLANES = ("nf_smooth", "nf_floor", "nf_total", "em_out", "em_rem")
# (gate, width) per estimator at the small geometry: its random weights
# remove little, so 'removed' reads 75-86 dB there and 'floor' 16-54 dB on
# _bursty's streams; each ramp sits inside its range, so alpha spreads
GATE_POINTS = {"removed": (80.0, 6.0), "floor": (30.0, 10.0),
               "both": (80.0, 6.0)}


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(max((ref ** 2).sum(), 1e-20)
                         / max(((ref - got) ** 2).sum(), 1e-20))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# -- ops ---------------------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop,win,length", [
    (64, 32, None, None), (64, 16, 48, None), (64, 16, None, 900),
    (1536, 768, None, None), (1536, 768, None, 2900)])
def test_stft_istft_match_jax(rng, n_fft, hop, win, length):
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    want = np.asarray(jax_ops.stft(jnp.asarray(x), n_fft, hop, win))
    got = ops.stft(torch.from_numpy(x), n_fft, hop, win)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < OP_REL
    want_t = np.asarray(jax_ops.istft(jnp.asarray(want), n_fft, hop, win,
                                      length=length))
    got_t = ops.istft(torch.from_numpy(want), n_fft, hop, win, length=length)
    assert got_t.shape == want_t.shape
    assert _rel(got_t.numpy(), want_t) < OP_REL


@pytest.mark.parametrize("length,n_fft,hop", [(1536, 1536, 768),
                                              (3000, 64, 16), (10, 8, 3)])
def test_num_frames_and_framing(rng, length, n_fft, hop):
    assert ops.num_frames(length, n_fft, hop) == \
        jax_ops.num_frames(length, n_fft, hop)
    from audio_denoising_torch.ops.stft import frame_signal
    from audio_denoising_tpu.ops.stft import frame_signal as jax_frames
    x = rng.standard_normal((2, length)).astype(np.float32)
    np.testing.assert_array_equal(
        frame_signal(torch.from_numpy(x), n_fft, hop).numpy(),
        np.asarray(jax_frames(jnp.asarray(x), n_fft, hop)))


@pytest.mark.parametrize("n_stft,n_mels,sr", [
    (769, 64, 48000), (513, 128, 48000), (33, 16, 16000)])
def test_mel_scale_pair_matches_jax(rng, n_stft, n_mels, sr):
    """The inverse's entries reach 4e4 on bases with few bins per mel
    (33 x 16, 513 x 128) and its sums cancel, so its error is taken
    relative to the largest sum of term magnitudes, the scale fp32
    summation errors grow with."""
    spec = np.abs(rng.standard_normal((2, n_stft, 3))).astype(np.float32)
    fb = ops.mel_filterbank(n_stft, n_mels, sr)
    inv = ops.inverse_mel_matrix(n_stft, n_mels, sr)
    mel = ops.mel_scale(torch.from_numpy(spec), fb)
    want = np.asarray(jax_ops.mel_scale(
        jnp.asarray(spec), jax_ops.mel_filterbank(n_stft, n_mels, sr)))
    assert _rel(mel.numpy(), want) < OP_REL
    back = ops.inverse_mel_scale(mel, inv)
    want_b = np.asarray(jax_ops.inverse_mel_scale(
        jnp.asarray(want), jax_ops.inverse_mel_matrix(n_stft, n_mels, sr)))
    assert back.min() >= 0 and back.shape == want_b.shape
    terms = np.einsum("...mt,fm->...ft", np.abs(want), np.abs(inv.numpy()))
    assert np.abs(back.numpy() - want_b).max() < OP_REL * terms.max()


@pytest.mark.parametrize("warm", [False, True])
def test_griffin_lim_matches_jax(rng, warm):
    mag = np.abs(rng.standard_normal((2, 33, 10))).astype(np.float32)
    kw = dict(n_iter=4, length=300)
    seed = None
    if warm:
        ang = rng.uniform(-np.pi, np.pi, mag.shape)
        seed = np.exp(1j * ang).astype(np.complex64)
    want, want_a = jax_ops.griffin_lim(
        jnp.asarray(mag), 64, 32, init_angles=None if seed is None
        else jnp.asarray(seed), return_angles=True, **kw)
    got, got_a = ops.griffin_lim(
        torch.from_numpy(mag), 64, 32, init_angles=None if seed is None
        else torch.from_numpy(seed), return_angles=True, **kw)
    assert got.shape == want.shape == (2, 300)
    assert _snr(np.asarray(want), got.numpy()) > SNR_DB
    assert got_a.shape == mag.shape and got_a.dtype == torch.complex64


def test_griffin_lim_random_init_takes_a_generator():
    """JAX's PRNG stream cannot be reproduced: shape and unit modulus."""
    mag = torch.ones(2, 33, 5)
    with pytest.raises(ValueError, match="generator"):
        ops.griffin_lim(mag, 64, 32, n_iter=2, init="random")
    g = torch.Generator().manual_seed(0)
    out, ang = ops.griffin_lim(mag, 64, 32, n_iter=2, init="random",
                               generator=g, return_angles=True)
    assert out.shape == (2, 128) and torch.isfinite(out).all()
    assert torch.allclose(ang.abs(), torch.ones(()), atol=1e-5)


# -- the kernels' transform schedule (csrc/webrtc_hop.cu's passes) -----------

FFT_REL = 1e-5   # fp32 passes against torch.fft, relative to a frame's peak


@pytest.mark.parametrize("m,radices", [(768, [8, 8, 12]), (512, [8, 8, 8]),
                                       (32, [8, 4])])
def test_fft_pass_schedule_matches_torch_fft(m, radices):
    """The kernels' complex FFT pass by pass (their radices, twiddle
    indices and Stockham order) on three complex64 frames, with the
    float32 pass-twiddle table the wrapper hands to the kernels, against
    torch.fft.fft and m * ifft."""
    assert fft_radices(m) == radices
    rng = np.random.default_rng(m)
    z = torch.from_numpy(rng.standard_normal((3, m))
                         + 1j * rng.standard_normal((3, m))).to(
                             torch.complex64)
    tw = torch.from_numpy(pass_twiddle_table(m)).float()
    for inverse, want in ((False, torch.fft.fft(z)),
                          (True, torch.fft.ifft(z) * m)):
        got = fft_passes(z, tw, inverse)
        peak = want.abs().amax(dim=1, keepdim=True)
        assert float(((got - want).abs() / peak).max()) < FFT_REL, inverse


@pytest.mark.parametrize("m", [1, 6, 24, 48, 96, 384, 1152, 5, 20, 320,
                               600])
def test_fft_radices_factor_every_half_length(m):
    """Any m of 2s, 3s and 5s splits into passes of the in-register
    radices, whose product is m, and their twiddles fill the m - 1
    entries of the pass table, each once; another prime factor is a pass
    of its own, after those of 2, 3 and 5, and fills the table too."""
    for size in (m, 7 * m):
        radices = fft_radices(size)
        assert int(np.prod(radices)) == size
        fixed = [r for r in radices if r in {1, 2, 3, 4, 5, 8, 12}]
        assert radices == fixed + [7] * (size != m)
        table = pass_twiddle_table(size)   # unfilled entries would be NaN
        assert len(table) == max(size - 1, 1)
        assert np.allclose(np.hypot(table[:, 0], table[:, 1]), 1.0)


@pytest.mark.parametrize("n_fft", [1536, 1024, 64])
def test_real_split_and_pre_twiddle_give_rfft_and_irfft(n_fft):
    """The kernels' real-input formulas around the half-length FFT, in
    float64: ``real_bins`` of the packed frame's FFT is rfft of the frame;
    the inverse FFT of ``inverse_input`` read as sample pairs, over n_fft,
    is irfft (DC's and Nyquist's imaginary parts dropped)."""
    rng = np.random.default_rng(n_fft)
    x = torch.from_numpy(rng.standard_normal((3, n_fft)))
    tw = torch.from_numpy(twiddle_table(n_fft))
    ptw = torch.from_numpy(pass_twiddle_table(n_fft // 2))
    spec = real_bins(fft_passes(torch.complex(x[:, 0::2], x[:, 1::2]), ptw),
                     tw)
    want = torch.fft.rfft(x)
    assert float((spec - want).abs().max()) < 1e-10 * float(
        want.abs().max())
    want = want.clone()
    want[:, 0] += 0.3j
    want[:, -1] -= 0.2j
    back = fft_passes(inverse_input(want, tw), ptw, inverse=True)
    y = torch.stack([back.real, back.imag], dim=-1).reshape(3, n_fft) / n_fft
    ref = torch.fft.irfft(want, n=n_fft)
    assert float((y - ref).abs().max()) < 1e-10 * float(ref.abs().max())


@pytest.mark.parametrize("n_fft", [640, 882, 1536])
def test_real_split_keeps_dc_and_nyquist_real(n_fft):
    """In float32, as the kernels run it: the real split of the packed
    frames' FFT gives DC and Nyquist bins with no imaginary part, as a real
    frame's are (the twiddle table's quarter turns exact; a rounded
    e^{-i pi} left one of order 1e-16, which Griffin-Lim's u / (|u| +
    1e-16) made a phase of norm between 0 and 1 where the bin was 0)."""
    rng = np.random.default_rng(n_fft)
    x = torch.from_numpy(rng.standard_normal((3, n_fft)).astype(np.float32))
    ptw = torch.from_numpy(pass_twiddle_table(n_fft // 2)).float()
    tw = torch.from_numpy(twiddle_table(n_fft)).float()
    spec = real_bins(fft_passes(torch.complex(x[:, 0::2], x[:, 1::2]), ptw),
                     tw)
    assert bool((spec[:, [0, -1]].imag == 0).all())
    want = torch.fft.rfft(x.double())
    assert float((spec - want).abs().max()) < 1e-5 * float(
        want.abs().max())


# -- the small setup: tests/test_webrtc_hop.py::_small_setup ----------------

def _small(n_iter=4, warm=True, **dsp):
    """The JAX side (cfg, model, params, plan) and the port's (cfg, model,
    plan) on the same random weights."""
    d = dict(SMALL, sample_rate=16000, reconstruction="griffin_lim",
             griffin_lim_iters=n_iter, griffin_lim_warm_start=warm, **dsp)
    m = dict(arch="GRUUNet2", num_compressed_bins=4, hidden_sizes=(5, 5),
             kernel_sizes=(3, 3), strides=(2, 2), paddings=(1, 1),
             num_gaussians=3)
    jcfg = JaxConfig(dsp=JaxDSPConfig(**d), model=JaxModelConfig(**m))
    jmodel = jax_build_model(jcfg.model, num_bins=jcfg.dsp.n_mels)
    params = jmodel.init(jax.random.PRNGKey(0))
    jplan = jax_build_cell_plan(jmodel, params)
    cfg = Config(dsp=DSPConfig(**d), model=ModelConfig(**m))
    model = build_model(cfg.model, num_bins=cfg.dsp.n_mels).load_params(
        params_from_jax({k: np.asarray(v) for k, v in params.items()}))
    return (jcfg, jmodel, params, jplan), (cfg, model, plan_from_numpy(jplan))


def _chunks(rng, b, hop, n):
    return [(0.2 * rng.standard_normal((b, hop))).astype(np.float32)
            for _ in range(n)]


def _angles_to_planes(a):
    """JAX step angles (B, F, 3, 2) -> (re, im) each (B, 3F), frame-major."""
    a = np.asarray(a)
    return (a[..., 0].transpose(0, 2, 1).reshape(a.shape[0], -1),
            a[..., 1].transpose(0, 2, 1).reshape(a.shape[0], -1))


@pytest.mark.parametrize("warm", [False, True])
def test_webrtc_step_matches_jax(rng, warm):
    (jcfg, jmodel, params, _), (cfg, model, _) = _small(warm=warm)
    jstep = jax_make_step(jcfg, jmodel)
    step = make_webrtc_step(cfg, model, "cpu")
    js = jax_step_init(jcfg, jmodel, 3)
    s = webrtc_init_state(cfg, model, 3)
    for t, c in enumerate(_chunks(rng, 3, 32, 6)):
        js, jout = jstep(params, js, jnp.asarray(c))
        s, out = step(s, torch.from_numpy(c))
        assert out.shape == (3, 32)
        np.testing.assert_allclose(s.hx.numpy(), np.asarray(js.hx),
                                   atol=HX_ATOL)
        if t >= 2:                   # warm-up hops emit (near-)silence
            assert _snr(np.asarray(jout), out.numpy()) > SNR_DB
    if warm:
        assert s.gl_angles.shape == np.asarray(js.gl_angles).shape
    else:
        assert s.gl_angles is None and js.gl_angles is None


def test_webrtc_step_refuses_lookahead_and_the_gate():
    """Lookahead checkpoints are refused, as in the JAX package; the SNR
    gate, refused until the fifth slice, is now served: the gated step
    builds, its state carries the estimator's planes, and a hop runs."""
    _, (cfg, model, _) = _small()
    la = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, lookahead_frames=1))
    with pytest.raises(ValueError, match="lookahead"):
        make_webrtc_step(la, model, "cpu")
    gated = dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, snr_gate_db=1.0))
    step = make_webrtc_step(gated, model, "cpu")
    state = webrtc_init_state(gated, model, 2)
    for name in GATE_PLANES:
        assert getattr(state, name) is not None, name
    state, out = step(state, torch.full((2, 32), 0.1))
    assert out.shape == (2, 32) and bool(torch.isfinite(state.ola).all())


# -- the webrtc step on gruunet2-dari_tult against the reference goldens -----

@pytest.fixture(scope="module")
def dari():
    cfg, model = load_pretrained("gruunet2-dari_tult")
    return cfg, model


def test_webrtc_stages_match_golden(dari):
    """tests/test_pipeline.py::test_stagewise_lockstep_vs_golden with the
    port's ops and model, at its bounds."""
    cfg, model = dari
    g = np.load(os.path.join(GOLD, "pipeline_webrtc_GRUUNet2-dari_tult.npz"))
    dsp = cfg.dsp
    fb = ops.mel_filterbank(dsp.n_stft, dsp.n_mels, dsp.sample_rate)
    win = ops.hann_window(dsp.n_fft)
    audio = torch.from_numpy(g["audio"])
    hx = model.init_state(1)
    with torch.no_grad():
        for i in range(g["frames_in"].shape[0]):
            cur = audio[i * dsp.hop_length:i * dsp.hop_length + dsp.n_fft]
            windowed = cur / cur.abs().max() * win
            np.testing.assert_allclose(windowed.numpy(), g["frames_in"][i],
                                       atol=1e-5)
            spec = ops.stft(windowed[None], dsp.n_fft, dsp.hop_length,
                            window=win)
            x = torch.log1p(ops.mel_scale(spec.abs(), fb)).transpose(-1, -2)
            np.testing.assert_allclose(x[0].numpy(), g["mels"][i],
                                       atol=2e-3, rtol=1e-4)
            resid, hx = model.apply(x, hx)
            np.testing.assert_allclose(resid[0].numpy(), g["residuals"][i],
                                       atol=2e-3, rtol=1e-3)
            recon = torch.nn.functional.leaky_relu(x - resid, 0.2)
            mel_mag = torch.clamp(torch.expm1(recon.transpose(-1, -2)),
                                  min=0)
            np.testing.assert_allclose(mel_mag[0].numpy(),
                                       g["recon_mags"][i],
                                       atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(hx.numpy(), g["final_hx"], atol=1e-3,
                               rtol=1e-3)


def test_webrtc_step_matches_waveform_golden(dari):
    """tests/test_pipeline.py::test_waveform_golden: cold GL-32 over the
    golden's audio, SNR above 25 dB against the executed reference."""
    cfg, model = dari
    g = np.load(os.path.join(
        GOLD, "pipeline_webrtc_waveform_GRUUNet2-dari_tult.npz"))
    cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, griffin_lim_iters=32, griffin_lim_warm_start=False))
    step = make_webrtc_step(cfg, model, "cpu")
    hop = cfg.dsp.hop_length
    audio = torch.from_numpy(g["audio"])
    state = webrtc_init_state(cfg, model, 1)
    # the reference waits for a full window: pre-seed the ring's tail
    state.ring[:, hop:] = audio[None, :hop]
    outs = []
    for j in range(g["out_hops"].shape[0]):
        state, out = step(state, audio[None, (j + 1) * hop:(j + 2) * hop])
        outs.append(out[0].numpy())
    outs, ref = np.stack(outs), g["out_hops"]
    np.testing.assert_array_equal(outs[0], 0.0)
    assert _snr(ref[1:], outs[1:]) > 25.0
    np.testing.assert_allclose(state.hx.numpy(),
                               g["final_hx"].reshape(state.hx.shape),
                               atol=2e-3)


# -- the WebRTC hop's plain version against the JAX kernel ---------------------

def _jax_planes(a, F):
    """The JAX kernel's FP-strided phases (B, 3 FP) as (B, 3 F)."""
    a, FP = np.asarray(a), _fpad(F)
    return np.concatenate([a[:, t * FP:t * FP + F] for t in range(3)], 1)


@pytest.mark.parametrize("batch", [3, 9])
def test_plain_hop_matches_jax_kernel(rng, batch):
    """B=3 at tests/test_webrtc_hop.py's elementwise bound; B=9 (not a
    multiple of the JAX kernel's tile of 8: its padding) relative to each
    hop's scale. On B=9's data the JAX kernel's bf16 3-pass error itself
    leaves the elementwise bound against the JAX op-by-op step (by 0.08
    at hop 4, where outputs reach 3.4e3), while the port's plain version
    stays inside it; the 2e-3 of the scale is the kernel's ~4e-4 relative
    error with room."""
    (jcfg, _, _, jplan), (cfg, _, plan) = _small()
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True, block_b=8)
    hop = make_webrtc_hop(cfg, plan, "cpu")
    js = jax_hop_init_state(jcfg, jplan, batch)
    s = webrtc_hop_init_state(cfg, plan, batch)
    F = cfg.dsp.n_stft
    for c in _chunks(rng, batch, 32, 6):
        js, jout = jax_hop(js, jnp.asarray(c))
        s, out = hop(s, torch.from_numpy(c))
        assert out.shape == (batch, 32) and out.dtype == torch.float32
        jout = np.asarray(jout)
        if batch == 3:
            np.testing.assert_allclose(out.numpy(), jout, **KERNEL_OUT)
        else:
            assert np.abs(out.numpy() - jout).max() <= \
                KERNEL_OUT["rtol"] * np.abs(jout).max() + KERNEL_OUT["atol"]
        np.testing.assert_allclose(s.hx.numpy(), np.asarray(js.hx),
                                   atol=KERNEL_HX)
        np.testing.assert_array_equal(s.ring.numpy(), np.asarray(js.ring))
        nrm = np.hypot(s.ang_re.numpy(), s.ang_im.numpy())
        assert np.all((np.abs(nrm - 1) < 1e-3) | (nrm < 1e-3))
        assert s.ang_re.shape == (batch, 3 * F)
    assert hop.launches == 0      # the plain version is not a launch


def test_plain_hop_zero_iterations_matches_jax_phases(rng):
    (jcfg, _, _, jplan), (cfg, _, plan) = _small(n_iter=0)
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True, block_b=8)
    hop = make_webrtc_hop(cfg, plan, "cpu")
    js = jax_hop_init_state(jcfg, jplan, 3)
    s = webrtc_hop_init_state(cfg, plan, 3)
    F = cfg.dsp.n_stft
    for c in _chunks(rng, 3, 32, 3):
        js, jout = jax_hop(js, jnp.asarray(c))
        s, out = hop(s, torch.from_numpy(c))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   **KERNEL_OUT)
        np.testing.assert_allclose(s.ang_re.numpy(),
                                   _jax_planes(js.ang_re, F),
                                   atol=KERNEL_PHASES)
        np.testing.assert_allclose(s.ang_im.numpy(),
                                   _jax_planes(js.ang_im, F),
                                   atol=KERNEL_PHASES)


@pytest.mark.parametrize("n_iter", [0, 4])
def test_plain_hop_matches_jax_step(rng, n_iter):
    """The hop (plan cell) against the op-by-op step (conv model): the
    same function in two forms."""
    (jcfg, jmodel, params, _), (cfg, _, plan) = _small(n_iter=n_iter)
    jstep = jax_make_step(jcfg, jmodel)
    hop = make_webrtc_hop(cfg, plan, "cpu")
    js = jax_step_init(jcfg, jmodel, 3)
    s = webrtc_hop_init_state(cfg, plan, 3)
    for t, c in enumerate(_chunks(rng, 3, 32, 6)):
        js, jout = jstep(params, js, jnp.asarray(c))
        s, out = hop(s, torch.from_numpy(c))
        np.testing.assert_allclose(s.hx.numpy(),
                                   np.asarray(js.hx).reshape(3, -1),
                                   atol=HX_ATOL)
        if t >= 2:
            assert _snr(np.asarray(jout), out.numpy()) > SNR_DB
    re, im = _angles_to_planes(js.gl_angles)
    if n_iter == 0:
        np.testing.assert_allclose(s.ang_re.numpy(), re, atol=1e-5)
        np.testing.assert_allclose(s.ang_im.numpy(), im, atol=1e-5)


def _bad_inputs(cfg, plan):
    s = webrtc_hop_init_state(cfg, plan, 2)
    c = torch.zeros(2, cfg.dsp.hop_length)
    return {
        "chunk dtype": (s, c.double(), TypeError),
        "chunk width": (s, torch.zeros(2, 33), ValueError),
        "state batch": (webrtc_hop_init_state(cfg, plan, 3), c, ValueError),
        "phase width": (s._replace(ang_im=torch.zeros(2, 7)), c, ValueError),
        "phase dtype": (s._replace(ang_re=s.ang_re.half()), c, TypeError),
    }


@pytest.mark.parametrize("case", ["chunk dtype", "chunk width",
                                  "state batch", "phase width",
                                  "phase dtype"])
def test_hop_wrapper_rejects_bad_inputs(case):
    _, (cfg, _, plan) = _small()
    hop = make_webrtc_hop(cfg, plan, "cpu")
    state, chunk, err = _bad_inputs(cfg, plan)[case]
    with pytest.raises(err):
        hop(state, chunk)


# the bf16 case keeps its id from before the bf16 GL mode was ported
@pytest.mark.parametrize("case,err", [
    ("cold", ValueError), ("hop", ValueError), ("raw", ValueError),
    ("delta", ValueError),
    pytest.param("bf16", None, id="bf16-NotImplementedError"),
    ("multi", ValueError)])
def test_hop_refuses_what_it_cannot_serve(case, err):
    """What the JAX kernel refuses, with ValueError. The bf16 GL mode,
    refused with NotImplementedError until it was ported, builds and runs
    a hop (held against JAX's bf16 kernel in test_bf16_gl_*). K hops per
    call are served (test_multi_hop_*); a call of no hops is refused."""
    _, (cfg, _, plan) = _small()
    kw = {}
    dsp = cfg.dsp
    if case == "cold":
        dsp = dataclasses.replace(dsp, griffin_lim_warm_start=False)
    elif case == "hop":
        dsp = dataclasses.replace(dsp, hop_length=16)
    elif case == "raw":
        dsp = dataclasses.replace(dsp, domain="raw")
    elif case == "delta":
        plan = plan._replace(delta=True)
    elif case == "bf16":
        kw["compute_dtype"] = torch.bfloat16
    else:
        kw["hops_per_call"] = 0
    cfg = dataclasses.replace(cfg, dsp=dsp)
    if err is None:
        hop = make_webrtc_hop(cfg, plan, "cpu", **kw)
        assert hop.gl_bf16 and hop.compute_dtype == torch.bfloat16
        state, out = hop(webrtc_hop_init_state(cfg, plan, 2),
                         torch.full((2, cfg.dsp.hop_length), 0.1))
        assert out.shape == (2, cfg.dsp.hop_length)
        assert bool(torch.isfinite(state.ola).all())
        return
    with pytest.raises(err):
        make_webrtc_hop(cfg, plan, "cpu", **kw)


def test_hop_needs_a_card_unless_cpu_is_asked(monkeypatch):
    _, (cfg, _, plan) = _small()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_webrtc_hop(cfg, plan)


def test_cpu_hop_refuses_tensors_it_was_not_built_for():
    _, (cfg, _, plan) = _small()
    hop = make_webrtc_hop(cfg, plan, "cpu")
    state = WebRTCHopState(*(torch.empty(2, w, device="meta")
                             for w in (64, 64, 20, 99, 99)))
    with pytest.raises(ValueError, match="built for cpu"):
        hop(state, torch.empty(2, 32, device="meta"))


# -- K hops per call ----------------------------------------------------------

@pytest.mark.parametrize("n_iter", [0, 4])
@pytest.mark.parametrize("batch,K", [(3, 4), (5, 2)])
def test_multi_hop_matches_jax_kernel(rng, batch, K, n_iter):
    """K hops per call (the plain version) against JAX's resident kernel
    (hops_per_call=K, interpret mode), two calls, the second from the
    carried state; B=5 is ragged against the JAX kernel's tile of 8 (its
    padding). Held at test_plain_hop_matches_jax_kernel's bounds: outputs
    within its rtol and atol of each hop's scale (the B=9 form: over 8
    hops the JAX kernel's bf16 3-pass error leaves the elementwise bound),
    hx within KERNEL_HX, the ring exact; the phases elementwise with no GL
    round (KERNEL_PHASES), unit vectors with one."""
    (jcfg, _, _, jplan), (cfg, _, plan) = _small(n_iter=n_iter)
    jax_multi = jax_make_hop(jcfg, jplan, interpret=True, block_b=8,
                             hops_per_call=K)
    multi = make_webrtc_hop(cfg, plan, "cpu", hops_per_call=K)
    js = jax_hop_init_state(jcfg, jplan, batch)
    s = webrtc_hop_init_state(cfg, plan, batch)
    F = cfg.dsp.n_stft
    for _ in range(2):
        chunks = np.stack(_chunks(rng, batch, 32, K))
        js, jouts = jax_multi(js, jnp.asarray(chunks))
        s, outs = multi(s, torch.from_numpy(chunks))
        assert outs.shape == (K, batch, 32) and outs.dtype == torch.float32
        for got, want in zip(outs.numpy(), np.asarray(jouts)):
            assert np.abs(got - want).max() <= \
                KERNEL_OUT["rtol"] * np.abs(want).max() + KERNEL_OUT["atol"]
        np.testing.assert_allclose(s.hx.numpy(), np.asarray(js.hx),
                                   atol=KERNEL_HX)
        np.testing.assert_array_equal(s.ring.numpy(), np.asarray(js.ring))
        np.testing.assert_allclose(
            s.ola.numpy(), np.asarray(js.ola),
            atol=KERNEL_OUT["rtol"] * np.abs(np.asarray(js.ola)).max()
            + KERNEL_OUT["atol"])
        if n_iter == 0:
            for got, want in ((s.ang_re, js.ang_re), (s.ang_im, js.ang_im)):
                np.testing.assert_allclose(got.numpy(), _jax_planes(want, F),
                                           atol=KERNEL_PHASES)
        nrm = np.hypot(s.ang_re.numpy(), s.ang_im.numpy())
        assert np.all((np.abs(nrm - 1) < 1e-3) | (nrm < 1e-3))
    assert multi.launches == 0      # the plain version is not a launch


@pytest.mark.parametrize("n_iter", [0, 4])
def test_multi_hop_equals_single_hops(rng, n_iter):
    """On the CPU a K-hop call is K single hops of the plain version,
    the state carried: exactly equal, outputs and every plane."""
    _, (cfg, _, plan) = _small(n_iter=n_iter)
    K, B = 4, 3
    multi = make_webrtc_hop(cfg, plan, "cpu", hops_per_call=K)
    single = make_webrtc_hop(cfg, plan, "cpu")
    chunks = torch.from_numpy(np.stack(_chunks(rng, B, 32, K)))
    s_m, outs = multi(webrtc_hop_init_state(cfg, plan, B), chunks)
    s_s = webrtc_hop_init_state(cfg, plan, B)
    for k in range(K):
        s_s, out = single(s_s, chunks[k])
        assert torch.equal(outs[k], out)
    for a, b in zip(s_m, s_s):
        assert torch.equal(a, b)


def _bad_multi_inputs(cfg, plan, K):
    s = webrtc_hop_init_state(cfg, plan, 2)
    c = torch.zeros(K, 2, cfg.dsp.hop_length)
    return {
        "hops": (s, torch.zeros(K + 1, 2, 32), ValueError),
        "one hop": (s, torch.zeros(2, 32), ValueError),
        "chunk width": (s, torch.zeros(K, 2, 33), ValueError),
        "chunk dtype": (s, c.double(), TypeError),
        "state batch": (webrtc_hop_init_state(cfg, plan, 3), c, ValueError),
        "phase dtype": (s._replace(ang_im=s.ang_im.half()), c, TypeError),
        "device": (WebRTCHopState(*(torch.empty(2, w, device="meta")
                                    for w in (64, 64, 20, 99, 99))),
                   torch.empty(K, 2, 32, device="meta"), ValueError),
    }


@pytest.mark.parametrize("case", ["hops", "one hop", "chunk width",
                                  "chunk dtype", "state batch",
                                  "phase dtype", "device"])
def test_multi_hop_wrapper_rejects_bad_inputs(case):
    """chunks must be (K, B, hop) float32 with K = hops_per_call (JAX's
    step_multi asserts the same), the state planes (B, width) float32 on
    the device the hop was built for."""
    _, (cfg, _, plan) = _small()
    K = 3
    multi = make_webrtc_hop(cfg, plan, "cpu", hops_per_call=K)
    state, chunks, err = _bad_multi_inputs(cfg, plan, K)[case]
    with pytest.raises(err):
        multi(state, chunks)


# -- the engine modes ----------------------------------------------------------

def _schedule(rng, hop, ticks=8):
    """{stream: chunk} per tick: stream 'c' skips every third tick, 'b'
    leaves at tick 3 and 'e' takes its slot; a NaN chunk at tick 2."""
    out = []
    for t in range(ticks):
        live = ["a", "c"] + (["b"] if t < 3 else ["e"] if t > 3 else [])
        chunks = {s: (0.2 * rng.standard_normal(hop)).astype(np.float32)
                  for s in live if not (s == "c" and t % 3 == 1)}
        if t == 2:
            chunks["a"][3] = np.nan
        out.append(chunks)
    return out


def _drive(engines, ticks):
    """Both engines through the schedule; per tick both outputs."""
    for e in engines:
        for s in "abc":
            e.add_stream(s)
    pairs = []
    for t, chunks in enumerate(ticks):
        if t == 3:
            for e in engines:
                e.remove_stream("b")
                e.add_stream("e")
        pairs.append(tuple(e.process(chunks) for e in engines))
    return pairs


@pytest.mark.parametrize("mode", ["webrtc", "fused-webrtc"])
def test_engine_mode_matches_jax(rng, mode):
    (jcfg, jmodel, params, _), (cfg, model, _) = _small(n_iter=2)
    jax_engine = JaxEngine(jcfg, jmodel, params, mode=mode, max_streams=4,
                           pallas_interpret=True)
    engine = StreamEngine(cfg, model, mode=mode, max_streams=4, device="cpu")
    pairs = _drive((jax_engine, engine), _schedule(rng, 32))
    assert engine.slots == jax_engine.slots
    seen = {}
    for oj, ot in pairs:
        assert set(ot) == set(oj)
        for s in ot:
            seen[s] = seen.get(s, 0) + 1
            assert np.all(np.isfinite(ot[s]))
            if mode == "fused-webrtc":
                np.testing.assert_allclose(ot[s], oj[s], **KERNEL_OUT)
            elif seen[s] > 2:        # a stream's first hops are silent
                assert _snr(oj[s], ot[s]) > SNR_DB
    np.testing.assert_allclose(
        engine.state.hx.numpy().reshape(4, -1),
        np.asarray(jax_engine.state.hx).reshape(4, -1),
        atol=KERNEL_HX if mode == "fused-webrtc" else HX_ATOL)
    assert engine.algorithmic_latency_ms == jax_engine.algorithmic_latency_ms
    assert engine.algorithmic_latency_samples == 32


@pytest.mark.parametrize("mode", ["webrtc", "fused-webrtc"])
def test_engine_idle_slots_and_snapshot(rng, mode):
    """Masked commit: an idle slot's state, carried phases included, does
    not move; a snapshot restores every state field."""
    _, (cfg, model, _) = _small(n_iter=2)
    engine = StreamEngine(cfg, model, mode=mode, max_streams=4, device="cpu")
    engine.add_stream("x")
    engine.add_stream("idle")
    chunk = lambda: (0.2 * rng.standard_normal(32)).astype(np.float32)
    engine.process({"x": chunk(), "idle": chunk()})
    slot = engine.slots["idle"]
    fields = {k: v for k, v in engine.state._asdict().items()
              if v is not None}
    assert ("ang_re" in fields) == (mode == "fused-webrtc")
    assert ("gl_angles" in fields) == (mode == "webrtc")
    before = {k: v[slot].clone() for k, v in fields.items()}
    snap = engine.snapshot()
    assert set(snap["state"]) == set(fields)
    for _ in range(3):
        engine.process({"x": chunk()})
    for k, v in before.items():
        assert torch.equal(getattr(engine.state, k)[slot], v), k
    engine.restore(snap)
    for k, v in snap["state"].items():
        np.testing.assert_array_equal(getattr(engine.state, k).numpy(), v)
    bad = dict(snap, state={k: v for k, v in snap["state"].items()
                            if k != "hx"})
    with pytest.raises(ValueError, match="layout"):
        engine.restore(bad)


def test_engine_snapshot_round_trip_replays_the_audio(rng):
    _, (cfg, model, _) = _small(n_iter=2)
    engine = StreamEngine(cfg, model, mode="fused-webrtc", max_streams=2,
                          device="cpu")
    engine.add_stream("s")
    chunks = [(0.2 * rng.standard_normal(32)).astype(np.float32)
              for _ in range(5)]
    engine.process({"s": chunks[0]})
    snap = engine.snapshot()
    first = [engine.process({"s": c})["s"] for c in chunks[1:]]
    engine.restore(snap)
    again = [engine.process({"s": c})["s"] for c in chunks[1:]]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_add_stream_resets_the_warm_seed(rng):
    """A reused slot starts from the 1+0j seed, not from zeros."""
    _, (cfg, model, _) = _small(n_iter=2)
    engine = StreamEngine(cfg, model, mode="fused-webrtc", max_streams=1,
                          device="cpu")
    engine.add_stream("a")
    engine.process({"a": (0.2 * rng.standard_normal(32)).astype(np.float32)})
    engine.remove_stream("a")
    slot = engine.add_stream("b")
    assert torch.equal(engine.state.ang_re[slot], torch.ones(99))
    assert torch.equal(engine.state.ang_im[slot], torch.zeros(99))
    assert torch.equal(engine.state.hx[slot], torch.zeros(20))


# the ids are the cases' names from before the port served JAX's
# downgrades, when every case but gate-webrtc raised
@pytest.mark.parametrize("case,mode,err,served", [
    pytest.param("gate", "fused-webrtc", None, "webrtc",
                 id="gate-fused-webrtc-ValueError"),
    pytest.param("gate", "webrtc", None, "webrtc", id="gate-webrtc-None"),
    pytest.param("int8", "fused-webrtc", None, "fast",
                 id="int8-fused-webrtc-ValueError"),
    pytest.param("int8", "webrtc", None, "fast", id="int8-webrtc-ValueError"),
    pytest.param("lookahead", "fused-webrtc", ValueError, None,
                 id="lookahead-fused-webrtc-ValueError"),
    pytest.param("lookahead", "webrtc", ValueError, None,
                 id="lookahead-webrtc-ValueError"),
    pytest.param("cold", "fused-webrtc", ValueError, None,
                 id="cold-fused-webrtc-ValueError"),
    pytest.param("bf16", "fused-webrtc", None, "fused-webrtc",
                 id="bf16-fused-webrtc-NotImplementedError")])
def test_engine_raises_where_jax_downgrades(case, mode, err, served):
    """Where the JAX engine downgrades (engine.py:278-308), the port now
    warns and serves the same mode: a gated fused-webrtc in mode webrtc,
    whose step carries the gate; int8 in mode fast on the quantized plan.
    bf16 is served in mode fused-webrtc itself (the GL loop in bf16), as
    JAX serves it; until that mode was ported the port raised there.
    Where neither serves the config, it raises and never serves another
    mode."""
    _, (cfg, model, _) = _small()
    srv, dsp, mc = cfg.serving, cfg.dsp, cfg.model
    if case == "gate":
        srv = dataclasses.replace(srv, snr_gate_db=1.0)
    elif case in ("int8", "bf16"):
        srv = dataclasses.replace(srv, dtype={"int8": "int8",
                                              "bf16": "bfloat16"}[case])
    elif case == "lookahead":
        mc = dataclasses.replace(mc, lookahead_frames=1)
    else:
        dsp = dataclasses.replace(dsp, griffin_lim_warm_start=False)
    cfg = dataclasses.replace(cfg, serving=srv, dsp=dsp, model=mc)
    if err is not None:
        with pytest.raises(err):
            StreamEngine(cfg, model, mode=mode, max_streams=2, device="cpu")
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        engine = StreamEngine(cfg, model, mode=mode, max_streams=2,
                              device="cpu")
    assert engine.mode == served
    said = [str(w.message) for w in caught]
    if served == mode:
        assert not said
    else:
        assert any(f"{mode!r} downgraded to {served!r}" in m for m in said)
    if case == "gate":
        assert engine.state.em_out is not None
    if case == "bf16":
        assert engine.hop_step.gl_bf16


def test_webrtc_engines_need_a_card_unless_cpu_is_asked(monkeypatch):
    _, (cfg, model, _) = _small()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("webrtc", "fused-webrtc"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamEngine(cfg, model, mode=mode, max_streams=2)


# -- the SNR gate of the webrtc step ------------------------------------------

def _gated(cfg, estimator, gate_db=None, width_db=None):
    points = GATE_POINTS[estimator]
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, snr_gate_db=points[0] if gate_db is None else gate_db,
        snr_gate_width_db=points[1] if width_db is None else width_db,
        snr_gate_estimator=estimator))


def _bursty(rng, B, hop, t, sr=16000):
    """A tone on every other 3 hops over per-stream noise levels (the
    JAX gate tests' bursty input): the estimators read the streams apart."""
    t_ax = np.arange(t * hop, (t + 1) * hop) / sr
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


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("estimator", ["removed", "floor", "both"])
def test_gated_webrtc_step_matches_jax(estimator, warm):
    """The gated op-by-op step against JAX's over 12 hops of bursty input
    on 4 streams, at test_webrtc_step_matches_jax's bounds (out SNR_DB
    from hop 2 on, hx HX_ATOL) and the gate's planes relative PLANE_RTOL;
    the gate blends (alpha in (0, 1)) on some stream-hops."""
    (jcfg, jmodel, params, _), (cfg, model, _) = _small(warm=warm)
    jcfg, cfg = _gated(jcfg, estimator), _gated(cfg, estimator)
    jstep = jax_make_step(jcfg, jmodel)
    step = make_webrtc_step(cfg, model, "cpu")
    js = jax_step_init(jcfg, jmodel, 4)
    s = webrtc_init_state(cfg, model, 4)
    rng = np.random.default_rng(11)
    alphas = []
    for t in range(12):
        c = _bursty(rng, 4, 32, t)
        js, jout = jstep(params, js, jnp.asarray(c))
        s, out = step(s, torch.from_numpy(c))
        np.testing.assert_allclose(s.hx.numpy(), np.asarray(js.hx),
                                   atol=HX_ATOL)
        if t >= 2:
            assert _snr(np.asarray(jout), out.numpy()) > SNR_DB
        _assert_planes_close(s, js)
        alphas.append(gate_weight(cfg.serving, s))
    alphas = torch.cat(alphas)
    assert bool(((alphas > 0) & (alphas < 1)).any())


def test_gate_in_webrtc_gl_mode_on_dari(dari):
    """tests/test_noisefloor.py::test_gate_in_webrtc_gl_mode with the
    port's engine: on gruunet2-dari_tult (cold GL-32), a passthrough gate
    (-60 dB: alpha 0) makes the GL targets the input's magnitudes, so the
    output's RMS comes back within 2x of the input's, while a never-pass
    gate (200 dB: alpha 1) leaves the suppressing model's output under a
    tenth of it. RMS, not samples: GL rebuilds its own phase."""
    cfg0, model = dari

    def run(gate_db):
        cfg = _gated(cfg0, "removed", gate_db, 1.0)
        eng = StreamEngine(cfg, model, mode="webrtc", max_streams=1,
                           device="cpu")
        eng.add_stream("a")
        assert eng.state.em_out is not None and eng.state.nf_floor is None
        hop, n_ticks = cfg.dsp.hop_length, 30
        t_ax = np.arange(n_ticks * hop, dtype=np.float32)
        audio = (0.3 * np.sin(2 * np.pi * 500 * t_ax / 48000)
                 + 0.01 * np.random.default_rng(7).standard_normal(
                     n_ticks * hop)).astype(np.float32)
        out = np.concatenate(
            [eng.process({"a": audio[t * hop:(t + 1) * hop]})["a"]
             for t in range(n_ticks)])
        return audio, out

    _, out_denoise = run(200.0)
    audio, out_pass = run(-60.0)
    half = len(audio) // 2
    rms = lambda x: float(np.sqrt(np.mean(x[half:] ** 2)))
    assert 0.5 * rms(audio) < rms(out_pass) < 2.0 * rms(audio)
    assert rms(out_denoise) < 0.1 * rms(out_pass)


@pytest.mark.parametrize("estimator", ["removed", "floor", "both"])
def test_gated_engine_webrtc_matches_jax(rng, estimator):
    """Mode webrtc with the gate against the JAX engine over _schedule's
    ticks (idle slots, a stream leaving and another admitted to its slot,
    a NaN chunk): outputs at SNR_DB after a stream's first two hops, hx
    and the gate's planes of every slot at the end; admission resets a
    slot's planes and the masked commit leaves an idle slot's as they
    were."""
    (jcfg, jmodel, params, _), (cfg, model, _) = _small(n_iter=2)
    jcfg, cfg = _gated(jcfg, estimator), _gated(cfg, estimator)
    jax_engine = JaxEngine(jcfg, jmodel, params, mode="webrtc",
                           max_streams=4)
    engine = StreamEngine(cfg, model, mode="webrtc", max_streams=4,
                          device="cpu")
    assert jax_engine.mode == engine.mode == "webrtc"
    ticks = _schedule(rng, 32)
    planes = [n for n in GATE_PLANES if getattr(engine.state, n) is not None]
    for e in (jax_engine, engine):
        for sid in "abc":
            e.add_stream(sid)
    seen = {}
    for t, chunks in enumerate(ticks):
        if t == 3:
            for e in (jax_engine, engine):
                e.remove_stream("b")
                e.add_stream("e")
            slot = engine.slots["e"]
            for name in planes:      # admission zeroes the new stream's planes
                assert not bool(getattr(engine.state, name)[slot].any())
        idle = [engine.slots[s] for s in engine.slots if s not in chunks]
        before = {n: getattr(engine.state, n)[idle].clone() for n in planes}
        oj, ot = jax_engine.process(chunks), engine.process(chunks)
        for n, v in before.items():
            assert torch.equal(getattr(engine.state, n)[idle], v), n
        assert set(ot) == set(oj)
        for sid in ot:
            seen[sid] = seen.get(sid, 0) + 1
            assert np.all(np.isfinite(ot[sid]))
            if seen[sid] > 2:
                assert _snr(oj[sid], ot[sid]) > SNR_DB
    assert engine.slots == jax_engine.slots
    np.testing.assert_allclose(
        engine.state.hx.numpy().reshape(4, -1),
        np.asarray(jax_engine.state.hx).reshape(4, -1), atol=HX_ATOL)
    _assert_planes_close(engine.state, jax_engine.state)


# -- hub, checkpoints and the daemon ---------------------------------------------

def test_hub_loads_dari_tult_with_its_own_weights(dari):
    cfg, model = dari
    assert cfg.to_json() == PRESETS["gruunet2-dari_tult"].to_json()
    params, _ = load_params_npz(os.path.join(CKPT, "gruunet2-dari_tult.npz"))
    w = "cell.input_gate.downs.0.conv.weight"
    np.testing.assert_array_equal(model.state_dict()[w].numpy(), params[w])


def _write_warm_npz(path, cfg, model):
    save_params_npz(path, {k: v.numpy() for k, v in
                           model.state_dict().items()},
                    {"full_config": json.loads(cfg.to_json())})
    return path


def test_warm_checkpoint_round_trip(tmp_path):
    """save_params_npz writes what both hubs read, full_config and all."""
    from audio_denoising_tpu.hub import load_pretrained as jax_load
    _, (cfg, model, _) = _small()
    path = _write_warm_npz(str(tmp_path / "warm.npz"), cfg, model)
    cfg2, model2 = load_pretrained(path)
    assert cfg2.dsp == cfg.dsp and cfg2.dsp.griffin_lim_warm_start
    jcfg, _, jparams = jax_load(path)
    assert jcfg.dsp.griffin_lim_warm_start
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v)
        np.testing.assert_array_equal(np.asarray(jparams[k]), v.numpy())


def _recv(conn):
    if not conn.poll(RECV_TIMEOUT_S):
        raise TimeoutError("no reply from the daemon")
    return conn.recv()


def test_daemon_serves_fused_webrtc(tmp_path, rng):
    _, (cfg, model, plan) = _small(n_iter=2)
    path = _write_warm_npz(str(tmp_path / "warm.npz"), cfg, model)
    daemon = EngineDaemon(path, max_streams=4, address=("127.0.0.1", 0),
                          mode="fused-webrtc", device="cpu")
    server = threading.Thread(target=daemon.serve_forever, daemon=True)
    server.start()
    data = (0.2 * rng.standard_normal((2, 3, 32))).astype(np.float32)
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
            assert stats["algorithmic_latency_ms"] == 2.0
    finally:
        daemon.stop()
        server.join(RECV_TIMEOUT_S)
    assert not server.is_alive()
    hop = make_webrtc_hop(cfg, plan, "cpu")
    state = webrtc_hop_init_state(cfg, plan, 2)
    for k in range(3):
        state, out = hop(state, torch.from_numpy(data[:, k].copy()))
        # the daemon's batch of 4 slots sums in another order than 2
        np.testing.assert_allclose(got[:, k], out.numpy(), rtol=1e-5,
                                   atol=1e-5 * np.abs(out.numpy()).max())


def _cli(*argv):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    return subprocess.run([sys.executable, "-m", "audio_denoising_torch",
                           "engine", *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("device", [[], ["--device", "cpu"]])
def test_cli_refuses_the_preset_in_mode_fused_webrtc(device):
    """No preset turns warm start on: the preset alone is refused, as the
    JAX package's assertion refuses it, before any device is sought."""
    proc = _cli("--mode", "fused-webrtc", "--model", "gruunet2-dari_tult",
                "--port", "0", *device)
    assert proc.returncode != 0
    assert "griffin_lim_warm_start" in proc.stderr

"""The port's offline path against the JAX package on the CPU: the
resampler, ``pipeline.offline_denoise`` at the full width of
gruunet2-good and on every branch (the raw domain with MOMO3's delta
carry, full-clip Griffin-Lim, the SNR gate with each estimator, bounded
lookahead), ``offline_denoiser``, ``apps.offline.denoise_array`` and
``denoise_file`` (the gate they resolve, the refusals of what is not
ported), and the CLI command ``denoise`` with ``--device cpu``. The same
numpy inputs, made from a seed, go through both packages; the shipped
weights load through both hubs from the same ``.npz``."""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu.apps import offline as jax_offline
from audio_denoising_tpu.config import (
    with_snr_gate as jax_with_snr_gate,
    with_unet_geometry as jax_with_unet_geometry)
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.io.wavio import read_wav as jax_read_wav
from audio_denoising_tpu.ops.resample import resample as jax_resample
from audio_denoising_tpu.pipeline import (
    offline_denoise as jax_offline_denoise)

from audio_denoising_torch.apps import offline
from audio_denoising_torch.compat import load_params_npz, save_params_npz
from audio_denoising_torch.config import (
    Config, DSPConfig, ModelConfig, ServingConfig, with_snr_gate,
    with_unet_geometry)
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.io.wavio import read_wav, write_wav
from audio_denoising_torch.models import build_model
from audio_denoising_torch.ops.resample import resample
from audio_denoising_torch.pipeline import offline_denoise, offline_denoiser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "gruunet2-good"
OUT_ATOL = 1e-4        # offline_denoise against JAX (measured <= 3e-7)
RESAMPLE_ATOL = 1e-5   # the resampler against JAX (measured <= 5e-7)
PASS_ATOL = 2e-4       # tests/test_lookahead.py's zero-model bound
# Griffin-Lim with momentum 0.99 amplifies fp32 round-off over the clip:
# the waveform is held by SNR (measured 38.4 dB against JAX and 39.9
# against float64 at GL-4 on 1 s of dari_tult)
GL_SNR_DB = 30.0
GATED = os.path.join(REPO, "runs", "gruunet2-mrstft-50k.npz")
LA4 = os.path.join(REPO, "runs", "gruunet2mel128w64-mrstft-la4-50k.npz")
UNET4 = os.path.join(REPO, "runs", "unet4crop2s-mrstft-30k.npz")


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * math.log10((ref ** 2).sum() / max(((ref - got) ** 2).sum(),
                                                  1e-30))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _noisy_voice(smoke, seconds, sr, seed=0):
    """The vowel chip_smoke feeds the gate, under noise whose level steps
    per quarter of the clip (so the gate's estimators move)."""
    n = int(seconds * sr)
    rng = np.random.default_rng(seed)
    levels = np.repeat([0.003, 0.1, 0.01, 0.3], -(-n // 4))[:n]
    return (smoke.voiced(n, sr) + levels * rng.standard_normal(n)
            ).astype(np.float32)


def _both(spec, jax_cfg=lambda c: c, port_cfg=lambda c: c):
    jcfg, jmodel, jparams = jax_load_pretrained(spec)
    cfg, model = load_pretrained(spec)
    return (jax_cfg(jcfg), jmodel, jparams), (port_cfg(cfg), model)


def _run_both(setup, x):
    (jcfg, jmodel, jparams), (cfg, model) = setup
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(
            lambda p, a: jax_offline_denoise(jcfg, jmodel, p, a))(
                jparams, jnp.asarray(x)))
    got = offline_denoise(cfg, model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    return got, want


@pytest.fixture(scope="module")
def good():
    return _both(SPEC)


# -- the resampler ------------------------------------------------------------

@pytest.mark.parametrize("orig,new", [(44100, 48000), (48000, 16000),
                                      (16000, 48000), (48000, 48000),
                                      (22050, 16000)])
def test_resample_matches_jax(rng, orig, new):
    for length in (orig // 2 + 7, 3):
        x = rng.standard_normal((2, length)).astype(np.float32)
        want = np.asarray(jax_resample(jnp.asarray(x), orig, new))
        got = resample(torch.from_numpy(x), orig, new).numpy()
        assert got.shape == want.shape == (2, math.ceil(length * new / orig))
        assert np.abs(got - want).max() <= RESAMPLE_ATOL


def test_resample_phase_bank_and_dtype():
    """44.1 -> 48 kHz is 147 -> 160 phases of 161 taps; the output keeps
    the input's dtype (float64 for a witness run)."""
    from audio_denoising_torch.ops.resample import resample_kernel
    k, width = resample_kernel(44100, 48000)
    assert k.shape == (160, 1, 2 * width + 147) and k.shape[-1] == 161
    y = resample(torch.zeros(3, 1000, dtype=torch.float64), 44100, 48000)
    assert y.dtype == torch.float64 and y.shape == (3, 1089)


# -- offline_denoise on every branch --------------------------------------------

@pytest.mark.parametrize("seconds", [1.5, 0.3, 700 / 48000])
def test_offline_denoise_matches_jax_at_full_width(good, rng, seconds):
    """gruunet2-good at 48 kHz, n_fft 1024, hop 512, 64 mels: 1.5 s, 0.3 s
    and a clip shorter than n_fft (the reflect pad longer than the
    signal)."""
    x = (0.1 * rng.standard_normal(int(seconds * 48000))).astype(np.float32)
    got, want = _run_both(good, x)
    assert np.abs(got - want).max() <= OUT_ATOL


def test_offline_denoise_batch_matches_jax(good, rng):
    x = (0.1 * rng.standard_normal((2, 24000))).astype(np.float32)
    got, want = _run_both(good, x)
    assert np.abs(got - want).max() <= OUT_ATOL


def test_offline_denoise_matches_jax_on_momo3(rng):
    """The raw-spectrogram domain and MOMO3's delta carry (prev starts at
    the first frame, as in JAX)."""
    setup = _both("momo3-4d4ea0")
    assert setup[1][0].dsp.domain == "raw"
    x = (0.1 * rng.standard_normal(48000)).astype(np.float32)
    got, want = _run_both(setup, x)
    assert np.abs(got - want).max() <= OUT_ATOL


def _gl(n_iter):
    return lambda c: dataclasses.replace(c, dsp=dataclasses.replace(
        c.dsp, griffin_lim_iters=n_iter))


@pytest.mark.parametrize("n_iter", [0, 4])
def test_offline_griffin_lim_matches_jax_and_float64(rng, n_iter):
    """Full-clip Griffin-Lim (init 'ones', momentum 0.99) on
    gruunet2-dari_tult: with no round the output is exact; with rounds,
    held by SNR against JAX and against the same chain in float64."""
    setup = _both("gruunet2-dari_tult", _gl(n_iter), _gl(n_iter))
    cfg, model = setup[1]
    assert cfg.dsp.reconstruction == "griffin_lim"
    x = (0.1 * rng.standard_normal(48000)).astype(np.float32)
    got, want = _run_both(setup, x)
    wide = offline_denoise(cfg, model.double(),
                           torch.from_numpy(x).double())
    assert wide.dtype == torch.float64
    if n_iter == 0:
        assert np.abs(got - want).max() <= OUT_ATOL
    assert _snr(want, got) >= GL_SNR_DB
    assert _snr(wide.numpy(), got) >= GL_SNR_DB


@pytest.mark.parametrize("estimator", ["removed", "floor", "both"])
def test_offline_gate_matches_jax(smoke, estimator):
    """The unit-gain 48 kHz checkpoint with the tuned gate (1 dB, width 6)
    under each estimator: the port equals JAX, and the gate moves the
    output away from the raw model's."""
    setup = _both(GATED, lambda c: jax_with_snr_gate(c, 1.0, 6.0, estimator),
                  lambda c: with_snr_gate(c, 1.0, 6.0, estimator))
    x = _noisy_voice(smoke, 1.5, 48000)
    got, want = _run_both(setup, x)
    assert np.abs(got - want).max() <= OUT_ATOL
    cfg, model = setup[1]
    ungated = dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, snr_gate_db=None))
    raw = offline_denoise(ungated, model, torch.from_numpy(x)).numpy()
    assert np.abs(got - raw).max() > 100 * OUT_ATOL


def test_offline_lookahead_matches_jax(rng):
    """runs/...-la4: four frames of lookahead, flushed and re-aligned; the
    output keeps the input's length."""
    setup = _both(LA4)
    assert setup[1][0].model.lookahead_frames == 4
    x = (0.1 * rng.standard_normal(40000)).astype(np.float32)
    got, want = _run_both(setup, x)
    assert np.abs(got - want).max() <= OUT_ATOL


class ZeroModel:
    """The residual-zero recurrent stand-in of tests/test_lookahead.py:
    denoise == passthrough, so a misaligned lookahead shows as a large
    waveform error instead of cancelling."""

    def init_state(self, batch, dtype=torch.float32, device=None):
        return torch.zeros((batch, 4), dtype=dtype, device=device)

    def apply(self, x, hx=None):
        return torch.zeros_like(x), hx


def _raw_cfg(lookahead):
    return Config(
        dsp=DSPConfig(sample_rate=16000, n_fft=256, hop_length=128,
                      n_mels=129, domain="raw", reconstruction="phase"),
        model=ModelConfig(arch="GRUUNet2", lookahead_frames=lookahead),
        serving=ServingConfig(chunk_samples=128))


def test_offline_lookahead_zero_model_is_passthrough(rng):
    audio = (rng.standard_normal(4096) * 0.3).astype(np.float32)
    out = offline_denoise(_raw_cfg(4), ZeroModel(), torch.from_numpy(audio))
    assert out.shape == audio.shape
    np.testing.assert_allclose(out.numpy(), audio, atol=PASS_ATOL)


def test_offline_lookahead_matches_causal_on_zero_model(rng):
    audio = torch.from_numpy(
        (rng.standard_normal(4096) * 0.3).astype(np.float32))
    out0 = offline_denoise(_raw_cfg(0), ZeroModel(), audio)
    out4 = offline_denoise(_raw_cfg(4), ZeroModel(), audio)
    np.testing.assert_allclose(out4.numpy(), out0.numpy(), atol=PASS_ATOL)


def test_offline_denoiser_binds_a_device(good, rng):
    """The counterpart of jit_offline_denoiser: fn(audio) on the device
    it was built for; arrays are taken as float32; no card, no default."""
    (_, _, _), (cfg, model) = good
    fn = offline_denoiser(cfg, model, "cpu")
    x = (0.1 * rng.standard_normal((2, 20000))).astype(np.float32)
    got = fn(x)
    assert got.device.type == "cpu" and got.shape == (2, 20000)
    want = offline_denoise(cfg, model, torch.from_numpy(x))
    assert torch.equal(got, want)
    assert torch.equal(fn(x[1]), offline_denoise(cfg, model,
                                                 torch.from_numpy(x[1])))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            offline_denoiser(cfg, model)


# -- apps/offline: the chain, the file, the CLI ------------------------------------

def test_denoise_array_matches_jax(good, rng):
    """44.1 kHz stereo in: mono by mean, 147 -> 160 resample, peak norm,
    the model, de-norm; (N',) at 48 kHz out."""
    (jcfg, jmodel, jparams), (cfg, model) = good
    x = (0.2 * rng.standard_normal((2, 44100))).astype(np.float32)
    want = jax_offline.denoise_array(jcfg, jmodel, jparams, x, 44100)
    got = offline.denoise_array(cfg, model, x, 44100, device="cpu")
    assert got.shape == want.shape == (48000,) and got.dtype == np.float32
    assert np.abs(got - want).max() <= OUT_ATOL * max(1.0, np.abs(x).max())
    silent = offline.denoise_array(cfg, model, np.zeros(2000, np.float32),
                                   48000, device="cpu")
    assert np.isfinite(silent).all()


def test_denoise_file_matches_jax(tmp_path, rng):
    """A 44.1 kHz stereo 16-bit WAV through both packages' denoise_file
    (no gate argument: gruunet2-good's recommended profile, a no-op at
    output gain 3): the written WAVs agree within one LSB."""
    src = str(tmp_path / "in.wav")
    write_wav(src, (0.2 * rng.standard_normal((2, 44100))).astype(
        np.float32), 44100)
    a, b = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    offline.denoise_file(SPEC, src, a, device="cpu")
    jax_offline.denoise_file(SPEC, src, b)
    got, sr = read_wav(a)
    want, jsr = jax_read_wav(b)
    assert sr == jsr == 48000 and got.shape == want.shape == (1, 48000)
    assert np.abs(got - want).max() <= 1 / 32768 + 1e-9


def test_denoise_file_reads_other_containers(tmp_path):
    """A non-WAV input goes through AudioCache (here FLAC, pure Python)."""
    from tests.helpers_flacenc import write_flac
    t = np.arange(16000) / 16000
    raw = np.round(0.3 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int64)
    src = str(tmp_path / "in.flac")
    write_flac(src, raw, 16000)
    out = str(tmp_path / "out.wav")
    offline.denoise_file(SPEC, src, out, device="cpu")
    got, sr = read_wav(out)
    assert sr == 48000 and got.shape == (1, 48000)
    assert np.isfinite(got).all()


def _tiny_cfg(**serving_kw):
    return Config(
        dsp=DSPConfig(sample_rate=16000, n_fft=256, hop_length=128,
                      n_mels=32, domain="mel", reconstruction="phase"),
        model=ModelConfig(arch="GRUUNet2", hidden_sizes=(6, 6, 6),
                          kernel_sizes=(3, 3, 3), strides=(2, 2, 2),
                          paddings=(1, 1, 1), num_compressed_bins=4),
        serving=ServingConfig(chunk_samples=128, **serving_kw))


def _save_ckpt(tmp_path, cfg, name="m.npz"):
    torch.manual_seed(0)
    model = build_model(cfg.model, num_bins=cfg.dsp.n_mels)
    path = str(tmp_path / name)
    save_params_npz(path, {k: v.numpy() for k, v in
                           model.state_dict().items()},
                    {"full_config": json.loads(cfg.to_json())})
    return path


def test_offline_auto_gate(tmp_path, monkeypatch):
    """tests/test_gate_default.py's spy, on the port: no gate argument
    runs the recommended profile, auto_gate=False the raw model, an
    explicit gate with_snr_gate."""
    path = _save_ckpt(tmp_path, _tiny_cfg())
    wav_in = str(tmp_path / "in.wav")
    rng = np.random.default_rng(0)
    write_wav(wav_in, rng.standard_normal((1, 4000)).astype(np.float32)
              * 0.1, 16000)
    seen = {}
    real = offline.denoise_array

    def spy(cfg, model, samples, sr, **kw):
        seen["gate"] = (cfg.serving.snr_gate_db, cfg.serving.snr_gate_width_db,
                        cfg.serving.snr_gate_estimator)
        return real(cfg, model, samples, sr, **kw)

    monkeypatch.setattr(offline, "denoise_array", spy)
    offline.denoise_file(path, wav_in, str(tmp_path / "a.wav"), device="cpu")
    assert seen["gate"] == (1.0, 6.0, "both")
    offline.denoise_file(path, wav_in, str(tmp_path / "b.wav"),
                         auto_gate=False, device="cpu")
    assert seen["gate"][0] is None
    offline.denoise_file(path, wav_in, str(tmp_path / "c.wav"),
                         snr_gate_db=3.0, snr_gate_estimator="floor",
                         device="cpu")
    assert seen["gate"][0] == 3.0 and seen["gate"][2] == "floor"


def test_denoise_file_gated_matches_jax(tmp_path):
    """The tiny unit-gain checkpoint with its recommended gate, through
    both packages' denoise_file, on 16 kHz mono: within one LSB."""
    path = _save_ckpt(tmp_path, _tiny_cfg())
    src = str(tmp_path / "in.wav")
    rng = np.random.default_rng(1)
    write_wav(src, (0.1 * rng.standard_normal(8000)).astype(np.float32),
              16000)
    a, b = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    offline.denoise_file(path, src, a, device="cpu")
    jax_offline.denoise_file(path, src, b)
    got, want = read_wav(a)[0], jax_read_wav(b)[0]
    assert got.shape == want.shape == (1, 8000)
    assert np.abs(got - want).max() <= 1 / 32768 + 1e-9


# the U-Net keywords this file refused (naming ROADMAP A8) until the
# segment family was ported: each is served now, the geometry ones on the
# streamed chain, where they act, against JAX's denoise_file
@pytest.mark.parametrize("kw", [
    {"streamed": True}, {"streamed": True, "unet_seg_hops": 4},
    {"streamed": True, "unet_ctx": 256},
    {"streamed": True, "unet_xfade": 64},
    {"streamed": True, "unet_ctx_left": 128}])
def test_denoise_file_serves_the_unet_keywords(tmp_path, kw):
    """runs/unet4crop2s-mrstft-30k.npz on 0.25 s of 44.1 kHz mono (the
    streamed chain with no geometry keyword at the recommended window),
    through both packages' denoise_file: within one LSB."""
    src = str(tmp_path / "in.wav")
    rng = np.random.default_rng(2)
    write_wav(src, (0.1 * rng.standard_normal(11025)).astype(np.float32),
              44100)
    a, b = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    offline.denoise_file(UNET4, src, a, device="cpu", **kw)
    jax_offline.denoise_file(UNET4, src, b, **kw)
    got, want = read_wav(a)[0], jax_read_wav(b)[0]
    assert got.shape == want.shape == (1, 12000)
    assert np.abs(got - want).max() <= 1 / 32768 + 1e-9


# kw5 keeps its name from when a .pth spec was refused (A7): the port
# serves .pth checkpoints now (test_denoise_file_serves_a_reference_pth),
# and the case checks what the hub still refuses
@pytest.mark.parametrize("kw,item", [
    pytest.param({"spec": "model.onnx"}, "A14", id="kw5-A7")])
def test_denoise_file_refuses_what_is_not_ported(tmp_path, kw, item):
    out = tmp_path / "out.wav"
    kw = dict(kw)
    spec = kw.pop("spec", SPEC)
    with pytest.raises(NotImplementedError, match=item):
        offline.denoise_file(spec, str(tmp_path / "in.wav"), str(out),
                             device="cpu", **kw)
    assert not out.exists()


def test_denoise_chain_serves_a_stateless_model():
    """The chain on a U-Net, which it refused (naming A8) until the
    segment family was ported: stereo at 44.1 kHz through mono,
    resampling, peak normalization and the whole-clip window (and the
    streamed chain at a small geometry), against JAX's denoise_array
    within OUT_ATOL."""
    jcfg, jmodel, jparams = jax_load_pretrained(UNET4)
    cfg, model = load_pretrained(UNET4)
    rng = np.random.default_rng(3)
    x = (0.1 * rng.standard_normal((2, 8820))).astype(np.float32)
    got = offline.denoise_chain(cfg, model, torch.from_numpy(x), 44100)
    want = jax_offline.denoise_array(jcfg, jmodel, jparams, x, 44100)
    assert got.shape == (9600,)
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_ATOL, rtol=0)
    cfg, jcfg = (g(c, seg_hops=2, ctx=384, xfade=192, ctx_left=768)
                 for g, c in ((with_unet_geometry, cfg),
                              (jax_with_unet_geometry, jcfg)))
    got = offline.denoise_chain(cfg, model, torch.from_numpy(x), 44100,
                                streamed=True)
    want = jax_offline.denoise_array(jcfg, jmodel, jparams, x, 44100,
                                     streamed=True)
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_ATOL, rtol=0)


def test_chain_refuses_tf32_matmuls(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        offline._check_fp32(torch.device("cuda"))
    offline._check_fp32(torch.device("cpu"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_denoise_file_without_a_card_writes_nothing(tmp_path):
    src = str(tmp_path / "in.wav")
    write_wav(src, np.zeros(4000, np.float32), 16000)
    out = tmp_path / "out.wav"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offline.denoise_file(SPEC, src, str(out))
    assert not out.exists()


def _cli(*argv, **env):
    env = {**{k: v for k, v in os.environ.items()
              if not k.startswith(("JAX", "XLA"))}, **env}
    return subprocess.run([sys.executable, "-m", "audio_denoising_torch",
                           "denoise", *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_device_cpu_matches_denoise_file(tmp_path, rng):
    src = str(tmp_path / "in.wav")
    write_wav(src, (0.2 * rng.standard_normal((2, 22050))).astype(
        np.float32), 44100)
    out = str(tmp_path / "cli.wav")
    proc = _cli(src, out, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert f"wrote {out}" in proc.stdout
    ref = str(tmp_path / "ref.wav")
    offline.denoise_file(SPEC, src, ref, device="cpu")
    got, sr = read_wav(out)
    assert sr == 48000 and got.shape == (1, 24000)
    np.testing.assert_array_equal(got, read_wav(ref)[0])


# the flags this command refused (naming A8) until the segment family was
# ported, served in a subprocess against JAX's denoise_file
@pytest.mark.parametrize("flags", [["--streamed"],
                                   ["--streamed", "--unet-ctx", "64"]])
def test_cli_serves_the_streamed_flags(tmp_path, flags):
    """``denoise in.wav out.wav --model <unet4crop2s> --device cpu`` with
    ``--streamed`` (the recommended window) and with ``--unet-ctx 64``
    (the class defaults but the context): the 48 kHz WAV within one LSB
    of JAX's."""
    src = str(tmp_path / "in.wav")
    rng = np.random.default_rng(4)
    write_wav(src, (0.1 * rng.standard_normal(12000)).astype(np.float32),
              48000)
    out, ref = str(tmp_path / "cli.wav"), str(tmp_path / "jax.wav")
    proc = _cli(src, out, "--device", "cpu", "--model", UNET4, *flags)
    assert proc.returncode == 0, proc.stderr
    kw = {"unet_ctx": 64} if "--unet-ctx" in flags else {}
    jax_offline.denoise_file(UNET4, src, ref, streamed=True, **kw)
    got, want = read_wav(out)[0], jax_read_wav(ref)[0]
    assert got.shape == want.shape == (1, 12000)
    assert np.abs(got - want).max() <= 1 / 32768 + 1e-9


# flags2 keeps its name from when a .pth model was refused (A7); the
# case now checks the .onnx model the port still refuses
@pytest.mark.parametrize("flags,item", [
    pytest.param(["--model", "x.onnx"], "A14", id="flags2-A7")])
def test_cli_refuses_what_is_not_ported(tmp_path, flags, item):
    out = tmp_path / "out.wav"
    proc = _cli(str(tmp_path / "in.wav"), str(out), "--device", "cpu",
                *flags)
    assert proc.returncode == 2
    assert item in proc.stderr
    assert not out.exists()


def _reference_pth(tmp_path):
    """gruunet2-good's weights as a reference checkpoint.pth."""
    from collections import OrderedDict
    params, meta = load_params_npz(os.path.join(REPO, "checkpoints",
                                                "gruunet2-good.npz"))
    path = str(tmp_path / "checkpoint.pth")
    torch.save({"arch": meta["arch"], "config": meta["config"],
                "model_state_dict": OrderedDict(
                    (k, torch.from_numpy(v.copy()))
                    for k, v in params.items())}, path)
    return path


def test_denoise_file_serves_a_reference_pth(tmp_path):
    """A .pth spec is served as the JAX command serves it: the hub's
    assumed socket-path DSP at 48 kHz, the same WAV within one LSB."""
    pth = _reference_pth(tmp_path)
    src = str(tmp_path / "in.wav")
    write_wav(src, (0.2 * np.random.default_rng(5).standard_normal(
        (1, 12000))).astype(np.float32), 48000)
    a, b = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    offline.denoise_file(pth, src, a, device="cpu")
    jax_offline.denoise_file(pth, src, b)
    got, want = read_wav(a)[0], jax_read_wav(b)[0]
    assert got.shape == want.shape == (1, 12000)
    assert np.abs(got - want).max() <= 1 / 32768 + 1e-9


def test_cli_denoise_takes_a_reference_pth(tmp_path):
    pth = _reference_pth(tmp_path)
    src, out = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    write_wav(src, np.zeros((1, 4800), np.float32), 48000)
    proc = _cli(src, out, "--device", "cpu", "--model", pth)
    assert proc.returncode == 0, proc.stderr
    assert "no DSP config embedded" in proc.stderr
    got, sr = read_wav(out)
    assert sr == 48000 and got.shape == (1, 4800)

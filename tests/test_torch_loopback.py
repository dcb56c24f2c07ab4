"""The port's ``loopback`` command (``apps/loopback.py``) against JAX's on
the CPU, headless: a stand-in ``sounddevice`` module (JAX's pattern,
tests/test_loopback.py) records the duplex stream's callback, and its
``sleep`` drives the callback with the same seeded mic frames for both
packages. The port runs its fast step with ``--torch-device cpu``; on the
card, chip_smoke.py phase 59 drives the same main."""

import json
import sys
import types

import numpy as np
import pytest
import jax

from audio_denoising_tpu.apps import loopback as jax_loopback
from audio_denoising_tpu.compat.npz_store import save_params_npz
from audio_denoising_tpu.config import (
    Config, DSPConfig, ModelConfig, ServingConfig)
from audio_denoising_tpu.models import build_model

from audio_denoising_torch.apps import loopback

OUT_ATOL = 2e-4   # tests/test_torch_fast.py's bound on a hop's output
FRAMES = 8


def _tiny_ckpt(tmp_path):
    """tests/test_loopback.py's tiny GRUUNet2 at 16 kHz, hop 128."""
    cfg = Config(
        dsp=DSPConfig(sample_rate=16000, n_fft=256, hop_length=128,
                      n_mels=32, domain="mel", reconstruction="phase"),
        model=ModelConfig(arch="GRUUNet2", hidden_sizes=(6, 6, 6),
                          kernel_sizes=(3, 3, 3), strides=(2, 2, 2),
                          paddings=(1, 1, 1), num_compressed_bins=4),
        serving=ServingConfig(chunk_samples=128),
    )
    model = build_model(cfg.model, num_bins=cfg.dsp.n_mels)
    params = {k: np.asarray(v)
              for k, v in model.init(jax.random.PRNGKey(0)).items()}
    path = str(tmp_path / "tiny.npz")
    save_params_npz(path, params,
                    {"full_config": json.loads(cfg.to_json())})
    return path


class _FakeSounddevice(types.ModuleType):
    """Records the duplex stream's callback; ``sleep`` fires it once per
    10 ms asked for, with a seeded tone-plus-noise mic frame, and keeps
    every frame fed and written."""

    def __init__(self, seed=7):
        super().__init__("sounddevice")
        self.captured, self.fed = [], []
        self.stream_kw = None
        self._cb = None
        self._rng = np.random.default_rng(seed)
        self._t = 0
        outer = self

        class Stream:
            def __init__(self, samplerate, blocksize, channels, dtype,
                         callback, device=None):
                outer.stream_kw = dict(samplerate=samplerate,
                                       blocksize=blocksize,
                                       channels=channels, dtype=dtype,
                                       device=device)
                outer._cb = callback

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                outer._cb = None
                return False

        self.Stream = Stream

    def frame(self, bs):
        tone = 0.3 * np.sin(
            2 * np.pi * 440.0 * (self._t + np.arange(bs)) / 16000.0)
        self._t += bs
        return (tone + 0.05 * self._rng.standard_normal(bs)).astype(
            np.float32)

    def sleep(self, ms):
        assert self._cb is not None, "sleep() outside an open Stream"
        for _ in range(max(1, int(ms) // 10)):
            bs, n = self.stream_kw["blocksize"], self.stream_kw["channels"]
            indata = self.frame(bs)[:, None].repeat(n, axis=1)
            outdata = np.zeros((bs, n), np.float32)
            self._cb(indata, outdata, bs, None, None)
            self.fed.append(indata[:, 0].copy())
            self.captured.append(outdata[:, 0].copy())


def _run(main, argv, monkeypatch, fake=None):
    fake = fake or _FakeSounddevice()
    monkeypatch.setitem(sys.modules, "sounddevice", fake)
    assert main(argv) == 0
    return fake


def test_loopback_denoise_matches_jax(tmp_path, monkeypatch):
    """FRAMES callbacks of the port's fast step (state carried across
    callbacks) against JAX's on the same mic frames: the device clocked
    at the model's rate and hop, each written frame within OUT_ATOL."""
    ckpt = _tiny_ckpt(tmp_path)
    argv = ["--model", ckpt, "--seconds", f"{FRAMES / 100}", "--gain",
            "1.0"]
    want = _run(jax_loopback.main, argv, monkeypatch)
    got = _run(loopback.main, argv + ["--torch-device", "cpu"], monkeypatch)
    assert got.stream_kw == want.stream_kw
    assert got.stream_kw["samplerate"] == 16000
    assert got.stream_kw["blocksize"] == 128
    assert len(got.captured) == len(want.captured) == FRAMES
    for a, b in zip(got.fed, want.fed):
        np.testing.assert_array_equal(a, b)
    for out, ref in zip(got.captured, want.captured):
        assert out.dtype == np.float32 and np.all(np.abs(out) <= 1.0)
        np.testing.assert_allclose(out, ref, atol=OUT_ATOL)
    # the denoiser is in the path: after the OLA warmup the output is not
    # the mic frame
    assert not np.allclose(got.captured[-1], got.fed[-1], atol=1e-4)


def test_loopback_state_carries_across_frames(tmp_path, monkeypatch):
    """The same mic frame at every callback gives different outputs, as
    in JAX: the fast step's ring, OLA buffer and hx advance; each
    written frame equals JAX's within OUT_ATOL. The frame is broadband
    (JAX's test repeats a constant 0.25, whose spectrum is rounding noise
    off DC: the noisy phase resynthesis then reads those bins' phases,
    which any two FFTs give differently)."""
    ckpt = _tiny_ckpt(tmp_path)
    argv = ["--model", ckpt, "--seconds", "0.04", "--gain", "1.0"]
    still = (0.2 * np.random.default_rng(11).standard_normal(128)).astype(
        np.float32)
    fakes = []
    for main, extra in ((jax_loopback.main, []),
                        (loopback.main, ["--torch-device", "cpu"])):
        fake = _FakeSounddevice()
        fake.frame = lambda bs: still
        fakes.append(_run(main, argv + extra, monkeypatch, fake))
    want, got = fakes
    assert len(got.captured) == 4
    assert not np.allclose(got.captured[0], got.captured[1])
    assert not np.allclose(got.captured[1], got.captured[2])
    for out, ref in zip(got.captured, want.captured):
        np.testing.assert_allclose(out, ref, atol=OUT_ATOL)


def test_loopback_no_denoise_is_the_reference_passthrough(monkeypatch):
    """``--no-denoise``: the reference's device clock (48 kHz, 768-sample
    blocks) and x2 gain, exactly JAX's frames, and no torch device asked
    for (it runs without a card)."""
    argv = ["--no-denoise", "--seconds", "0.03"]
    want = _run(jax_loopback.main, argv, monkeypatch)
    got = _run(loopback.main, argv, monkeypatch)
    assert got.stream_kw == want.stream_kw
    assert got.stream_kw["samplerate"] == 48000
    assert got.stream_kw["blocksize"] == 768
    for out, ref, mic in zip(got.captured, want.captured, got.fed):
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, np.clip(mic * 2.0, -1.0, 1.0))


def test_loopback_without_a_card_asks_for_the_cpu(tmp_path, monkeypatch):
    """The denoising path runs on the card unless ``--torch-device cpu``:
    without a card it raises before opening the stream."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    fake = _FakeSounddevice()
    monkeypatch.setitem(sys.modules, "sounddevice", fake)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loopback.main(["--model", _tiny_ckpt(tmp_path), "--seconds",
                       "0.01"])
    assert fake.stream_kw is None


def test_loopback_errors_without_sounddevice(monkeypatch):
    """Both commands refuse to run without the sounddevice package."""
    monkeypatch.setattr(jax_loopback, "sounddevice_available",
                        lambda: False)
    monkeypatch.setattr(loopback, "playback_available", lambda: False)
    for mod in (jax_loopback, loopback):
        with pytest.raises(SystemExit) as e:
            mod.main(["--no-denoise", "--seconds", "0.001"])
        assert e.value.code == 2


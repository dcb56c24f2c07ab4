"""The port's training data (train/data.py, train/device_data.py), U-Net
training dropout and distillation targets (train/distill.py) against the
JAX package on the CPU.

``MixtureSampler`` draws from numpy as JAX's does, so the two give the
same batches bit for bit from one seed and corpus (synthetic noise, WAV
noise resampled to the clean rate, files shorter than a crop). The device
sampler's synthesis is fed the draws JAX's ``make_device_sampler`` makes
from its key (``jax.random`` cannot be replayed by torch generators):
uniform gains, the SNR curriculum with its clamp, real noise crops and
``identity_prob``. Then the JAX tests of the device sampler and of
distillation, case for case, on the port. Corpora are WAVs made with
numpy from a seed in a temporary directory."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu.train.data import MixtureSampler as JaxSampler
from audio_denoising_tpu.train.device_data import (
    DeviceCorpus as JaxCorpus, make_device_sampler as jax_device_sampler)
from audio_denoising_tpu.train.distill import load_teacher as jax_teacher

from audio_denoising_torch.config import (
    Config, DSPConfig, ModelConfig, PRESETS, TrainConfig)
from audio_denoising_torch.io.wavio import write_wav
from audio_denoising_torch.models import build_model
from audio_denoising_torch.train import MixtureSampler
from audio_denoising_torch.train.context import TrainingContext
from audio_denoising_torch.train.device_data import (
    DeviceCorpus, Draws, make_device_sampler, synthesize)
from audio_denoising_torch.train.distill import load_teacher


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small tensors: one intra-op thread each, so workers running side
    by side do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER = os.path.join(REPO, "runs", "unet4crop2s-mrstft-30k.npz")
SYNTH_ATOL = 1e-6    # device synthesis vs JAX on JAX's draws (|x| <= 1;
                     # the synthetic noise's cumsum sums in its own order)
RESAMPLE_ATOL = 1e-5  # the corpus resampled on upload vs JAX's
TEACHER_TOL = dict(rtol=1e-3, atol=1e-4)   # the teacher's denoised wave
                     # vs JAX's: below 0.2 in the middle, tens in the
                     # last frames, where the U-Net's residual at the
                     # crop's edge passes through expm1 unnormalized


def _voiced(n, sr, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    sig = 0.2 * sig * (1 + 0.8 * np.sin(2 * np.pi * 2.5 * t))
    return (sig + 1e-3 * rng.standard_normal(n)).astype(np.float32)


def _corpus(tmp_path, sr=8000, noise_sr=None, lengths=(12000, 9000, 700)):
    """Clean WAVs of ``lengths`` samples (the last shorter than a crop)
    and, with ``noise_sr``, two noise WAVs at that rate."""
    d = tmp_path / "corpus"
    d.mkdir()
    clean = []
    for i, n in enumerate(lengths):
        p = str(d / f"c{i}.wav")
        write_wav(p, _voiced(n, sr, 110 + 40 * i, i), sr)
        clean.append(p)
    noise = []
    if noise_sr:
        (d / "noise").mkdir()
        rng = np.random.default_rng(9)
        for i in range(2):
            p = str(d / "noise" / f"n{i}.wav")
            write_wav(p, (0.3 * rng.standard_normal(noise_sr)).astype(
                np.float32), noise_sr)
            noise.append(p)
    return clean, noise


@pytest.mark.parametrize("noise_sr", [None, 8000, 16000])
def test_mixture_sampler_bit_for_bit(tmp_path, noise_sr):
    clean, noise = _corpus(tmp_path, noise_sr=noise_sr)
    kw = dict(crop_samples=1024, batch_size=6, noise_gain=(0.3, 0.9),
              seed=5, sample_rate=8000)
    ours, theirs = MixtureSampler(clean, noise, **kw), \
        JaxSampler(clean, noise, **kw)
    for _ in range(3):
        for a, b in zip(ours.sample(), theirs.sample()):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def _buffers(rng, n=30000, n_noise=20000):
    buf = np.clip(0.4 * rng.standard_normal(n), -1, 1).astype(np.float32)
    nbuf = np.clip(0.3 * rng.standard_normal(n_noise), -1,
                   1).astype(np.float32)
    return buf, nbuf


def _jax_draws(key, batch, crop, n, n_noise, level, identity_prob):
    """The draws JAX's sampler makes from ``key`` (device_data.py:118-
    160), as the port's ``Draws``."""
    k_pos, k_noise, k_gain = jax.random.split(key, 3)
    starts = jax.random.randint(k_pos, (batch,), 0, n - crop)
    nstarts = white = None
    if n_noise:
        nstarts = torch.from_numpy(np.asarray(jax.random.randint(
            k_noise, (batch,), 0, n_noise - crop)).astype(np.int64))
    else:
        white = torch.from_numpy(np.array(
            jax.random.normal(k_noise, (batch, crop))))
    lvl = jax.random.uniform(k_gain, (batch, 1), minval=level[0],
                             maxval=level[1])
    keep = None
    if identity_prob > 0:
        keep = torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.fold_in(key, 3), 1.0 - identity_prob, (batch, 1))))
    return Draws(torch.from_numpy(np.asarray(starts).astype(np.int64)),
                 nstarts, white, torch.from_numpy(np.array(lvl)), keep)


@pytest.mark.parametrize("noise,snr,identity", [
    (False, None, 0.0), (True, None, 0.0), (False, (-10.0, 15.0), 0.0),
    (True, (-10.0, 15.0), 0.5)])
def test_device_synthesis_from_jax_draws(noise, snr, identity):
    rng = np.random.default_rng(3)
    buf, nbuf = _buffers(rng)
    crop, batch, gain = 2000, 16, (0.2, 1.0)
    j_noise = JaxCorpus(jnp.asarray(nbuf), 48000) if noise else None
    sample = jax.jit(jax_device_sampler(
        JaxCorpus(jnp.asarray(buf), 48000), crop, batch, noise_gain=gain,
        noise_corpus=j_noise, snr_range_db=snr, identity_prob=identity))
    key = jax.random.PRNGKey(11)
    args = (jnp.asarray(buf),) + ((jnp.asarray(nbuf),) if noise else ())
    m_j, c_j = sample(key, *args)
    draws = _jax_draws(key, batch, crop, len(buf), len(nbuf) if noise else 0,
                       snr or gain, identity)
    m, c = synthesize(draws, torch.from_numpy(buf),
                      torch.from_numpy(nbuf) if noise else None, crop, snr)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=0,
                               atol=SYNTH_ATOL)
    if identity:
        same = [torch.equal(m[i], c[i]) for i in range(batch)]
        assert sum(same) == int((~draws.keep).sum()) > 0


def test_device_corpus_resamples_like_jax(tmp_path):
    clean, _ = _corpus(tmp_path, sr=16000, lengths=(6000, 5000))
    extra = str(tmp_path / "c48.wav")
    write_wav(extra, _voiced(9000, 48000, 200, 7), 48000)
    paths = clean + [extra]
    ours = DeviceCorpus.from_paths(paths, 48000, device="cpu")
    theirs = JaxCorpus.from_paths(paths, 48000)
    assert len(ours) == len(theirs)
    np.testing.assert_allclose(ours.buffer.numpy(),
                               np.asarray(theirs.buffer), rtol=0,
                               atol=RESAMPLE_ATOL)


# -- the JAX package's device-sampler tests, case for case ------------------

def _sampler(buf, crop, batch, nbuf=None, **kw):
    return make_device_sampler(
        DeviceCorpus(torch.from_numpy(np.float32(buf)), 48000), crop, batch,
        noise_corpus=None if nbuf is None else DeviceCorpus(
            torch.from_numpy(np.float32(nbuf)), 48000), **kw)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


class TestDeviceResidentTraining:
    def test_device_sampler_shapes_and_clip(self, rng):
        buf = (0.5 * rng.standard_normal(10000)).astype(np.float32)
        m, c = _sampler(buf, 2000, 4)(_gen(0))
        assert m.shape == c.shape == (4, 2000)
        assert float(m.abs().max()) <= 1.0
        c0 = c[0].numpy()
        assert any(np.array_equal(buf[s:s + 2000], c0) for s in range(8000))

    def test_identity_prob_mixes_clean_examples(self, rng):
        buf = np.clip(0.5 * rng.standard_normal(50000), -1, 1)
        nbuf = np.clip(0.3 * rng.standard_normal(40000), -1, 1)
        m, c = _sampler(buf, 2000, 64, nbuf, snr_range_db=(-10.0, 15.0),
                        identity_prob=0.5)(_gen(1))
        same = np.array([torch.equal(m[i], c[i]) for i in range(64)])
        assert 16 <= same.sum() <= 48
        m0, c0 = _sampler(buf, 2000, 64, nbuf,
                          snr_range_db=(-10.0, 15.0))(_gen(1))
        assert not any(torch.equal(m0[i], c0[i]) for i in range(64))

    def test_same_generator_seed_same_batch(self, rng):
        buf = (0.5 * rng.standard_normal(10000)).astype(np.float32)
        s = _sampler(buf, 2000, 4)
        for a, b in zip(s(_gen(2)), s(_gen(2))):
            assert torch.equal(a, b)

    def test_fit_on_device_learns(self):
        cfg = PRESETS["gruunet2-dari_tult"]
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=4, crop_samples=12000))
        model = build_model(cfg.model, num_bins=cfg.dsp.n_mels)
        ctx = TrainingContext(cfg, model, seed=0, device="cpu")
        t = np.arange(60000) / 48000.0
        tone = (0.4 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
        rec = ctx.fit_on_device(DeviceCorpus(torch.from_numpy(tone), 48000),
                                iters=20, steps_per_dispatch=5)
        losses = [rec[k] for k in sorted(rec)]
        assert losses[-1] < losses[0]
        assert ctx.total_iters == 20 and ctx.state.step == 20


class TestDeviceRealNoise:
    def test_device_sampler_real_noise_crops(self, rng):
        buf = 0.4 * rng.standard_normal(10000)
        nbuf = np.tile(np.float32([0.25]), 8000)
        m, c = _sampler(buf, 2000, 4, nbuf, noise_gain=(1.0, 1.0))(_gen(0))
        diff = (m - c).numpy()
        inside = np.abs(c.numpy()) < 0.7
        np.testing.assert_allclose(diff[inside], 0.25, atol=1e-6)


class TestSNRCurriculum:
    def test_snr_targeted_gains(self, rng):
        buf = 0.3 * np.sin(np.arange(60000) / 8.0)
        nbuf = 0.2 * rng.standard_normal(50000)
        m, c = _sampler(buf, 4000, 16, nbuf, snr_range_db=(5.0, 5.0))(
            _gen(1))
        n = (m - c).numpy()
        snr = 10 * np.log10(np.mean(c.numpy() ** 2, -1) / np.mean(n ** 2, -1))
        assert np.all(np.abs(snr - 5.0) < 0.7), snr

    def test_snr_range_spreads(self, rng):
        buf = 0.3 * np.sin(np.arange(60000) / 8.0)
        nbuf = 0.2 * rng.standard_normal(50000)
        m, c = _sampler(buf, 4000, 32, nbuf, snr_range_db=(-10.0, 15.0))(
            _gen(2))
        n = (m - c).numpy()
        snr = 10 * np.log10(np.mean(c.numpy() ** 2, -1) / np.mean(n ** 2, -1))
        assert snr.min() < -4 and snr.max() > 9

    def test_gain_clamp(self):
        """A silent clean crop still gets the 0.02 gain floor; a quiet
        noise crop under a loud clean one stops at 6."""
        buf = np.zeros(8000)
        nbuf = np.full(8000, 0.1)
        m, c = _sampler(buf, 1000, 2, nbuf, snr_range_db=(0.0, 0.0))(_gen(0))
        np.testing.assert_allclose((m - c).numpy(), 0.02 * 0.1, rtol=1e-5)
        buf = np.full(8000, 0.5)
        nbuf = np.full(8000, 1e-4)
        m, c = _sampler(buf, 1000, 2, nbuf, snr_range_db=(0.0, 0.0))(_gen(0))
        np.testing.assert_allclose((m - c).numpy(), 6.0 * 1e-4, rtol=1e-3)


# -- training dropout ---------------------------------------------------------

class TestDropout:
    def _unet(self):
        cfg = PRESETS["unet4-raw480"]
        return build_model(cfg.model, num_bins=cfg.dsp.n_stft)

    def test_keep_rate_and_scaling(self):
        """Each block keeps an element with probability 1 - p and scales
        the kept ones by 1 / (1 - p): dcl_1's output against the same
        block without dropout."""
        from audio_denoising_torch.models import unet2d
        model = self._unet()
        t = model.compatible_frames(40)
        x = torch.rand(2, 241, t)
        outs = {}
        real = unet2d.prelu

        def spy(h, a):
            y = real(h, a)
            outs.setdefault("clean", y)
            return y
        unet2d.prelu = spy
        try:
            model.apply(x)
            clean = outs.pop("clean")
            p = 0.3
            model.apply(x, _gen(4), p)
        finally:
            unet2d.prelu = real
        # the first drop applies to dcl_1's PReLU output: recompute it
        gen = _gen(4)
        mask = torch.rand(clean.shape, generator=gen) < 1 - p
        kept = mask.float().mean().item()
        assert abs(kept - (1 - p)) < 0.01
        layers = model.dcl_1.layers
        h = unet2d.conv2d(torch.cat([x[:, None], model.smear[None, :, :, None]
                                     .expand(2, -1, -1, t)], dim=1),
                          layers[0].weight, layers[0].bias, stride=2,
                          padding=1)
        h = unet2d.prelu(unet2d.instance_norm_2d(h), layers[-1].weight)
        dropped = torch.where(mask, h / (1 - p), torch.zeros_like(h))
        np.testing.assert_allclose(dropped.detach().numpy(),
                                   (clean * mask / (1 - p)).detach().numpy(),
                                   rtol=1e-6, atol=1e-6)

    def test_identity_without_generator(self):
        model = self._unet()
        x = torch.rand(1, 241, model.compatible_frames(40))
        assert torch.equal(model.apply(x), model.apply(x, None, 0.5))
        assert not torch.equal(model.apply(x), model.apply(x, _gen(0), 0.5))

    def test_replay_at_the_same_step(self):
        """The mask is a function of (train seed, step): two contexts, and
        a context resumed from a checkpoint, draw the same mask at the
        same step and another at the next."""
        cfg = PRESETS["unet4-raw480"]
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, dropout=0.2),
            train=dataclasses.replace(cfg.train, batch_size=1,
                                      crop_samples=4800))
        model = build_model(cfg.model, num_bins=241)
        a = TrainingContext(cfg, model, seed=1, device="cpu")
        b = TrainingContext(cfg, model, seed=1, device="cpu")
        rng = np.random.default_rng(0)
        mix = (0.2 * rng.standard_normal((1, 4800))).astype(np.float32)
        clean = 0.5 * mix
        la, _ = a.loss_and_grads(mix, clean)
        lb, _ = b.loss_and_grads(mix, clean)
        assert float(la) == float(lb)
        b.state.step = 1
        assert float(b.loss_and_grads(mix, clean)[0]) != float(la)
        r1 = torch.rand(3, generator=a.dropout_generator(7))
        r2 = torch.rand(3, generator=b.dropout_generator(7))
        assert torch.equal(r1, r2)
        no_drop = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dropout=0.0))
        c = TrainingContext(no_drop, model, seed=1, device="cpu")
        assert c.dropout_generator(0) is None


# -- distillation (the JAX package's tests/test_distill.py) -------------------

def _student_cfg(teacher_path, crop=6000):
    return Config(
        dsp=DSPConfig(sample_rate=48000, n_fft=256, hop_length=128,
                      n_mels=32, domain="mel", reconstruction="phase"),
        model=ModelConfig(arch="GRUUNet2", hidden_sizes=(6, 6, 6),
                          kernel_sizes=(3, 3, 3), strides=(2, 2, 2),
                          paddings=(1, 1, 1), num_compressed_bins=4),
        train=TrainConfig(batch_size=2, crop_samples=crop,
                          objective="recon_mrstft",
                          distill_from=teacher_path))


def _wave(batch=2, n=6000, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([_voiced(n, 48000, 150 + 30 * i, seed + i)
                     + (0.1 * rng.standard_normal(n)).astype(np.float32)
                     for i in range(batch)])


def test_teacher_target_matches_jax():
    """The distillation target: the teacher's gate-off offline chain on
    the mixture, against JAX's teacher on the same checkpoint."""
    wave = _wave()
    fn = load_teacher(TEACHER, _student_cfg(TEACHER), device="cpu")
    tp, jfn = jax_teacher(TEACHER, _student_cfg(TEACHER))
    out = fn(torch.from_numpy(wave))
    assert not out.requires_grad and out.shape == wave.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jfn(tp, jnp.asarray(wave))), **TEACHER_TOL)


def test_distill_changes_the_objective_host_path():
    cfg_d = _student_cfg(TEACHER)
    cfg_0 = dataclasses.replace(cfg_d, train=dataclasses.replace(
        cfg_d.train, distill_from=None))
    model = build_model(cfg_d.model, num_bins=cfg_d.dsp.n_mels)
    mixture = _wave()
    l_d = TrainingContext(cfg_d, model, device="cpu").train_step(
        mixture, mixture * 0.5)
    l_0 = TrainingContext(cfg_0, model, device="cpu").train_step(
        mixture, mixture * 0.5)
    assert np.isfinite(l_d) and np.isfinite(l_0) and abs(l_d - l_0) > 1e-9


def test_distill_device_path():
    cfg_d = _student_cfg(TEACHER)
    cfg_0 = dataclasses.replace(cfg_d, train=dataclasses.replace(
        cfg_d.train, distill_from=None))
    model = build_model(cfg_d.model, num_bins=cfg_d.dsp.n_mels)
    corpus = DeviceCorpus(torch.from_numpy(_wave(1, 30000)[0]), 48000)
    rec_d = TrainingContext(cfg_d, model, device="cpu").fit_on_device(
        corpus, iters=2, steps_per_dispatch=2, seed=7)
    rec_0 = TrainingContext(cfg_0, model, device="cpu").fit_on_device(
        corpus, iters=2, steps_per_dispatch=2, seed=7)
    assert all(np.isfinite(v) for v in rec_d.values())
    assert abs(rec_d[1] - rec_0[1]) > 1e-9


def test_distill_from_round_trips_checkpoint(tmp_path):
    from audio_denoising_torch.hub import load_pretrained
    cfg = _student_cfg(TEACHER)
    model = build_model(cfg.model, num_bins=cfg.dsp.n_mels)
    ctx = TrainingContext(cfg, model, device="cpu")
    mixture = _wave()
    ctx.train_step(mixture, mixture * 0.5)
    out = str(tmp_path / "student.npz")
    ctx.save(out)
    cfg2, model2 = load_pretrained(out)
    assert cfg2.train.distill_from == TEACHER
    assert TrainingContext.load(out, cfg2, model2,
                                device="cpu")._teacher is not None


def test_distill_rate_mismatch_raises():
    cfg = _student_cfg(TEACHER)
    cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, sample_rate=16000))
    with pytest.raises(ValueError, match="Hz"):
        TrainingContext(cfg, build_model(cfg.model, num_bins=32),
                        device="cpu")

"""The port's losses and quality metrics (train/losses.py,
train/eval_metrics.py) and its evaluation surface (apps/evaluate.py,
apps/compare.py, the ``eval`` and ``compare`` commands) against the JAX
package on the CPU: values and gradients (``jax.grad`` against
autograd), ``build_manifest_set`` bit for bit, ``evaluate`` and
``evaluate_manifest`` on gruunet2-good, ``paired_report``; then the JAX
package's tests/test_eval.py, case for case, on the port. Corpora are
WAVs made with numpy from a seed in a temporary directory."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu.apps import compare as jax_compare
from audio_denoising_tpu.apps import evaluate as jax_evaluate
from audio_denoising_tpu.train import eval_metrics as jax_metrics
from audio_denoising_tpu.train import losses as jax_losses

from audio_denoising_torch.apps import compare, evaluate
from audio_denoising_torch.io.wavio import write_wav
from audio_denoising_torch.train import eval_metrics, losses


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small tensors: one intra-op thread each, so workers running side
    by side do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALUE_RTOL = 1e-5    # a loss or metric against JAX's (float32)
GRAD_RTOL = 1e-4     # its gradient, relative to the largest element
# the L1 of log magnitudes: where |E| and |R| of a bin tie within
# float32 round-off, the term's sign, so its gradient, is round-off's
# (measured up to 1.5e-3, at the clip's reflect-padded edges)
GRAD_RTOL_L1LOG = 5e-3
REPORT_DB = 2e-3     # report entries (rounded to 1e-3 dB) vs JAX's
REPORT_LSD = 2e-3    # LSD entries: a tone corpus has round-off magnitudes
                     # between its harmonics, which log(|.| + 1e-5)
                     # turns into ~3e-4 of LSD; manifest means are
                     # rounded to 1e-3
PER_EXAMPLE_DB = 1e-3   # per-example metrics of the same mixtures
PER_EXAMPLE_LSD = 4e-3  # per-example LSD of a tone corpus (measured
                        # 1.8e-3 of about 4.5, the harmonics' round-off
                        # bins again)
RES = ((256, 64), (512, 128))


def _pair(seed=0, n=4096, scale=0.3):
    rng = np.random.default_rng(seed)
    a = (scale * rng.standard_normal((2, n))).astype(np.float32)
    b = (a + 0.2 * scale * rng.standard_normal((2, n))).astype(np.float32)
    return a, b


FUNCS = {
    "mse": (losses.mse, jax_losses.mse),
    "mae": (losses.mae, jax_losses.mae),
    "multi_res_stft": (lambda e, r: losses.multi_res_stft(e, r, RES),
                       lambda e, r: jax_losses.multi_res_stft(e, r, RES)),
    "multi_res_stft_default": (losses.multi_res_stft,
                               jax_losses.multi_res_stft),
    "snr_db": (lambda e, r: eval_metrics.snr_db(r, e).mean(),
               lambda e, r: jax_metrics.snr_db(r, e).mean()),
    "si_sdr_db": (lambda e, r: eval_metrics.si_sdr_db(r, e).mean(),
                  lambda e, r: jax_metrics.si_sdr_db(r, e).mean()),
    "log_spectral_distance": (
        lambda e, r: eval_metrics.log_spectral_distance(r, e).mean(),
        lambda e, r: jax_metrics.log_spectral_distance(r, e).mean()),
}


@pytest.mark.parametrize("name", list(FUNCS))
def test_value_and_gradient_match_jax(name):
    ours, theirs = FUNCS[name]
    ref, est = _pair()
    e = torch.from_numpy(est).requires_grad_(True)
    v = ours(e, torch.from_numpy(ref))
    (g,) = torch.autograd.grad(v, [e])
    vj, gj = jax.value_and_grad(lambda x: theirs(x, jnp.asarray(ref)))(
        jnp.asarray(est))
    assert float(v.detach()) == pytest.approx(float(vj), rel=VALUE_RTOL)
    gj = np.asarray(gj)
    rtol = GRAD_RTOL_L1LOG if name.startswith("multi_res") else GRAD_RTOL
    assert np.abs(g.numpy() - gj).max() <= rtol * np.abs(gj).max()


def test_spectral_parts_match_jax():
    ref, est = _pair(1)
    r, e = np.abs(ref[..., :1200]).reshape(2, 30, 40), \
        np.abs(est[..., :1200]).reshape(2, 30, 40)
    for ours, theirs in ((losses.spectral_convergence,
                          jax_losses.spectral_convergence),
                         (losses.log_mag_l1, jax_losses.log_mag_l1)):
        assert float(ours(torch.from_numpy(e), torch.from_numpy(r))) == \
            pytest.approx(float(theirs(jnp.asarray(e), jnp.asarray(r))),
                          rel=VALUE_RTOL)
    assert losses.DEFAULT_RESOLUTIONS == jax_losses.DEFAULT_RESOLUTIONS
    assert set(losses.LOSSES) == set(jax_losses.LOSSES)


class TestReconLoss:
    def test_mrstft_loss_properties(self):
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.standard_normal((2, 4096)).astype(
            np.float32)) * 0.3
        b = torch.from_numpy(rng.standard_normal((2, 4096)).astype(
            np.float32)) * 0.3
        assert float(losses.multi_res_stft(a, a, RES)) < 1e-4
        assert float(losses.multi_res_stft(a, a + 0.01 * b, RES)) < \
            float(losses.multi_res_stft(a, b, RES))
        x = a.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(losses.multi_res_stft(x, b, RES), [x])
        assert torch.isfinite(g).all() and g.abs().max() > 0


class TestMetrics:
    def test_snr_perfect_and_noisy(self, rng):
        clean = torch.from_numpy(rng.standard_normal((2, 4000)).astype(
            np.float32))
        assert float(eval_metrics.snr_db(clean, clean).min()) > 70
        noisy = clean + 0.1 * torch.from_numpy(
            rng.standard_normal((2, 4000)).astype(np.float32))
        assert 15 < float(eval_metrics.snr_db(clean, noisy).mean()) < 25

    def test_si_sdr_scale_invariant(self, rng):
        clean = torch.from_numpy(rng.standard_normal((2, 4000)).astype(
            np.float32))
        est = clean + 0.05 * torch.from_numpy(
            rng.standard_normal((2, 4000)).astype(np.float32))
        np.testing.assert_allclose(eval_metrics.si_sdr_db(clean, est),
                                   eval_metrics.si_sdr_db(clean, 3 * est),
                                   atol=0.05)
        assert abs(float(eval_metrics.snr_db(clean, est).mean()
                         - eval_metrics.snr_db(clean, 3 * est).mean())) > 3

    def test_lsd_zero_on_identity(self, rng):
        x = torch.from_numpy(rng.standard_normal((1, 8000)).astype(
            np.float32))
        assert float(eval_metrics.log_spectral_distance(x, x).max()) < 1e-5
        y = x + 0.5 * torch.from_numpy(rng.standard_normal((1, 8000)).astype(
            np.float32))
        assert float(eval_metrics.log_spectral_distance(x, y).mean()) > 0.1


def _tones(d, sr, seconds, n=3):
    d.mkdir(exist_ok=True)
    for i in range(n):
        t = np.arange(int(sr * seconds)) / sr
        tone = (0.4 * np.sin(2 * np.pi * (220 + 60 * i) * t)).astype(
            np.float32)
        write_wav(str(d / f"c{i}.wav"), tone, sr)
    return str(d)


class TestEvaluateHarness:
    def test_evaluate_reports_as_jax(self, tmp_path):
        d = tmp_path / "corpus"
        t = np.arange(96000) / 48000.0
        d.mkdir()
        for i in range(3):
            sig = 0.4 * np.sin(2 * np.pi * (300 + 100 * i) * t)
            write_wav(str(d / f"c{i}.wav"), sig[None].astype(np.float32),
                      48000)
        kw = dict(n_examples=2, crop_seconds=1.0, noise_gain=0.3)
        rep = evaluate.evaluate("gruunet2-good", str(d), device="cpu", **kw)
        want = jax_evaluate.evaluate("gruunet2-good", str(d), **kw)
        assert set(rep) == set(want)
        for k, v in want.items():
            if isinstance(v, float):
                tol = REPORT_LSD if "lsd" in k else REPORT_DB
                assert rep[k] == pytest.approx(v, abs=tol), k
            else:
                assert rep[k] == v, k
        assert np.isfinite(rep["si_sdr_improvement_db"])

    def test_evaluate_with_noise_dir_and_gl(self, tmp_path, rng):
        """A noise corpus and the Griffin-Lim back-end: the report names
        both and carries the level-matched metrics (WAV noise here; the
        codec's webm path is the io tests')."""
        d = _tones(tmp_path / "corpus", 48000, 2.0, 2)
        ndir = tmp_path / "realnoise"
        ndir.mkdir()
        write_wav(str(ndir / "n.wav"),
                  (0.1 * rng.standard_normal(48000)).astype(np.float32),
                  48000)
        rep = evaluate.evaluate("gruunet2-good", d, n_examples=2,
                                crop_seconds=1.0, noise_gain=1.0,
                                noise_dir=str(ndir),
                                reconstruction="griffin_lim", gl_iters=4,
                                device="cpu")
        assert rep["noise_source"] == "realnoise"
        assert rep["reconstruction"] == "griffin_lim"
        for k in ("output_snr_matched_db", "output_lsd_matched"):
            assert np.isfinite(rep[k])

    def test_stateless_refuses_a_back_end_override(self, tmp_path):
        d = _tones(tmp_path / "corpus", 48000, 1.0, 1)
        with pytest.raises(ValueError, match="stateless"):
            evaluate.evaluate(os.path.join(REPO, "runs",
                                           "unet4crop2s-mrstft-30k.npz"),
                              d, n_examples=1, crop_seconds=0.5,
                              reconstruction="griffin_lim", device="cpu")


class TestManifestEval:
    def _manifest(self, tmp_path, **extra):
        d = _tones(tmp_path / "corpus", 8000, 3.0)
        man = {"version": 0, "data_dir": d, "noise_dir": None,
               "crop_seconds": 0.5,
               "blocks": [{"seed": 1, "noise_gain": 0.5, "n": 3},
                          {"seed": 2, "noise_gain": 1.0, "n": 3}]}
        man.update(extra)
        p = tmp_path / "man.json"
        p.write_text(json.dumps(man))
        return str(p), man

    def test_build_manifest_set_bit_for_bit(self, tmp_path):
        """Both block kinds (noise gain, target SNR) and a noise corpus:
        the port's mixtures, gains, rate and hash are JAX's."""
        _p, man = self._manifest(tmp_path)
        ndir = tmp_path / "noise"
        ndir.mkdir()
        write_wav(str(ndir / "n.wav"), (0.2 * np.random.default_rng(4)
                                        .standard_normal(16000)).astype(
            np.float32), 16000)
        man = dict(man, noise_dir=str(ndir), blocks=man["blocks"] + [
            {"seed": 5, "target_snr_db": 0.0, "n": 3}])
        ours = evaluate.build_manifest_set(man)
        theirs = jax_evaluate.build_manifest_set(man)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)

    def test_build_manifest_set_deterministic(self, tmp_path):
        _p, man = self._manifest(tmp_path)
        m1, c1, g1, sr1, h1 = evaluate.build_manifest_set(man)
        m2, c2, g2, sr2, h2 = evaluate.build_manifest_set(man)
        assert h1 == h2 and sr1 == sr2 == 8000
        np.testing.assert_array_equal(m1, m2)
        assert m1.shape == (6, 4000)
        np.testing.assert_array_equal(g1, [0.5] * 3 + [1.0] * 3)

    def test_hash_drift_warns(self, tmp_path, capsys):
        _p, man = self._manifest(tmp_path)
        evaluate.build_manifest_set(dict(man, sha256_16="deadbeefdeadbeef"))
        assert "hash" in capsys.readouterr().err

    def test_bootstrap_ci_brackets_mean(self):
        x = np.random.default_rng(0).normal(5.0, 1.0, 200)
        lo, hi = evaluate._bootstrap_ci(x)
        assert lo < x.mean() < hi and hi - lo < 0.6
        assert (lo, hi) == jax_evaluate._bootstrap_ci(x)
        s = evaluate._stat(x)
        assert s == jax_evaluate._stat(x)
        assert s["n"] == 200 and s["ci95"][0] < s["mean"] < s["ci95"][1]

    def test_snr_targeted_blocks(self, tmp_path):
        _p, man = self._manifest(tmp_path)
        man = dict(man, blocks=[{"seed": 5, "target_snr_db": 0.0, "n": 3},
                                {"seed": 6, "target_snr_db": 8.0, "n": 3}])
        m1, c1, g1, _sr, h1 = evaluate.build_manifest_set(man)
        m2, _c2, _g2, _sr2, h2 = evaluate.build_manifest_set(man)
        assert h1 == h2
        np.testing.assert_array_equal(m1, m2)
        n = m1 - c1
        snr = 10 * np.log10((c1 ** 2).mean(1) / (n ** 2).mean(1))
        np.testing.assert_allclose(snr[:3], 0.0, atol=0.5)
        np.testing.assert_allclose(snr[3:], 8.0, atol=0.5)
        np.testing.assert_array_equal(g1, [0.0] * 3 + [8.0] * 3)

    def test_evaluate_manifest_matches_jax(self, tmp_path):
        """The report and the per-example file against JAX's
        evaluate_manifest on gruunet2-good."""
        p, _man = self._manifest(tmp_path)
        pe, pj = str(tmp_path / "pe.npz"), str(tmp_path / "pj.npz")
        rep = evaluate.evaluate_manifest("gruunet2-good", p, n_boot=200,
                                         per_example_out=pe, device="cpu")
        want = jax_evaluate.evaluate_manifest("gruunet2-good", p, n_boot=200,
                                              per_example_out=pj)
        assert rep["n_examples"] == 6
        assert set(rep["by_noise_gain"]) == {"0.5", "1.0"}
        assert {k: v for k, v in rep.items()
                if k not in ("metrics", "by_noise_gain")} == \
            {k: v for k, v in want.items()
             if k not in ("metrics", "by_noise_gain")}
        for k, v in want["metrics"].items():
            tol = REPORT_LSD if "lsd" in k else REPORT_DB
            assert rep["metrics"][k]["n"] == v["n"]
            assert rep["metrics"][k]["mean"] == pytest.approx(v["mean"],
                                                              abs=tol), k
        ours, theirs = np.load(pe), np.load(pj)
        assert set(ours.files) == set(theirs.files)
        assert int(ours["sample_rate"]) == 48000
        for k in theirs.files:
            np.testing.assert_allclose(
                ours[k], theirs[k], rtol=0, err_msg=k,
                atol=PER_EXAMPLE_LSD if "lsd" in k else PER_EXAMPLE_DB)

    def test_rate_pinned_manifest_and_pairing_guard(self, tmp_path):
        p, man = self._manifest(tmp_path)
        p16 = tmp_path / "man16.json"
        p16.write_text(json.dumps(dict(man, sample_rate=16000)))
        pe48 = str(tmp_path / "pe48.npz")
        pe16 = str(tmp_path / "pe16.npz")
        rep = evaluate.evaluate_manifest("gruunet2-good", str(p16),
                                         n_boot=100, per_example_out=pe16,
                                         device="cpu")
        assert rep["n_examples"] == 6
        assert np.isfinite(rep["metrics"]["si_sdr_improvement"]["mean"])
        assert int(np.load(pe16)["sample_rate"]) == 16000
        evaluate.evaluate_manifest("gruunet2-good", p, n_boot=100,
                                   per_example_out=pe48, device="cpu")
        with pytest.raises(ValueError, match="different sample rates"):
            compare.paired_report(pe16, pe48)
        out = compare.paired_report(pe16, pe16, n_boot=50)
        assert all(v["mean_delta"] == 0.0 for v in out.values())

    def test_streamed_evaluation(self, tmp_path):
        """--streamed through the window chain on a stateless checkpoint;
        a recurrent one refuses it."""
        d = _tones(tmp_path / "corpus", 48000, 1.0, 2)
        p = tmp_path / "m.json"
        p.write_text(json.dumps({
            "version": 0, "data_dir": d, "noise_dir": None,
            "crop_seconds": 0.25, "blocks": [{"seed": 1, "noise_gain": 0.5,
                                              "n": 2}]}))
        rep = evaluate.evaluate_manifest(
            os.path.join(REPO, "runs", "unet4crop2s-mrstft-30k.npz"), str(p),
            n_boot=50, streamed=True, unet_seg_hops=2, unet_ctx=384,
            device="cpu")
        assert rep["streamed"] and rep["stream_latency_ms"] == 24.0
        assert np.isfinite(rep["metrics"]["si_sdr_out"]["mean"])
        with pytest.raises(ValueError, match="recurrent"):
            evaluate.evaluate_manifest("gruunet2-good", str(p),
                                       streamed=True, device="cpu")


def _per_example(tmp_path, name, si_in, value):
    path = tmp_path / name
    np.savez(path, si_sdr_in=si_in, **{m: value for m in compare.METRICS})
    return str(path)


class TestPairedReport:
    def test_paired_report_matches_jax(self, tmp_path):
        rng = np.random.default_rng(1)
        base = rng.normal(0.0, 3.0, 64)
        a = _per_example(tmp_path, "a.npz", base,
                         base + 0.3 + rng.normal(0.0, 0.1, 64))
        b = _per_example(tmp_path, "b.npz", base, base)
        rep = compare.paired_report(a, b)
        assert rep == jax_compare.paired_report(a, b)
        for m, r in rep.items():
            assert r["significant"] and 0.2 < r["mean_delta"] < 0.4, (m, r)

    def test_paired_report_mixture_guard_tolerance(self, tmp_path):
        rng = np.random.default_rng(2)
        base = rng.normal(0.0, 3.0, 32)
        a = _per_example(tmp_path, "a.npz",
                         base + rng.normal(0.0, 3e-3, 32), base)
        b = _per_example(tmp_path, "b.npz", base, base)
        compare.paired_report(a, b)
        c = _per_example(tmp_path, "c.npz", base + 1.0, base)
        with pytest.raises(AssertionError, match="inputs differ"):
            compare.paired_report(c, b)

    def test_compare_cli_self_comparison(self, tmp_path, capsys):
        p, _man = TestManifestEval()._manifest(tmp_path)
        assert compare.main(["gruunet2-good", "gruunet2-good", "--manifest",
                             p, "--bootstrap", "50", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        rep = json.loads(out[out.index("{"):])
        for v in rep["delta_a_minus_b"].values():
            assert v["mean_delta"] == 0.0 and v["significant"] is False

    def test_eval_command_in_a_subprocess(self, tmp_path):
        """``python -m audio_denoising_torch eval --manifest M --device
        cpu`` prints the report; without a card and without ``--device
        cpu`` it exits 1."""
        p, _man = TestManifestEval()._manifest(tmp_path)
        cmd = [sys.executable, "-m", "audio_denoising_torch", "eval",
               "--manifest", p, "--bootstrap", "50"]
        env = dict(os.environ, PYTHONPATH=REPO)
        r = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        rep = json.loads(r.stdout[r.stdout.index("{"):])
        assert rep["n_examples"] == 6 and rep["model"] == "gruunet2-good"
        if not torch.cuda.is_available():
            r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                               text=True, timeout=300)
            assert r.returncode == 1 and "cpu" in r.stderr

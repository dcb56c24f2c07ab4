"""Evaluation CLI (JAX counterpart apps/evaluate.py): denoising quality
on synthesized mixtures.

Builds (clean, mixture) pairs as training does (random corpus crops plus
noise at set gains), runs the offline chain (``apps.offline``'s
``denoise_chain``) on the card unless ``device="cpu"``, and reports SI-SDR
and SNR improvement and log-spectral distance; ``--manifest`` evaluates a
frozen mixture manifest with bootstrap confidence intervals. Mixtures
come from numpy generators as in the JAX package, so both synthesize the
same manifest bit for bit; the metrics are computed in float32 on the
CPU.
"""

import argparse
import dataclasses
import glob
import hashlib
import json
import os
import sys

import numpy as np
import torch

from audio_denoising_torch.device import resolve_device


def _wav_corpus(data_dir: str):
    """(the WAVs under ``data_dir`` outside ``noise/`` at the first
    file's rate, sorted; that rate)."""
    from audio_denoising_torch.io.cache import AudioCache
    excluded = os.path.abspath(os.path.join(data_dir, "noise"))
    paths = sorted(
        p for p in glob.glob(os.path.join(data_dir, "**", "*.wav"),
                             recursive=True)
        if not os.path.abspath(p).startswith(excluded + os.sep))
    if not paths:
        raise FileNotFoundError(f"no WAVs under {data_dir}")
    # the corpus may be at another rate than the model (the reference cats
    # corpus is 8 kHz): crops are cut in source samples and resampled;
    # other rates would be pitch-shifted by one ratio, so they are dropped
    src_sr = AudioCache.probe_rate(paths[0])      # header-only, no decode
    return [p for p in paths if AudioCache.probe_rate(p) == src_sr], src_sr


def _resample(a: np.ndarray, orig: int, new: int) -> np.ndarray:
    from audio_denoising_torch.ops.resample import resample
    with torch.no_grad():
        return resample(torch.from_numpy(np.ascontiguousarray(a)), orig,
                        new).numpy()


def _denoiser(cfg, model, device, streamed: bool = False):
    """``fn(samples (N,), sr) -> (N',)`` with the model copied to
    ``device`` once: ``denoise_chain``, or with ``streamed`` the window
    chain alone on samples already at the model's rate (as JAX's
    streamed evaluation runs it, without the chain's normalization)."""
    from audio_denoising_torch.apps.offline import _check_fp32, denoise_chain
    from audio_denoising_torch.pipeline import (
        fp32_convs, offline_denoise_streamed, serving_model)
    model = serving_model(model, device)

    def fn(samples: np.ndarray, sr: int) -> np.ndarray:
        x = torch.as_tensor(np.asarray(samples, np.float32), device=device)
        if not streamed:
            return denoise_chain(cfg, model, x, sr).cpu().numpy()
        if sr != cfg.dsp.sample_rate:
            raise ValueError(f"streamed evaluation takes samples at the "
                             f"model's {cfg.dsp.sample_rate} Hz, not {sr}")
        _check_fp32(device)
        with torch.no_grad(), fp32_convs():
            return offline_denoise_streamed(cfg, model, x).cpu().numpy()

    return fn


def _metric_inputs(clean: np.ndarray, est: np.ndarray):
    """(clean, estimate, the level-matched estimate) as CPU tensors. The
    serving chain keeps the reference's loudness conventions (x3 output
    gain, server.py:213), so absolute level is a convention: SNR and LSD
    are also reported against the least-squares projection alpha =
    <clean, est> / |est|^2 (the alignment SI-SDR makes inside)."""
    cl = torch.from_numpy(np.asarray(clean, np.float32))
    est = torch.from_numpy(np.asarray(est, np.float32))
    alpha = (cl * est).sum(-1, keepdim=True) / (
        (est * est).sum(-1, keepdim=True) + 1e-8)
    return cl, est, est * alpha


def evaluate(spec: str, data_dir: str, n_examples: int = 16,
             crop_seconds: float = 2.0, noise_gain: float = 0.5,
             seed: int = 0, noise_dir: str = None,
             reconstruction: str = None, gl_iters: int = None,
             device=None):
    """Quality of ``spec`` on ``n_examples`` mixtures of the corpus in
    ``data_dir`` at one noise gain. ``noise_dir``: a real noise corpus
    (wav/mp3/webm); None keeps the synthetic white and brown noise.
    ``reconstruction``/``gl_iters`` override the checkpoint's back-end
    (e.g. 'griffin_lim')."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.train.data import MixtureSampler
    from audio_denoising_torch.train.eval_metrics import (
        log_spectral_distance, si_sdr_db, snr_db)

    device = resolve_device(device)
    cfg, model = load_pretrained(spec)
    # the stateless family always resynthesizes with the noisy phase; a
    # Griffin-Lim override would be ignored and then misreported
    stateless = not hasattr(model, "init_state")
    if stateless and (reconstruction is not None or gl_iters is not None):
        raise ValueError(
            f"{spec} is a stateless U-Net: reconstruction is fixed to "
            "noisy-phase iSTFT; --reconstruction/--gl-iters do not apply")
    if reconstruction is not None or gl_iters is not None:
        dsp = dataclasses.replace(
            cfg.dsp,
            reconstruction=(reconstruction if reconstruction is not None
                            else cfg.dsp.reconstruction),
            griffin_lim_iters=(gl_iters if gl_iters is not None
                               else cfg.dsp.griffin_lim_iters))
        cfg = dataclasses.replace(cfg, dsp=dsp)
    sr = cfg.dsp.sample_rate
    paths, src_sr = _wav_corpus(data_dir)
    crop = int(crop_seconds * src_sr)
    noise_paths = ()
    if noise_dir:
        from audio_denoising_torch.io.codec import list_decodable_audio
        noise_paths = list_decodable_audio(noise_dir)
        if not noise_paths:
            raise FileNotFoundError(f"no decodable noise under {noise_dir}")
    sampler = MixtureSampler(paths, noise_paths=noise_paths,
                             crop_samples=crop, batch_size=n_examples,
                             noise_gain=(noise_gain, noise_gain), seed=seed,
                             sample_rate=src_sr)
    mixture, clean = sampler.sample()
    if src_sr != sr:
        mixture = _resample(mixture, src_sr, sr)
        clean = _resample(clean, src_sr, sr)
        crop = mixture.shape[-1]

    denoise = _denoiser(cfg, model, device)
    est = np.stack([denoise(mixture[i], sr)[:crop]
                    for i in range(n_examples)])
    cl, est, est_matched = _metric_inputs(clean, est)
    mix = torch.from_numpy(mixture)

    def mean(v):
        return float(v.mean())

    report = {
        "model": spec,
        "n_examples": n_examples,
        "noise_gain": noise_gain,
        "noise_source": (os.path.basename(os.path.normpath(noise_dir))
                         if noise_dir else "synthetic white+brown"),
        "reconstruction": ("phase" if stateless else cfg.dsp.reconstruction),
        "input_si_sdr_db": round(mean(si_sdr_db(cl, mix)), 3),
        "output_si_sdr_db": round(mean(si_sdr_db(cl, est)), 3),
        "input_snr_db": round(mean(snr_db(cl, mix)), 3),
        "output_snr_db": round(mean(snr_db(cl, est)), 3),
        "output_snr_matched_db": round(mean(snr_db(cl, est_matched)), 3),
        "input_lsd": round(mean(log_spectral_distance(cl, mix)), 4),
        "output_lsd": round(mean(log_spectral_distance(cl, est)), 4),
        "output_lsd_matched": round(
            mean(log_spectral_distance(cl, est_matched)), 4),
    }
    report["si_sdr_improvement_db"] = round(
        report["output_si_sdr_db"] - report["input_si_sdr_db"], 3)
    return report


def _bootstrap_ci(x: np.ndarray, n_boot: int = 2000, seed: int = 0,
                  alpha: float = 0.05):
    """Percentile bootstrap 95% CI of the mean -> (lo, hi)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(x), size=(n_boot, len(x)))
    means = x[idx].mean(axis=1)
    return (float(np.percentile(means, 100 * alpha / 2)),
            float(np.percentile(means, 100 * (1 - alpha / 2))))


def _stat(x: np.ndarray, n_boot: int = 2000, seed: int = 0):
    lo, hi = _bootstrap_ci(x, n_boot, seed)
    return {"mean": round(float(x.mean()), 3), "n": int(len(x)),
            "ci95": [round(lo, 3), round(hi, 3)]}


def build_manifest_set(manifest: dict):
    """Synthesize the manifest's mixtures deterministically.

    The manifest freezes {data_dir, noise_dir, crop_seconds, blocks},
    each block {seed, noise_gain, n} or {seed, target_snr_db, n}: every
    (mixture, clean) pair is reproducible because the sampler is seeded
    and the corpus listing sorted. Returns (mixture (B, T), clean (B, T),
    gains (B,), source rate, hash), and warns on stderr when the hash
    differs from the manifest's frozen ``sha256_16``."""
    from audio_denoising_torch.io.codec import list_decodable_audio
    from audio_denoising_torch.train.data import MixtureSampler

    paths, src_sr = _wav_corpus(manifest["data_dir"])
    noise_dir = manifest.get("noise_dir")
    noise_paths = list_decodable_audio(noise_dir) if noise_dir else ()
    crop = int(manifest["crop_seconds"] * src_sr)

    mixtures, cleans, gains = [], [], []
    for blk in manifest["blocks"]:
        target = blk.get("target_snr_db")
        if target is None:
            sampler = MixtureSampler(
                paths, noise_paths=noise_paths, crop_samples=crop,
                batch_size=blk["n"], noise_gain=(blk["noise_gain"],
                                                 blk["noise_gain"]),
                seed=blk["seed"], sample_rate=src_sr)
            m, c = sampler.sample()
            mixtures.append(m)
            cleans.append(c)
            gains += [blk["noise_gain"]] * blk["n"]
            continue
        # an SNR-targeted block (manifest v2): the noise is rescaled per
        # example to an exact input SNR, and near-silent clean crops
        # (SNR undefined) are redrawn deterministically
        got_m, got_c = [], []
        draw = 0
        while len(got_m) < blk["n"] and draw < 20:
            sampler = MixtureSampler(
                paths, noise_paths=noise_paths, crop_samples=crop,
                batch_size=blk["n"], noise_gain=(1.0, 1.0),
                seed=blk["seed"] + 100000 * draw, sample_rate=src_sr)
            m, c = sampler.sample()
            n = m - c
            for i in range(len(m)):
                if len(got_m) >= blk["n"]:
                    break
                ce = float(np.sqrt((c[i] ** 2).mean()))
                ne = float(np.sqrt((n[i] ** 2).mean()))
                if ce < 1e-3 or ne < 1e-8:
                    continue                      # silent crop: redraw
                g = ce / (ne * 10.0 ** (target / 20.0))
                got_m.append(np.clip(c[i] + g * n[i], -1.0, 1.0))
                got_c.append(c[i])
            draw += 1
        if len(got_m) < blk["n"]:
            raise RuntimeError(
                f"block {blk}: could not draw {blk['n']} non-silent "
                f"crops in {draw} attempts")
        mixtures.append(np.stack(got_m))
        cleans.append(np.stack(got_c))
        gains += [float(target)] * blk["n"]
    mixture = np.concatenate(mixtures)
    clean = np.concatenate(cleans)

    digest = hashlib.sha256(mixture.tobytes()
                            + clean.tobytes()).hexdigest()[:16]
    want = manifest.get("sha256_16")
    if want and digest != want:
        print(f"WARNING: manifest mixtures hash {digest} != frozen {want} "
              "(corpus or sampler changed; metrics are not comparable to "
              "older reports)", file=sys.stderr)
    return mixture, clean, np.asarray(gains, np.float64), src_sr, digest


def evaluate_manifest(spec: str, manifest_path: str, n_boot: int = 2000,
                      per_example_out: str = None,
                      snr_gate_db: float = None,
                      snr_gate_width_db: float = None,
                      snr_gate_estimator: str = None,
                      streamed: bool = False,
                      unet_seg_hops: int = None,
                      unet_ctx: int = None,
                      unet_xfade: int = None,
                      unet_ctx_left: int = None,
                      device=None):
    """Quality on a frozen mixture manifest, each metric with its mean and
    bootstrap 95% CI, overall and per noise gain, on ``device`` (the card
    unless ``"cpu"``).

    ``streamed=True`` (the stateless family only) evaluates through the
    cadence-locked window chain (``offline_denoise_streamed``) instead of
    the whole clip: a bounded-latency point of ``seg + ctx`` samples of
    future context, at the ``unet_*`` geometry given (default: the
    checkpoint's serving config)."""
    from audio_denoising_torch.config import (
        with_snr_gate, with_unet_geometry)
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.train.eval_metrics import (
        log_spectral_distance, si_sdr_db, snr_db)

    device = resolve_device(device)
    with open(manifest_path) as f:
        manifest = json.load(f)
    mixture, clean, gains, src_sr, digest = build_manifest_set(manifest)

    cfg, model = load_pretrained(spec)
    cfg = with_snr_gate(cfg, snr_gate_db, snr_gate_width_db,
                        snr_gate_estimator)
    cfg = with_unet_geometry(cfg, unet_seg_hops, unet_ctx, unet_xfade,
                             unet_ctx_left)
    stream_latency = None
    if streamed:
        if not hasattr(model, "compatible_frames"):
            raise ValueError(
                "--streamed evaluates the cadence-locked U-Net segment "
                "chain; recurrent checkpoints already stream causally "
                "(their bounded-lookahead points come from "
                "ModelConfig.lookahead_frames)")
        stream_latency = (cfg.serving.unet_seg_hops * cfg.dsp.hop_length
                          + cfg.serving.unet_ctx_samples)
    denoise = _denoiser(cfg, model, device, streamed)
    sr = cfg.dsp.sample_rate
    eval_sr = manifest.get("sample_rate")
    if eval_sr:
        # a rate-pinned manifest: metrics at its rate for every model; a
        # model of another basis pays its resampling round trip, as
        # serving a stream of that rate through it would
        if src_sr != eval_sr:
            mixture = _resample(mixture, src_sr, eval_sr)
            clean = _resample(clean, src_sr, eval_sr)
        crop = mixture.shape[-1]
        model_in = (mixture if sr == eval_sr
                    else _resample(mixture, eval_sr, sr))
        est = np.stack([denoise(model_in[i], sr)[:model_in.shape[-1]]
                        for i in range(len(model_in))])
        if sr != eval_sr:
            est = _resample(est, sr, eval_sr)[..., :crop]
        sr = eval_sr                 # the metrics' (and the npz's) rate
    else:
        if src_sr != sr:
            mixture = _resample(mixture, src_sr, sr)
            clean = _resample(clean, src_sr, sr)
        crop = mixture.shape[-1]
        est = np.stack([denoise(mixture[i], sr)[:crop]
                        for i in range(len(mixture))])
    cl, est, est_m = _metric_inputs(clean, est)
    mix = torch.from_numpy(np.asarray(mixture, np.float32))

    per = {
        "si_sdr_in": si_sdr_db(cl, mix).numpy(),
        "si_sdr_out": si_sdr_db(cl, est).numpy(),
        "snr_in": snr_db(cl, mix).numpy(),
        "snr_out_matched": snr_db(cl, est_m).numpy(),
        "lsd_in": log_spectral_distance(cl, mix).numpy(),
        "lsd_out_matched": log_spectral_distance(cl, est_m).numpy(),
    }
    per["si_sdr_improvement"] = per["si_sdr_out"] - per["si_sdr_in"]
    if per_example_out:
        # per-example vectors, the input of paired comparisons
        # (apps/compare.py): the same mixtures under every model, so
        # differences bootstrap per example with the difficulty cancelled
        np.savez(per_example_out, gains=gains, sample_rate=sr,
                 **{k: v.astype(np.float64) for k, v in per.items()})

    report = {
        "model": spec,
        "snr_gate_db": cfg.serving.snr_gate_db,
        "snr_gate_estimator": (cfg.serving.snr_gate_estimator
                               if cfg.serving.snr_gate_db
                               is not None else None),
        "streamed": bool(streamed),
        "stream_latency_ms": (
            round(stream_latency / cfg.dsp.sample_rate * 1e3, 2)
            if streamed else None),
        "unet_seg_hops": cfg.serving.unet_seg_hops if streamed else None,
        "unet_ctx_samples": (cfg.serving.unet_ctx_samples
                             if streamed else None),
        "unet_xfade_samples": (cfg.serving.unet_xfade_samples
                               if streamed else None),
        "unet_ctx_left_samples": (cfg.serving.unet_ctx_left_samples
                                  if streamed else None),
        "manifest": os.path.basename(manifest_path),
        "manifest_version": manifest.get("version"),
        "manifest_hash": digest,
        "n_examples": int(len(mixture)),
        "metrics": {k: _stat(v.astype(np.float64), n_boot)
                    for k, v in per.items()},
        "by_noise_gain": {},
    }
    for g in sorted(set(gains.tolist())):
        m = gains == g
        report["by_noise_gain"][str(g)] = {
            k: _stat(v[m].astype(np.float64), n_boot)
            for k, v in per.items()
            if k in ("si_sdr_improvement", "si_sdr_out",
                     "snr_out_matched", "lsd_out_matched")}
    return report


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audio_denoising_torch eval",
        description="Denoising quality on synthesized mixtures")
    p.add_argument("--model", default="gruunet2-good")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cpu' runs the denoise on the CPU")
    p.add_argument("--data", default=None)
    p.add_argument("--manifest", default=None,
                   help="frozen eval manifest JSON (runs/eval_manifest_*."
                        "json): mean +/- bootstrap CI per metric")
    p.add_argument("--bootstrap", type=int, default=2000)
    p.add_argument("--save-per-example", default=None,
                   help="write per-example metric vectors (npz) for "
                        "paired model comparisons")
    p.add_argument("--examples", type=int, default=16)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--noise-gain", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise-dir", default=None,
                   help="real noise corpus (wav/mp3/webm); default: "
                        "synthetic white+brown")
    p.add_argument("--reconstruction", default=None,
                   choices=["phase", "griffin_lim"],
                   help="override the checkpoint's spectral back-end")
    p.add_argument("--gl-iters", type=int, default=None)
    p.add_argument("--snr-gate", type=float, default=None,
                   help="enable the SNR-gated passthrough blend at this "
                        "gate (dB), ServingConfig.snr_gate_db")
    p.add_argument("--snr-gate-width", type=float, default=None)
    p.add_argument("--snr-gate-estimator", default=None,
                   choices=("removed", "floor", "both"),
                   help="SNR estimator for the gate (ops/noisefloor.py)")
    p.add_argument("--streamed", action="store_true",
                   help="evaluate the stateless U-Net family through the "
                        "cadence-locked streaming window chain (latency "
                        "seg+ctx) instead of the whole-clip path")
    p.add_argument("--unet-seg-hops", type=int, default=None,
                   help="streamed segment length in hops")
    p.add_argument("--unet-ctx", type=int, default=None,
                   help="streamed window context in samples")
    p.add_argument("--unet-xfade", type=int, default=None,
                   help="segment-join crossfade in samples")
    p.add_argument("--unet-ctx-left", type=int, default=None,
                   help="past window context in samples (latency-free)")
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        p.exit(1, f"{p.prog}: {e}\n")
    if args.manifest:
        report = evaluate_manifest(
            args.model, args.manifest, n_boot=args.bootstrap,
            per_example_out=args.save_per_example,
            snr_gate_db=args.snr_gate,
            snr_gate_width_db=args.snr_gate_width,
            snr_gate_estimator=args.snr_gate_estimator,
            streamed=args.streamed, unet_seg_hops=args.unet_seg_hops,
            unet_ctx=args.unet_ctx, unet_xfade=args.unet_xfade,
            unet_ctx_left=args.unet_ctx_left, device=device)
        print(json.dumps(report, indent=2))
        return 0
    if not args.data:
        p.error("--data or --manifest is required")
    report = evaluate(args.model, args.data, args.examples, args.seconds,
                      args.noise_gain, args.seed, noise_dir=args.noise_dir,
                      reconstruction=args.reconstruction,
                      gl_iters=args.gl_iters, device=device)
    print(json.dumps(report, indent=2))
    return 0

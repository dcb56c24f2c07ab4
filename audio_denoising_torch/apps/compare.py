"""Paired model comparison CLI (JAX counterpart apps/compare.py):
``compare A B --manifest M.json``.

Evaluates both models on the same frozen-manifest mixtures and
bootstraps the per-example metric difference, so the mixtures' spread of
difficulty cancels (unpaired CIs from two ``eval`` reports overlap
heavily because the manifest's input-SNR spread dominates them).
"""

import argparse
import json
import os
import tempfile

import numpy as np

from audio_denoising_torch.device import resolve_device

METRICS = ("si_sdr_improvement", "si_sdr_out", "snr_out_matched",
           "lsd_out_matched")


def paired_report(a_path: str, b_path: str, n_boot: int = 5000,
                  seed: int = 0) -> dict:
    """Bootstrap the per-example difference between two saved
    per-example metric files (``eval --save-per-example``)."""
    a = np.load(a_path)
    b = np.load(b_path)
    # metrics are computed at each model's own rate (or the manifest's
    # pinned one): a cross-rate pairing is undefined
    if "sample_rate" in a and "sample_rate" in b \
            and int(a["sample_rate"]) != int(b["sample_rate"]):
        raise ValueError(
            f"models evaluated at different sample rates "
            f"({int(a['sample_rate'])} vs {int(b['sample_rate'])} Hz); "
            f"paired comparison undefined: evaluate both at one rate "
            f"(e.g. a 16 kHz manifest with 16 kHz-basis models)")
    # same-mixture guard: different manifest mixtures differ by dB of
    # input SI-SDR; the same mixtures on two backends (the card and the
    # CPU) by ~3e-3 dB of float reassociation. 0.05 dB parts the two.
    np.testing.assert_allclose(a["si_sdr_in"], b["si_sdr_in"], rtol=0,
                               atol=0.05,
                               err_msg="inputs differ: not the same "
                                       "manifest mixtures")
    rng = np.random.default_rng(seed)
    out = {}
    for m in METRICS:
        d = a[m] - b[m]
        idx = rng.integers(0, len(d), size=(n_boot, len(d)))
        means = d[idx].mean(axis=1)
        lo, hi = np.percentile(means, [2.5, 97.5])
        out[m] = {"mean_delta": round(float(d.mean()), 3),
                  "ci95": [round(float(lo), 3), round(float(hi), 3)],
                  "significant": bool(lo > 0 or hi < 0)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="audio_denoising_torch compare",
        description="Paired two-model comparison on a frozen manifest")
    p.add_argument("model_a")
    p.add_argument("model_b")
    p.add_argument("--manifest", required=True)
    p.add_argument("--bootstrap", type=int, default=5000)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cpu' runs both evaluations on the CPU")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        p.exit(1, f"{p.prog}: {e}\n")

    from audio_denoising_torch.apps.evaluate import evaluate_manifest

    with tempfile.TemporaryDirectory() as td:
        pa = os.path.join(td, "a.npz")
        pb = os.path.join(td, "b.npz")
        evaluate_manifest(args.model_a, args.manifest, per_example_out=pa,
                          device=device)
        evaluate_manifest(args.model_b, args.manifest, per_example_out=pb,
                          device=device)
        report = {
            "a": args.model_a,
            "b": args.model_b,
            "manifest": os.path.basename(args.manifest),
            "delta_a_minus_b": paired_report(pa, pb,
                                             n_boot=args.bootstrap),
        }
    print(json.dumps(report, indent=2))
    return 0

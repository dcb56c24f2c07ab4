"""Offline file denoising (JAX counterpart apps/offline.py): the intended
semantics of the reference's upload path (app.py:171-223), which
monotizes, resamples and peak-normalizes, then was meant to run STFT ->
model -> iSTFT.

The chain (``denoise_array``) runs on one device (the card unless the
caller passes ``device="cpu"``): mono by mean, resample to the model's
rate, peak normalization, ``pipeline.offline_denoise``, de-normalization,
all in full fp32 (``pipeline.fp32_convs()``, TF32 matmuls refused), as
the JAX chain runs under float32 matmul precision. ``denoise_file`` reads
any decodable container (WAV natively, the rest through
``io.AudioCache``) and writes a 16-bit WAV at the model's rate.

Not ported yet: ``--streamed`` and the ``--unet-*`` geometry (the U-Net
segment family, ROADMAP A8) and ``.onnx`` models (A14).
"""

import argparse
from typing import Optional, Union

import numpy as np
import torch

from audio_denoising_torch.config import (
    Config, recommended_serving, with_snr_gate)
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.io.wavio import read_wav, write_wav
from audio_denoising_torch.ops.resample import resample
from audio_denoising_torch.pipeline import (
    fp32_convs, offline_denoise, serving_model)

UNET_REFUSAL = ("the U-Net segment family (--streamed, --unet-*) is not "
                "ported yet (ROADMAP A8)")


def _check_fp32(device: torch.device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the offline "
            "chain runs in full fp32 (the JAX chain's float32 matmul "
            "precision); set it to False")


def denoise_chain(cfg: Config, model, x: torch.Tensor,
                  sample_rate: int) -> torch.Tensor:
    """The chain on ``x`` (C, N) or (N,) at ``sample_rate``, on x's device
    with ``model`` already there: mono by mean, resample, peak
    normalization, ``offline_denoise``, de-normalization -> (N',)."""
    if not hasattr(model, "init_state"):
        raise NotImplementedError(UNET_REFUSAL)
    _check_fp32(x.device)
    with torch.no_grad(), fp32_convs():
        if x.dim() == 2:                  # to mono (app.py:186-188)
            x = x.mean(dim=0)
        if sample_rate != cfg.dsp.sample_rate:
            x = resample(x[None], sample_rate, cfg.dsp.sample_rate)[0]
        peak = x.abs().max()
        scale = torch.where(peak > 1e-8, peak, torch.ones_like(peak))
        return offline_denoise(cfg, model, x / scale) * scale


def denoise_array(cfg: Config, model, samples: np.ndarray, sample_rate: int,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> np.ndarray:
    """samples: (C, N) or (N,) float32 at ``sample_rate`` -> denoised mono
    (N',) float32 at ``cfg.dsp.sample_rate``, computed on ``device`` (the
    card unless ``"cpu"``)."""
    device = resolve_device(device)
    model = serving_model(model, device)
    x = torch.as_tensor(np.asarray(samples, np.float32), device=device)
    return denoise_chain(cfg, model, x, sample_rate).cpu().numpy()


def denoise_file(spec: str, in_path: str, out_path: str,
                 cfg: Optional[Config] = None,
                 snr_gate_db: Optional[float] = None,
                 snr_gate_width_db: Optional[float] = None,
                 snr_gate_estimator: Optional[str] = None,
                 auto_gate: bool = True, streamed: bool = False,
                 unet_seg_hops: Optional[int] = None,
                 unet_ctx: Optional[int] = None,
                 unet_xfade: Optional[int] = None,
                 unet_ctx_left: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None) -> str:
    """Any decodable container in -> denoised WAV out, on ``device`` (the
    card unless ``"cpu"``; without a card this raises before it reads or
    writes a file). An explicit ``snr_gate_db`` turns the SNR gate on
    (``with_snr_gate``); with no gate argument, eligible causal
    checkpoints run the tuned gate (``recommended_serving``), and
    ``auto_gate=False`` runs the raw model."""
    if streamed or any(v is not None for v in (
            unet_seg_hops, unet_ctx, unet_xfade, unet_ctx_left)):
        raise NotImplementedError(UNET_REFUSAL)
    device = resolve_device(device)
    cfg, model = load_pretrained(spec, cfg)
    if snr_gate_db is not None:
        cfg = with_snr_gate(cfg, snr_gate_db, snr_gate_width_db,
                            snr_gate_estimator)
    elif auto_gate:
        cfg = recommended_serving(cfg)
    if in_path.lower().endswith(".wav"):
        samples, sr = read_wav(in_path)
    else:
        from audio_denoising_torch.io.cache import AudioCache
        samples, sr = AudioCache().load(in_path)
    out = denoise_array(cfg, model, samples, sr, device=device)
    write_wav(out_path, out[None], cfg.dsp.sample_rate)
    return out_path


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audio_denoising_torch denoise",
        description="Offline file -> WAV denoising (PyTorch/CUDA)")
    p.add_argument("input", help="input audio path (WAV, or any container "
                   "the codec libraries decode)")
    p.add_argument("output", help="output WAV path")
    p.add_argument("--model", default="gruunet2-good",
                   help="a preset name, an .npz or a reference .pth "
                   "checkpoint")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cpu' runs the chain on the CPU")
    p.add_argument("--snr-gate", type=float, default=None,
                   help="SNR-gated passthrough blend (dB): protects "
                   "near-clean input (ServingConfig.snr_gate_db). Without "
                   "it, eligible causal checkpoints run the tuned gate "
                   "(config.recommended_serving)")
    p.add_argument("--no-snr-gate", action="store_true",
                   help="run the raw model: no recommended gate")
    p.add_argument("--snr-gate-width", type=float, default=None)
    p.add_argument("--snr-gate-estimator", default=None,
                   choices=("removed", "floor", "both"),
                   help="the gate's SNR estimator (ops/noisefloor.py)")
    p.add_argument("--streamed", action="store_true",
                   help="the U-Net segment chain: not ported yet (A8)")
    for flag in ("--unet-seg-hops", "--unet-ctx", "--unet-xfade",
                 "--unet-ctx-left"):
        p.add_argument(flag, type=int, default=None,
                       help="--streamed geometry: not ported yet (A8)")
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        p.exit(1, f"{p.prog}: {e}\n")
    try:
        path = denoise_file(args.model, args.input, args.output,
                            snr_gate_db=args.snr_gate,
                            snr_gate_width_db=args.snr_gate_width,
                            snr_gate_estimator=args.snr_gate_estimator,
                            auto_gate=not args.no_snr_gate,
                            streamed=args.streamed,
                            unet_seg_hops=args.unet_seg_hops,
                            unet_ctx=args.unet_ctx,
                            unet_xfade=args.unet_xfade,
                            unet_ctx_left=args.unet_ctx_left,
                            device=device)
    except NotImplementedError as e:
        p.error(str(e))
    print(f"wrote {path}")
    return 0

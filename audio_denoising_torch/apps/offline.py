"""Offline file denoising (JAX counterpart apps/offline.py): the intended
semantics of the reference's upload path (app.py:171-223), which
monotizes, resamples and peak-normalizes, then was meant to run STFT ->
model -> iSTFT.

The chain (``denoise_array``) runs on one device (the card unless the
caller passes ``device="cpu"``): mono by mean, resample to the model's
rate, peak normalization, the denoise, de-normalization, all in full fp32
(``pipeline.fp32_convs()``, TF32 matmuls refused), as the JAX chain runs
under float32 matmul precision. The denoise is
``pipeline.offline_denoise`` for the recurrent families, and for the
stateless segment family (the U-Nets, TRUNetDenoiser)
``offline_denoise_stateless`` over the whole clip or, with
``streamed=True`` (``--streamed``), ``offline_denoise_streamed``: the
cadence-locked window chain engine mode ``unet`` serves, at the
recommended geometry unless a ``--unet-*`` flag or ``--no-snr-gate`` is
given. ``denoise_file`` reads any decodable container (WAV natively,
the rest through ``io.AudioCache``) and writes a 16-bit WAV at the
model's rate. A MOMO cell's ``.onnx`` graph is served through the hub,
with its assumed raw front-end.
"""

import argparse
from typing import Optional, Union

import numpy as np
import torch

from audio_denoising_torch.config import (
    Config, recommended_serving, recommended_streaming_geometry,
    with_snr_gate, with_unet_geometry)
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.io.wavio import read_wav, write_wav
from audio_denoising_torch.ops.resample import resample
from audio_denoising_torch.pipeline import (
    fp32_convs, offline_denoise, offline_denoise_stateless,
    offline_denoise_streamed, serving_model)


def _check_fp32(device: torch.device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the offline "
            "chain runs in full fp32 (the JAX chain's float32 matmul "
            "precision); set it to False")


def denoise_chain(cfg: Config, model, x: torch.Tensor,
                  sample_rate: int, streamed: bool = False) -> torch.Tensor:
    """The chain on ``x`` (C, N) or (N,) at ``sample_rate``, on x's device
    with ``model`` already there: mono by mean, resample, peak
    normalization, the denoise (``offline_denoise`` for a recurrent
    model; for a stateless one ``offline_denoise_streamed`` when
    ``streamed``, else ``offline_denoise_stateless``), de-normalization
    -> (N',)."""
    if hasattr(model, "init_state"):
        denoise = offline_denoise
    elif streamed:
        denoise = offline_denoise_streamed
    else:
        denoise = offline_denoise_stateless
    _check_fp32(x.device)
    with torch.no_grad(), fp32_convs():
        if x.dim() == 2:                  # to mono (app.py:186-188)
            x = x.mean(dim=0)
        if sample_rate != cfg.dsp.sample_rate:
            x = resample(x[None], sample_rate, cfg.dsp.sample_rate)[0]
        peak = x.abs().max()
        scale = torch.where(peak > 1e-8, peak, torch.ones_like(peak))
        return denoise(cfg, model, x / scale) * scale


def denoise_array(cfg: Config, model, samples: np.ndarray, sample_rate: int,
                  device: Optional[Union[str, torch.device]] = None,
                  streamed: bool = False) -> np.ndarray:
    """samples: (C, N) or (N,) float32 at ``sample_rate`` -> denoised mono
    (N',) float32 at ``cfg.dsp.sample_rate``, computed on ``device`` (the
    card unless ``"cpu"``); ``streamed`` runs a stateless model through
    the bounded-latency segment chain."""
    device = resolve_device(device)
    model = serving_model(model, device)
    x = torch.as_tensor(np.asarray(samples, np.float32), device=device)
    return denoise_chain(cfg, model, x, sample_rate,
                         streamed).cpu().numpy()


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
    ``auto_gate=False`` runs the raw model. ``streamed`` runs a stateless
    checkpoint through the segment chain of engine mode ``unet``, at the
    ``unet_*`` geometry given (``with_unet_geometry``) or, with none and
    ``auto_gate``, the recommended one; a recurrent checkpoint refuses
    it, as in JAX."""
    device = resolve_device(device)
    cfg, model = load_pretrained(spec, cfg)
    if snr_gate_db is not None:
        cfg = with_snr_gate(cfg, snr_gate_db, snr_gate_width_db,
                            snr_gate_estimator)
    elif auto_gate:
        cfg = recommended_serving(cfg)
    cfg = with_unet_geometry(cfg, unet_seg_hops, unet_ctx, unet_xfade,
                             unet_ctx_left)
    if auto_gate and streamed and all(v is None for v in (
            unet_seg_hops, unet_ctx, unet_xfade, unet_ctx_left)):
        # no geometry flag: the measured-best window; any flag, or
        # --no-snr-gate (the raw profile), opts out
        cfg = recommended_streaming_geometry(cfg)
    if streamed and not hasattr(model, "compatible_frames"):
        raise ValueError(
            "--streamed runs the cadence-locked U-Net segment chain; "
            "recurrent checkpoints already process causally (bounded "
            "lookahead comes from ModelConfig.lookahead_frames)")
    if in_path.lower().endswith(".wav"):
        samples, sr = read_wav(in_path)
    else:
        from audio_denoising_torch.io.cache import AudioCache
        samples, sr = AudioCache().load(in_path)
    out = denoise_array(cfg, model, samples, sr, device=device,
                        streamed=streamed)
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
                   help="run the raw profile: no recommended gate on "
                   "causal checkpoints, no recommended --streamed geometry")
    p.add_argument("--snr-gate-width", type=float, default=None)
    p.add_argument("--snr-gate-estimator", default=None,
                   choices=("removed", "floor", "both"),
                   help="the gate's SNR estimator (ops/noisefloor.py)")
    p.add_argument("--streamed", action="store_true",
                   help="stateless checkpoints (the U-Nets, TRUNet): "
                   "denoise through the bounded-latency segment chain "
                   "engine mode unet serves, not the whole-file window")
    p.add_argument("--unet-seg-hops", type=int, default=None,
                   help="--streamed: segment length in hops")
    p.add_argument("--unet-ctx", type=int, default=None,
                   help="--streamed: future window context in samples")
    p.add_argument("--unet-xfade", type=int, default=None,
                   help="--streamed: segment-join crossfade in samples")
    p.add_argument("--unet-ctx-left", type=int, default=None,
                   help="--streamed: past window context in samples")
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

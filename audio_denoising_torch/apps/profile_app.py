"""Serving profiler CLI (JAX counterpart apps/profile_app.py): per-hop
latency of a preset's step at a number of streams, dispatch-inclusive
(the card synchronized after every hop) and amortized over a chain of
dependent hops (with eager PyTorch that still holds the host's launch
cost, runtime/profiler.py); optionally per stage and a Chrome trace.

Usage: python -m audio_denoising_torch profile --model gruunet2-good \
           --streams 256 --mode fast --fused [--trace DIR] [--stages]
"""

import argparse
import json

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="audio_denoising_torch profile")
    p.add_argument("--model", default="gruunet2-good")
    p.add_argument("--streams", type=int, default=256)
    p.add_argument("--hops", type=int, default=50)
    p.add_argument("--mode", choices=["fast", "server", "webrtc"],
                   default="fast")
    p.add_argument("--plan", action="store_true",
                   help="use the matrixized cell plan")
    p.add_argument("--fused", action="store_true",
                   help="use the hand-written fused cell kernel")
    p.add_argument("--trace", default=None,
                   help="write a torch.profiler Chrome trace to this "
                   "directory")
    p.add_argument("--stages", action="store_true",
                   help="also time front-end / model / back-end separately")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cpu' runs the plain PyTorch versions")
    args = p.parse_args(argv)

    import torch
    from audio_denoising_torch.device import resolve_device
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.pipeline import (
        fp32_convs, make_server_step, make_webrtc_step, serving_model,
        webrtc_init_state)
    from audio_denoising_torch.runtime.engine import (
        fast_init_state, make_fast_step)
    from audio_denoising_torch.runtime.plan import PlanModel
    from audio_denoising_torch.runtime.profiler import (
        StageProfile, device_trace)

    device = resolve_device(args.device)
    cfg, model = load_pretrained(args.model)
    if args.plan or args.fused:
        model = PlanModel(model, fused=args.fused, device=device)
    B = args.streams
    hop = cfg.dsp.hop_length
    rng = np.random.default_rng(0)
    chunk = torch.from_numpy(
        (0.1 * rng.standard_normal((B, hop))).astype(np.float32)).to(device)

    if args.mode == "fast":
        step = make_fast_step(cfg, model, device)
        state = fast_init_state(cfg, model, B, device)
    elif args.mode == "webrtc":
        step = make_webrtc_step(cfg, model, device)
        state = webrtc_init_state(cfg, model, B, device)
    else:
        step = make_server_step(cfg, model, device)
        state = model.init_state(B, device=device)

    hops_run = 0

    def counted(s, c):
        nonlocal hops_run
        hops_run += 1
        return step(s, c)

    with torch.no_grad():
        prof = StageProfile(device)
        disp = prof.measure_dispatch(counted, state, chunk, iters=args.hops)

        def make_chain(chain):
            def run():
                s = state
                for _ in range(chain):
                    s, _ = counted(s, chunk)
            return run

        amort = prof.measure_amortized(make_chain, chain=args.hops)

    hop_ms = hop / cfg.dsp.sample_rate * 1e3
    report = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "streams": B,
        "hop_ms": round(hop_ms, 3),
        "dispatch_inclusive": {k: round(v, 3) for k, v in disp.items()},
        "amortized_ms_per_hop": round(amort, 4),
        "aggregate_realtime_x": round(B * hop_ms / amort, 1),
    }
    if args.stages:
        from audio_denoising_torch.ops import (
            hann_window, inverse_mel_matrix, inverse_mel_scale,
            mel_filterbank, mel_scale)
        dsp = cfg.dsp
        fb = mel_filterbank(dsp.n_stft, dsp.n_mels,
                            dsp.sample_rate).to(device)
        inv = inverse_mel_matrix(dsp.n_stft, dsp.n_mels,
                                 dsp.sample_rate).to(device)
        win = hann_window(dsp.n_fft).to(device)
        stage_model = serving_model(model, device)

        def frontend(x):
            spec = torch.fft.rfft(x * win, dim=-1)
            return torch.log1p(mel_scale(spec.abs()[..., None], fb))

        def modelstage(m):
            with fp32_convs():
                y, _ = stage_model.apply(
                    m.transpose(-1, -2),
                    stage_model.init_state(B, device=device))
            return y

        def backend(m):
            lin = inverse_mel_scale(torch.clamp(torch.expm1(m), min=0), inv)
            return torch.fft.irfft(lin[..., 0].to(torch.complex64),
                                   n=dsp.n_fft, dim=-1)

        ring = torch.zeros((B, dsp.n_fft), device=device)
        mel_in = torch.zeros((B, dsp.n_mels, 1), device=device)
        stage_ms = {}
        with torch.no_grad():
            for name, fn, arg in (("frontend", frontend, ring),
                                  ("model", modelstage, mel_in),
                                  ("backend", backend, mel_in)):
                def make_chain(chain, fn=fn, arg=arg):
                    def run():
                        for _ in range(chain):
                            fn(arg)
                    return run
                stage_ms[name] = round(
                    prof.measure_amortized(make_chain, chain=args.hops), 4)
        report["stage_ms_per_hop"] = stage_ms

    if args.trace:
        with torch.no_grad(), device_trace(args.trace):
            s = state
            for _ in range(5):
                s, _ = counted(s, chunk)
            prof.wait()
        report["trace_dir"] = args.trace
    report["hops_run"] = hops_run
    if args.fused:
        report["fused_cell_launches"] = model.fused_cell.launches
    print(json.dumps(report, indent=2))
    return 0

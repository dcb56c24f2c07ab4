"""Top-level CLI: ``python -m audio_denoising_torch <command> ...``
(JAX counterpart cli.py).

The port's commands: ``denoise`` (an audio file to a denoised WAV),
``serve`` (the reference's socket protocol), ``engine`` (the batched
multi-stream daemon), ``ws`` (the WebSocket browser-mic daemon),
``profile`` (per-hop latency of a serving step), ``train`` (training on
mixture-synthesized data), ``eval`` (quality on synthesized mixtures or
a frozen manifest), ``compare`` (a paired two-model comparison on a
manifest), and the checkpoint
tools ``convert`` (.pth or preset/.npz to .npz), ``info`` (a
checkpoint's meta) and ``models`` (the presets), which touch no device.
"""

import sys


def _info(argv) -> int:
    import argparse
    import json
    p = argparse.ArgumentParser(prog="audio_denoising_torch info")
    p.add_argument("checkpoint", help=".npz or reference .pth checkpoint")
    args = p.parse_args(argv)
    if args.checkpoint.endswith(".pth"):
        from audio_denoising_torch.compat import load_torch_checkpoint
        ck = load_torch_checkpoint(args.checkpoint)
        meta = {k: v for k, v in ck.items()
                if isinstance(v, (str, int, float))}
        meta["config"] = ck.get("config")
        meta["n_params"] = sum(
            getattr(v, "size", 0) for v in ck["model_state_dict"].values())
        losses = (ck.get("loss_record") or {}).get("train") or {}
        if losses:
            vals = list(losses.values())
            meta["train_loss_first"] = vals[0]
            meta["train_loss_min"] = min(vals)
    else:
        from audio_denoising_torch.compat import load_params_npz
        params, meta = load_params_npz(args.checkpoint)
        meta = dict(meta)
        meta["n_params"] = int(sum(v.size for v in params.values()))
    print(json.dumps(meta, indent=2, default=str))
    return 0


def _models(argv) -> int:
    import json
    import os
    from audio_denoising_torch.config import PRESETS
    from audio_denoising_torch.hub import CHECKPOINT_DIR, _CKPT_ALIASES
    rows = {}
    for name, cfg in sorted(PRESETS.items()):
        ckpt = _CKPT_ALIASES.get(name, name)
        rows[name] = {
            "arch": cfg.model.arch,
            "sample_rate": cfg.dsp.sample_rate,
            "n_fft": cfg.dsp.n_fft,
            "hop": cfg.dsp.hop_length,
            "reconstruction": cfg.dsp.reconstruction,
            "weights": os.path.exists(
                os.path.join(CHECKPOINT_DIR, f"{ckpt}.npz")),
        }
    print(json.dumps(rows, indent=2))
    return 0


def _convert(argv) -> int:
    import argparse
    import json
    from audio_denoising_torch.compat import save_params_npz
    p = argparse.ArgumentParser(prog="audio_denoising_torch convert")
    p.add_argument("src", help="checkpoint (preset name, .npz or "
                   "reference .pth)")
    p.add_argument("out", help="output .npz (the .onnx cell export is "
                   "not ported yet, ROADMAP A14)")
    args = p.parse_args(argv)
    if args.out.lower().endswith(".onnx"):
        from audio_denoising_torch.hub import ONNX_REFUSAL
        p.error(ONNX_REFUSAL)
    if args.src.lower().endswith(".pth"):
        from audio_denoising_torch.compat import (
            load_torch_checkpoint, state_dict_to_params)
        ck = load_torch_checkpoint(args.src)
        params = state_dict_to_params(ck["model_state_dict"])
        meta = {k: v for k, v in ck.items()
                if k not in ("model_state_dict", "optimizer_state_dict",
                             "scheduler_state_dict", "state_dict")}
    else:
        # a preset name or an .npz resolves through the hub, as every
        # other command's model does; its parameters go out as stored
        from audio_denoising_torch.compat import load_params_npz
        from audio_denoising_torch.hub import checkpoint_path, load_pretrained
        cfg, _ = load_pretrained(args.src)
        params, _ = load_params_npz(checkpoint_path(args.src))
        meta = {"arch": cfg.model.arch,
                "config": cfg.model.to_reference_dict(),
                "full_config": json.loads(cfg.to_json())}
    save_params_npz(args.out, params, meta)
    print(f"wrote {args.out} ({len(params)} tensors)")
    return 0


COMMANDS = {
    "denoise": "audio_denoising_torch.apps.offline",
    "serve": "audio_denoising_torch.apps.serve",
    "engine": "audio_denoising_torch.apps.engine_serve",
    "profile": "audio_denoising_torch.apps.profile_app",
    "ws": "audio_denoising_torch.apps.ws_serve",
    "train": "audio_denoising_torch.apps.trainer",
    "eval": "audio_denoising_torch.apps.evaluate",
    "compare": "audio_denoising_torch.apps.compare",
}
TOOLS = {"convert": _convert, "info": _info, "models": _models}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        names = ", ".join(list(COMMANDS) + list(TOOLS))
        print(f"usage: python -m audio_denoising_torch <command> [...]\n"
              f"commands: {names}")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd in TOOLS:
        return TOOLS[cmd](rest)
    if cmd in COMMANDS:
        import importlib
        return importlib.import_module(COMMANDS[cmd]).main(rest)
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 2

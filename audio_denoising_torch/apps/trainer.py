"""Training CLI (JAX counterpart apps/trainer.py): the reconstructed loop
of the reference's missing ``main.ipynb`` (SURVEY §3.5: AdamW with an
exponential LR decay, batch 64, random clean and noise crops mixed
additively, MSE on the residual spectrogram, per-iteration loss records,
a checkpoint at the end).

    python -m audio_denoising_torch train --data DIR [--device-data]

runs on the card unless ``--device cpu``. ``--data-parallel`` trains
one replica per card on its rows of every batch
(``train.context.make_sharded_train_step``; JAX trainer.py:242-256),
on the host sampler with no eval and no teacher, as JAX does. Under
torchrun, or with ``ADT_COORDINATOR`` (and ``RANK``/``WORLD_SIZE``) set,
each process joins that group; with several cards and no such
environment the command starts one worker per card itself
(``torch.multiprocessing.spawn``, NCCL). Every rank draws the same
seeded batch and keeps its rows, so no batch crosses between ranks;
rank 0 alone prints and saves. With one device, or with
``--device-data`` (checked first, as in JAX), the flag takes the
single-device path.
"""

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import sys

import torch
import torch.distributed as dist

from audio_denoising_torch.config import Config, PRESETS
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.models import build_model
from audio_denoising_torch.parallel import distributed
from audio_denoising_torch.train.context import (
    TrainingContext, make_sharded_train_step)
from audio_denoising_torch.train.data import MixtureSampler

def find_corpus(data_dir: str):
    """(clean WAVs under ``data_dir`` outside ``noise/``, decodable noise
    files under ``noise/``), each sorted."""
    from audio_denoising_torch.io.codec import list_decodable_audio
    noise_dir = os.path.join(data_dir, "noise")
    clean = sorted(
        p for p in glob.glob(os.path.join(data_dir, "**", "*.wav"),
                             recursive=True)
        if not os.path.abspath(p).startswith(os.path.abspath(noise_dir)
                                             + os.sep))
    noise = (list_decodable_audio(noise_dir)
             if os.path.isdir(noise_dir) else [])
    return clean, noise


def device_count(device: torch.device) -> int:
    """The devices a data-parallel run would span."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _worker(rank: int, world: int, address: str, argv) -> None:
    """One rank of a data-parallel run the command started itself."""
    os.environ.update(ADT_COORDINATOR=address, RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    main(argv)


def spawn_workers(argv, world: int) -> int:
    """Run this command once per card, as ranks 0 .. world-1 of one
    NCCL group on a free localhost port; returns when all have ended
    (``torch.multiprocessing.spawn`` raises if one fails)."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.spawn(_worker, args=(world, f"tcp://127.0.0.1:{port}", list(argv)),
             nprocs=world, join=True)
    return 0


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audio_denoising_torch train",
        description="Train a denoising model on mixture-synthesized data")
    p.add_argument("--preset", default="gruunet2-dari_tult",
                   choices=sorted(PRESETS))
    p.add_argument("--data", required=True,
                   help="directory of clean WAVs (noise/ subdir optional)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cpu' trains on the CPU")
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--save", default="run.npz", help="checkpoint output path")
    p.add_argument("--resume", default=None, help="checkpoint to resume from")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard every batch over all cards, one process "
                        "each (under torchrun or ADT_COORDINATOR, the "
                        "group's ranks)")
    p.add_argument("--device-data", action="store_true",
                   help="device-resident pipeline: the corpus (and noise "
                        "corpus) go to the device once and every batch is "
                        "synthesized there")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--crop-samples", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr-gamma", type=float, default=None,
                   help="per-1000-step exponential LR decay rate "
                        "(reference: 0.9; long runs want gentler, e.g. "
                        "0.97, or the LR hits ~0 long before the end)")
    p.add_argument("--noise-gain", type=float, nargs=2, default=(0.2, 1.0),
                   metavar=("LO", "HI"),
                   help="uniform noise gain range per mixture")
    p.add_argument("--objective", default=None,
                   choices=["residual_mse", "recon_mrstft"],
                   help="recon_mrstft trains through the full phase-reuse "
                        "reconstruction against a multi-resolution STFT + "
                        "waveform objective")
    p.add_argument("--snr-range", type=float, nargs=2, default=None,
                   metavar=("LO_DB", "HI_DB"),
                   help="SNR-targeted mixture curriculum (device-data "
                        "path): per-mixture noise gain solved to hit a "
                        "uniform SNR in [lo, hi] dB")
    p.add_argument("--identity-prob", type=float, default=None,
                   help="probability that a training example carries ZERO "
                        "noise (mixture == clean): easy-input preservation "
                        "against near-clean degradation (device-data path)")
    p.add_argument("--si-sdr-weight", type=float, default=None,
                   help="add -SI-SDR/10 to the recon_mrstft objective "
                        "(directly optimizes the headline eval metric)")
    p.add_argument("--mrstft-weight", type=float, default=None,
                   help="weight of the multi-resolution STFT term in the "
                        "recon_mrstft objective (default 1.0)")
    p.add_argument("--wave-l1-weight", type=float, default=None,
                   help="weight of the waveform-L1 term in the "
                        "recon_mrstft objective (default 10.0)")
    p.add_argument("--lookahead", type=int, default=None,
                   help="bounded lookahead in FRAMES (hops): the model's "
                        "output at step t targets frame t - k, so serving "
                        "sees k hops of future context at k*hop/sr seconds "
                        "of added latency (recurrent family only); the "
                        "checkpoint carries the shift "
                        "(ModelConfig.lookahead_frames)")
    p.add_argument("--distill-from", default=None,
                   help="teacher checkpoint path: the training target "
                        "becomes the TEACHER's denoised output on each "
                        "mixture (computed on the device without a "
                        "gradient) instead of the clean crop "
                        "(train/distill.py); same sample rate required")
    p.add_argument("--hidden", type=int, default=None,
                   help="override the model's hidden width (uniform "
                        "across levels); the checkpoint carries its own "
                        "config, so eval and serving pick it up")
    p.add_argument("--noise-dir", default=None,
                   help="extra noise corpus (wav/mp3/webm via io/codec.py) "
                        "in addition to <data>/noise; crops are resampled "
                        "to the clean corpus rate")
    return p


def resolve_config(args, p) -> Config:
    """The preset, or on resume the checkpoint's full_config (the source
    of truth, as the reference's checkpoint 'config' field wins,
    app2.py:62-99), with the CLI flags on top."""
    cfg: Config = PRESETS[args.preset]
    if args.resume:
        from audio_denoising_torch.compat.npz_store import load_params_npz
        try:
            _, meta = load_params_npz(args.resume)
        except (OSError, ValueError, KeyError) as e:
            p.error(f"cannot read --resume {args.resume}: {e}")
        if meta.get("full_config"):
            resumed = Config.from_json(json.dumps(meta["full_config"]))
            # an arch mismatch only: every resume of a run with a CLI
            # override differs from the preset somewhere
            if resumed.model.arch != cfg.model.arch:
                print(f"note: --preset {args.preset} ({cfg.model.arch}) "
                      f"differs from the resumed checkpoint's arch "
                      f"({resumed.model.arch}); using the checkpoint's "
                      f"config (CLI flags still override)")
            cfg = resumed
        else:
            print("warning: resumed checkpoint has no full_config; "
                  f"falling back to preset {args.preset} + CLI flags")
    flags = {"batch_size": args.batch_size,
             "crop_samples": args.crop_samples,
             "learning_rate": args.lr, "lr_gamma": args.lr_gamma,
             "objective": args.objective,
             "snr_range_db": tuple(args.snr_range) if args.snr_range
             else None}
    overrides = {k: v for k, v in flags.items() if v}
    for k, v in (("identity_prob", args.identity_prob),
                 ("si_sdr_weight", args.si_sdr_weight),
                 ("mrstft_weight", args.mrstft_weight),
                 ("wave_l1_weight", args.wave_l1_weight),
                 ("distill_from", args.distill_from)):
        if v is not None:
            overrides[k] = v
    if overrides:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **overrides))
    if args.hidden:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model,
            hidden_sizes=(args.hidden,) * len(cfg.model.hidden_sizes)))
    if args.lookahead is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, lookahead_frames=args.lookahead))
    if args.objective == "recon_mrstft":
        # trained through the reconstruction, the model is level-
        # calibrated: the preset's x3 serving gain and 0.9 state decay
        # compensate the reference weights' under-suppression
        # (server.py:213-214) and would mis-level this checkpoint
        cfg = dataclasses.replace(cfg, serving=dataclasses.replace(
            cfg.serving, output_gain=1.0, state_decay=1.0))
    return cfg


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = parser()
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        p.exit(1, f"{p.prog}: {e}\n")
    rank, world = 0, 1
    if args.data_parallel and not args.device_data:
        if distributed.initialize(device="cpu" if device.type == "cpu"
                                  else None):
            device = distributed.local_device()
            rank, world = dist.get_rank(), dist.get_world_size()
            if world == 1:
                distributed.shutdown()
        elif device_count(device) > 1:
            return spawn_workers(argv, device_count(device))
    if rank:                # rank 0 alone prints
        with open(os.devnull, "w") as quiet, \
                contextlib.redirect_stdout(quiet):
            return _train(args, p, device, rank, world)
    return _train(args, p, device, rank, world)


def _train(args, p, device: torch.device, rank: int, world: int) -> int:
    cfg = resolve_config(args, p)
    model = build_model(cfg.model, num_bins=cfg.dsp.n_mels)
    if args.resume:
        ctx = TrainingContext.load(args.resume, cfg, model, device=device)
        print(f"resumed at iter {ctx.total_iters}")
    else:
        ctx = TrainingContext(cfg, model, seed=cfg.train.seed, device=device)

    clean, noise = find_corpus(args.data)
    if not clean:
        p.error(f"no WAV files under {args.data}")
    from audio_denoising_torch.io.codec import list_decodable_audio

    if args.device_data:
        from audio_denoising_torch.train.device_data import DeviceCorpus
        corpus = DeviceCorpus.from_paths(clean, cfg.dsp.sample_rate,
                                         device=device)
        print(f"device corpus: {len(corpus)} samples "
              f"({len(corpus) / cfg.dsp.sample_rate:.0f}s)")
        noise_all = list(noise)        # already decodability-filtered
        if args.noise_dir:
            noise_all += list_decodable_audio(args.noise_dir)
        noise_corpus = None
        if noise_all:
            noise_corpus = DeviceCorpus.from_paths(
                noise_all, cfg.dsp.sample_rate, device=device)
            print(f"device noise corpus: {len(noise_corpus)} samples")
        ctx.fit_on_device(corpus, iters=args.iters,
                          log_every=args.log_every,
                          noise_corpus=noise_corpus,
                          noise_gain=tuple(args.noise_gain))
        ctx.save(args.save)
        print(f"saved {args.save} at iter {ctx.total_iters}")
        return 0

    if args.noise_dir:
        noise = list(noise) + list_decodable_audio(args.noise_dir)
    from audio_denoising_torch.io.cache import AudioCache
    # a single-rate clean corpus (as evaluate.py keeps): noise resampled
    # to the first file's rate would pitch-shift against the others
    src_sr = AudioCache.probe_rate(clean[0])
    kept = [c for c in clean if AudioCache.probe_rate(c) == src_sr]
    if len(kept) != len(clean):
        print(f"clean corpus: keeping {len(kept)}/{len(clean)} files at "
              f"{src_sr} Hz (mixed-rate corpus; others dropped)")
    sampler = MixtureSampler(kept, noise,
                             crop_samples=cfg.train.crop_samples,
                             batch_size=cfg.train.batch_size,
                             noise_gain=tuple(args.noise_gain),
                             seed=cfg.train.seed, sample_rate=src_sr)
    if world > 1:
        fit_data_parallel(ctx, sampler, args, rank, world)
        if rank:
            return 0
    else:
        ctx.fit(sampler, iters=args.iters, eval_every=args.eval_every,
                log_every=args.log_every)
    ctx.save(args.save)
    print(f"saved {args.save} at iter {ctx.total_iters} "
          f"(best eval: {ctx.best_eval_loss})")
    return 0


def fit_data_parallel(ctx: TrainingContext, sampler, args, rank: int,
                      world: int) -> None:
    """``args.iters`` data-parallel steps on the sampler's global batches
    (the same on every rank), then the group is left; rank 0 logs."""
    step = make_sharded_train_step(ctx, distributed.global_mesh())
    if rank == 0:
        print(f"data-parallel over {world} ranks", flush=True)
    try:
        for i, (mixture, clean) in enumerate(sampler):
            if i >= args.iters:
                break
            loss = float(step(mixture, clean))
            ctx.total_iters += 1
            ctx.train_loss_record[ctx.total_iters] = loss
            if rank == 0 and args.log_every and (i + 1) % args.log_every == 0:
                print(f"iter {ctx.total_iters}: train "
                      f"{ctx.cfg.train.loss_metric_train}={loss:.5f}",
                      flush=True)
    finally:
        distributed.shutdown()

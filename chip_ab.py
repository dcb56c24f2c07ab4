#!/usr/bin/env python3
"""Compare this checkout's kernels with another source of them on one
NVIDIA card.

    python3 chip_ab.py [--kernel webrtc_hop|fused_cell|fused_hop]
                       [--batches 64,128,256] OTHER_CSRC_DIR

``OTHER_CSRC_DIR`` holds another ``<kernel>.cu`` with the same C
interface and argument struct (with the headers it includes), for example
an earlier commit's ``audio_denoising_torch/csrc`` unpacked with
``git archive``, or a copy with one text change. Both are built with the
same nvcc flags (their ptxas register and spill lines printed) and bound
to the same wrappers.

``--kernel webrtc_hop`` (the default), on gruunet2-dari_tult with
warm-start Griffin-Lim at 256 streams:

1. both run from one random state on the same chunks: the single hop at
   GL-32 over 3 hops, and one K-hop call (K = 25) at GL-8 and at GL-32;
   the largest difference on every output and plane is printed (0 when
   the two sources compute the same arithmetic);
2. both are timed in turns, other, this, this, other: the single hop at
   GL-32 (CUDA events over 50 hops, and torch.profiler's time per
   kernel), and the K-hop call per hop at GL-8 and GL-32 (CUDA events
   over 5 calls);
3. this checkout's Griffin-Lim launch by rounds: its profiler time in
   the single hop at GL-0, GL-8 and GL-32, and from them the time per
   round and the time outside the rounds.

``--kernel fused_cell`` (gruunet2-good's plan) and ``--kernel fused_hop``
(gruunet2-stream16k, ungated):

1. both run on one random state (and, for the hop, the same chunks):
   the cell step at 256 streams, the single hop over 3 hops and one K-hop
   call (K = 50); the largest difference on every output and plane;
2. both are timed in turns, other, this, this, other, at each of
   ``--batches`` streams (default 256): the cell step, or the single hop
   (CUDA events over 200 launches); for the hop also the K-hop call per
   hop at K = 50 at the largest batch (CUDA events over 5 calls).

``OTHER_CSRC_DIR`` inside an earlier commit's ``audio_denoising_torch``
tree (``git archive`` of the package) brings that tree's own wrappers for
the fused kernels, so the two C interfaces may differ; a bare source
directory is bound to this checkout's wrappers. For the fused cell,
``--cluster C`` launches each side that has a weight ring on clusters of
C blocks, ``--stage-bytes N`` sizes the ring's stages at about N bytes,
and ``--other-tile T`` lays a bare other source's ring out for T streams
a block (a variant that changes kTile). The card's name and power limit
come first. Without a card it fails.
"""

import os
import subprocess
import sys

import chip_smoke as cs

TURNS = ("other", "this", "this", "other")
SINGLE_HOPS = 3
TIMED_SINGLE = 50
TIMED_MULTI = 5
GL_ROUNDS = (0, 8, 32)


KERNELS = ("webrtc_hop", "fused_cell", "fused_hop")
FUSED_TIMED = 200
FUSED_K = 50


def build_other(csrc, kernel):
    """Starts nvcc on ``csrc``/``kernel``.cu; returns (process, library
    path)."""
    from audio_denoising_torch.ops.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"lib{kernel}-other.so"
    proc = subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
         os.path.join(csrc, f"{kernel}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def ptxas_lines(label, log):
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry",
                                   "Function properties")):
            cs.say(f"  ptxas ({label}): {line.strip()}")


def bound(hop, lib):
    hop._bind(lib)
    return hop


def main() -> int:
    import argparse
    import ctypes

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", metavar="OTHER_CSRC_DIR")
    ap.add_argument("--kernel", choices=KERNELS, default="webrtc_hop")
    ap.add_argument("--batches", default=str(cs.SLOTS),
                    help="streams to time the fused kernels at, "
                         "comma-separated")
    ap.add_argument("--cluster", type=int, default=None,
                    help="blocks per cluster of the fused cell's weight "
                         "ring, on each side that has one")
    ap.add_argument("--stage-bytes", type=int, default=None,
                    help="bytes a stage of the fused cell's weight ring "
                         "aims at (weight_ring.STAGE_TARGET)")
    ap.add_argument("--other-tile", type=int, default=None,
                    help="streams per block (kTile) of a bare other "
                         "source that changes it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    from audio_denoising_torch.ops.kernels.build import load_kernel_library

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    cs.say(smi)
    if args.kernel != "webrtc_hop":
        from audio_denoising_torch.ops.kernels import weight_ring
        if args.stage_bytes is not None:
            weight_ring.STAGE_TARGET = args.stage_bytes
        batches = [int(b) for b in args.batches.split(",")]
        makers = fused_makers(args.other, args.kernel, args.other_tile)
        return fused_ab(torch, args.kernel, makers, smi, batches,
                        args.cluster, args.other_tile)
    proc, other_path = build_other(args.other, args.kernel)
    this = load_kernel_library(args.kernel)
    log = proc.communicate(timeout=600)[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {args.other}:\n{log}")
    ptxas_lines("this", this.log)
    ptxas_lines("other", log)
    libs = {"this": this.lib, "other": ctypes.CDLL(str(other_path))}
    return webrtc_ab(torch, libs, smi)


def fused_makers(csrc, kernel, other_tile=None):
    """{"this", "other"}: makers of ``kernel``'s wrapper (make_fused_cell
    or make_fused_hop) on each source, built, their ptxas lines printed.
    Where ``csrc`` lies in a package tree with wrappers of its own (an
    earlier commit's ``audio_denoising_torch``, whose C interface may
    differ), the other side is that tree's wrapper, imported from a copy
    renamed ``adt_other`` and built from its own sources; a bare source
    directory is bound to this checkout's wrapper, with its ring laid out
    for ``other_tile`` streams a block where given."""
    import ctypes
    import importlib
    import shutil
    from pathlib import Path

    from audio_denoising_torch.ops.kernels import build
    maker = "make_" + kernel
    this_mod = importlib.import_module(
        f"audio_denoising_torch.ops.kernels.{kernel}")
    pkg = Path(csrc).resolve().parent
    if (pkg / "ops" / "kernels" / f"{kernel}.py").exists():
        root = build.BUILD_DIR / "other_package"
        shutil.rmtree(root, ignore_errors=True)
        dst = root / "adt_other"
        shutil.copytree(pkg, dst, ignore=shutil.ignore_patterns(
            "build", "__pycache__"))
        for py in dst.rglob("*.py"):
            py.write_text(py.read_text().replace("audio_denoising_torch",
                                                 "adt_other"))
        sys.path.insert(0, str(root))
        other_build = importlib.import_module("adt_other.ops.kernels.build")
        this, other = (b.load_kernel_library(kernel)
                       for b in (build, other_build))
        ptxas_lines("this", this.log)
        ptxas_lines("other", other.log)
        other_mod = importlib.import_module(f"adt_other.ops.kernels.{kernel}")
        return {"this": getattr(this_mod, maker),
                "other": getattr(other_mod, maker)}
    proc, other_path = build_other(csrc, kernel)
    this = build.load_kernel_library(kernel)
    log = proc.communicate(timeout=600)[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc}:\n{log}")
    ptxas_lines("this", this.log)
    ptxas_lines("other", log)
    lib = ctypes.CDLL(str(other_path))

    def other(*args, **kwargs):
        from audio_denoising_torch.ops.kernels import weight_ring
        obj = getattr(this_mod, maker)(*args, **kwargs)
        tile = weight_ring.KTILE
        weight_ring.KTILE = other_tile or tile
        try:
            obj._bind(lib)
        finally:
            weight_ring.KTILE = tile
        return obj

    return {"this": getattr(this_mod, maker), "other": other}


def fused_ab(torch, kernel, makers, smi, batches, cluster, other_tile):
    """Parts 1 and 2 for ``fused_cell`` or ``fused_hop`` (module
    docstring)."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state)
    from audio_denoising_torch.runtime.plan import build_cell_plan

    def make(name, *args, **kwargs):
        obj = makers[name](*args, **kwargs)
        if cluster is not None and getattr(obj, "ring", None) is not None:
            obj._base_args.ring.cluster = cluster
        return obj

    B = max(batches)
    if kernel == "fused_cell":
        plan = build_cell_plan(load_pretrained("gruunet2-good")[1])
        cells = {n: make(n, plan, "cuda") for n in makers}
        c = cells["this"]
        for n, cell in cells.items():
            if getattr(cell, "ring", None) is not None:
                r, a = cell.ring, cell._base_args.ring
                tile = other_tile if n == "other" and other_tile else 2
                blocks = -(-B // tile)
                cs.say(f"  {n}: weight ring C {a.cluster}, {r.stages} stages "
                       f"of {r.stage_bytes} B, {len(r.slabs)} slabs; "
                       f"{cell.max_active_clusters(blocks)} clusters fit "
                       f"for {blocks} blocks")
        cs.say(f"1. this against other on one random state (B={B}):")
        x, hx, _ = cs.cell_inputs(torch, B, c.n_feat, c.n, 7)
        (y_a, h_a), (y_b, h_b) = (cells[n](x, hx) for n in ("this", "other"))
        cs.say(f"  cell step: y {cs.max_err(y_a, y_b):.3e}, hx' "
               f"{cs.max_err(h_a, h_b):.3e}")
        cs.say(f"2. times in turns {', '.join(TURNS)} ({smi}):")
        for b in batches:
            x, hx, _ = cs.cell_inputs(torch, b, c.n_feat, c.n, 7)
            for turn in TURNS:
                ms = cs.time_launches(torch, lambda: cells[turn](x, hx),
                                      FUSED_TIMED)
                cs.say(f"  B={b} {turn}: cell step {ms * 1e3:.1f} us")
        return 0

    cfg, model = load_pretrained("gruunet2-stream16k")
    plan = build_cell_plan(model)
    single = {n: make(n, cfg, plan, "cuda") for n in makers}
    multi = {n: make(n, cfg, plan, "cuda", hops_per_call=FUSED_K)
             for n in makers}
    init = lambda b: fused_hop_init_state(cfg, plan, b, "cuda")
    g = torch.Generator(device="cuda").manual_seed(23)
    state, _ = cs.hop_inputs(torch, single["this"], init, B)
    chunks = 0.1 * torch.randn((FUSED_K, B, single["this"].hop),
                               generator=g, device="cuda")
    cs.say(f"1. this against other from one state, the same chunks (B={B}):")
    runs = {n: cs.run_hops(h, state, chunks[:SINGLE_HOPS])
            for n, h in single.items()}
    (s_a, o_a), (s_b, o_b) = runs["this"], runs["other"]
    diff = {k: cs.max_err(v, getattr(s_b, k))
            for k, v in cs.planes(s_a).items()}
    diff["out"] = max(cs.max_err(a, b) for a, b in zip(o_a, o_b))
    cs.say(f"  single hop, {SINGLE_HOPS} hops: {cs.fmt(diff)}")
    (s_a, o_a), (s_b, o_b) = (multi[n](state, chunks)
                              for n in ("this", "other"))
    diff = {k: cs.max_err(v, getattr(s_b, k))
            for k, v in cs.planes(s_a).items()}
    diff["out"] = cs.max_err(o_a, o_b)
    cs.say(f"  K-hop call, K={FUSED_K}: {cs.fmt(diff)}")
    cs.say(f"2. times in turns {', '.join(TURNS)} ({smi}):")
    for b in batches:
        s_b, _ = cs.hop_inputs(torch, single["this"], init, b)
        for turn in TURNS:
            h = single[turn]
            ms = cs.time_launches(torch, lambda: h(s_b, chunks[0, :b]),
                                  FUSED_TIMED)
            cs.say(f"  B={b} {turn}: single hop {ms * 1e3:.1f} us/hop")
    for turn in TURNS:
        m = multi[turn]
        ms = cs.time_launches(torch, lambda: m(state, chunks), TIMED_MULTI)
        cs.say(f"  B={B} {turn}: K-hop K={FUSED_K} {ms * 1e3:.1f} us/call, "
               f"{ms * 1e3 / FUSED_K:.2f} us/hop")
    return 0


def webrtc_ab(torch, libs, smi):
    """Parts 1-3 for ``webrtc_hop`` (module docstring)."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    from audio_denoising_torch.runtime.plan import build_cell_plan

    for name in ("adt_webrtc_hop_fft_instance", "adt_webrtc_hop_fft_radices"):
        if not hasattr(libs["other"], name):   # an older source: report -1
            setattr(libs["other"], name, lambda *args: -1)
    cfg, model = load_pretrained("gruunet2-dari_tult")
    plan = build_cell_plan(model)
    g = torch.Generator(device="cuda").manual_seed(23)

    def hop_pair(n_iter, K):
        c = cs.warm_cfg(cfg, n_iter)
        return c, {name: bound(make_webrtc_hop(c, plan, "cuda",
                                               hops_per_call=K), lib)
                   for name, lib in libs.items()}

    single_cfg, single = hop_pair(32, 1)
    state, _ = cs.hop_inputs(
        torch, single["this"],
        lambda b: webrtc_hop_init_state(single_cfg, plan, b, "cuda"),
        cs.SLOTS)
    chunks = 0.2 * torch.randn((cs.WEBRTC_K, cs.SLOTS, single["this"].hop),
                               generator=g, device="cuda")
    multis = {n: hop_pair(n, cs.WEBRTC_K)[1] for n in cs.WEBRTC_GL}
    cs.say(f"FFT instantiation: this M={single['this'].fft_instance}")

    cs.say("1. this against other from one state, the same chunks "
           f"(B={cs.SLOTS}):")
    runs = {name: cs.run_hops(h, state, chunks[:SINGLE_HOPS])
            for name, h in single.items()}
    (s_a, o_a), (s_b, o_b) = runs["this"], runs["other"]
    diff = {k: cs.max_err(v, getattr(s_b, k))
            for k, v in cs.planes(s_a).items()}
    diff["out"] = max(cs.max_err(a, b) for a, b in zip(o_a, o_b))
    cs.say(f"  single hop, GL-32, {SINGLE_HOPS} hops: {cs.fmt(diff)}")
    for n, pair in multis.items():
        (s_a, o_a), (s_b, o_b) = (pair[k](state, chunks)
                                  for k in ("this", "other"))
        diff = {k: cs.max_err(v, getattr(s_b, k))
                for k, v in cs.planes(s_a).items()}
        diff["out"] = cs.max_err(o_a, o_b)
        cs.say(f"  K-hop call, GL-{n}, K={cs.WEBRTC_K}: {cs.fmt(diff)}")

    cs.say(f"2. times in turns {', '.join(TURNS)} ({smi}):")
    for turn in TURNS:
        h = single[turn]
        ms = cs.time_launches(torch, lambda: h(state, chunks[0]),
                              TIMED_SINGLE)
        cs.say(f"  {turn}: single hop GL-32 {ms * 1e3:.1f} us/hop")
        cs.print_breakdown(cs.device_breakdown(
            torch, lambda: h(state, chunks[0]), 20), "hop")
        for n, pair in multis.items():
            m = pair[turn]
            ms = cs.time_launches(torch, lambda: m(state, chunks),
                                  TIMED_MULTI)
            cs.say(f"  {turn}: K-hop GL-{n} {ms * 1e3:.1f} us/call, "
                   f"{ms * 1e3 / cs.WEBRTC_K:.2f} us/hop")

    cs.say(f"3. this checkout's GL launch by rounds ({smi}):")
    gl = {}
    for n in GL_ROUNDS:
        h = hop_pair(n, 1)[1]["this"]
        rows = cs.device_breakdown(torch, lambda: h(state, chunks[0]), 20)
        gl[n] = sum(us for name, us in rows.items() if "gl_kernel" in name)
        cs.say(f"  GL-{n}: the GL launch {gl[n]:.1f} us/hop")
    lo, hi = GL_ROUNDS[0], GL_ROUNDS[-1]
    per_round = (gl[hi] - gl[lo]) / (hi - lo)
    cs.say(f"  {per_round:.2f} us per round; {gl[lo]:.1f} us outside the "
           f"rounds (inverse mel, seed, the last inverse STFT, output)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

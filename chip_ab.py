#!/usr/bin/env python3
"""Compare this checkout's kernels with another source of them on one
NVIDIA card.

    python3 chip_ab.py [--kernel webrtc_hop|fused_cell|fused_hop]
                       [--batches 64,128,256] OTHER_CSRC_DIR

``OTHER_CSRC_DIR`` holds another ``<kernel>.cu`` with the same C
interface and argument struct (with the headers it includes), for example
an earlier commit's ``audio_denoising_torch/csrc`` unpacked with
``git archive``, or a copy with one text change. Both are built with the
same nvcc flags (their ptxas register, stack frame and spill lines
printed) and bound to the same wrappers.

``--kernel webrtc_hop`` (the default), on gruunet2-dari_tult with
warm-start Griffin-Lim at 256 streams (at its n_fft 1536, or at
``--n-fft N`` with hop N / 2: 640 runs the M = 0 instantiation, passes
8 x 8 x 5; 882 the compiled-in M = 441, 9 x 7 x 7), in fp32 and then in
the bf16 GL mode:

1. both run from one random state on the same chunks: the single hop at
   GL-32 over 3 hops, and one K-hop call (K = 25) at GL-8 and at GL-32;
   the largest difference on every output and plane is printed (0 when
   the two sources compute the same arithmetic);
2. both are timed in turns, other, this, this, other: the single hop at
   GL-32 (CUDA events over 50 hops, and torch.profiler's time per
   launch, the mean over its events; the cell launch's on a line of its
   own and per turn at the end), and the K-hop call per hop at GL-8 and
   GL-32 (CUDA events over 5 calls);
3. both Griffin-Lim launches by rounds, in turns: each one's profiler
   time in the single hop at GL-0, GL-8 and GL-32, and from them the
   time per round and the time outside the rounds.

``--kernel fused_cell`` (gruunet2-good's plan):

1. both run on one random state: the cell step at 256 streams; the
   largest difference on every output and plane;
2. both are timed in turns, other, this, this, other, at each of
   ``--batches`` streams (default 256): the cell step (CUDA events over
   200 launches).

``--kernel fused_hop``, on gruunet2-stream16k, gruunet2-good (n_fft
1024), bench.py's quality flagship (runs/gruunet2mel128w64-mrstft-50k.npz)
and MOMO3 (momo3-4d4ea0), each in fp32, bf16 and int8, ungated and with
the tuned gate ('both'):

1. both run from a fresh state on the same voiced chunks at the largest
   batch: the single hop over 3 hops, then one K-hop call (K = 50) from
   the state they reached; the largest difference on every output and
   plane (a configuration the other side cannot build, its shared memory
   per block over the card's, is named and skipped);
2. both are timed in turns, other, this, this, other, in each of those
   configurations at the largest batch: the single hop (CUDA events over
   200 launches, 20 on the flagship) and the K-hop call per hop (5 calls,
   2 on the flagship); and the ungated fp32 single hop on stream16k at
   each of ``--batches`` streams.

``OTHER_CSRC_DIR`` inside an earlier commit's ``audio_denoising_torch``
tree (``git archive`` of the package) brings that tree's own wrappers for
each kernel, so the two C interfaces may differ; a bare source directory
is bound to this checkout's wrappers. For the fused cell,
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


def main() -> int:
    import argparse

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
    ap.add_argument("--n-fft", type=int, default=None,
                    help="the WebRTC hop's n_fft (hop n_fft / 2) in place "
                         "of gruunet2-dari_tult's")
    ap.add_argument("--other-tile", type=int, default=None,
                    help="streams per block (kTile) of a bare other "
                         "source that changes it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    cs.say(smi)
    makers = kernel_makers(args.other, args.kernel, args.other_tile)
    if args.kernel == "webrtc_hop":
        return webrtc_ab(torch, makers, smi, args.n_fft)
    from audio_denoising_torch.ops.kernels import weight_ring
    if args.stage_bytes is not None:
        weight_ring.STAGE_TARGET = args.stage_bytes
    batches = [int(b) for b in args.batches.split(",")]
    if args.kernel == "fused_hop":
        return fused_hop_ab(torch, makers, smi, batches)
    return fused_ab(torch, makers, smi, batches, args.cluster,
                    args.other_tile)


def kernel_makers(csrc, kernel, other_tile=None):
    """{"this", "other"}: makers of ``kernel``'s wrapper (make_fused_cell,
    make_fused_hop or make_webrtc_hop) on each source, built, their ptxas
    lines printed.
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


def fused_ab(torch, makers, smi, batches, cluster, other_tile):
    """Parts 1 and 2 for ``fused_cell`` (module docstring)."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.runtime.plan import build_cell_plan

    def make(name, *args, **kwargs):
        obj = makers[name](*args, **kwargs)
        if cluster is not None and getattr(obj, "ring", None) is not None:
            obj._base_args.ring.cluster = cluster
        return obj

    B = max(batches)
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


def hop_configs():
    """(label, cfg, plan) of the fused hop's configurations: each model in
    each compute mode, ungated and with the tuned gate."""
    import torch

    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.runtime.plan import build_cell_plan
    for spec in (cs.S16K, "gruunet2-good",
                 os.path.join(cs.REPO, "runs", cs.FLAGSHIP), cs.MOMO_SPEC):
        cfg, model = load_pretrained(spec)
        plan = build_cell_plan(model)
        for gated in (False, True):
            c = cs.tuned_gate(cfg) if gated else cfg
            for dtype in ("float32",) + cs.REDUCED:
                label = (f"{os.path.basename(spec)}, {dtype}, "
                         f"{'tuned gate' if gated else 'ungated'}")
                yield label, c, plan, getattr(torch, dtype)


def fused_hop_ab(torch, makers, smi, batches):
    """Parts 1 and 2 for ``fused_hop`` (module docstring)."""
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state)
    B = max(batches)
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    pairs = []
    cs.say(f"1. this against other from a fresh state, the same chunks "
           f"(B={B}):")
    for label, cfg, plan, dt in hop_configs():
        hops = {}
        for name, maker in makers.items():
            try:
                hops[name] = (maker(cfg, plan, "cuda", compute_dtype=dt),
                              maker(cfg, plan, "cuda", hops_per_call=FUSED_K,
                                    compute_dtype=dt))
            except RuntimeError as e:
                if "shared memory per block" not in str(e):
                    raise
                cs.say(f"  {label}: {name} cannot be built ({e}); skipped")
        if len(hops) < 2:
            continue
        if hops["this"][0].smem_bytes > limit:
            raise AssertionError(f"{label}: this checkout over the limit")
        chunks = torch.from_numpy(cs.voiced_chunks(
            B, FUSED_K, cfg.dsp.hop_length, cfg.dsp.sample_rate,
            23)).cuda()
        state = fused_hop_init_state(cfg, plan, B, "cuda")
        runs = {n: cs.run_hops(h[0], state, chunks[:SINGLE_HOPS])
                for n, h in hops.items()}
        (s_a, o_a), (s_b, o_b) = runs["this"], runs["other"]
        diff = {k: cs.max_err(v, getattr(s_b, k))
                for k, v in cs.planes(s_a).items()}
        diff["out"] = max(cs.max_err(a, b) for a, b in zip(o_a, o_b))
        (m_a, mo_a), (m_b, mo_b) = (hops[n][1](s_a, chunks)
                                    for n in ("this", "other"))
        mdiff = {k: cs.max_err(v, getattr(m_b, k))
                 for k, v in cs.planes(m_a).items()}
        mdiff["out"] = cs.max_err(mo_a, mo_b)
        cs.say(f"  {label}: single hop, {SINGLE_HOPS} hops: {cs.fmt(diff)}; "
               f"then K-hop call, K={FUSED_K}: {cs.fmt(mdiff)}")
        pairs.append((label, cfg, plan, hops, s_a, chunks))
    cs.say(f"2. times in turns {', '.join(TURNS)} ({smi}):")
    for label, cfg, plan, hops, state, chunks in pairs:
        wide = cfg.dsp.n_mels > 64
        times = []
        for turn in TURNS:
            single, multi = hops[turn]
            ms = cs.time_launches(torch, lambda: single(state, chunks[0]),
                                  20 if wide else FUSED_TIMED)
            mk = cs.time_launches(torch, lambda: multi(state, chunks),
                                  2 if wide else TIMED_MULTI)
            times.append(f"{turn} {ms * 1e3:.1f} / "
                         f"{mk * 1e3 / FUSED_K:.2f}")
        cs.say(f"  {label}, B={B}, single hop / K-hop per hop (us): "
               + "; ".join(times))
    s16 = next(p for p in pairs if p[0].startswith(cs.S16K)
               and "float32, ungated" in p[0])
    _, cfg, plan, hops, _, chunks = s16
    for b in batches:
        s_b, _ = cs.hop_inputs(torch, hops["this"][0],
                               lambda n: fused_hop_init_state(cfg, plan, n,
                                                              "cuda"), b)
        for turn in TURNS:
            h = hops[turn][0]
            ms = cs.time_launches(torch, lambda: h(s_b, chunks[0, :b]),
                                  FUSED_TIMED)
            cs.say(f"  {s16[0]}, B={b} {turn}: single hop "
                   f"{ms * 1e3:.1f} us/hop")
    return 0


def webrtc_ab(torch, makers, smi, n_fft=None):
    """Parts 1-3 for ``webrtc_hop`` (module docstring), in each GL mode."""
    import dataclasses

    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        webrtc_hop_init_state)
    from audio_denoising_torch.runtime.plan import build_cell_plan

    cfg, model = load_pretrained("gruunet2-dari_tult")
    if n_fft is not None:
        cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
            cfg.dsp, n_fft=n_fft, hop_length=n_fft // 2))
    plan = build_cell_plan(model)
    g = torch.Generator(device="cuda").manual_seed(23)

    def hop_pair(n_iter, K, dtype):
        c = cs.warm_cfg(cfg, n_iter)
        return {name: maker(c, plan, "cuda", hops_per_call=K,
                            compute_dtype=dtype)
                for name, maker in makers.items()}

    first = hop_pair(32, 1, torch.float32)
    state, _ = cs.hop_inputs(
        torch, first["this"],
        lambda b: webrtc_hop_init_state(cs.warm_cfg(cfg, 32), plan, b,
                                        "cuda"), cs.SLOTS)
    chunks = 0.2 * torch.randn((cs.WEBRTC_K, cs.SLOTS, first["this"].hop),
                               generator=g, device="cuda")
    cs.say(f"n_fft {first['this'].n_fft}, FFT instantiation: "
           + ", ".join(f"{n} M={h.fft_instance}" for n, h in first.items()))
    for mode, dtype in (("fp32", torch.float32),
                        ("bf16 GL", torch.bfloat16)):
        single = hop_pair(32, 1, dtype)
        multis = {n: hop_pair(n, cs.WEBRTC_K, dtype) for n in cs.WEBRTC_GL}
        cs.say(f"1. {mode}: this against other from one state, the same "
               f"chunks (B={cs.SLOTS}):")
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

        cs.say(f"2. {mode}: times in turns {', '.join(TURNS)} ({smi}):")
        cells = []
        for turn in TURNS:
            h = single[turn]
            ms = cs.time_launches(torch, lambda: h(state, chunks[0]),
                                  TIMED_SINGLE)
            cs.say(f"  {turn}: single hop GL-32 {ms * 1e3:.1f} us/hop")
            events = cs.kernel_events(torch, lambda: h(state, chunks[0]),
                                      cs.PROFILED_CALLS)
            cs.print_breakdown({name: us / k for name, (us, k)
                                in events.items()}, "launch")
            cell, k = cs.launch_us(events, "cell_kernel")
            cells.append(f"{turn} {cell:.1f}" if k else
                         f"{turn} not measured")
            cs.say(f"  {turn}: the cell launch "
                   + (f"{cell:.1f} us ({k} profiler events)" if k else
                      "not measured") + f" of the hop's {ms * 1e3:.1f} us, "
                   f"cell walk {getattr(h, 'cell_walk', None) or 'per-frame'}")
            for n, pair in multis.items():
                m = pair[turn]
                ms = cs.time_launches(torch, lambda: m(state, chunks),
                                      TIMED_MULTI)
                cs.say(f"  {turn}: K-hop GL-{n} {ms * 1e3:.1f} us/call, "
                       f"{ms * 1e3 / cs.WEBRTC_K:.2f} us/hop")
        cs.say(f"  {mode}: the cell launch in turns (us a launch, the "
               f"profiler's mean over its events): "
               + "; ".join(cells))

        cs.say(f"3. {mode}: the GL launch by rounds, in turns ({smi}):")
        by_rounds = {n: hop_pair(n, 1, dtype) for n in GL_ROUNDS}
        lo, hi = GL_ROUNDS[0], GL_ROUNDS[-1]
        for turn in TURNS:
            gl = {}
            for n, pair in by_rounds.items():
                h = pair[turn]
                gl[n] = cs.launch_us(cs.kernel_events(
                    torch, lambda: h(state, chunks[0]), cs.PROFILED_CALLS),
                    "gl_kernel")[0]
            per_round = (gl[hi] - gl[lo]) / (hi - lo)
            cs.say(f"  {turn}: the GL launch "
                   + ", ".join(f"GL-{n} {us:.1f}" for n, us in gl.items())
                   + f" us/hop; {per_round:.2f} us per round, {gl[lo]:.1f} "
                   f"us outside the rounds (inverse mel, seed, the last "
                   f"inverse STFT, output)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Compare this checkout's WebRTC-hop kernels with another source of them
on one NVIDIA card.

    python3 chip_ab.py OTHER_CSRC_DIR

``OTHER_CSRC_DIR`` holds another ``webrtc_hop.cu`` with the same C
interface and argument struct (with the headers it includes), for example
an earlier commit's ``audio_denoising_torch/csrc`` unpacked with
``git archive``. Both are built with the same nvcc flags (their ptxas
register and spill lines printed) and bound to the same wrappers, on
gruunet2-dari_tult with warm-start Griffin-Lim at 256 streams. Then:

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

The card's name and power limit come first. Without a card it fails.
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


def build_other(csrc):
    """Starts nvcc on ``csrc``/webrtc_hop.cu; returns (process, library
    path)."""
    from audio_denoising_torch.ops.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "libwebrtc_hop-other.so"
    proc = subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
         os.path.join(csrc, "webrtc_hop.cu")],
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
    import ctypes

    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops.kernels.build import load_kernel_library
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    from audio_denoising_torch.runtime.plan import build_cell_plan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    cs.say(smi)
    proc, other_path = build_other(sys.argv[1])
    this = load_kernel_library("webrtc_hop")
    log = proc.communicate(timeout=600)[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {sys.argv[1]}:\n{log}")
    ptxas_lines("this", this.log)
    ptxas_lines("other", log)
    other = ctypes.CDLL(str(other_path))
    for name in ("adt_webrtc_hop_fft_instance", "adt_webrtc_hop_fft_radices"):
        if not hasattr(other, name):   # an older source: report -1
            setattr(other, name, lambda *args: -1)
    libs = {"this": this.lib, "other": other}

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

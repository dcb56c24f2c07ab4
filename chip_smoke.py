#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``audio_denoising_torch/csrc``, then
runs five phases, each of which raises on failure (so the script exits
non-zero and prints no result):

1. the card's name and power limit, and the kernel build (nvcc's
   register and shared-memory lines, build seconds);
2. the fused-hop kernel against its plain PyTorch version on the card,
   at 256 streams and at 3 (the ragged edge), over 20 hops; then at 64
   streams on two trained checkpoints of other widths (hidden 40; 128
   mels, n_fft 1024, five levels, hidden 64);
3. ``StreamEngine`` mode ``fused`` with 256 slots and 256 streams for 50
   ticks, some streams skipping ticks, against the same run on the CPU;
4. ``EngineDaemon`` on 127.0.0.1 serving gruunet2-stream16k to 4 clients
   x 16 streams x 25 chunks, every reply within a deadline, each
   stream's output against its own sequence through the plain version on
   the CPU, and the reply latency each client sees per round;
5. CUDA-event timing at 256 streams: the kernel, its plain version, and
   the bound from the hop's operations and bytes.

Phases 3 and 4 are the main path: the fused-hop launch counters are set
to 0 just before each and read just after. The last two lines are the
``kernels`` JSON line and ``{"ok": true, "device": {...}}``. Without a
card, or outside a checkout of the repo, the script fails.
"""

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np

OUT_ATOL = 2e-4      # per-hop output, as tests/test_fused_hop.py bounds it
STATE_ATOL = 2e-5    # ring, ola and hx after 20 hops
HOPS = 20
TIMED_LAUNCHES = 200
FP32_FLOPS = 67e12   # H100 SXM fp32 FMA peak, NVIDIA data sheet
HBM_BYTES_S = 3.35e12
REPLY_DEADLINE_S = 30.0
REPO = os.path.dirname(os.path.abspath(__file__))
# trained checkpoints of other widths, held in phase 2 besides the main one
OTHER_CHECKPOINTS = ("gruunet2s16kw40-mrstft-idp-50k.npz",
                     "gruunet2mel128d5w64-mrstft-50k.npz")


def say(*parts):
    print(*parts, flush=True)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().cpu())


def run_hops(step, state, chunks):
    outs = []
    for c in chunks:
        state, out = step(state, c)
        outs.append(out)
    return state, outs


def phase_kernel_vs_plain(torch, hop, cfg, plan, batches):
    """Kernel against its plain version on the same inputs, each carrying
    its own state; returns the largest output error seen."""
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state)
    worst = 0.0
    for batch in batches:
        rng = np.random.default_rng(batch)
        chunks = [torch.from_numpy(
            (0.1 * rng.standard_normal((batch, hop.hop))).astype(np.float32)
        ).cuda() for _ in range(HOPS)]
        s_ref, o_ref = run_hops(
            hop.reference, fused_hop_init_state(cfg, plan, batch, "cuda"),
            chunks)
        s_k, o_k = run_hops(
            hop, fused_hop_init_state(cfg, plan, batch, "cuda"), chunks)
        torch.cuda.synchronize()
        e_out = max(max_err(a, b) for a, b in zip(o_k, o_ref))
        e_state = {k: max_err(getattr(s_k, k), getattr(s_ref, k))
                   for k in ("ring", "ola", "hx")}
        say(f"  B={batch:3d}: out {e_out:.3e} (bound {OUT_ATOL:g}); ring "
            f"{e_state['ring']:.3e} ola {e_state['ola']:.3e} hx "
            f"{e_state['hx']:.3e} (bound {STATE_ATOL:g})")
        if e_out > OUT_ATOL or max(e_state.values()) > STATE_ATOL:
            raise AssertionError(
                f"fused hop kernel disagrees with its plain version at "
                f"B={batch}")
        worst = max(worst, e_out)
    return worst


def phase_engine(torch, cfg, model):
    from audio_denoising_torch.runtime.engine import StreamEngine
    n, ticks = 256, 50
    gpu = StreamEngine(cfg, model, mode="fused", max_streams=n)
    cpu = StreamEngine(cfg, model, mode="fused", max_streams=n, device="cpu")
    sids = [f"s{i}" for i in range(n)]
    for sid in sids:
        gpu.add_stream(sid)
        cpu.add_stream(sid)
    rng = np.random.default_rng(3)
    worst = 0.0
    gpu.hop_step.launches = 0
    for t in range(ticks):
        chunks = {sid: (0.1 * rng.standard_normal(cfg.dsp.hop_length)
                        ).astype(np.float32)
                  for i, sid in enumerate(sids) if (7 * i + t) % 5}
        a, b = gpu.process(chunks), cpu.process(chunks)
        worst = max(worst, max(float(np.abs(a[s] - b[s]).max())
                               for s in chunks))
    launches = gpu.hop_step.launches
    st = max(max_err(x.cpu(), y) for x, y in zip(gpu.state, cpu.state))
    say(f"  {n} streams x {ticks} ticks: out {worst:.3e} (bound {OUT_ATOL:g}),"
        f" state {st:.3e} (bound {STATE_ATOL:g}); {launches} launches")
    if worst > OUT_ATOL or st > STATE_ATOL:
        raise AssertionError("engine on the card disagrees with the CPU run")
    if launches != ticks:
        raise AssertionError(f"expected {ticks} kernel launches, saw "
                             f"{launches}")
    return launches


def _client(address, cid, chunks, results, errors):
    from multiprocessing.connection import Client
    try:
        with Client(address) as conn:
            def recv():
                if not conn.poll(REPLY_DEADLINE_S):
                    raise TimeoutError(f"client {cid}: no reply within "
                                       f"{REPLY_DEADLINE_S} s")
                return conn.recv()

            sids = [f"c{cid}s{j}" for j in range(chunks.shape[0])]
            for sid in sids:
                conn.send(("open", sid))
                msg = recv()
                if msg[0] != "ok":
                    raise RuntimeError(f"open {sid}: {msg}")
            outs = {sid: [] for sid in sids}
            rounds = []
            for k in range(chunks.shape[1]):
                t0 = time.perf_counter()
                for j, sid in enumerate(sids):
                    conn.send(("chunk", sid, chunks[j, k]))
                for _ in sids:
                    msg = recv()
                    if msg[0] != "out":
                        raise RuntimeError(f"chunk: {msg}")
                    outs[msg[1]].append(msg[2])
                rounds.append(time.perf_counter() - t0)
            results[("round_s", cid)] = rounds
            if cid == 0:
                conn.send(("stats",))
                results["stats"] = recv()[1]
            for sid in sids:
                conn.send(("close", sid))
                msg = recv()
                if msg[0] != "ok":
                    raise RuntimeError(f"close {sid}: {msg}")
            results[cid] = np.stack([np.stack(outs[s]) for s in sids])
    except Exception as e:   # reported by the main thread, which raises
        errors.append(f"client {cid}: {e!r}")


def phase_daemon(torch):
    from audio_denoising_torch.apps.engine_serve import EngineDaemon
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    clients, streams, n_chunks = 4, 16, 25
    daemon = EngineDaemon("gruunet2-stream16k", max_streams=256,
                          address=("127.0.0.1", 0))
    hop_len = daemon.cfg.dsp.hop_length
    rng = np.random.default_rng(4)
    data = (0.1 * rng.standard_normal(
        (clients, streams, n_chunks, hop_len))).astype(np.float32)
    server = threading.Thread(target=daemon.serve_forever, daemon=True)
    results, errors, threads = {}, [], []
    server.start()
    try:
        if not daemon.listening.wait(60):
            raise TimeoutError("daemon did not start listening")
        daemon.engine.hop_step.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=_client, args=(
            daemon.address, c, data[c], results, errors), daemon=True)
            for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(REPLY_DEADLINE_S * (n_chunks + 4))
        wall = time.perf_counter() - t0
        launches = daemon.engine.hop_step.launches
    finally:
        daemon.stop()
        server.join(10)
    if any(t.is_alive() for t in threads) or server.is_alive():
        raise TimeoutError("a client or the daemon did not finish")
    if errors:
        raise RuntimeError("; ".join(errors))
    say(f"  stats: {json.dumps(results['stats'])}")
    got = np.concatenate([results[c] for c in range(clients)])
    ref_hop = make_fused_hop(daemon.cfg, daemon.engine.plan, "cpu")
    state = fused_hop_init_state(daemon.cfg, daemon.engine.plan,
                                 clients * streams)
    seqs = data.reshape(clients * streams, n_chunks, hop_len)
    want = []
    for k in range(n_chunks):
        state, out = ref_hop(state, torch.from_numpy(seqs[:, k].copy()))
        want.append(out.numpy())
    err = float(np.abs(got - np.stack(want, axis=1)).max())
    rounds = np.concatenate([results[("round_s", c)] for c in range(clients)])
    p50, p99 = np.percentile(rounds, [50, 99]) * 1e3
    say(f"  {clients} clients x {streams} streams x {n_chunks} chunks in "
        f"{wall:.2f} s: out {err:.3e} (bound {OUT_ATOL:g}); {launches} "
        f"launches; reply latency per round (a client's {streams} chunks "
        f"sent to its {streams} replies in) p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms over {rounds.size} rounds")
    if err > OUT_ATOL:
        raise AssertionError("daemon output disagrees with the plain version")
    if launches <= 0:
        raise AssertionError("the daemon never launched the kernel")
    return launches


def time_launches(torch, fn, n):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def hop_work(hop, batch):
    """(flops, bytes) one hop needs: 2 per multiply-add of the mel pair
    and the plan cell's matmuls, the transform and its inverse at the cost
    of a real FFT of n_fft points (2.5 N log2 N each), and each input read
    and output written once (no DFT matrices). The kernel itself takes
    the transforms as dense matmuls, about twice this work."""
    macs = 2 * hop.F * hop.M + sum(w.numel() for w in hop.weights
                                   if w.dim() == 2)
    ffts = 2 * 2.5 * hop.n_fft * math.log2(hop.n_fft)
    weights = (sum(w.numel() for w in hop.weights)
               + sum(t.numel() for t in (hop.mel, hop.imel, hop.win,
                                         hop.env)))
    per_stream = 2 * 2 * hop.n_fft + 2 * hop.n + 2 * hop.hop
    return batch * (2 * macs + ffts), 4 * (batch * per_stream + weights)


def phase_timing(torch, hop, cfg, plan):
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state)
    batch = 256
    g = torch.Generator(device="cuda").manual_seed(5)
    state = fused_hop_init_state(cfg, plan, batch, "cuda")
    state = type(state)(*(0.1 * torch.randn(t.shape, generator=g,
                                            device="cuda") for t in state))
    chunk = 0.1 * torch.randn((batch, hop.hop), generator=g, device="cuda")
    ms = time_launches(torch, lambda: hop(state, chunk), TIMED_LAUNCHES)
    plain_ms = time_launches(torch, lambda: hop.reference(state, chunk),
                             TIMED_LAUNCHES)
    flops, nbytes = hop_work(hop, batch)
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    say(f"  B={batch}: kernel {ms * 1e3:.1f} us/hop, plain "
        f"{plain_ms * 1e3:.1f} us/hop; bound {bound_ms * 1e3:.2f} us "
        f"({flops / 1e6:.1f} MFLOP -> {t_ops * 1e3:.2f} us, "
        f"{nbytes / 1e6:.2f} MB -> {t_bytes * 1e3:.2f} us); kernel at "
        f"{bound_ms / ms:.1%} of the bound")
    return ms, plain_ms, bound_ms, ("operations" if t_ops >= t_bytes
                                    else "bytes")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops.kernels.build import load_kernel_library
    from audio_denoising_torch.ops.kernels.fused_hop import make_fused_hop
    from audio_denoising_torch.runtime.plan import build_cell_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    say("phase 1: card and build")
    say(smi)
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    built = load_kernel_library("fused_hop")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            say("  ptxas: " + line.strip())
    say(f"  built {built.path} in {built.seconds:.1f} s")

    cfg, model = load_pretrained("gruunet2-stream16k")
    plan = build_cell_plan(model)
    hop = make_fused_hop(cfg, plan, "cuda")
    say("phase 2: fused hop kernel vs its plain version on the card")
    err = phase_kernel_vs_plain(torch, hop, cfg, plan, (256, 3))
    for name in OTHER_CHECKPOINTS:
        other_cfg, other = load_pretrained(os.path.join(REPO, "runs", name))
        other_plan = build_cell_plan(other)
        say(f"  {name}: n_fft {other_cfg.dsp.n_fft}, {other_cfg.dsp.n_mels} "
            f"mels, hidden {other_cfg.model.hidden_sizes}")
        phase_kernel_vs_plain(
            torch, make_fused_hop(other_cfg, other_plan, "cuda"), other_cfg,
            other_plan, (64,))
    say("phase 3: StreamEngine mode fused, 256 slots, card vs CPU")
    launches = phase_engine(torch, cfg, model)
    say("phase 4: EngineDaemon on 127.0.0.1")
    launches += phase_daemon(torch)
    say("phase 5: timing")
    ms, plain_ms, bound_ms, bound_by = phase_timing(torch, hop, cfg, plan)

    say(json.dumps({"kernels": [{
        "name": "fused_hop", "route": "cuda",
        "source": "audio_denoising_torch/csrc/fused_hop.cu",
        "replaces": "audio_denoising_tpu/ops/pallas/fused_hop.py:242",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``audio_denoising_torch/csrc`` (one
nvcc per source, all at once), then runs these phases, each of which
raises on failure (so the script exits non-zero and prints no result):

1. the card's name and power limit, and the kernel builds (nvcc's
   register and shared-memory lines, build seconds); the fused cell's
   weight ring on gruunet2-good: tile, cluster size, stages, slab bytes,
   and how many clusters of the 128-block grid the card holds at once;
2. the fused-hop kernel against its plain PyTorch version on the card,
   at 256 streams and at 3 (the ragged edge), over 20 hops; then at 64
   streams on two trained checkpoints of other widths (hidden 40; 128
   mels, n_fft 1024, five levels, hidden 64);
3. the WebRTC-hop kernels against their plain version on the card (each
   check names the FFT instantiation that ran, M = n_fft / 2 compiled in
   or M = 0 for the geometry read at run time), after the kernels' FFT
   pass radices against ``fft_radices``, on
   gruunet2-dari_tult with warm-start Griffin-Lim at 256 streams and at
   3: with no GL round, each carrying its own state over 6 hops (every
   surface exact); with the configured 32 rounds, every hop taken from
   the plain version's state (the frame added to the OLA buffer against
   the plain version and a float64 witness, each stream's spectral
   convergence, hx), and so with 4 rounds at 64 streams over 40 hops;
   with 32 rounds, each carrying its own state (hx, two kernel runs
   bit-identical; the waveform SNR of every pair of versions printed);
   then GL-32 and GL-4 at the JAX tests' small geometry, each carrying
   its own state, waveform held; GL-4 at n_fft 96 (the M = 0
   instantiation, chaotic there), each hop from the plain version's
   state; the 128-mel checkpoint of phase 2 with no GL round (its shared
   memory for one hop and for K hops printed);
4. ``StreamEngine`` mode ``fused`` with 256 slots and 256 streams for 50
   ticks, some streams skipping ticks, against the same run on the CPU;
5. ``EngineDaemon`` mode ``fused`` on 127.0.0.1 serving
   gruunet2-stream16k to 4 clients x 16 streams x 25 chunks, every reply
   within a deadline, each stream's output against its own sequence
   through the plain version on the CPU, and the reply latency each
   client sees per round;
6. ``StreamEngine`` mode ``fused-webrtc`` with 256 slots and 256 streams
   for 8 ticks, some streams skipping ticks, against the CPU engine given
   the card's state before every tick;
7. ``EngineDaemon`` mode ``fused-webrtc`` serving an ``.npz`` it writes
   (dari_tult's weights, warm start on) to 4 clients x 16 streams x 8
   chunks, each stream's replies against its own sequence through the
   kernel in this process, hx against the plain version on the CPU;
8. the fused-cell kernel against its plain version on the card, at 1, 3
   and 256 streams, on gruunet2-good's plan and on the two other widths
   of phase 2;
9. ``profile --mode fast --fused --streams 256`` in process: its report,
   and the fused cell launched once per hop it ran;
10. the fast step with ``PlanModel(fused=True)`` on the card against the
    zoo model's fast step on the CPU, 256 streams over 20 hops;
11. ``StreamEngine`` mode ``fast`` (gruunet2-good, the zoo model) with 256
    slots and 256 streams for 50 ticks, some streams skipping ticks,
    against the same run on the CPU, idle slots bit-identical;
12. ``EngineDaemon`` mode ``fast`` on 127.0.0.1 serving gruunet2-good to
    4 clients x 16 streams x 25 chunks, each stream's replies against its
    own sequence replayed through the fast step on the CPU;
13. the fused-hop kernel with the SNR gate against its plain version, on
    gruunet2-stream16k and on the unit-gain hidden-40 checkpoint (its
    recommended gate), estimators 'removed', 'floor' and 'both', at 256
    streams and at 3 over 20 hops of a synthetic vowel over per-stream
    noise levels (the share of stream-hops whose gate blends, 0 < alpha
    < 1, printed and required above 0); and against the gated fast step
    on the card;
14. the resident K-hop kernel at 256 streams and K = 50, ungated and with
    the tuned gate: two calls carrying the state and one with int16 IO,
    each one launch; then against 50 launches of the single-hop kernel
    (every plane, 0 expected), its plain version, the int16 plain path
    (1 LSB) and the float32 K-hop clipped and scaled (2 LSB);
15. ``StreamEngine`` mode ``fused`` on the hidden-40 checkpoint with its
    recommended gate, 256 slots for 30 ticks with skipped slots, against
    the same run on the CPU, idle slots bit-identical;
16. ``EngineDaemon`` mode ``fused`` with the auto gate on that checkpoint,
    4 clients x 16 streams x 25 chunks, each stream's replies against its
    own sequence through the plain version on the CPU;
17. ``EngineDaemon`` with its defaults (mode ``fast``, auto gate) on the
    unit-gain 48 kHz gruunet2-mrstft-50k, the same clients, against the
    gated fast step on the CPU;
18. CUDA-event timing at 256 streams: each kernel, its plain version, and
    the bound from its operations and bytes; the gated single hop; the
    K-hop kernel per call and per hop in float32, with the gate and with
    int16 IO, beside 50 single-hop launches; the fast step per hop with
    the zoo model and with the fused cell; the K-hop WebRTC kernel per
    call and per hop at GL-8 and GL-32 (K = 25), beside 25 single-hop
    calls; torch.profiler breakdowns; one GL round's transforms on cuFFT
    (irfft then rfft) beside the GL launch's time per round; on MOMO3
    (momo3-4d4ea0) the single hop ungated and gated, the K-hop kernel per
    call and per hop, the delta fused cell and mode fast per hop, each
    beside the 437.5 us real-time budget of one hop; and the bf16 and
    int8 timing of phases 35-38;
19. the resident K-hop WebRTC kernel on gruunet2-dari_tult at 256
    streams and K = 25, GL-8 (bench.py's fused_webrtc_gl8_resident_k25)
    and GL-32: two calls carrying the state, each one launch, against 50
    single-hop calls from the same state (0 on every output and plane);
20. the same at 255 and 3 streams (the ragged tile), one call;
21. the K-hop kernel against its plain version at K = 2, GL-32 and GL-8,
    256 and 3 streams: every call from the plain version's state, what
    the call adds to the output stream held against the float64 plain
    version as phase 3 holds one hop (``forced_floor``), hx, unit phases;
22. the K-hop kernel against its plain version at the JAX tests' small
    geometry: one call of 6 hops at GL-32 (256 and 3 streams) and of 40
    hops at GL-4 (64 streams), waveform held; and at n_fft 96 (M = 0)
    four calls of K = 2 at GL-4, each from the plain version's state;
23. ``StreamEngine`` mode ``webrtc`` with the tuned SNR gate (1 dB, width
    6, 'both') on gruunet2-dari_tult (cold GL-32), 256 slots for 8 ticks
    of a synthetic vowel with skipped slots, against the CPU engine given
    the card's state before every tick (outputs, hx, the gate's planes,
    what each slot adds to its OLA buffer, idle slots, the gate's blend);
24. ``EngineDaemon`` from ``--mode webrtc --snr-gate 1`` on
    gruunet2-dari_tult, 4 clients x 16 streams x 8 chunks, each stream's
    replies against its chunks replayed through the gated step on the
    card, hx and the gate's planes against the same replay on the CPU;
25. the fused-hop kernel on the MOMO family (the raw-spectrogram domain,
    no mel pair, and the delta carry's plane prev) against its plain
    version over 20 hops: momo3-4d4ea0 at 256 and 3 streams (every plane,
    prev included); runs/momo3-realnoise.npz with its recommended gate on
    voiced input (the blending share printed and required above 0); MOMO2
    (no delta) on the weights of tests/goldens/model_MOMO2-rand.npz;
26. the K-hop kernel on momo3-4d4ea0 at 256 streams and K = 50 (bench.py's
    fused_hop_momo3_raw), as phase 14 runs it: two calls carrying the
    state and one with int16 IO, each one launch; against 50 single-hop
    launches (0 on every plane, prev included), its plain version and the
    int16 plain path (1 LSB);
27. the fused cell's delta branch against its plain version at 1, 3 and
    256 streams (and MOMO2's plan); then the fast step with
    ``PlanModel(fused=True)`` on the card against the zoo MOMO3's fast
    step on the CPU, 256 streams over 20 hops (output, hx and prev);
28. ``StreamEngine`` modes ``fused`` and ``fast`` on momo3-4d4ea0, 256
    slots for 50 ticks with skipped slots, against the same run on the
    CPU, idle slots' planes (hx and prev among them) bit-identical;
29. ``EngineDaemon`` mode ``fused`` with the auto gate (1 dB, width 6,
    'both') on runs/momo3-realnoise.npz, 4 clients x 16 streams x 25
    chunks, each stream against its own sequence through the plain
    version on the CPU, the reply latency per round printed;
30. ``apps.offline.denoise_file`` with the default device (the card) on a
    WAV the script writes, 20 s of 44.1 kHz stereo 16-bit PCM (the vowel
    under per-quarter noise levels), gruunet2-good with no gate argument
    (its recommended profile, a no-op at output gain 3), against the same
    call with ``device="cpu"``: the peak-normalized outputs within
    OFFLINE_ATOL, the written 48 kHz mono WAVs within one LSB;
31. full-clip Griffin-Lim (GL-32, momentum 0.99) on gruunet2-dari_tult,
    10 s at 48 kHz through ``offline_denoiser`` on the card and the CPU,
    each against the same chain in float64 on the CPU: the waveform's SNR
    and the spectral convergence held;
32. the offline SNR gate on the unit-gain runs/gruunet2-mrstft-50k.npz:
    ``denoise_file`` with its recommended gate (1 dB, width 6, 'both'),
    then the CLI's ``--snr-gate 1`` with estimators 'removed' and 'floor'
    in process, card against CPU, the share of frames whose alpha lies
    strictly between 0 and 1 printed (above 0 required for the
    recommended gate);
33. the lookahead branch (runs/gruunet2mel128w64-mrstft-la4-50k.npz, 10 s)
    and MOMO3 (momo3-4d4ea0: the raw domain, the delta carry; 2 s)
    through ``offline_denoiser``, card against CPU, the output as long as
    the input;
34. ``python -m audio_denoising_torch denoise in.wav out.wav`` in a
    subprocess with the default device on phase 30's input: exit 0, a 48
    kHz mono WAV of the resampled length, equal to phase 30's (one LSB);
    then the offline timing: ``denoise_array`` on 60 s of 44.1 kHz stereo
    (wall seconds, real-time factor, the card's busy share by
    torch.profiler), the chain stage by stage (resample, STFT, the model
    scan, residual and inverse mel, the gate scans on phase 32's
    checkpoint, the iSTFT), and ``offline_denoiser`` on 16 clips of 10 s;
35. the fused-hop kernel in its reduced compute modes, bf16 and W8A8
    int8, against its plain version on the card over 20 hops (every
    hop's outputs and every plane but the ring by SNR, the ring exact):
    each hop from the plain version's state at ``FORCED_DB``, and the
    kernel carrying its own state by each stream's SNR over the run, its
    median and its worst at ``FREE_DB`` (the plain version carries its
    own in both); the control, the plain fp32 hop in the kernel's place,
    must fail both: gruunet2-stream16k at 256 and 3 streams, ungated
    and with the tuned gate ('both', voiced input, the blending share
    printed and required above 0); bench.py's quality
    flagship runs/gruunet2mel128w64-mrstft-50k.npz (48 kHz, n_fft 1024,
    128 mels, hidden 64) at 256 streams, first in fp32 as phase 2 holds
    it; momo3-4d4ea0 at 256 and 3 (prev included; in int8 level 0
    quantizes x and prev each with its own row scale);
36. the K-hop kernel at K = 50 in both modes on stream16k, the flagship
    and MOMO3 at 256 streams: two calls carrying the state and one with
    int16 IO, each one launch; against 50 single-hop launches (0 on every
    output and plane), its plain version and the int16 plain path (each
    stream's SNR, as phase 35's free runs) and the float32-IO K-hop
    clipped and scaled (2 LSB);
37. ``StreamEngine`` mode ``fused`` at serving.dtype bfloat16 and int8
    (gruunet2-stream16k) and mode ``fast`` at int8 (gruunet2-good on the
    quantized plan, ``PlanModel(quantized=True)``), 256 slots for 50
    ticks with skipped slots, against the same run on the CPU (each
    stream's SNR), idle slots bit-identical;
38. ``EngineDaemon`` from ``engine --dtype int8`` (mode fused,
    gruunet2-stream16k) and ``engine --dtype int8 --mode fast`` (the
    daemon's default model), 4 clients x 16 streams x 25 chunks, each
    stream against its own sequence replayed on the CPU. Their timing is
    in phase 18: CUDA events at 256 streams for the single hop and the
    K-hop call (per hop) in fp32, bf16 and int8 on stream16k, the
    flagship and MOMO3, each beside its plain version and its bound (each
    product at its type's published peak: bf16 989 TFLOP/s, int8 1,979
    TOP/s; each operand's bytes at its own size) and the yardstick of
    the kernel's own instructions (fp32 FMA, dp4a), and mode fast on the
    quantized plan per hop with the card's busy share;
39. ``WSDaemon`` mode ``fused`` (the WebSocket browser-mic daemon) on
    gruunet2-stream16k with 256 slots: ``GET /`` answers the page with
    its placeholders replaced; 16 clients connect (client i in slot i),
    then each streams 50 hops of int16 PCM in frames of odd sizes at the
    audio's own pace; each client's int16 replies, in order, against its
    sequence through the plain fused hop on the CPU (the same
    ``pcm_to_float32`` chunks, ``float32_to_pcm16`` out) within WS_LSB;
    ``stats`` reports the 16 streams; the reply latency per hop at the
    client (p50, p99) printed beside the card's name and power limit;
40. ``WSDaemon`` mode ``fused-webrtc`` on dari_tult with warm start (the
    checkpoint phase 7 writes), 16 clients x 25 hops: each client's
    replies against its chunks replayed through the kernel on the card
    (1 LSB after int16), the slots' hx against the plain version on the
    CPU within HX_ATOL, the latency per hop printed;
41. ``SocketDaemon`` (``serve``, the reference's pickled ``(n, C)`` wire
    format) on gruunet2-good on the card: 3 connections, interleaved
    2-channel messages of several lengths, each reply's shape and values
    against ``make_server_step`` on the CPU with a state per connection;
    with ``--shared-state`` two connections against one state over both
    (and away from a state per connection); the round trip per message;
42. the engine's downgrades on the card, each asserting its warning and
    ``engine.mode``: a gated ``fused-webrtc`` serves ``webrtc``, int8 in
    mode ``webrtc`` serves ``fast`` on the quantized plan, the gated int8
    flagship (its shared memory per block over the card's) in mode
    ``fused`` serves ``fast``; each engine against its served mode's step
    run alone on the card (0 expected). Then, for every configuration
    the script builds, in each compute mode, gated and not, one hop and
    K hops, the libraries' shared memory per block against the plain
    mirrors the engine decides by (``fused_hop_smem_bytes``,
    ``webrtc_hop_smem_bytes``; each kernel's wrapper also holds them
    equal whenever it binds on the card).

Phases 30-34 drive the offline path, which launches none of the
hand-written kernels: the JAX offline graph reaches no Pallas kernel
(``offline_denoise`` runs ``model.apply``, JAX pipeline.py:140).

Phases 4 to 7, 9 to 12, 15 to 17, 27 to 29, 37 to 40, the first three
calls of phases 14, 26 and of each case of 36, and phase 19's calls are
the main paths: each kernel's
launch counter is set to 0 just before each (a new wrapper starts at 0)
and read just after (the single WebRTC hop counts its three kernels, the
K-hop call one). Mode ``fast`` with the zoo model (phases 11, 12, 17,
28), mode ``fast`` on the quantized plan (phases 37, 38, 42), mode
``webrtc`` (phases 23, 24, 42) and the socket daemon's server step (phase
41) run no hand-written kernel, as the JAX package's modes ``fast`` and
``webrtc`` and its ``serve`` run no Pallas kernel.
Griffin-Lim with carried phases is chaotic where a frame's rebuilt
spectrum nears zero: fp32 round-off there flips a phase, and the carried
phases spread it, so two correct fp32 versions that each carry their own
state part ways within a few hops (the plain version on the card, on the
CPU and the kernel all part from a float64 run alike). So the served
geometry's waveform is held one hop at a time from a shared state, with
a float64 witness, beside the surfaces no phase reaches (hx, spectral
convergence). The last two lines are the ``kernels`` JSON line (each
entry with the variants checked, the MOMO3, flagship, bf16 and int8 ones
with their times) and
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout
of the repo, the script fails.
"""

import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

OUT_ATOL = 2e-4      # per-hop output, as tests/test_fused_hop.py bounds it
STATE_ATOL = 2e-5    # ring, ola and hx after 20 hops
HX_ATOL = 1e-5       # webrtc hx, as tests/test_webrtc_hop.py bounds it
PHASE_ATOL = 2e-3    # carried phases with no GL round (test_webrtc_hop.py)
UNIT_TOL = 1e-3      # carried phases: |1 - |a|| or |a| below this
SNR_GL32_DB = 35.0   # tests/test_webrtc_hop.py's waveform bounds
SNR_GL4_DB = 40.0
MAG_REL = 2e-2       # GL-4 output rfft magnitudes, relative to max(1, max)
SC_TOL = 1e-2        # spectral convergence, kernel vs plain, per stream
WITNESS_DB = 10.0    # see forced_floor
REPLAY_ATOL = 1e-6   # daemon replies vs the kernel replayed per stream
SLOTS = 256          # streams at full width: the engines' slot count
HOPS = 20
WEBRTC_HOPS = 6
TIMED_LAUNCHES = 200
FP32_FLOPS = 67e12   # H100 SXM fp32 FMA peak, NVIDIA data sheet
HBM_BYTES_S = 3.35e12
REPLY_DEADLINE_S = 30.0
REPO = os.path.dirname(os.path.abspath(__file__))
CELL_ATOL = 1e-5     # y and hx' of one cell step (test_torch_fused_cell.py)
CELL_BATCHES = (1, 3, SLOTS)
KERNELS = ("fused_hop", "webrtc_hop", "fused_cell")
# trained checkpoints of other widths, held in phase 2 besides the main one
OTHER_CHECKPOINTS = ("gruunet2s16kw40-mrstft-idp-50k.npz",
                     "gruunet2mel128d5w64-mrstft-50k.npz")
# unit-gain checkpoints, which the daemons serve with the tuned SNR gate:
# the only trained 16 kHz one mode fused can serve, and a 48 kHz one for
# mode fast
GATED_CHECKPOINT = "gruunet2s16kw40-mrstft-idp-50k.npz"
FAST_CHECKPOINT = "gruunet2-mrstft-50k.npz"
# (gate dB, width dB) per estimator on gruunet2-stream16k (x3 gain, where
# 'removed' reads 15-40 dB); the unit-gain checkpoint takes its
# recommended 1 dB / 6 with each estimator
GATE_POINTS = {"removed": (30.0, 10.0), "floor": (10.0, 4.0),
               "both": (10.0, 4.0)}
PLANE_RTOL = 2e-4    # the gate's planes, relative (tests/test_fused_hop.py)
ABS_PLANES = ("ring", "ola", "hx", "prev")   # held at STATE_ATOL
PLANE_ATOL = 1e-9
GATED_OUT_ATOL = 3e-4  # gated kernel vs the gated fast step (JAX's bound)
K_HOPS = 50          # hops per call of the resident kernel (bench.py's K)
KHOP_EXACT = 1e-6    # K-hop kernel vs K single-hop launches (0 expected)
GATE_FLOPS_PER_BIN = 20   # the gate's EMAs, means and blend, per bin
# the resident K-hop WebRTC hop: bench.py's fused_webrtc_gl8_resident_k25
# (256 streams, K = 25, GL-8) and the served GL-32; it must equal K
# single-hop launches exactly
WEBRTC_K = 25
WEBRTC_GL = (8, 32)
RUNTIME_FFT = 96     # n_fft whose M = 48 has no instantiation of its own
FFT_SIZES = (768, 512, 32, RUNTIME_FFT // 2)   # the checks' n_fft / 2
FORCED_K = 2         # hops per call where each call starts from a shared state
MOMO_SPEC = "momo3-4d4ea0"
MOMO_TRAINED = "momo3-realnoise.npz"
MOMO2_GOLDEN = "model_MOMO2-rand.npz"
# the offline path (phases 30-34): denoise_file at gruunet2-good's full
# width on 44.1 kHz stereo input, resampled to the model's 48 kHz
OFFLINE_SPEC = "gruunet2-good"
OFFLINE_IN_RATE = 44100
OFFLINE_ATOL = 1e-4  # card vs CPU on the peak-normalized output
WAV_LSB = 1          # 16-bit WAVs of two such outputs: one rounding edge
OFFLINE_GL_SPEC = "gruunet2-dari_tult"
# full-clip GL-32 with momentum 0.99 against float64; fp32 on the CPU
# reaches 49.2 dB and spectral convergence 2.1e-4 on this input
OFFLINE_GL_SNR_DB = 30.0
OFFLINE_LA_CHECKPOINT = "gruunet2mel128w64-mrstft-la4-50k.npz"
OFFLINE_LEVELS = (0.003, 0.1, 0.01, 0.3)   # noise level per quarter clip
OFFLINE_FILE_S = 20
OFFLINE_GL_S = 10
OFFLINE_GATE_S = 10
OFFLINE_LA_S = 10
OFFLINE_MOMO_S = 2   # 4,571 frames of MOMO3's 21-sample hop
OFFLINE_TIMED_S = 60
OFFLINE_TIMED_CALLS = 3   # the host's clock varies from call to call
OFFLINE_BATCH = 16
OFFLINE_BATCH_S = 10
REDUCED = ("bfloat16", "int8")   # the fused hop's reduced compute modes
FLAGSHIP = "gruunet2mel128w64-mrstft-50k.npz"   # bench.py's quality flagship
S16K = "gruunet2-stream16k"
# The reduced modes' kernel against its plain version on the card, by SNR
# in dB. fp32 round-off upstream of a bf16 rounding or an int8 quant step
# can move a value across the tie, and one element then moves by 2^-8 of
# itself or 1/127 of its row's max. Each limit sits between the worst
# reading of the sound runs and that of the control, the plain fp32 hop
# in the kernel's place on the same inputs (phase 35 runs it and requires
# every limit to fail it). On an NVIDIA H100 80GB HBM3 at 700 W, with
# this script's inputs:
# - one hop from the plain version's state (batch-wide, worst hop):
#   bf16 56.5-95.5 dB, control 26.4-37.4; int8 50.9-123.2, control
#   9.2-34.4 -> FORCED_DB;
# - each side carrying its own state: a value that crossed a tie in one
#   stream moves more values across ties downstream and, through hx, in
#   later hops, until that stream differs at the mode's own noise level,
#   while the others stay near the forced readings. So each stream's SNR
#   over the run is held: its median at FREE_DB's first number, the
#   midpoint between the sound runs' lowest median and the control's
#   highest (stream16k bf16 96.9 and 52.0, int8 96.9 and 51.8; the
#   flagship bf16 56.0 and 33.0 (the K = 50 calls spread the most: 35% of
#   streams below 45 dB after 100 hops), int8 89.0 and 18.2; MOMO3 bf16
#   147.6 and 50.9, int8 147.5 and 45.2), which a fault spread over every
#   stream would miss; and its worst stream at the second, the control's
#   worst stream less 6 dB (the mode's own noise: stream16k 35.2 and
#   34.3, the flagship 27.3 and 12.4, MOMO3 49.8 and 43.1; the sound runs'
#   worst streams 64.4, 49.4, 36.8, 24.9, 69.7, 61.5).
FORCED_DB = {"bfloat16": 46.0, "int8": 45.0}
FREE_DB = {(S16K, "bfloat16"): (74.0, 29.0), (S16K, "int8"): (74.0, 28.0),
           (FLAGSHIP, "bfloat16"): (44.0, 21.0),
           (FLAGSHIP, "int8"): (53.0, 6.0),
           (MOMO_SPEC, "bfloat16"): (99.0, 43.0),
           (MOMO_SPEC, "int8"): (96.0, 37.0)}
BF16_FLOPS = 989e12   # H100 SXM bf16 dense tensor-core peak, NVIDIA data sheet
INT8_OPS = 1979e12    # H100 SXM int8 dense tensor-core peak
# dp4a: 64 per clock per SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput), 4 multiply-adds
# each: twice the fp32 FMA rate in operations. A yardstick of the
# instructions the kernel runs, not a bound
DP4A_OPS = 2 * FP32_FLOPS
PEAK_BY_ITEMSIZE = {4: FP32_FLOPS, 2: BF16_FLOPS, 1: INT8_OPS}


def say(*parts):
    print(*parts, flush=True)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().cpu())


def snr_db(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * math.log10(max(float((ref ** 2).sum()), 1e-20)
                           / max(float(((ref - got) ** 2).sum()), 1e-20))


def run_hops(step, state, chunks):
    outs = []
    for c in chunks:
        state, out = step(state, c)
        outs.append(out)
    return state, outs


def dtype_name(dt) -> str:
    return str(dt).rsplit(".", 1)[-1]


def as_f64(x):
    """A tensor (any device) or array as a float64 numpy array."""
    if hasattr(x, "detach"):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def tensor_db(ref, got) -> float:
    """SNR of ``got`` against ``ref`` in dB (inf where they are equal)."""
    ref, got = as_f64(ref), as_f64(got)
    err = float(((got - ref) ** 2).sum())
    if err == 0.0:
        return math.inf
    return 10 * math.log10(max(float((ref ** 2).sum()), 1e-30) / err)


def stream_dbs(ref, got):
    """Each stream's SNR in dB (stream_snrs) over a run of (T, B, ...)
    outputs: (B,)."""
    return stream_snrs(np.moveaxis(as_f64(ref), 1, 0),
                       np.moveaxis(as_f64(got), 1, 0))


def reduced_planes(got, want):
    """{plane: SNR in dB} of two states (the ring: 0 or inf, exact)."""
    dbs = {}
    for k, a in planes(got).items():
        b = planes(want)[k].to(a.device)
        if k == "ring":
            dbs[k] = math.inf if a.equal(b) else -math.inf
        else:
            dbs[k] = tensor_db(b, a)
    return dbs


def fmt_db(dbs):
    return ", ".join(f"{k} {v:.1f}" for k, v in dbs.items())


def limits_of(cfg):
    """The model whose FREE_DB holds for ``cfg``: MOMO3's in the raw
    domain, the flagship's at 128 mels, else stream16k's (gruunet2-good's
    weights)."""
    if cfg.dsp.domain == "raw":
        return MOMO_SPEC
    return FLAGSHIP if cfg.dsp.n_mels == 128 else S16K


def free_verdict(dbs, cfg, dtype):
    """(ok, text) for each stream's SNR ``dbs`` where each side carried
    its own state: the median stream and the worst at FREE_DB."""
    median, floor = FREE_DB[(limits_of(cfg), dtype)]
    below = int((dbs < FORCED_DB[dtype]).sum())
    ok = float(np.median(dbs)) >= median and float(dbs.min()) >= floor
    return ok, (f"streams median {np.median(dbs):.1f} dB (limit "
                f"{median:g}), worst {dbs.min():.1f} (limit {floor:g}), "
                f"{below} of {len(dbs)} below {FORCED_DB[dtype]:g}")


def hold_free(label, dtype, cfg, outs_ref, outs_got, s_ref=None,
              s_got=None):
    """``outs_got`` (and the state ``s_got``) against ``outs_ref``
    (``s_ref``) where each side carried its own state; outputs (T, B,
    ...). float32: the largest output error at OUT_ATOL, the planes at
    theirs (check_state). bf16, int8: free_verdict on each stream's SNR,
    every plane but the ring (exact) by SNR at FREE_DB's worst-stream
    limit, all finite.
    Returns (text, largest output error, worst stream dB)."""
    ref, got = as_f64(outs_ref), as_f64(outs_got)
    e_out = float(np.abs(got - ref).max())
    if dtype == "float32":
        errs = {} if s_ref is None else plane_errors(s_got, s_ref)
        text = f"out {e_out:.3e} (bound {OUT_ATOL:g})" + (
            f", {fmt(errs)}" if errs else "")
        if e_out > OUT_ATOL:
            raise AssertionError(f"{label}: {text}")
        check_state(errs, label)
        return text, e_out, None
    dbs = stream_dbs(ref, got)
    ok, text = free_verdict(dbs, cfg, dtype)
    pl = {} if s_ref is None else reduced_planes(s_got, s_ref)
    text = f"out {e_out:.3e}; {text}" + (
        f"; planes {fmt_db(pl)}" if pl else "")
    floor = FREE_DB[(limits_of(cfg), dtype)][1]
    if (not ok or min(pl.values(), default=math.inf) < floor
            or not np.isfinite(got).all()):
        raise AssertionError(f"{label} ({dtype}): {text}")
    return text, e_out, float(dbs.min())


def phase_kernel_vs_plain(torch, hop, cfg, plan, batches, label="",
                          voiced_input=False):
    """Kernel against its plain version on the same inputs over HOPS hops,
    each carrying its own state, every plane held (hold_free: ring, ola,
    hx and, for a delta plan, prev). In bf16 and int8 also each hop from
    the plain version's state, its outputs and new planes by SNR at
    FORCED_DB; and the control: the plain fp32 hop in the kernel's place,
    which both limits must fail; with a gate, the share of stream-hops
    whose alpha blends (above 0). Returns (largest output error, worst
    forced hop dB or None)."""
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    dtype = dtype_name(hop.compute_dtype)
    reduced = dtype != "float32"
    fp32 = make_fused_hop(cfg, plan, "cuda") if reduced else None
    worst_e, worst_db = 0.0, None
    for batch in batches:
        if voiced_input:
            chunks = torch.from_numpy(voiced_chunks(
                batch, HOPS, hop.hop, cfg.dsp.sample_rate, batch)).cuda()
        else:
            rng = np.random.default_rng(batch)
            chunks = torch.from_numpy((0.1 * rng.standard_normal(
                (HOPS, batch, hop.hop))).astype(np.float32)).cuda()
        s_k = s_p = s_c = fused_hop_init_state(cfg, plan, batch, "cuda")
        o_k, o_p, o_c, alphas = [], [], [], []
        forced, control, e_forced, dbs = math.inf, math.inf, 0.0, {}
        for c in chunks:
            s_k, out = hop(s_k, c)
            o_k.append(out)
            s_next, want = hop.reference(s_p, c)
            o_p.append(want)
            if reduced:
                f_k, f_out = hop(s_p, c)      # one hop from the plain state
                forced = min(forced, tensor_db(want, f_out))
                e_forced = max(e_forced, max_err(f_out, want))
                for k, v in reduced_planes(f_k, s_next).items():
                    dbs[k] = min(dbs.get(k, math.inf), v)
                control = min(control, tensor_db(want, fp32.reference(
                    s_p, c)[1]))
                s_c, out_c = fp32.reference(s_c, c)
                o_c.append(out_c)
            s_p = s_next
            if hop.gated:
                alphas.append(hop.alpha(s_p))
        torch.cuda.synchronize()
        text, e_free, _ = hold_free(f"{label} B={batch}", dtype, cfg,
                                    torch.stack(o_p), torch.stack(o_k), s_p,
                                    s_k)
        blend = ""
        if alphas:
            share = float(((torch.cat(alphas) > 0) & (torch.cat(alphas) < 1)
                           ).double().mean().cpu())
            blend = f"; alpha in (0, 1) on {share:.1%} of stream-hops"
            if share <= 0:
                raise AssertionError(f"{label} ({dtype}): the gate never "
                                     f"blended")
        if not reduced:
            say(f"  B={batch:3d}: {text}{blend}")
            worst_e = max(worst_e, e_free)
            continue
        c_ok, c_text = free_verdict(stream_dbs(torch.stack(o_p),
                                               torch.stack(o_c)), cfg, dtype)
        say(f"    {label}, {dtype}, B={batch:3d}: from the plain state: out "
            f"{e_forced:.3e}, worst hop {forced:.1f} dB, planes "
            f"{fmt_db(dbs)} (limit {FORCED_DB[dtype]:g} dB); carrying its "
            f"own: {text}{blend}; control, plain fp32 in its place: worst "
            f"hop {control:.1f} dB from the plain state, {c_text}")
        if min([forced] + list(dbs.values())) < FORCED_DB[dtype]:
            raise AssertionError(f"{label} ({dtype}): the kernel disagrees "
                                 f"with its plain version at B={batch}")
        check_control(label, dtype, control, c_ok)
        worst_e = max(worst_e, e_forced)
        worst_db = forced if worst_db is None else min(worst_db, forced)
    return worst_e, worst_db


def check_control(label, dtype, forced_db, free_ok):
    """Raises unless both checks fail the control (fp32 in the place of
    the ``dtype`` kernel): its worst hop from the plain state below
    FORCED_DB, and free_verdict rejecting its own run."""
    if forced_db >= FORCED_DB[dtype] or free_ok:
        raise AssertionError(f"{label} ({dtype}): the limits would pass "
                             f"fp32 in the {dtype} kernel's place")


# -- the WebRTC hop -----------------------------------------------------------

def warm_cfg(cfg, n_iter=None):
    """``cfg`` with warm-start Griffin-Lim on (and n_iter rounds)."""
    dsp = dataclasses.replace(cfg.dsp, griffin_lim_warm_start=True)
    if n_iter is not None:
        dsp = dataclasses.replace(dsp, griffin_lim_iters=n_iter)
    return dataclasses.replace(cfg, dsp=dsp)


def small_webrtc_model(torch, n_iter, n_fft=64):
    """The JAX webrtc tests' geometry (tests/test_webrtc_hop.py
    _small_setup: n_fft 64, 16 mels, hidden (5, 5)) with random weights
    from a seed: a point where warm GL is not chaotic, so the waveform is
    a surface to hold. Another ``n_fft`` keeps the model and weights."""
    from audio_denoising_torch.config import Config, DSPConfig, ModelConfig
    from audio_denoising_torch.models import build_model
    cfg = Config(
        dsp=DSPConfig(sample_rate=16000, n_fft=n_fft, hop_length=n_fft // 2,
                      n_mels=16,
                      reconstruction="griffin_lim", griffin_lim_iters=n_iter,
                      griffin_lim_warm_start=True),
        model=ModelConfig(arch="GRUUNet2", num_compressed_bins=4,
                          hidden_sizes=(5, 5), kernel_sizes=(3, 3),
                          strides=(2, 2), paddings=(1, 1), num_gaussians=3))
    torch.manual_seed(0)
    return cfg, build_model(cfg.model, num_bins=cfg.dsp.n_mels)


def fft_label(hop) -> str:
    """Which FFT instantiation of csrc/webrtc_hop.cu ran ``hop``: M =
    n_fft / 2 compiled in, or M = 0, the geometry read at run time."""
    m = hop.fft_instance
    return "FFT M=0 (runtime geometry)" if m == 0 else f"FFT M={m}"


def phases_ok(torch, state) -> bool:
    nrm = torch.sqrt(state.ang_re ** 2 + state.ang_im ** 2)
    return bool(((nrm - 1).abs() < UNIT_TOL).logical_or(nrm < UNIT_TOL)
                .all())


def webrtc_chunks(torch, batch, hops, seed, hop_len):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((0.2 * rng.standard_normal((batch, hop_len)))
                             .astype(np.float32)) for _ in range(hops)]


def to(state, device, dtype=None):
    return type(state)(*(None if t is None else t.to(device, dtype)
                         for t in state))


def planes(state):
    """The state's present planes by name (absent gate planes left out)."""
    return {k: v for k, v in state._asdict().items() if v is not None}


def float64_plain(torch, cfg, plan, hops_per_call=1):
    """The plain version on the CPU in float64: a witness of how far each
    fp32 version departs."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import make_webrtc_hop
    hop = make_webrtc_hop(cfg, plan, "cpu", hops_per_call=hops_per_call)
    for name in ("win", "env", "mel", "imel"):
        setattr(hop, name, getattr(hop, name).double())
    hop.rot = hop.rot.to(torch.complex128)
    hop.weights = [w.double() for w in hop.weights]
    return hop


def added_frame(state_in, state_out, hop_len):
    """What one hop adds to the OLA buffer (the synthesized frame times the
    peak), float64 on the CPU: ola' minus the shifted ola."""
    ola = state_in.ola.double().cpu()
    shifted = ola.roll(-hop_len, dims=1)
    shifted[:, -hop_len:] = 0
    return (state_out.ola.double().cpu() - shifted).numpy()


def call_signal(state_in, state_out, outs, hop_len):
    """What one call of K hops adds to the output stream, float64 on the
    CPU, (B, (K + 1) hop): outputs 1 to K - 1 and the final OLA buffer
    laid end to end (the K frames overlap-added), less the input OLA
    buffer's share (n_fft = 2 hop: its second half, in the first hop)."""
    import torch
    y = torch.cat([*outs[1:].double().cpu(), *state_out.ola.double().cpu()
                   .reshape(-1, 2, hop_len).transpose(0, 1)], dim=1)
    y[:, :hop_len] -= state_in.ola.double().cpu()[:, hop_len:]
    return y.numpy()


def spectral_convergence(torch, hop, frame, peak, lin):
    """Per stream || |STFT(frame / peak)| - lin || / || lin ||: how far a
    synthesized frame's magnitudes are from the target magnitudes ``lin``
    that Griffin-Lim rebuilds phases for. It reads no phase, so it holds
    the loop where phases may part ways."""
    from audio_denoising_torch.ops.stft import stft
    x = torch.from_numpy(frame) / peak
    m = stft(x, hop.n_fft, hop.hop, window=hop.win).abs().transpose(1, 2)
    return (torch.linalg.vector_norm(m - lin, dim=(1, 2))
            / torch.linalg.vector_norm(lin, dim=(1, 2)).clamp_min(1e-30)
            ).numpy()


def stream_snrs(ref, got):
    return np.array([snr_db(r, g) for r, g in zip(ref, got)])


def check_webrtc_exact(torch, cfg, plan, batch):
    """No GL round: the seed, analysis, cell and synthesis only, every
    surface exact to fp32 round-off; each version carries its own state."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    cfg = warm_cfg(cfg, 0)
    hop = make_webrtc_hop(cfg, plan, "cuda")
    s_k = s_p = webrtc_hop_init_state(cfg, plan, batch, "cuda")
    e = {"out": 0.0, "ola": 0.0, "hx": 0.0, "phases": 0.0}
    for c in webrtc_chunks(torch, batch, WEBRTC_HOPS, batch, hop.hop):
        c = c.cuda()
        s_k, o_k = hop(s_k, c)
        s_p, o_p = hop.reference(s_p, c)
        e["out"] = max(e["out"], max_err(o_k, o_p))
        e["ola"] = max(e["ola"], max_err(s_k.ola, s_p.ola))
        e["hx"] = max(e["hx"], max_err(s_k.hx, s_p.hx))
        e["phases"] = max(e["phases"], max_err(s_k.ang_re, s_p.ang_re),
                          max_err(s_k.ang_im, s_p.ang_im))
        if max_err(s_k.ring, s_p.ring) != 0:
            raise AssertionError("webrtc kernel's ring differs")
    say(f"  GL-0  B={batch:3d}, {fft_label(hop)}: out {e['out']:.3e} (bound "
        f"{OUT_ATOL:g}), ola {e['ola']:.3e} (bound {STATE_ATOL:g}), hx "
        f"{e['hx']:.3e} "
        f"(bound {HX_ATOL:g}), phases {e['phases']:.3e} (bound "
        f"{PHASE_ATOL:g})")
    if (e["out"] > OUT_ATOL or e["ola"] > STATE_ATOL or e["hx"] > HX_ATOL
            or e["phases"] > PHASE_ATOL):
        raise AssertionError(f"webrtc kernel disagrees with its plain "
                             f"version with no GL round at B={batch}")


def forced_floor(f_kernel, f_plain, f_f64, bound=SNR_GL32_DB):
    """The waveform rule for one hop taken from one state by the kernel, a
    plain fp32 version and the float64 plain version: over the streams,
    the kernel's median SNR against float64 must reach ``bound``, or,
    on a hop where the plain fp32 version itself departs further, come
    within WITNESS_DB of the plain version's median. Medians, because a
    few streams per hop flip a near-zero bin's phase in any fp32 version.
    Returns (kernel median, plain median, floor)."""
    k = float(np.median(stream_snrs(f_f64, f_kernel)))
    p = float(np.median(stream_snrs(f_f64, f_plain)))
    return k, p, min(bound, p - WITNESS_DB)


def check_webrtc_forced(torch, cfg, plan, batch, hops, bound):
    """Griffin-Lim held hop by hop at the served geometry. The plain
    version on the card sets the trajectory; at every hop the kernel, the
    plain version on the card, the plain version on the CPU and the
    float64 plain version start from its state and take the same chunk.
    Held on hops 2 on: ``forced_floor`` at ``bound`` on the frame each adds
    to its OLA buffer, and each stream's spectral convergence within SC_TOL of the
    plain version's; at every hop hx and unit phases. Returns the largest
    error of the kernel's ola against the plain version's, all hops."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    hop = make_webrtc_hop(cfg, plan, "cuda")
    cpu = make_webrtc_hop(cfg, plan, "cpu")
    f64 = float64_plain(torch, cfg, plan)
    s = webrtc_hop_init_state(cfg, plan, batch, "cuda")
    pairs = ("kernel/plain", "plain card/CPU", "kernel/f64", "plain/f64")
    batch_snr = {k: [] for k in pairs}
    stream_min = {k: [] for k in pairs}
    rules, sc_err, worst_hx, worst_ola = [], [], 0.0, 0.0
    for t, c in enumerate(webrtc_chunks(torch, batch, hops, batch + 7,
                                        hop.hop)):
        s_k, _ = hop(s, c.cuda())
        s_p, _ = hop.reference(s, c.cuda())
        s_c, _ = cpu.reference(to(s, "cpu"), c)
        s_d, _ = f64.reference(to(s, "cpu", torch.float64), c.double())
        torch.cuda.synchronize()
        worst_hx = max(worst_hx, max_err(s_k.hx, s_p.hx))
        worst_ola = max(worst_ola, max_err(s_k.ola, s_p.ola))
        if not phases_ok(torch, s_k) or not bool(torch.isfinite(
                s_k.ola).all()):
            raise AssertionError(f"webrtc kernel: non-unit phases or a "
                                 f"non-finite frame at hop {t}")
        fk, fp, fc, fd = (added_frame(s, x, hop.hop)
                          for x in (s_k, s_p, s_c, s_d))
        if t >= 2:         # a stream's first window is half silence
            for k, (ref, got) in zip(pairs, ((fp, fk), (fp, fc), (fd, fk),
                                             (fd, fp))):
                batch_snr[k].append(snr_db(ref, got))
                stream_min[k].append(float(stream_snrs(ref, got).min()))
            rules.append(forced_floor(fk, fp, fd, bound))
            _, peak, _, lin = f64.targets(to(s, "cpu", torch.float64),
                                          c.double())
            sc_k = spectral_convergence(torch, f64, fk, peak, lin)
            sc_p = spectral_convergence(torch, f64, fp, peak, lin)
            sc_err.append(float(np.abs(sc_k - sc_p).max()))
        s = s_p
    say(f"  GL-{hop.n_iter} B={batch:3d}, {fft_label(hop)}, each hop from the "
        f"plain version's state, hops 2-{hops - 1}: SNR of the added frame, "
        f"over the batch and the lowest stream:")
    for k in pairs:
        say(f"    {k:15s} batch min {min(batch_snr[k]):.1f}, median "
            f"{float(np.median(batch_snr[k])):.1f} dB; lowest stream "
            f"{min(stream_min[k]):.1f} dB")
    worst = min(rules, key=lambda r: r[0] - r[2])
    say(f"    held, median over streams of kernel/f64 >= floor = min("
        f"{bound:g}, plain/f64 - {WITNESS_DB:g}) at every hop; lowest "
        f"kernel/f64 {min(r[0] for r in rules):.1f} dB; closest hop "
        f"{worst[0]:.1f} (plain/f64 {worst[1]:.1f}, floor {worst[2]:.1f}) "
        f"dB")
    say(f"    spectral convergence, kernel vs plain: max difference "
        f"{max(sc_err):.2e} (bound {SC_TOL:g}); hx {worst_hx:.3e} (bound "
        f"{HX_ATOL:g}); ola {worst_ola:.3e} over all hops; phases unit")
    if (worst_hx > HX_ATOL or any(k < f for k, _, f in rules)
            or max(sc_err) > SC_TOL):
        raise AssertionError(f"webrtc kernel disagrees with its plain "
                             f"version (GL-{hop.n_iter}, B={batch})")
    return worst_ola


def check_webrtc_free(torch, cfg, plan, batch, hops):
    """Each version carries its own state over the same chunks: the kernel
    (run twice, which must agree bit for bit), the plain version on the
    card, on the CPU and in float64. hx and unit phases are held; the
    waveform SNR of each pair on hops 2 on is printed: carried phases part
    ways where a rebuilt spectrum nears zero."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    hop = make_webrtc_hop(cfg, plan, "cuda")
    cpu = make_webrtc_hop(cfg, plan, "cpu")
    f64 = float64_plain(torch, cfg, plan)
    chunks = webrtc_chunks(torch, batch, hops, batch + 7, hop.hop)
    init = lambda: webrtc_hop_init_state(cfg, plan, batch, "cuda")
    runs = {}
    for name, step, state, dev in (
            ("kernel", hop, init(), "cuda"),
            ("kernel again", hop, init(), "cuda"),
            ("plain card", hop.reference, init(), "cuda"),
            ("plain CPU", cpu.reference, to(init(), "cpu"), "cpu"),
            ("f64", f64.reference, to(init(), "cpu", torch.float64), "f64")):
        outs = []
        for c in chunks:
            c = c.double() if dev == "f64" else c.to(dev)
            state, o = step(state, c)
            outs.append(o.double().cpu().numpy())
        runs[name] = (state, outs)
    s_k, o_k = runs["kernel"]
    s_again, o_again = runs["kernel again"]
    if not all(np.array_equal(a, b) for a, b in zip(o_k, o_again)) or not \
            all(torch.equal(a, b) for a, b in zip(s_k, s_again)):
        raise AssertionError("webrtc kernel: two runs on the same inputs "
                             "differ")
    hx = max_err(s_k.hx, runs["plain card"][0].hx)
    if hx > HX_ATOL or not phases_ok(torch, s_k):
        raise AssertionError(f"webrtc kernel: hx {hx:.3e} or non-unit "
                             f"phases, B={batch}")
    say(f"  GL-{hop.n_iter} B={batch:3d}, each version on its own state "
        f"over {hops} hops: kernel twice bit-identical; hx {hx:.3e} (bound "
        f"{HX_ATOL:g}); phases unit; waveform SNR over the batch on hops "
        f"2-{hops - 1} (printed, not held):")
    for ref, got in (("plain card", "kernel"), ("plain CPU", "plain card"),
                     ("f64", "kernel"), ("f64", "plain card"),
                     ("f64", "plain CPU")):
        per_hop = [snr_db(a, b) for a, b in zip(runs[ref][1],
                                                runs[got][1])][2:]
        say(f"    {got} vs {ref}: " + ", ".join(f"{v:.1f}" for v in per_hop)
            + " dB")


def check_webrtc_small(torch, cfg, plan, batch, hops, snr_bound,
                       mag_rel=None, label=""):
    """At the JAX tests' small geometry each version carries its own state
    and the waveform is held: SNR on hops 2 on, hx at every hop (and with
    ``mag_rel`` each hop's output rfft magnitudes)."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    hop = make_webrtc_hop(cfg, plan, "cuda")
    s_k = s_p = webrtc_hop_init_state(cfg, plan, batch, "cuda")
    worst_hx, snrs = 0.0, []
    for t, c in enumerate(webrtc_chunks(torch, batch, hops, batch + 7,
                                        hop.hop)):
        s_k, o_k = hop(s_k, c.cuda())
        s_p, o_p = hop.reference(s_p, c.cuda())
        o_k, o_p = o_k.cpu().numpy(), o_p.cpu().numpy()
        worst_hx = max(worst_hx, max_err(s_k.hx, s_p.hx))
        if not phases_ok(torch, s_k) or not np.all(np.isfinite(o_k)):
            raise AssertionError(f"webrtc kernel: non-unit phases or a "
                                 f"non-finite output at hop {t}")
        if t < 2:          # warm-up hops emit (near-)silence
            continue
        snrs.append(snr_db(o_p, o_k))
        if mag_rel is not None:
            m0 = np.abs(np.fft.rfft(o_p, axis=-1))
            m1 = np.abs(np.fft.rfft(o_k, axis=-1))
            if np.abs(m1 - m0).max() > mag_rel * max(1.0, m0.max()):
                raise AssertionError(f"webrtc kernel: output magnitudes "
                                     f"drift at hop {t}")
    say(f"  {label} B={batch:3d} x {hops} hops, {fft_label(hop)}: hx "
        f"{worst_hx:.3e} (bound {HX_ATOL:g}); waveform SNR on hops 2-{hops - 1} min "
        f"{min(snrs):.1f} dB (bound {snr_bound:g}); phases unit")
    if worst_hx > HX_ATOL or min(snrs) < snr_bound:
        raise AssertionError(f"webrtc kernel disagrees with its plain "
                             f"version ({label}, B={batch})")


def check_fft_plans(hop):
    """The kernels' pass radices for each FFT size the checks run equal
    ``fft_radices``, the plain schedule the CPU tests hold against
    torch.fft."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import fft_radices
    for m in FFT_SIZES:
        got = hop.kernel_radices(m)
        say(f"  FFT of {m} points: passes of radix "
            f"{' x '.join(map(str, got))}")
        if got != fft_radices(m):
            raise AssertionError(f"the kernels' passes for {m} points "
                                 f"{got} differ from fft_radices "
                                 f"{fft_radices(m)}")


def check_mel128(torch):
    """The 128-mel checkpoint (n_fft 1024, 3 x 128 mel outputs, more than
    the 288 lanes a stream has) in the single WebRTC hop: the shared
    memory a block needs for one hop and for K hops (printed), and with no
    GL round every surface exact to fp32 round-off."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops.kernels.webrtc_hop import make_webrtc_hop
    from audio_denoising_torch.runtime.plan import build_cell_plan
    cfg, model = load_pretrained(os.path.join(REPO, "runs",
                                              OTHER_CHECKPOINTS[1]))
    cfg, plan = warm_cfg(cfg), build_cell_plan(model)
    h = make_webrtc_hop(cfg, plan, "cuda")
    multi = type(h._base_args).from_buffer_copy(h._base_args)
    multi.hops = WEBRTC_K
    need = [h._lib.adt_webrtc_hop_smem_bytes(ctypes.byref(a))
            for a in (h._base_args, multi)]
    say(f"  {OTHER_CHECKPOINTS[1]} (n_fft {h.n_fft}, {h.M} mels, "
        f"{fft_label(h)}): shared memory per block {need[0]} B for one "
        f"hop, {need[1]} B for K={WEBRTC_K} (the card allows "
        f"{torch.cuda.get_device_properties(0).shared_memory_per_block_optin}"
        f" B)")
    for b in (SLOTS, 3):
        check_webrtc_exact(torch, cfg, plan, b)


def phase_webrtc_kernel(torch, cfg, plan):
    """Phase 3; returns the largest ola error of the served GL-n run at
    B=SLOTS, each hop from the plain version's state."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import make_webrtc_hop
    check_fft_plans(make_webrtc_hop(cfg, plan, "cuda"))
    for b in (SLOTS, 3):
        check_webrtc_exact(torch, cfg, plan, b)
    err = max(check_webrtc_forced(torch, cfg, plan, b, WEBRTC_HOPS,
                                  SNR_GL32_DB) for b in (SLOTS, 3))
    check_webrtc_forced(torch, warm_cfg(cfg, 4), plan, 64, 40, SNR_GL4_DB)
    for b in (SLOTS, 3):
        check_webrtc_free(torch, cfg, plan, b, WEBRTC_HOPS)
    from audio_denoising_torch.runtime.plan import build_cell_plan
    small_cfg, small = small_webrtc_model(torch, 32)
    small_plan = build_cell_plan(small)
    say("  the JAX tests' geometry (n_fft 64, 16 mels, hidden (5, 5)), "
        "random weights:")
    for b in (SLOTS, 3):
        check_webrtc_small(torch, small_cfg, small_plan, b, WEBRTC_HOPS,
                           SNR_GL32_DB, label="GL-32")
    check_webrtc_small(torch, warm_cfg(small_cfg, 4), small_plan, 64, 40,
                       SNR_GL4_DB, MAG_REL, label="GL-4 ")
    say(f"  n_fft {RUNTIME_FFT} (no compiled-in M), the same weights; warm GL "
        f"is chaotic there, so each hop from the plain version's state:")
    odd_cfg, _ = small_webrtc_model(torch, 4, RUNTIME_FFT)
    check_webrtc_forced(torch, odd_cfg, small_plan, 64, 8, SNR_GL4_DB)
    check_mel128(torch)
    return err


# -- the engines --------------------------------------------------------------

def phase_engine(torch, cfg, model):
    from audio_denoising_torch.runtime.engine import StreamEngine
    n, ticks = SLOTS, 50
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
    st = max(max_err(x.cpu(), planes(cpu.state)[k])
             for k, x in planes(gpu.state).items())
    say(f"  {n} streams x {ticks} ticks: out {worst:.3e} (bound {OUT_ATOL:g}),"
        f" state {st:.3e} (bound {STATE_ATOL:g}); {launches} launches")
    if worst > OUT_ATOL or st > STATE_ATOL:
        raise AssertionError("engine on the card disagrees with the CPU run")
    if launches != ticks:
        raise AssertionError(f"expected {ticks} kernel launches, saw "
                             f"{launches}")
    return launches


def phase_engine_webrtc(torch, cfg, model):
    """Mode fused-webrtc on the card against the CPU engine, the CPU engine
    given the card's state before every tick: each tick's outputs equal,
    hx within HX_ATOL, from tick 2 on the frame each active slot adds to
    its OLA buffer held by ``forced_floor`` (the float64 plain version run
    from the same state is the witness), idle slots untouched."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import KERNELS_PER_HOP
    from audio_denoising_torch.runtime.engine import StreamEngine
    n, ticks = SLOTS, 8
    gpu = StreamEngine(cfg, model, mode="fused-webrtc", max_streams=n)
    cpu = StreamEngine(cfg, model, mode="fused-webrtc", max_streams=n,
                       device="cpu")
    sids = [f"s{i}" for i in range(n)]
    for sid in sids:
        gpu.add_stream(sid)
        cpu.add_stream(sid)
    f64 = float64_plain(torch, cfg, gpu.plan)
    rng = np.random.default_rng(6)
    worst_hx, snrs, rules = 0.0, [], []
    gpu.hop_step.launches = 0
    for t in range(ticks):
        chunks = {sid: (0.2 * rng.standard_normal(cfg.dsp.hop_length)
                        ).astype(np.float32)
                  for i, sid in enumerate(sids) if (7 * i + t) % 5}
        active = [gpu.slots[s] for s in sids if s in chunks]
        idle = [gpu.slots[s] for s in sids if s not in chunks]
        before = to(gpu.state, "cpu")
        cpu.state = type(before)(*(x.clone() for x in before))
        a, b = gpu.process(chunks), cpu.process(chunks)
        after = to(gpu.state, "cpu")
        for x, y in zip(before, after):
            if not torch.equal(x[idle], y[idle]):
                raise AssertionError("an idle slot's state moved")
        for sid in chunks:
            if not np.array_equal(a[sid], b[sid]) or not np.all(
                    np.isfinite(a[sid])):
                raise AssertionError("engine outputs differ from the CPU "
                                     "engine's on the same state")
        worst_hx = max(worst_hx, max_err(after.hx, cpu.state.hx))
        if t >= 2:
            batch = torch.zeros((n, cfg.dsp.hop_length), dtype=torch.float64)
            for sid, chunk in chunks.items():
                batch[gpu.slots[sid]] = torch.from_numpy(chunk).double()
            s_d, _ = f64.reference(to(before, "cpu", torch.float64), batch)
            f_gpu, f_cpu, f_d = (added_frame(before, x, cfg.dsp.hop_length)
                                 [active] for x in (after, cpu.state, s_d))
            rules.append(forced_floor(f_gpu, f_cpu, f_d))
            snrs.append(snr_db(f_cpu, f_gpu))
    launches = gpu.hop_step.launches
    say(f"  {n} streams x {ticks} ticks, the CPU engine given the card's "
        f"state each tick: outputs equal; hx {worst_hx:.3e} (bound "
        f"{HX_ATOL:g}); idle slots bit-identical; {launches} kernel "
        f"launches; on ticks 2-{ticks - 1} the added frames' SNR card vs "
        f"CPU over the active slots "
        + ", ".join(f"{v:.1f}" for v in snrs) + " dB, and held, median "
        "over streams of card/f64 (CPU/f64, floor): "
        + ", ".join(f"{k:.1f} ({p:.1f}, {f:.1f})" for k, p, f in rules)
        + " dB")
    if worst_hx > HX_ATOL or any(k < f for k, _, f in rules):
        raise AssertionError("engine on the card disagrees with the CPU run")
    if launches != KERNELS_PER_HOP * ticks:
        raise AssertionError(f"expected {KERNELS_PER_HOP * ticks} "
                             f"kernel launches, saw {launches}")
    return launches


def _client(address, cid, chunks, results, errors, before_close=None):
    from multiprocessing.connection import Client
    try:
        with Client(address) as conn:
            def recv():
                if not conn.poll(REPLY_DEADLINE_S):
                    raise TimeoutError(f"client {cid}: no reply within "
                                       f"{REPLY_DEADLINE_S} s")
                return conn.recv()

            sids = [f"c{cid}s{j}" for j in range(chunks.shape[0])]
            slots = {}
            for sid in sids:
                conn.send(("open", sid))
                msg = recv()
                if msg[0] != "ok":
                    raise RuntimeError(f"open {sid}: {msg}")
                slots[sid] = msg[2]
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
            results[("slots", cid)] = [slots[s] for s in sids]
            if cid == 0:
                conn.send(("stats",))
                results["stats"] = recv()[1]
            if before_close is not None:
                before_close.wait(REPLY_DEADLINE_S)
            for sid in sids:
                conn.send(("close", sid))
                msg = recv()
                if msg[0] != "ok":
                    raise RuntimeError(f"close {sid}: {msg}")
            results[cid] = np.stack([np.stack(outs[s]) for s in sids])
    except Exception as e:   # reported by the main thread, which raises
        errors.append(f"client {cid}: {e!r}")


def serve_clients(daemon, data, kernel, before_close=None):
    """Run ``daemon`` for one client thread per row of ``data`` (clients,
    streams, chunks, hop); returns (outputs, slots, round seconds,
    launches, wall seconds). ``kernel`` is the wrapper whose launches are
    counted, or None where the mode's path has no hand-written kernel
    (launches then None)."""
    clients = data.shape[0]
    server = threading.Thread(target=daemon.serve_forever, daemon=True)
    results, errors, threads = {}, [], []
    server.start()
    try:
        if not daemon.listening.wait(60):
            raise TimeoutError("daemon did not start listening")
        if kernel is not None:
            kernel.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=_client, args=(
            daemon.address, c, data[c], results, errors, before_close),
            daemon=True) for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(REPLY_DEADLINE_S * (data.shape[2] + 4))
        wall = time.perf_counter() - t0
        launches = None if kernel is None else kernel.launches
    finally:
        daemon.stop()
        server.join(10)
    if any(t.is_alive() for t in threads) or server.is_alive():
        raise TimeoutError("a client or the daemon did not finish")
    if errors:
        raise RuntimeError("; ".join(errors))
    say(f"  stats: {json.dumps(results['stats'])}")
    got = np.concatenate([results[c] for c in range(clients)])
    slots = sum((results[("slots", c)] for c in range(clients)), [])
    rounds = np.concatenate([results[("round_s", c)]
                             for c in range(clients)])
    return got, slots, rounds, launches, wall


def latency_line(data, rounds, launches, wall):
    clients, streams, n_chunks = data.shape[:3]
    p50, p99 = np.percentile(rounds, [50, 99]) * 1e3
    counted = ("no hand-written kernel on this path" if launches is None
               else f"{launches} launches")
    return (f"{clients} clients x {streams} streams x {n_chunks} chunks in "
            f"{wall:.2f} s; {counted}; reply latency per round "
            f"(a client's {streams} chunks sent to its {streams} replies "
            f"in) p50 {p50:.3f} ms, p99 {p99:.3f} ms over {rounds.size} "
            f"rounds")


def phase_daemon(torch):
    from audio_denoising_torch.apps.engine_serve import EngineDaemon
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    clients, streams, n_chunks = 4, 16, 25
    daemon = EngineDaemon("gruunet2-stream16k", max_streams=SLOTS,
                          address=("127.0.0.1", 0), mode="fused")
    hop_len = daemon.cfg.dsp.hop_length
    rng = np.random.default_rng(4)
    data = (0.1 * rng.standard_normal(
        (clients, streams, n_chunks, hop_len))).astype(np.float32)
    got, _, rounds, launches, wall = serve_clients(daemon, data,
                                                   daemon.engine.hop_step)
    ref_hop = make_fused_hop(daemon.cfg, daemon.engine.plan, "cpu")
    state = fused_hop_init_state(daemon.cfg, daemon.engine.plan,
                                 clients * streams)
    seqs = data.reshape(clients * streams, n_chunks, hop_len)
    want = []
    for k in range(n_chunks):
        state, out = ref_hop(state, torch.from_numpy(seqs[:, k].copy()))
        want.append(out.numpy())
    err = float(np.abs(got - np.stack(want, axis=1)).max())
    say(f"  out {err:.3e} (bound {OUT_ATOL:g}); "
        + latency_line(data, rounds, launches, wall))
    if err > OUT_ATOL:
        raise AssertionError("daemon output disagrees with the plain version")
    if launches <= 0:
        raise AssertionError("the daemon never launched the kernel")
    return launches


def write_warm_checkpoint(model, cfg, directory):
    """dari_tult's weights with a full_config that turns warm start on:
    what serving mode fused-webrtc takes."""
    from audio_denoising_torch.compat import save_params_npz
    path = os.path.join(directory, "gruunet2-dari_tult-warm.npz")
    params = {k: v.numpy() for k, v in model.state_dict().items()}
    save_params_npz(path, params,
                    {"full_config": json.loads(warm_cfg(cfg).to_json())})
    return path


def phase_daemon_webrtc(torch, cfg, model):
    """Every reply in time; each stream's replies against its own sequence
    run through the kernel in this process (a stream's hop does not depend
    on the other streams in the batch, so the bound is tight), and its hx
    after its last chunk against the plain version on the CPU."""
    from audio_denoising_torch.apps.engine_serve import EngineDaemon
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    clients, streams, n_chunks = 4, 16, 8
    with tempfile.TemporaryDirectory() as tmp:
        spec = write_warm_checkpoint(model, cfg, tmp)
        daemon = EngineDaemon(spec, max_streams=SLOTS, mode="fused-webrtc",
                              address=("127.0.0.1", 0))
    hop_len = daemon.cfg.dsp.hop_length
    rng = np.random.default_rng(8)
    data = (0.2 * rng.standard_normal(
        (clients, streams, n_chunks, hop_len))).astype(np.float32)
    # streams close only once every client is done, so no slot is reused
    # before its final state is read
    got, slots, rounds, launches, wall = serve_clients(
        daemon, data, daemon.engine.hop_step, threading.Barrier(clients))
    plan = daemon.engine.plan
    seqs = torch.from_numpy(data.reshape(clients * streams, n_chunks,
                                         hop_len))
    want = {}
    for device in ("cuda", "cpu"):
        step = make_webrtc_hop(daemon.cfg, plan, device)
        state = webrtc_hop_init_state(daemon.cfg, plan, clients * streams,
                                      device)
        outs = []
        for k in range(n_chunks):
            state, out = step(state, seqs[:, k].contiguous().to(device))
            outs.append(out.cpu().numpy())
        want[device] = (state, np.stack(outs, axis=1))
    replay = float(np.abs(got - want["cuda"][1]).max())
    hx_err = max_err(daemon.engine.state.hx[slots].cpu(), want["cpu"][0].hx)
    say(f"  replies vs the kernel replayed per stream {replay:.3e} (bound "
        f"{REPLAY_ATOL:g}); hx vs the plain version on the CPU "
        f"{hx_err:.3e} (bound {HX_ATOL:g}); "
        + latency_line(data, rounds, launches, wall))
    if replay > REPLAY_ATOL or hx_err > HX_ATOL:
        raise AssertionError("daemon disagrees with the kernel replayed "
                             "per stream or with the plain version")
    if launches <= 0:
        raise AssertionError("the daemon never launched the kernel")
    return launches


# -- the fused cell and mode fast ---------------------------------------------

def cell_inputs(torch, batch, n_feat, n, seed, delta=False):
    """Features as the hop makes them (log1p of a magnitude, >= 0) and a
    state in the gating's range (-1, 1), on the card; for a delta plan
    also the previous features (else None)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.log1p(4 * torch.rand((batch, n_feat), generator=g,
                                   device="cuda"))
    hx = 2 * torch.rand((batch, n), generator=g, device="cuda") - 1
    prev = torch.log1p(4 * torch.rand((batch, n_feat), generator=g,
                                      device="cuda")) if delta else None
    return x, hx, prev


def phase_fused_cell(torch, plans):
    """Phases 8 and 27: the kernel against its plain version on the same
    inputs, at CELL_BATCHES streams, for each (name, plan); returns the
    largest error seen."""
    from audio_denoising_torch.ops.kernels.fused_cell import make_fused_cell
    worst = 0.0
    for name, plan in plans:
        cell = make_fused_cell(plan, "cuda")
        errs = []
        for batch in CELL_BATCHES:
            x, hx, prev = cell_inputs(torch, batch, cell.n_feat, cell.n,
                                      batch, cell.delta)
            y_k, h_k = cell(x, hx, prev)
            y_p, h_p = cell.reference(x, hx, prev)
            torch.cuda.synchronize()
            e = (max_err(y_k, y_p), max_err(h_k, h_p))
            errs.append(f"B={batch} y {e[0]:.3e} hx' {e[1]:.3e}")
            if max(e) > CELL_ATOL or not bool(torch.isfinite(y_k).all()):
                raise AssertionError(f"fused cell kernel disagrees with its "
                                     f"plain version ({name}, B={batch})")
            worst = max(worst, *e)
        say(f"  {name} (levels {len(plan.down_mats)}, hx {cell.n}, "
            f"{sum(w.numel() for w in cell.weights)} weights): "
            + "; ".join(errs) + f" (bound {CELL_ATOL:g})")
    return worst


def phase_profile(torch):
    """Phase 9: the profile command in mode fast on the fused cell, in
    this process; returns the cell's launches (one per hop it ran)."""
    import contextlib
    import io
    from audio_denoising_torch.apps import profile_app
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = profile_app.main(["--model", "gruunet2-good", "--streams",
                               str(SLOTS), "--mode", "fast", "--fused"])
    out = buf.getvalue()
    say("  " + out.strip().replace("\n", "\n  "))
    report = json.loads(out)
    launches = report["fused_cell_launches"]
    if rc != 0 or report["streams"] != SLOTS or not math.isfinite(
            report["amortized_ms_per_hop"]):
        raise AssertionError("the profile command failed")
    if launches != report["hops_run"] or launches <= 0:
        raise AssertionError(f"the profile ran {report['hops_run']} hops "
                             f"and launched the fused cell {launches} times")
    return launches, report


def phase_fast_step(torch, cfg, model):
    """Phases 10 and 27: the fast step with the fused cell on the card
    against the zoo model's fast step on the CPU, each carrying its own
    state; returns the cell's launches."""
    from audio_denoising_torch.runtime.engine import (
        fast_init_state, make_fast_step)
    from audio_denoising_torch.runtime.plan import PlanModel
    pm = PlanModel(model, fused=True)
    card = make_fast_step(cfg, pm)
    cpu = make_fast_step(cfg, model, "cpu")
    s_k = fast_init_state(cfg, pm, SLOTS, "cuda")
    s_c = fast_init_state(cfg, model, SLOTS, "cpu")
    rng = np.random.default_rng(10)
    pm.fused_cell.launches = 0
    e_out = e_hx = 0.0
    for t in range(HOPS):
        c = torch.from_numpy((0.1 * rng.standard_normal(
            (SLOTS, cfg.dsp.hop_length))).astype(np.float32))
        if t == 3:
            c.zero_()              # a silent hop: angle(0) is 0
        s_k, o_k = card(s_k, c.cuda())
        s_c, o_c = cpu(s_c, c)
        e_out = max(e_out, max_err(o_k.cpu(), o_c))
        e_hx = max(e_hx, max_err(s_k.hx.cpu(), s_c.hx.reshape(SLOTS, -1)))
        if s_c.prev is not None:     # MOMO3's previous frame
            e_hx = max(e_hx, max_err(s_k.prev.cpu(), s_c.prev))
        if not bool(torch.isfinite(o_k).all()):
            raise AssertionError(f"fast step: non-finite output at hop {t}")
    launches = pm.fused_cell.launches
    carried = "hx" if s_c.prev is None else "hx and prev"
    say(f"  {SLOTS} streams x {HOPS} hops: out {e_out:.3e} (bound "
        f"{OUT_ATOL:g}), {carried} {e_hx:.3e} (bound {HX_ATOL:g}); "
        f"{launches} fused-cell launches")
    if e_out > OUT_ATOL or e_hx > HX_ATOL:
        raise AssertionError("fast step on the card disagrees with the CPU")
    if launches != HOPS:
        raise AssertionError(f"expected {HOPS} fused-cell launches, saw "
                             f"{launches}")
    return launches


def phase_engine_fast(torch, cfg, model):
    """Phase 11: mode fast on the card against the CPU engine, each
    carrying its own state; idle slots bit-identical on the card."""
    from audio_denoising_torch.runtime.engine import StreamEngine
    n, ticks = SLOTS, 50
    gpu = StreamEngine(cfg, model, mode="fast", max_streams=n)
    cpu = StreamEngine(cfg, model, mode="fast", max_streams=n, device="cpu")
    sids = [f"s{i}" for i in range(n)]
    for sid in sids:
        gpu.add_stream(sid)
        cpu.add_stream(sid)
    rng = np.random.default_rng(11)
    worst = 0.0
    for t in range(ticks):
        chunks = {sid: (0.1 * rng.standard_normal(cfg.dsp.hop_length)
                        ).astype(np.float32)
                  for i, sid in enumerate(sids) if (7 * i + t) % 5}
        idle = [gpu.slots[s] for s in sids if s not in chunks]
        before = {k: x[idle].clone() for k, x in planes(gpu.state).items()}
        a, b = gpu.process(chunks), cpu.process(chunks)
        for k, x in before.items():
            if not torch.equal(x, planes(gpu.state)[k][idle]):
                raise AssertionError("an idle slot's state moved")
        worst = max(worst, max(float(np.abs(a[s] - b[s]).max())
                               for s in chunks))
    st = max(max_err(x.cpu(), planes(cpu.state)[k])
             for k, x in planes(gpu.state).items())
    say(f"  {n} streams x {ticks} ticks: out {worst:.3e} (bound "
        f"{OUT_ATOL:g}), state {st:.3e} (bound {STATE_ATOL:g}); idle slots "
        f"bit-identical; no hand-written kernel on this path")
    if worst > OUT_ATOL or st > STATE_ATOL:
        raise AssertionError("engine on the card disagrees with the CPU run")


def phase_daemon_fast(torch):
    """Phase 12: the JAX daemon's defaults (gruunet2-good, mode fast);
    every reply against its stream's sequence through the fast step on the
    CPU."""
    from audio_denoising_torch.apps.engine_serve import EngineDaemon
    from audio_denoising_torch.runtime.engine import (
        fast_init_state, make_fast_step)
    clients, streams, n_chunks = 4, 16, 25
    daemon = EngineDaemon("gruunet2-good", max_streams=SLOTS, mode="fast",
                          address=("127.0.0.1", 0))
    hop_len = daemon.cfg.dsp.hop_length
    rng = np.random.default_rng(13)
    data = (0.1 * rng.standard_normal(
        (clients, streams, n_chunks, hop_len))).astype(np.float32)
    got, _, rounds, launches, wall = serve_clients(daemon, data, None)
    step = make_fast_step(daemon.cfg, daemon.model, "cpu")
    state = fast_init_state(daemon.cfg, daemon.model, clients * streams)
    seqs = data.reshape(clients * streams, n_chunks, hop_len)
    want = []
    for k in range(n_chunks):
        state, out = step(state, torch.from_numpy(seqs[:, k].copy()))
        want.append(out.numpy())
    err = float(np.abs(got - np.stack(want, axis=1)).max())
    say(f"  out {err:.3e} (bound {OUT_ATOL:g}); "
        + latency_line(data, rounds, launches, wall))
    if err > OUT_ATOL or not np.all(np.isfinite(got)):
        raise AssertionError("daemon output disagrees with the fast step")


# -- the SNR gate and the resident K-hop kernel -------------------------------

def with_gate(cfg, estimator, gate_db, width_db):
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, snr_gate_db=gate_db, snr_gate_width_db=width_db,
        snr_gate_estimator=estimator))


def voiced(n, sr):
    """A synthetic vowel: a glottal pulse train (f0 140 +- 30 Hz) through
    three formant resonators (700, 1220, 2600 Hz), in syllables at 4 Hz,
    peak 0.3. The models keep it, so the gate's estimators read clean
    streams as clean (a steady tone reads as noise to them)."""
    t = np.arange(n) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 1.5 * t)
    cycles = np.floor(np.cumsum(f0) / sr)
    x = (np.diff(cycles, prepend=0) > 0).astype(np.float64)
    for freq, bw in ((700, 130), (1220, 70), (2600, 160)):
        r = math.exp(-math.pi * bw / sr)
        c1, c2 = 2 * r * math.cos(2 * math.pi * freq / sr), -r * r
        y, y1, y2 = np.empty_like(x), 0.0, 0.0
        for i in range(n):
            y1, y2 = (1 - r) * x[i] + c1 * y1 + c2 * y2, y1
            y[i] = y1
        x = y
    x *= 0.5 * (1 - np.cos(2 * np.pi * 4 * t))
    return 0.3 * x / np.abs(x).max()


def voiced_chunks(batch, hops, hop_len, sr, seed):
    """(hops, batch, hop_len) float32: the vowel over per-stream noise
    levels from 1e-3 to 1 (seeded), which spread the gate's alpha over
    (0, 1) in the manner of tests/test_fused_hop.py's _bursty."""
    rng = np.random.default_rng(seed)
    x = voiced(hops * hop_len, sr)
    lv = np.geomspace(1e-3, 1.0, batch)[:, None]
    sig = x[None] + lv * rng.standard_normal((batch, hops * hop_len))
    return np.ascontiguousarray(sig.reshape(batch, hops, hop_len)
                                .transpose(1, 0, 2)).astype(np.float32)


def plane_errors(got, want):
    """{plane: error} of two states on their present planes: max abs for
    ring, ola, hx and prev (ABS_PLANES); for the gate's planes the largest
    |a - b| / (PLANE_ATOL / PLANE_RTOL + |b|), which stays under
    PLANE_RTOL exactly when |a - b| <= PLANE_ATOL + PLANE_RTOL |b|."""
    errs = {}
    for k, a in planes(got).items():
        b = planes(want)[k].to(a.device)
        if k in ABS_PLANES:
            errs[k] = max_err(a, b)
        else:
            d = (a.double() - b.double()).abs()
            errs[k] = float((d / (PLANE_ATOL / PLANE_RTOL
                                  + b.double().abs())).max().cpu())
    return errs


def check_state(errs, label):
    bad = {k: v for k, v in errs.items()
           if v > (STATE_ATOL if k in ABS_PLANES else PLANE_RTOL)}
    if bad:
        raise AssertionError(f"{label}: state planes out of bounds {bad}")


def fmt(errs):
    return ", ".join(f"{k} {v:.2e}" for k, v in errs.items())


def check_gated_hop(torch, cfg, plan, batch):
    """Gated kernel against its plain version, each carrying its own
    state over HOPS hops of voiced_chunks; returns (out error, alpha share
    in (0, 1))."""
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    hop = make_fused_hop(cfg, plan, "cuda")
    chunks = torch.from_numpy(voiced_chunks(batch, HOPS, hop.hop,
                                            cfg.dsp.sample_rate, batch)).cuda()
    s_k = s_p = fused_hop_init_state(cfg, plan, batch, "cuda")
    e_out, alphas = 0.0, []
    for c in chunks:
        s_k, o_k = hop(s_k, c)
        s_p, o_p = hop.reference(s_p, c)
        e_out = max(e_out, max_err(o_k, o_p))
        alphas.append(hop.alpha(s_p))
    torch.cuda.synchronize()
    alphas = torch.cat(alphas)
    share = float(((alphas > 0) & (alphas < 1)).double().mean().cpu())
    errs = plane_errors(s_k, s_p)
    srv = cfg.serving
    say(f"    {srv.snr_gate_estimator:7s} gate {srv.snr_gate_db:g} dB width "
        f"{srv.snr_gate_width_db:g}, B={batch:3d}: out {e_out:.3e} (bound "
        f"{OUT_ATOL:g}); {fmt(errs)}; alpha in (0, 1) on {share:.1%} of "
        f"stream-hops")
    if e_out > OUT_ATOL or not bool(torch.isfinite(s_k.ola).all()):
        raise AssertionError(f"gated fused hop disagrees with its plain "
                             f"version at B={batch}")
    check_state(errs, "gated fused hop")
    if share <= 0:
        raise AssertionError("the gate never blended: alpha in {0, 1} on "
                             "every stream-hop")
    return e_out, share


def check_gated_against_fast(torch, cfg, model, plan):
    """The gated kernel against the gated fast step (the zoo model on the
    card), each carrying its own state over HOPS hops at SLOTS streams."""
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    from audio_denoising_torch.runtime.engine import (
        fast_init_state, make_fast_step)
    hop = make_fused_hop(cfg, plan, "cuda")
    fast = make_fast_step(cfg, model)
    chunks = torch.from_numpy(voiced_chunks(
        SLOTS, HOPS, hop.hop, cfg.dsp.sample_rate, 17)).cuda()
    s_k = fused_hop_init_state(cfg, plan, SLOTS, "cuda")
    s_f = fast_init_state(cfg, model, SLOTS, "cuda")
    worst = 0.0
    for c in chunks:
        s_k, o_k = hop(s_k, c)
        s_f, o_f = fast(s_f, c)
        worst = max(worst, max_err(o_k, o_f))
    say(f"    kernel vs the gated fast step ({cfg.serving.snr_gate_estimator},"
        f" B={SLOTS}, {HOPS} hops): out {worst:.3e} (bound "
        f"{GATED_OUT_ATOL:g})")
    if worst > GATED_OUT_ATOL:
        raise AssertionError("gated fused hop disagrees with the gated fast "
                             "step")


def phase_gated_hop(torch, checkpoints):
    """The gated kernel on each (name, cfg, model, plan, {estimator:
    (gate, width)}); returns the largest output error."""
    worst = 0.0
    for name, cfg, model, plan, points in checkpoints:
        say(f"  {name}:")
        for estimator, (gate_db, width_db) in points.items():
            gcfg = with_gate(cfg, estimator, gate_db, width_db)
            for batch in (SLOTS, 3):
                worst = max(worst, check_gated_hop(torch, gcfg, plan,
                                                   batch)[0])
        check_gated_against_fast(torch, with_gate(cfg, "both",
                                                  *points["both"]),
                                 model, plan)
    return worst


def check_multi(torch, cfg, plan, label, chunks, dtype="float32"):
    """The K-hop kernel in ``dtype`` on the main path (two calls carrying
    the state, in float32 and with int16 IO, each one launch), then
    against K launches of the single-hop kernel (0 expected on every
    output and plane), its plain version over both calls and the int16
    plain path (hold_free; in float32 the int16 path within 1 LSB) and the
    float32 K-hop clipped and scaled (2 LSB). Returns (launches, largest
    output error against the plain version, worst stream dB or None)."""
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    dt = getattr(torch, dtype)
    K, B = chunks.shape[:2]
    multi = make_fused_hop(cfg, plan, "cuda", hops_per_call=K,
                           compute_dtype=dt)
    multi16 = make_fused_hop(cfg, plan, "cuda", hops_per_call=K,
                             io_dtype=torch.int16, compute_dtype=dt)
    pcm = (torch.clamp(chunks, -1, 1) * 32767).to(torch.int16)
    s0 = fused_hop_init_state(cfg, plan, B, "cuda")
    # the main path: each call one launch
    multi.launches = multi16.launches = 0
    s_m, outs_m = multi(s0, chunks)
    s_m2, outs_m2 = multi(s_m, chunks)
    s_16, outs_16 = multi16(s0, pcm)
    torch.cuda.synchronize()
    launches = multi.launches + multi16.launches
    if multi.launches != 2 or multi16.launches != 1:
        raise AssertionError(f"{label} ({dtype}): {multi.launches} and "
                             f"{multi16.launches} launches for 2 and 1 "
                             f"calls")
    # K launches of the single-hop kernel on the same chunks
    single = make_fused_hop(cfg, plan, "cuda", compute_dtype=dt)
    s_s, outs_s = run_hops(single, s0, chunks)
    exact = {k: max_err(planes(s_m)[k], v) for k, v in planes(s_s).items()}
    exact["out"] = max_err(outs_m, torch.stack(outs_s))
    # the plain version, over both calls
    s_p, outs_p = multi.plain(s0, chunks)
    s_p2, outs_p2 = multi.plain(s_p, chunks)
    if max(exact.values()) > KHOP_EXACT:
        raise AssertionError(f"{label} ({dtype}): the K-hop kernel differs "
                             f"from K single hops: {fmt(exact)}")
    text, e_plain, db = hold_free(
        f"{label} K-hop", dtype, cfg, torch.cat([outs_p, outs_p2]),
        torch.cat([outs_m, outs_m2]), s_p2, s_m2)
    # int16 IO
    _, outs_16p = multi16.plain(s0, pcm)
    if dtype == "float32":
        lsb_plain = int((outs_16.int() - outs_16p.int()).abs().max().cpu())
        text16 = f"{lsb_plain} LSB (bound 1)"
        if lsb_plain > 1:
            raise AssertionError(f"{label}: int16 IO out of bounds")
    else:
        text16 = hold_free(f"{label} int16 IO", dtype, cfg, outs_16p,
                           outs_16)[0]
    s_f, outs_f = multi(s0, pcm.float() * (1.0 / 32768.0))
    scaled = torch.clamp(outs_f, -1, 1) * 32767
    lsb_f32 = float((outs_16.float() - scaled).abs().max().cpu())
    torch.cuda.synchronize()
    say(f"  {label}, {dtype}, B={B}, K={K}: K-hop vs {K} single-hop "
        f"launches: {fmt(exact)} (bound {KHOP_EXACT:g}, 0 expected); vs "
        f"the plain version over 2 calls: {text}; int16 IO vs its plain "
        f"path: {text16}; vs the float32 K-hop clipped and scaled "
        f"{lsb_f32:.2f} LSB (bound 2); {launches} launches for 3 calls")
    if lsb_f32 > 2:
        raise AssertionError(f"{label} ({dtype}): int16 IO out of bounds")
    return launches, e_plain, db


def phase_multi(torch, cfg, plan):
    """Phase 14 at bench.py's headline shape: ungated (fused_hop_resident)
    and with the tuned gate, estimator 'both' (fused_hop_gated_both)."""
    chunks = torch.from_numpy(voiced_chunks(
        SLOTS, K_HOPS, cfg.dsp.hop_length, cfg.dsp.sample_rate, 14)).cuda()
    launches = worst = 0
    for label, c in (("ungated", cfg), ("gated both", tuned_gate(cfg))):
        n, e, _ = check_multi(torch, c, plan, label, chunks)
        launches += n
        worst = max(worst, e)
    return launches, worst


def tuned_gate(cfg):
    """bench.py's fused_hop_gated_both: with_snr_gate(cfg, 1.0)."""
    import warnings
    from audio_denoising_torch.config import with_snr_gate
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the x3 gain's level warning
        return with_snr_gate(cfg, 1.0)


def phase_engine_gated(torch, cfg, model):
    """Mode fused with the checkpoint's recommended gate, card vs CPU,
    each carrying its own state; idle slots bit-identical on the card."""
    from audio_denoising_torch.runtime.engine import StreamEngine
    n, ticks = SLOTS, 30
    gpu = StreamEngine(cfg, model, mode="fused", max_streams=n)
    cpu = StreamEngine(cfg, model, mode="fused", max_streams=n, device="cpu")
    sids = [f"s{i}" for i in range(n)]
    for sid in sids:
        gpu.add_stream(sid)
        cpu.add_stream(sid)
    data = voiced_chunks(n, ticks, cfg.dsp.hop_length, cfg.dsp.sample_rate,
                         15)
    worst = 0.0
    gpu.hop_step.launches = 0
    for t in range(ticks):
        chunks = {sid: data[t, i] for i, sid in enumerate(sids)
                  if (7 * i + t) % 5}
        idle = [gpu.slots[s] for s in sids if s not in chunks]
        before = {k: x[idle].clone() for k, x in planes(gpu.state).items()}
        a, b = gpu.process(chunks), cpu.process(chunks)
        for k, x in before.items():
            if not torch.equal(x, planes(gpu.state)[k][idle]):
                raise AssertionError(f"an idle slot's {k} moved")
        worst = max(worst, max(float(np.abs(a[s] - b[s]).max())
                               for s in chunks))
    launches = gpu.hop_step.launches
    errs = plane_errors(gpu.state, cpu.state)
    say(f"  {n} streams x {ticks} ticks ({cfg.serving.snr_gate_estimator}, "
        f"gate {cfg.serving.snr_gate_db:g} dB): out {worst:.3e} (bound "
        f"{OUT_ATOL:g}), {fmt(errs)}; idle slots bit-identical; {launches} "
        f"launches")
    if worst > OUT_ATOL:
        raise AssertionError("gated engine on the card disagrees with the "
                             "CPU run")
    check_state(errs, "gated engine")
    if launches != ticks:
        raise AssertionError(f"expected {ticks} kernel launches, saw "
                             f"{launches}")
    return launches


def replay(step, state, data):
    """Each stream's chunks (clients, streams, chunks, hop) through
    ``step`` from ``state``, on the CPU; (clients * streams, chunks, hop)."""
    import torch
    seqs = data.reshape(-1, data.shape[2], data.shape[3])
    want = []
    for k in range(seqs.shape[1]):
        state, out = step(state, torch.from_numpy(seqs[:, k].copy()))
        want.append(out.numpy())
    return np.stack(want, axis=1)


def daemon_data(cfg, clients, streams, n_chunks, seed):
    """Voiced streams at spread noise levels, (clients, streams, chunks,
    hop)."""
    hop = cfg.dsp.hop_length
    v = voiced_chunks(clients * streams, n_chunks, hop, cfg.dsp.sample_rate,
                      seed)
    return np.ascontiguousarray(v.transpose(1, 0, 2).reshape(
        clients, streams, n_chunks, hop))


def phase_daemon_gated(torch, spec):
    """EngineDaemon mode fused with auto gate on a unit-gain checkpoint;
    every reply against its stream's sequence through the CPU step."""
    from audio_denoising_torch.apps.engine_serve import EngineDaemon
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    clients, streams, n_chunks = 4, 16, 25
    daemon = EngineDaemon(spec, max_streams=SLOTS, address=("127.0.0.1", 0),
                          mode="fused")
    srv = daemon.cfg.serving
    if srv.snr_gate_db is None:
        raise AssertionError("auto gate did not gate a unit-gain checkpoint")
    data = daemon_data(daemon.cfg, clients, streams, n_chunks, 16)
    got, _, rounds, launches, wall = serve_clients(daemon, data,
                                                   daemon.engine.hop_step)
    plan = daemon.engine.plan
    want = replay(make_fused_hop(daemon.cfg, plan, "cpu"),
                  fused_hop_init_state(daemon.cfg, plan, clients * streams),
                  data)
    err = float(np.abs(got - want).max())
    say(f"  gate {srv.snr_gate_db:g} dB, width {srv.snr_gate_width_db:g}, "
        f"{srv.snr_gate_estimator}: out {err:.3e} (bound {OUT_ATOL:g}); "
        + latency_line(data, rounds, launches, wall))
    if err > OUT_ATOL:
        raise AssertionError("gated daemon disagrees with the plain version")
    if launches <= 0:
        raise AssertionError("the daemon never launched the kernel")
    return launches


def phase_daemon_defaults(torch, spec):
    """EngineDaemon(spec) with the JAX daemon's defaults (mode fast, auto
    gate) on a unit-gain 48 kHz checkpoint; every reply against its
    stream's sequence through the gated fast step on the CPU."""
    from audio_denoising_torch.apps.engine_serve import EngineDaemon
    from audio_denoising_torch.runtime.engine import (
        fast_init_state, make_fast_step)
    clients, streams, n_chunks = 4, 16, 25
    daemon = EngineDaemon(spec, max_streams=SLOTS, address=("127.0.0.1", 0))
    srv = daemon.cfg.serving
    if daemon.engine.mode != "fast" or srv.snr_gate_db is None:
        raise AssertionError("the daemon's defaults are not mode fast with "
                             "the gate")
    data = daemon_data(daemon.cfg, clients, streams, n_chunks, 18)
    got, _, rounds, launches, wall = serve_clients(daemon, data, None)
    want = replay(make_fast_step(daemon.cfg, daemon.model, "cpu"),
                  fast_init_state(daemon.cfg, daemon.model,
                                  clients * streams), data)
    err = float(np.abs(got - want).max())
    say(f"  mode {daemon.engine.mode}, gate {srv.snr_gate_db:g} dB, "
        f"{srv.snr_gate_estimator}, n_fft {daemon.cfg.dsp.n_fft}: out "
        f"{err:.3e} (bound {OUT_ATOL:g}); "
        + latency_line(data, rounds, launches, wall))
    if err > OUT_ATOL or not np.all(np.isfinite(got)):
        raise AssertionError("daemon output disagrees with the fast step")


# -- the resident K-hop WebRTC hop and the gated webrtc step -----------------

def check_webrtc_multi_exact(torch, cfg, plan, batch, calls):
    """``calls`` calls of the K-hop kernel (K = WEBRTC_K) carrying the
    state, each one launch (the main path where batch = SLOTS), against
    the same hops as single-hop calls from the same state: every output
    and every plane must be equal (0 expected). Returns the launches."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    multi = make_webrtc_hop(cfg, plan, "cuda", hops_per_call=WEBRTC_K)
    single = make_webrtc_hop(cfg, plan, "cuda")
    chunks = [torch.stack(webrtc_chunks(torch, batch, WEBRTC_K, batch + c,
                                        multi.hop)).cuda()
              for c in range(calls)]
    s0 = webrtc_hop_init_state(cfg, plan, batch, "cuda")
    multi.launches = 0
    s_m, outs_m = s0, []
    for c in chunks:
        s_m, o = multi(s_m, c)
        outs_m.append(o)
    torch.cuda.synchronize()
    launches = multi.launches
    s_s, outs_s = run_hops(single, s0, torch.cat(chunks))
    exact = {k: max_err(getattr(s_m, k), v) for k, v in planes(s_s).items()}
    exact["out"] = max_err(torch.cat(outs_m), torch.stack(outs_s))
    say(f"  GL-{multi.n_iter:<2d} B={batch:3d}, {fft_label(multi)}: {calls} "
        f"calls of K={WEBRTC_K} "
        f"vs {calls * WEBRTC_K} single-hop calls: {fmt(exact)} (0 "
        f"expected); {launches} launches for {calls} calls; phases unit")
    if max(exact.values()) != 0 or not phases_ok(torch, s_m):
        raise AssertionError(f"the K-hop webrtc kernel differs from single "
                             f"hops (GL-{multi.n_iter}, B={batch})")
    if launches != calls:
        raise AssertionError(f"{launches} K-hop launches for {calls} calls")
    return launches


def check_webrtc_multi_forced(torch, cfg, plan, batch, calls, bound):
    """The K-hop kernel (K = FORCED_K) against its plain version by the
    forced-state rule: every call starts from the plain version's state,
    and the kernel, the plain version and the float64 plain version each
    run its K hops; from the second call on, ``forced_floor`` holds what
    the call adds to the output stream (``call_signal``); at every call
    hx within HX_ATOL and unit phases. Returns the largest error of the
    kernel's OLA buffer against the plain version's."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    multi = make_webrtc_hop(cfg, plan, "cuda", hops_per_call=FORCED_K)
    f64 = float64_plain(torch, cfg, plan, FORCED_K)
    s = webrtc_hop_init_state(cfg, plan, batch, "cuda")
    rules, worst_hx, worst_ola = [], 0.0, 0.0
    for t in range(calls):
        c = torch.stack(webrtc_chunks(torch, batch, FORCED_K, batch + 31 + t,
                                      multi.hop))
        s_k, o_k = multi(s, c.cuda())
        s_p, o_p = multi.plain(s, c.cuda())
        s_d, o_d = f64.plain(to(s, "cpu", torch.float64), c.double())
        torch.cuda.synchronize()
        worst_hx = max(worst_hx, max_err(s_k.hx, s_p.hx))
        worst_ola = max(worst_ola, max_err(s_k.ola, s_p.ola))
        if not phases_ok(torch, s_k) or not bool(torch.isfinite(
                s_k.ola).all()):
            raise AssertionError(f"K-hop webrtc kernel: non-unit phases or "
                                 f"a non-finite frame at call {t}")
        if t >= 1:         # a stream's first window is half silence
            rules.append(forced_floor(
                *(call_signal(s, x, o, multi.hop)
                  for x, o in ((s_k, o_k), (s_p, o_p), (s_d, o_d))), bound))
        s = s_p
    worst = min(rules, key=lambda r: r[0] - r[2])
    say(f"  GL-{multi.n_iter:<2d} B={batch:3d}, {fft_label(multi)}, "
        f"K={FORCED_K}, {calls} calls "
        f"each from the plain version's state: median over streams of "
        f"kernel/f64 >= min({bound:g}, plain/f64 - {WITNESS_DB:g}) on calls 1-"
        f"{calls - 1}: lowest {min(r[0] for r in rules):.1f} dB, closest "
        f"call {worst[0]:.1f} (plain/f64 {worst[1]:.1f}, floor {worst[2]:.1f})"
        f" dB; hx {worst_hx:.3e} (bound {HX_ATOL:g}); ola {worst_ola:.3e}; "
        f"phases unit")
    if worst_hx > HX_ATOL or any(k < f for k, _, f in rules):
        raise AssertionError(f"K-hop webrtc kernel disagrees with its plain "
                             f"version (GL-{multi.n_iter}, B={batch})")
    return worst_ola


def check_webrtc_multi_small(torch, cfg, plan, batch, K, snr_bound,
                             mag_rel=None, label=""):
    """At the JAX tests' small geometry one call of K hops from the
    initial state against the plain version's K hops: the waveform SNR of
    hops 2 on (and with ``mag_rel`` each hop's output rfft magnitudes),
    hx and unit phases, as ``check_webrtc_small`` holds the single hop."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    multi = make_webrtc_hop(cfg, plan, "cuda", hops_per_call=K)
    chunks = torch.stack(webrtc_chunks(torch, batch, K, batch + 7,
                                       multi.hop)).cuda()
    s0 = webrtc_hop_init_state(cfg, plan, batch, "cuda")
    s_k, o_k = multi(s0, chunks)
    s_p, o_p = multi.plain(s0, chunks)
    o_k, o_p = o_k.cpu().numpy(), o_p.cpu().numpy()
    hx = max_err(s_k.hx, s_p.hx)
    snrs = [snr_db(p, k) for p, k in zip(o_p[2:], o_k[2:])]
    if not phases_ok(torch, s_k) or not np.all(np.isfinite(o_k)):
        raise AssertionError("K-hop webrtc kernel: non-unit phases or a "
                             "non-finite output")
    if mag_rel is not None:
        m0 = np.abs(np.fft.rfft(o_p, axis=-1))
        m1 = np.abs(np.fft.rfft(o_k, axis=-1))
        if np.abs(m1 - m0).max() > mag_rel * max(1.0, m0.max()):
            raise AssertionError("K-hop webrtc kernel: output magnitudes "
                                 "drift")
    say(f"  {label} B={batch:3d}, {fft_label(multi)}, one call of K={K}: hx "
        f"{hx:.3e} (bound "
        f"{HX_ATOL:g}); waveform SNR on hops 2-{K - 1} min {min(snrs):.1f} "
        f"dB (bound {snr_bound:g}); phases unit")
    if hx > HX_ATOL or min(snrs) < snr_bound:
        raise AssertionError(f"K-hop webrtc kernel disagrees with its plain "
                             f"version ({label}, B={batch})")


def phase_webrtc_multi(torch, cfg, plan):
    """Phases 19 to 22; returns (launches on the main path, the largest
    OLA error against the plain version of the forced GL-32 run at
    B=SLOTS)."""
    say(f"phase 19: the resident K-hop WebRTC hop (gruunet2-dari_tult, "
        f"{SLOTS} streams, K={WEBRTC_K}) vs single-hop calls, bit for bit")
    launches = sum(check_webrtc_multi_exact(torch, warm_cfg(cfg, n), plan,
                                            SLOTS, 2) for n in WEBRTC_GL)
    say("phase 20: the K-hop WebRTC hop on ragged batches")
    for b in (SLOTS - 1, 3):
        check_webrtc_multi_exact(torch, warm_cfg(cfg, WEBRTC_GL[0]), plan, b,
                                 1)
    say("phase 21: the K-hop WebRTC hop vs its plain version, each call from "
        "a shared state")
    err = max(check_webrtc_multi_forced(torch, warm_cfg(cfg, n), plan, b, 4,
                                        SNR_GL32_DB)
              for n in WEBRTC_GL for b in (SLOTS, 3))
    say("phase 22: the K-hop WebRTC hop vs its plain version at the JAX "
        "tests' geometry (n_fft 64, 16 mels, hidden (5, 5)), random weights")
    from audio_denoising_torch.runtime.plan import build_cell_plan
    small_cfg, small = small_webrtc_model(torch, 32)
    small_plan = build_cell_plan(small)
    for b in (SLOTS, 3):
        check_webrtc_multi_small(torch, small_cfg, small_plan, b, WEBRTC_HOPS,
                                 SNR_GL32_DB, label="GL-32")
    check_webrtc_multi_small(torch, warm_cfg(small_cfg, 4), small_plan, 64, 40,
                             SNR_GL4_DB, MAG_REL, label="GL-4 ")
    say(f"  n_fft {RUNTIME_FFT} (no compiled-in M), each call from the plain "
        f"version's state:")
    odd_cfg, _ = small_webrtc_model(torch, 4, RUNTIME_FFT)
    check_webrtc_multi_forced(torch, odd_cfg, small_plan, 64, 4, SNR_GL4_DB)
    return launches, err


def phase_engine_webrtc_gated(torch, cfg, model):
    """Mode webrtc with the SNR gate (the op-by-op step; no hand-written
    kernel on this path) on the card against the CPU engine, the CPU
    engine given the card's state before every tick, as phase 6 holds
    mode fused-webrtc: each tick's outputs equal, hx within HX_ATOL, the
    gate's planes within PLANE_RTOL, idle slots bit-identical, and from
    tick 2 on the median over the active slots of the SNR of what each
    adds to its OLA buffer, card vs CPU, at least SNR_GL32_DB (a few
    streams per hop flip a near-zero bin's phase in any fp32 version);
    the gate blends on some stream-ticks."""
    from audio_denoising_torch.ops.noisefloor import gate_weight
    from audio_denoising_torch.runtime.engine import StreamEngine
    n, ticks = SLOTS, 8
    gpu = StreamEngine(cfg, model, mode="webrtc", max_streams=n)
    cpu = StreamEngine(cfg, model, mode="webrtc", max_streams=n,
                       device="cpu")
    sids = [f"s{i}" for i in range(n)]
    for sid in sids:
        gpu.add_stream(sid)
        cpu.add_stream(sid)
    data = voiced_chunks(n, ticks, cfg.dsp.hop_length, cfg.dsp.sample_rate,
                         23)
    worst_hx, medians, alphas, worst_planes = 0.0, [], [], {}
    for t in range(ticks):
        chunks = {sid: data[t, i] for i, sid in enumerate(sids)
                  if (7 * i + t) % 5}
        active = [gpu.slots[s] for s in sids if s in chunks]
        idle = [gpu.slots[s] for s in sids if s not in chunks]
        before = to(gpu.state, "cpu")
        cpu.state = type(before)(*(None if x is None else x.clone()
                                   for x in before))
        a, b = gpu.process(chunks), cpu.process(chunks)
        after = to(gpu.state, "cpu")
        for k, x in planes(before).items():
            if not torch.equal(x[idle], getattr(after, k)[idle]):
                raise AssertionError(f"an idle slot's {k} moved")
        for sid in chunks:
            if not np.array_equal(a[sid], b[sid]) or not np.all(
                    np.isfinite(a[sid])):
                raise AssertionError("engine outputs differ from the CPU "
                                     "engine's on the same state")
        worst_hx = max(worst_hx, max_err(after.hx, cpu.state.hx))
        for k, v in plane_errors(after, cpu.state).items():
            worst_planes[k] = max(worst_planes.get(k, 0.0), v)
        alphas.append(gate_weight(cfg.serving, after)[active])
        if t >= 2:
            f_gpu, f_cpu = (added_frame(before, x, cfg.dsp.hop_length)[active]
                            for x in (after, cpu.state))
            medians.append(float(np.median(stream_snrs(f_cpu, f_gpu))))
    alphas = torch.cat(alphas)
    share = float(((alphas > 0) & (alphas < 1)).double().mean())
    srv = cfg.serving
    gate_errs = {k: v for k, v in worst_planes.items()
                 if k not in ("ring", "ola", "hx")}
    say(f"  {n} streams x {ticks} ticks ({srv.snr_gate_estimator}, gate "
        f"{srv.snr_gate_db:g} dB, width {srv.snr_gate_width_db:g}, GL-"
        f"{cfg.dsp.griffin_lim_iters}), the CPU engine given the card's state "
        f"each tick: outputs equal; hx {worst_hx:.3e} (bound {HX_ATOL:g}); "
        f"{fmt(gate_errs)} (bound {PLANE_RTOL:g}); idle slots bit-identical; "
        f"median over streams of the added frames' SNR card vs CPU on ticks "
        f"2-{ticks - 1}: " + ", ".join(f"{v:.1f}" for v in medians)
        + f" dB (bound {SNR_GL32_DB:g}); alpha in (0, 1) on {share:.1%} of "
        f"stream-ticks; no hand-written kernel on this path")
    if worst_hx > HX_ATOL or min(medians) < SNR_GL32_DB:
        raise AssertionError("gated webrtc engine on the card disagrees with "
                             "the CPU engine")
    check_state(gate_errs, "gated webrtc engine")
    if share <= 0:
        raise AssertionError("the gate never blended in mode webrtc")


def phase_daemon_webrtc_gated(torch, spec):
    """EngineDaemon mode webrtc with ``--snr-gate`` (the tuned 1 dB, width
    6, 'both') on ``spec``: every reply in time and each stream's replies
    equal to its chunks replayed through the gated step on the card at
    the daemon's slot count, the streams at their slots (a stream's hop
    reads only its own row); hx and the gate's planes against the same
    replay on the CPU."""
    from audio_denoising_torch.apps.engine_serve import (
        daemon_from_args, parser)
    from audio_denoising_torch.pipeline import (
        make_webrtc_step, webrtc_init_state)
    clients, streams, n_chunks = 4, 16, 8
    daemon = daemon_from_args(parser().parse_args(
        ["--model", spec, "--mode", "webrtc", "--snr-gate", "1",
         "--max-streams", str(SLOTS), "--host", "127.0.0.1", "--port", "0"]))
    srv, cfg = daemon.cfg.serving, daemon.cfg
    data = daemon_data(cfg, clients, streams, n_chunks, 24)
    # streams close only once every client is done, so no slot is reused
    # before its final state is read
    got, slots, rounds, launches, wall = serve_clients(
        daemon, data, None, threading.Barrier(clients))
    seqs = data.reshape(clients * streams, n_chunks, -1)
    want = {}
    for device in ("cuda", "cpu"):
        step = make_webrtc_step(cfg, daemon.model, device)
        state = webrtc_init_state(cfg, daemon.model, SLOTS, device)
        outs = []
        for k in range(n_chunks):
            batch = torch.zeros((SLOTS, seqs.shape[2]))
            batch[slots] = torch.from_numpy(seqs[:, k].copy())
            state, out = step(state, batch.to(device))
            outs.append(out[slots].cpu().numpy())
        want[device] = (state, np.stack(outs, axis=1))
    replay = float(np.abs(got - want["cuda"][1]).max())
    final = daemon.engine.state._replace(**{
        k: v[slots] for k, v in planes(daemon.engine.state).items()})
    ref = want["cpu"][0]._replace(**{
        k: v[slots] for k, v in planes(want["cpu"][0]).items()})
    hx_err = max_err(final.hx.cpu(), ref.hx)
    gate_errs = {k: v for k, v in plane_errors(final, ref).items()
                 if k not in ("ring", "ola", "hx")}
    say(f"  gate {srv.snr_gate_db:g} dB, width {srv.snr_gate_width_db:g}, "
        f"{srv.snr_gate_estimator}: replies vs the gated step replayed on the "
        f"card {replay:.3e} (bound {REPLAY_ATOL:g}); hx vs the CPU replay "
        f"{hx_err:.3e} (bound {HX_ATOL:g}); {fmt(gate_errs)} (bound "
        f"{PLANE_RTOL:g}); " + latency_line(data, rounds, launches, wall))
    if replay > REPLAY_ATOL or hx_err > HX_ATOL or not np.all(
            np.isfinite(got)):
        raise AssertionError("gated webrtc daemon disagrees with the gated "
                             "step")
    check_state(gate_errs, "gated webrtc daemon")


# -- the MOMO family: the delta carry and the raw domain ----------------------

def momo2_model():
    """MOMO2 (raw domain, no delta) at MOMO3's geometry on the weights of
    tests/goldens/model_MOMO2-rand.npz: (cfg, model)."""
    from audio_denoising_torch.compat import params_from_jax
    from audio_denoising_torch.config import ModelConfig
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.models import build_model
    g = np.load(os.path.join(REPO, "tests", "goldens", MOMO2_GOLDEN))
    mc = ModelConfig(arch="MOMO2", num_compressed_bins=3,
                     hidden_sizes=(16, 16, 16), kernel_sizes=(3, 3, 3),
                     strides=(2, 2, 2), paddings=(1, 0, 1))
    model = build_model(mc, 22).load_params(params_from_jax(
        {k[3:]: g[k] for k in g.files if k.startswith("sd.")}))
    cfg = load_pretrained(MOMO_SPEC)[0]
    return dataclasses.replace(cfg, model=mc), model


def phase_momo_hop(torch, momo, trained, momo2):
    """Phase 25: the fused hop on each ``(name, cfg, plan)``: MOMO3 ungated
    at SLOTS and 3 streams, every plane with prev; the trained MOMO3 with
    its recommended gate on voiced input (the gate must blend); MOMO2.
    Returns the largest output error."""
    from audio_denoising_torch.ops.kernels.fused_hop import make_fused_hop
    name, cfg, plan = momo
    say(f"  {name} (raw, delta), {cfg.dsp.n_fft}/{cfg.dsp.hop_length} at "
        f"{cfg.dsp.sample_rate} Hz, {cfg.dsp.n_stft} bins:")
    worst = phase_kernel_vs_plain(torch, make_fused_hop(cfg, plan, "cuda"),
                                  cfg, plan, (SLOTS, 3))[0]
    name, cfg, plan = trained
    say(f"  {name}, its recommended gate:")
    for batch in (SLOTS, 3):
        worst = max(worst, check_gated_hop(torch, cfg, plan, batch)[0])
    name, cfg, plan = momo2
    say(f"  {name} (raw, no delta):")
    return max(worst, phase_kernel_vs_plain(
        torch, make_fused_hop(cfg, plan, "cuda"), cfg, plan, (SLOTS,))[0])


def momo_chunks(torch, cfg, hops, seed):
    """bench.py's fused_hop_momo3_raw shape, (hops, SLOTS, hop): 0.1 x
    standard normal from ``seed``, on the card."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((0.1 * rng.standard_normal(
        (hops, SLOTS, cfg.dsp.hop_length))).astype(np.float32)).cuda()


def phase_engine_idle(torch, cfg, model, mode, ticks, seed):
    """StreamEngine ``mode`` on the card against the CPU engine, each
    carrying its own state, SLOTS slots for ``ticks`` ticks with skipped
    slots: outputs and every plane (hold_free, in the compute dtype the
    engine serves: cfg.serving.dtype in mode fused, int8 or float32 in
    mode fast), and on the card the idle slots' planes (hx and prev among
    them) bit-identical. Returns the kernel's launches in mode fused (None
    in mode fast: the zoo model and the quantized plan run no hand-written
    kernel)."""
    from audio_denoising_torch.runtime.engine import StreamEngine
    gpu = StreamEngine(cfg, model, mode=mode, max_streams=SLOTS)
    cpu = StreamEngine(cfg, model, mode=mode, max_streams=SLOTS,
                       device="cpu")
    sids = [f"s{i}" for i in range(SLOTS)]
    for sid in sids:
        gpu.add_stream(sid)
        cpu.add_stream(sid)
    rng = np.random.default_rng(seed)
    kernel = gpu.hop_step if mode == "fused" else None
    if kernel is not None:
        kernel.launches = 0
    got = np.zeros((ticks, SLOTS, cfg.dsp.hop_length))
    want = np.zeros_like(got)
    for t in range(ticks):
        chunks = {sid: (0.1 * rng.standard_normal(cfg.dsp.hop_length)
                        ).astype(np.float32)
                  for i, sid in enumerate(sids) if (7 * i + t) % 5}
        idle = [gpu.slots[s] for s in sids if s not in chunks]
        before = {k: x[idle].clone() for k, x in planes(gpu.state).items()}
        a, b = gpu.process(chunks), cpu.process(chunks)
        for k, x in before.items():
            if not torch.equal(x, planes(gpu.state)[k][idle]):
                raise AssertionError(f"mode {mode}: an idle slot's {k} "
                                     f"moved")
        for i, sid in enumerate(sids):
            if sid in chunks:
                got[t, i], want[t, i] = a[sid], b[sid]
    launches = None if kernel is None else kernel.launches
    counted = ("no hand-written kernel on this path" if launches is None
               else f"{launches} launches")
    dtype = cfg.serving.dtype
    if dtype not in REDUCED or (mode == "fast" and dtype == "bfloat16"):
        dtype = "float32"
    text = hold_free(f"engine mode {mode}", dtype, cfg, want, got,
                     cpu.state, gpu.state)[0]
    say(f"  mode {mode}, {dtype}, {SLOTS} streams x {ticks} ticks: {text}; "
        f"idle slots bit-identical ({', '.join(before)}); {counted}")
    if launches is not None and launches != ticks:
        raise AssertionError(f"expected {ticks} kernel launches, saw "
                             f"{launches}")
    return launches


def time_momo(torch, cfg, model, plan, smi):
    """Phase 18 on MOMO3 at SLOTS streams: the single hop ungated and with
    the tuned gate, the K-hop kernel per call and per hop, the delta fused
    cell, and mode fast per hop (zoo model, fused cell), each beside the
    real-time budget of one hop. Returns {label: (ms, plain ms, bound ms,
    bound by)}."""
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    from audio_denoising_torch.runtime.plan import PlanModel
    budget_us = cfg.dsp.hop_length / cfg.dsp.sample_rate * 1e6
    say(f"  MOMO3 ({MOMO_SPEC}), real-time budget of one hop "
        f"{budget_us:.1f} us ({smi}):")
    out = {}
    for label, c in (("hop", cfg), ("hop, tuned gate", tuned_gate(cfg))):
        hop = make_fused_hop(c, plan, "cuda")
        state, chunk = hop_inputs(
            torch, hop, lambda b: fused_hop_init_state(c, plan, b, "cuda"),
            SLOTS)
        say(f"  MOMO3 fused {label}:")
        out[label] = timed(torch, lambda: hop(state, chunk),
                           lambda: hop.reference(state, chunk),
                           hop_work(hop, SLOTS), SLOTS, TIMED_LAUNCHES)
    multi = make_fused_hop(cfg, plan, "cuda", hops_per_call=K_HOPS)
    s0 = fused_hop_init_state(cfg, plan, SLOTS, "cuda")
    chunks = momo_chunks(torch, cfg, K_HOPS, 181)
    say(f"  MOMO3 K-hop kernel, K={K_HOPS} (fused_hop_momo3_raw):")
    out["K-hop"] = timed(torch, lambda: multi(s0, chunks),
                         lambda: multi.plain(s0, chunks),
                         hop_work(multi, SLOTS), SLOTS, 20,
                         plain_launches=3, hops=K_HOPS)
    pm = PlanModel(model, fused=True)
    cell = pm.fused_cell
    x, hx, prev = cell_inputs(torch, SLOTS, cell.n_feat, cell.n, 182, True)
    say("  MOMO3 fused cell (delta):")
    out["cell"] = timed(torch, lambda: cell(x, hx, prev),
                        lambda: cell.reference(x, hx, prev),
                        cell_work(cell, SLOTS), SLOTS, TIMED_LAUNCHES)
    fast = {"zoo model": time_fast_step(torch, cfg, model, "MOMO3 zoo model"),
            "fused cell": time_fast_step(torch, cfg, pm,
                                         "MOMO3 PlanModel(fused=True)")}
    per_hop = {f"fused {k}": v[0] for k, v in out.items() if k != "cell"}
    per_hop["K-hop, per hop"] = out["K-hop"][0] / K_HOPS
    per_hop.update({f"mode fast, {k}": v for k, v in fast.items()})
    say("  against the real-time budget of one hop: " + "; ".join(
        f"{k} {ms * 1e3:.2f} us ({ms * 1e3 / budget_us:.1%})"
        for k, ms in per_hop.items()))
    return out


# -- bf16 and int8 compute of the fused hop (phases 35-38) --------------------

def phase_reduced_hop(torch, cases):
    """Phase 35 on each (model, label, cfg, plan, batches, voiced): both
    reduced modes (phase_kernel_vs_plain); returns {(model, dtype):
    (worst forced hop dB, largest forced output error)}."""
    from audio_denoising_torch.ops.kernels.fused_hop import make_fused_hop
    worst = {}
    for model, label, cfg, plan, batches, voiced_input in cases:
        for dtype in REDUCED:
            hop = make_fused_hop(cfg, plan, "cuda",
                                 compute_dtype=getattr(torch, dtype))
            e, db = phase_kernel_vs_plain(torch, hop, cfg, plan, batches,
                                          label, voiced_input)
            w = worst.get((model, dtype), (math.inf, 0.0))
            worst[(model, dtype)] = (min(w[0], db), max(w[1], e))
    return worst


def phase_reduced_multi(torch, cases):
    """Phase 36 on each (model, cfg, plan, chunks) in both reduced modes
    (check_multi); returns {(model, dtype): (launches, largest output
    error, worst stream dB)}."""
    return {(model, dtype): check_multi(torch, cfg, plan, model, chunks,
                                        dtype)
            for model, cfg, plan, chunks in cases for dtype in REDUCED}


def with_dtype(cfg, dtype):
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, dtype=dtype))


def phase_daemon_dtype(torch, argv, seed):
    """EngineDaemon from the CLI's ``engine`` arguments ``argv`` (with
    ``--dtype``) on 127.0.0.1, 4 clients x 16 streams x 25 chunks; each
    stream against its own sequence replayed on the CPU through the same
    step (the plain fused hop in its dtype, or the fast step on the
    quantized plan), by each stream's SNR (hold_free). Returns the
    kernel's launches (None in mode fast)."""
    from audio_denoising_torch.apps.engine_serve import (
        daemon_from_args, parser)
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    from audio_denoising_torch.runtime.engine import (
        fast_init_state, make_fast_step)
    from audio_denoising_torch.runtime.plan import PlanModel
    clients, streams, n_chunks = 4, 16, 25
    daemon = daemon_from_args(parser().parse_args(
        argv + ["--max-streams", str(SLOTS), "--host", "127.0.0.1",
                "--port", "0"]))
    cfg, eng = daemon.cfg, daemon.engine
    dtype = cfg.serving.dtype
    fused = eng.mode == "fused"
    if fused and eng.hop_step.compute_dtype != getattr(torch, dtype):
        raise AssertionError("the daemon's hop does not run --dtype")
    data = daemon_data(cfg, clients, streams, n_chunks, seed)
    got, _, rounds, launches, wall = serve_clients(
        daemon, data, eng.hop_step if fused else None)
    n = clients * streams
    if fused:
        step = make_fused_hop(cfg, eng.plan, "cpu",
                              compute_dtype=getattr(torch, dtype))
        state = fused_hop_init_state(cfg, eng.plan, n)
    else:
        pm = PlanModel(daemon.model, device="cpu", quantized=True)
        step, state = make_fast_step(cfg, pm, "cpu"), fast_init_state(
            cfg, pm, n)
    want = replay(step, state, data)
    text = hold_free(f"--dtype {dtype} daemon", dtype, cfg,
                     want.transpose(1, 0, 2), got.transpose(1, 0, 2))[0]
    say(f"  {' '.join(argv)}: mode {eng.mode}, {dtype}: {text}; "
        + latency_line(data, rounds, launches, wall))
    if fused and launches <= 0:
        raise AssertionError("the daemon never launched the kernel")
    return launches


def time_reduced(torch, specs, good, smi):
    """CUDA events at SLOTS streams for the single hop and the K-hop call
    (per hop) in fp32, bf16 and int8 on each (label, cfg, plan), each
    beside its plain version and its bound; then mode fast on the
    quantized plan (gruunet2-good) per hop with the card's busy share.
    Returns {(label, dtype, 'hop' or 'K-hop'): (ms, plain ms, bound ms,
    bound by)}."""
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    from audio_denoising_torch.runtime.plan import PlanModel
    out = {}
    for label, cfg, plan in specs:
        budget_us = cfg.dsp.hop_length / cfg.dsp.sample_rate * 1e6
        g = torch.Generator(device="cuda").manual_seed(38)
        chunks = 0.1 * torch.randn((K_HOPS, SLOTS, cfg.dsp.hop_length),
                                   generator=g, device="cuda")
        launches = 5 if cfg.dsp.n_mels > 64 else 50
        for dtype in ("float32",) + REDUCED:
            dt = getattr(torch, dtype)
            hop = make_fused_hop(cfg, plan, "cuda", compute_dtype=dt)
            s0 = fused_hop_init_state(cfg, plan, SLOTS, "cuda")
            say(f"  fused hop, {label}, {dtype}, one hop (budget "
                f"{budget_us:.1f} us) ({smi}):")
            out[(label, dtype, "hop")] = timed(
                torch, lambda: hop(s0, chunks[0]),
                lambda: hop.reference(s0, chunks[0]), hop_work(hop, SLOTS),
                SLOTS, launches, plain_launches=5)
            multi = make_fused_hop(cfg, plan, "cuda", hops_per_call=K_HOPS,
                                   compute_dtype=dt)
            say(f"  K-hop kernel, {label}, {dtype}, K={K_HOPS} ({smi}):")
            out[(label, dtype, "K-hop")] = timed(
                torch, lambda: multi(s0, chunks),
                lambda: multi.plain(s0, chunks), hop_work(multi, SLOTS),
                SLOTS, 3, plain_launches=1, hops=K_HOPS)
            say(f"  yardstick, not a bound: one hop's operations at the "
                f"rates of the kernel's own instructions (fp32 FMA"
                f"{', dp4a' if dtype == 'int8' else ''}, no tensor cores) "
                f"{instruction_seconds(hop, SLOTS) * 1e6:.2f} us")
    good_cfg, good_model = good
    pm = PlanModel(good_model, quantized=True)
    say(f"  mode fast on the quantized plan, gruunet2-good ({smi}); its "
        f"matmuls run in fp32 and fp64 on cuBLAS, both 67 TFLOP/s on the "
        f"H100 SXM:")
    ms = time_fast_step(torch, with_dtype(good_cfg, "int8"), pm,
                        "PlanModel(quantized=True)")
    hop = make_fused_hop(good_cfg, pm.plan, "cuda", compute_dtype=torch.int8)
    flops, nbytes, seconds = hop_work(hop, SLOTS, fp32_dsp=True)
    bound_ms = max(seconds, nbytes / HBM_BYTES_S) * 1e3
    say(f"  mode fast int8: {ms * 1e3:.1f} us/hop against the hop's bound "
        f"{bound_ms * 1e3:.2f} us (the fused hop's work at gruunet2-good: "
        f"fp32 DSP, int8 plan at {INT8_OPS / 1e12:g} TOP/s)")
    out[("gruunet2-good", "int8", "fast")] = (
        ms, None, bound_ms, "operations" if seconds >= nbytes / HBM_BYTES_S
        else "bytes")
    return out


# -- the offline path -----------------------------------------------------------

@contextlib.contextmanager
def normalized_outputs():
    """Collect, in call order, the peak-normalized output (on the CPU) of
    every ``offline_denoise`` that ``apps.offline``'s chain runs, so two
    runs of an entry point are compared before de-normalization."""
    from audio_denoising_torch.apps import offline
    real, seen = offline.offline_denoise, []

    def spy(cfg, model, audio, *args, **kw):
        y = real(cfg, model, audio, *args, **kw)
        seen.append(y.detach().cpu())
        return y

    offline.offline_denoise = spy
    try:
        yield seen
    finally:
        offline.offline_denoise = real


@contextlib.contextmanager
def gate_alphas():
    """Collect, in call order, the per-frame alpha (on the CPU) of every
    offline SNR gate that ``pipeline`` evaluates."""
    from audio_denoising_torch import pipeline
    real, seen = pipeline.offline_gate_alpha, []

    def spy(cfg, mag, lin_mag):
        alpha = real(cfg, mag, lin_mag)
        seen.append(None if alpha is None else alpha.cpu())
        return alpha

    pipeline.offline_gate_alpha = spy
    try:
        yield seen
    finally:
        pipeline.offline_gate_alpha = real


def noisy_voice(n, sr, seed, channels=1):
    """(channels, n) float32: the vowel (``voiced``) under white noise
    whose level steps through OFFLINE_LEVELS, one level per quarter of
    the clip, each channel its own noise; peak at most 1."""
    rng = np.random.default_rng(seed)
    quarter = -(-n // len(OFFLINE_LEVELS))
    levels = np.repeat(OFFLINE_LEVELS, quarter)[:n]
    x = voiced(n, sr)[None] + levels * rng.standard_normal((channels, n))
    return (x / max(1.0, np.abs(x).max())).astype(np.float32)


def resampled_length(n, orig, new):
    g = math.gcd(orig, new)
    return math.ceil(n * (new // g) / (orig // g))


def check_offline(label, card, plain, length=None):
    """Hold the card's peak-normalized output against the CPU's."""
    err = max_err(card, plain)
    shape = tuple(card.shape)
    finite = bool(np.isfinite(card.numpy()).all())
    say(f"  {label}: {shape}, max abs error card vs CPU {err:.3e} (bound "
        f"{OFFLINE_ATOL:g})")
    if not finite or err > OFFLINE_ATOL or tuple(plain.shape) != shape or (
            length is not None and shape[-1] != length):
        raise AssertionError(f"offline {label}: card and CPU disagree or "
                             f"the output is malformed")


def phase_offline_file(torch, tmp):
    """Phase 30: ``denoise_file`` on the card (the default device) and on
    the CPU on a WAV it writes: OFFLINE_FILE_S s of 44.1 kHz stereo
    16-bit PCM. Returns (the input path, the card's written samples)."""
    from audio_denoising_torch.apps import offline
    from audio_denoising_torch.io import read_wav, write_wav
    n = OFFLINE_FILE_S * OFFLINE_IN_RATE
    src = os.path.join(tmp, "in.wav")
    write_wav(src, noisy_voice(n, OFFLINE_IN_RATE, 30, channels=2),
              OFFLINE_IN_RATE)
    card_path, cpu_path = (os.path.join(tmp, f) for f in ("card.wav",
                                                          "cpu.wav"))
    with normalized_outputs() as outs:
        offline.denoise_file(OFFLINE_SPEC, src, card_path)
        offline.denoise_file(OFFLINE_SPEC, src, cpu_path, device="cpu")
    length = resampled_length(n, OFFLINE_IN_RATE, 48000)
    check_offline(f"{OFFLINE_SPEC}, {OFFLINE_FILE_S} s 44.1 kHz stereo -> "
                  "48 kHz mono", outs[0], outs[1], length)
    card, sr = read_wav(card_path)
    plain, _ = read_wav(cpu_path)
    lsb = float(np.abs(card - plain).max()) * 32768
    say(f"  written WAVs: {sr} Hz, {card.shape}, card vs CPU {lsb:.0f} LSB "
        f"(bound {WAV_LSB})")
    if sr != 48000 or card.shape != (1, length) or lsb > WAV_LSB:
        raise AssertionError("denoise_file's WAVs on the card and the CPU "
                             "differ")
    return src, card


def spectral_distance(torch, cfg, got, want):
    """|| |STFT(got)| - |STFT(want)| || / || |STFT(want)| || in float64 at
    the model's geometry: the spectral convergence of ``got`` against
    ``want``."""
    from audio_denoising_torch.ops import hann_window, stft
    dsp = cfg.dsp
    win = hann_window(dsp.win).double()

    def mag(y):
        return stft(y.double().cpu(), dsp.n_fft, dsp.hop_length, dsp.win,
                    window=win).abs()

    m = mag(want)
    return float(torch.linalg.norm(mag(got) - m) / torch.linalg.norm(m))


def phase_offline_gl(torch):
    """Phase 31: full-clip Griffin-Lim (GL-32, momentum 0.99, init
    'ones') on gruunet2-dari_tult, OFFLINE_GL_S s at 48 kHz: the card and
    the CPU in float32 against the same chain in float64 on the CPU (the
    waveform's SNR, the spectral convergence)."""
    import copy
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.pipeline import (
        offline_denoise, offline_denoiser)
    cfg, model = load_pretrained(OFFLINE_GL_SPEC)
    sr = cfg.dsp.sample_rate
    x = noisy_voice(OFFLINE_GL_S * sr, sr, 31)[0]
    card = offline_denoiser(cfg, model)(x).cpu()
    plain = offline_denoiser(cfg, model, "cpu")(x)
    wide = offline_denoise(cfg, copy.deepcopy(model).double(),
                           torch.from_numpy(x).double())
    snr = {k: snr_db(wide.numpy(), v.numpy())
           for k, v in (("card", card), ("CPU", plain))}
    sc = {k: spectral_distance(torch, cfg, v, wide)
          for k, v in (("card", card), ("CPU", plain))}
    say(f"  {OFFLINE_GL_SPEC}, n_fft {cfg.dsp.n_fft}, hop "
        f"{cfg.dsp.hop_length}, GL-{cfg.dsp.griffin_lim_iters}, momentum "
        f"{cfg.dsp.griffin_lim_momentum}, {OFFLINE_GL_S} s: against float64 "
        f"SNR card {snr['card']:.1f} dB, CPU {snr['CPU']:.1f} dB (bound "
        f"{OFFLINE_GL_SNR_DB:g}); spectral convergence card "
        f"{sc['card']:.2e}, CPU {sc['CPU']:.2e} (bound {SC_TOL:g}); card "
        f"vs CPU SNR {snr_db(plain.numpy(), card.numpy()):.1f} dB")
    if (card.shape != x.shape or snr["card"] < OFFLINE_GL_SNR_DB
            or sc["card"] > SC_TOL):
        raise AssertionError("offline Griffin-Lim on the card parts from "
                             "the float64 chain")


def phase_offline_gate(torch, tmp):
    """Phase 32: the offline SNR gate on the unit-gain 48 kHz
    FAST_CHECKPOINT, OFFLINE_GATE_S s of the vowel over per-quarter noise
    levels: ``denoise_file`` with no gate argument (the recommended gate:
    1 dB, width 6, 'both'), then the CLI's ``--snr-gate 1 --snr-gate-width
    6`` with estimators 'removed' and 'floor' in process, each on the
    card and on the CPU; the share of frames the gate blends (0 < alpha <
    1) printed, and required above 0 for the recommended gate."""
    from audio_denoising_torch.apps import offline
    from audio_denoising_torch.io import write_wav
    spec = os.path.join(REPO, "runs", FAST_CHECKPOINT)
    src = os.path.join(tmp, "gate.wav")
    write_wav(src, noisy_voice(OFFLINE_GATE_S * 48000, 48000, 32), 48000)
    out = os.path.join(tmp, "gated.wav")
    runs = [("recommended gate ('both')",
             lambda dev: offline.denoise_file(spec, src, out, device=dev))]
    for est in ("removed", "floor"):
        argv = [src, out, "--model", spec, "--snr-gate", "1",
                "--snr-gate-width", "6", "--snr-gate-estimator", est]
        runs.append((f"--snr-gate 1 --snr-gate-estimator {est}",
                     lambda dev, argv=argv: offline.main(
                         argv + ([] if dev is None else ["--device", dev]))))
    for label, run in runs:
        with normalized_outputs() as outs, gate_alphas() as alphas:
            run(None)
            run("cpu")
        check_offline(label, outs[0], outs[1])
        a = alphas[0]
        blend = float(((a > 0) & (a < 1)).double().mean())
        say(f"    alpha card vs CPU {max_err(a, alphas[1]):.3e}; frames "
            f"blending (0 < alpha < 1): {blend:.1%}, alpha 1: "
            f"{float((a == 1).double().mean()):.1%}, alpha 0: "
            f"{float((a == 0).double().mean()):.1%}")
        if label.startswith("recommended") and not blend > 0:
            raise AssertionError("the recommended offline gate never blends")


def phase_offline_lookahead(torch):
    """Phase 33: the bounded-lookahead branch on OFFLINE_LA_CHECKPOINT
    (OFFLINE_LA_S s), then MOMO3 (raw domain, delta carry) on
    OFFLINE_MOMO_S s, through ``offline_denoiser`` on the card and the
    CPU; the output keeps the input's length."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.pipeline import offline_denoiser
    for spec, seconds, seed in (
            (os.path.join(REPO, "runs", OFFLINE_LA_CHECKPOINT), OFFLINE_LA_S,
             33), (MOMO_SPEC, OFFLINE_MOMO_S, 34)):
        cfg, model = load_pretrained(spec)
        sr = cfg.dsp.sample_rate
        x = noisy_voice(seconds * sr, sr, seed)[0]
        card = offline_denoiser(cfg, model)(x).cpu()
        plain = offline_denoiser(cfg, model, "cpu")(x)
        check_offline(f"{os.path.basename(spec)} (lookahead "
                      f"{cfg.model.lookahead_frames}, {cfg.dsp.domain} "
                      f"domain), {seconds} s", card, plain, x.shape[-1])


def phase_offline_cli(torch, tmp, src, card):
    """Phase 34: ``python -m audio_denoising_torch denoise in.wav out.wav``
    in a subprocess with the default device, on phase 30's input: exit 0,
    and the WAV it writes equals phase 30's (index_add_'s atomics on the
    card may move a sample across a rounding edge: WAV_LSB)."""
    from audio_denoising_torch.io import read_wav
    out = os.path.join(tmp, "cli.wav")
    proc = subprocess.run(
        [sys.executable, "-m", "audio_denoising_torch", "denoise", src, out],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"denoise exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    got, sr = read_wav(out)
    lsb = float(np.abs(got - card).max()) * 32768 if got.shape == \
        card.shape else math.inf
    say(f"  exit 0, {out}: {sr} Hz, {got.shape}; against phase 30's "
        f"in-process output {lsb:.0f} LSB (bound {WAV_LSB})")
    if sr != 48000 or got.shape != card.shape or lsb > WAV_LSB:
        raise AssertionError("the CLI's output differs from denoise_file's")


def time_offline(torch, smi):
    """The offline path's timing on the card: ``denoise_array`` on
    OFFLINE_TIMED_S s of 44.1 kHz stereo (gruunet2-good): wall seconds,
    the real-time factor and the share of the call the card is busy (by
    torch.profiler); the chain stage by stage; ``offline_denoiser`` on a
    batch of OFFLINE_BATCH clips of OFFLINE_BATCH_S s."""
    from audio_denoising_torch import pipeline
    from audio_denoising_torch.apps import offline
    from audio_denoising_torch.config import recommended_serving
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops import istft, stft
    from audio_denoising_torch.ops.resample import resample
    cfg, model = load_pretrained(OFFLINE_SPEC)
    dsp = cfg.dsp
    secs = OFFLINE_TIMED_S
    x = noisy_voice(secs * OFFLINE_IN_RATE, OFFLINE_IN_RATE, 35, channels=2)
    offline.denoise_array(cfg, model, x[:, :OFFLINE_IN_RATE],
                          OFFLINE_IN_RATE)                      # warm-up
    walls = []
    for _ in range(OFFLINE_TIMED_CALLS):
        t0 = time.perf_counter()
        offline.denoise_array(cfg, model, x, OFFLINE_IN_RATE)
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[len(walls) // 2]
    rows, prof_wall = profiled(torch, lambda: offline.denoise_array(
        cfg, model, x, OFFLINE_IN_RATE))
    busy = sum(rows.values()) / 1e6
    frames = resampled_length(x.shape[-1], OFFLINE_IN_RATE,
                              dsp.sample_rate) // dsp.hop_length + 1
    say(f"  denoise_array, {OFFLINE_SPEC}, {secs} s of 44.1 kHz stereo, "
        f"{frames} frames ({smi}): calls of "
        + ", ".join(f"{w:.3f}" for w in walls)
        + f" s wall, median {wall:.3f} s: real-time factor "
        f"{wall / secs:.4f} ({secs / wall:.1f}x real time); the card "
        f"busy {busy:.3f} s by torch.profiler, {busy / wall:.1%} of the "
        f"median call ({prof_wall:.3f} s under the profiler), "
        f"{len(rows)} kernels; top:")
    print_breakdown(dict(sorted(rows.items(), key=lambda kv: -kv[1])[:6]),
                    "call")

    dev_model = pipeline.serving_model(model, torch.device("cuda"))
    gcfg = recommended_serving(load_pretrained(
        os.path.join(REPO, "runs", FAST_CHECKPOINT))[0])
    fb, inv, win = pipeline._transforms(cfg, "cuda")
    times = {}

    def stage(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        return out

    with torch.no_grad(), pipeline.fp32_convs():
        xm = torch.from_numpy(x).cuda().mean(dim=0)
        y = stage("resample", lambda: resample(
            xm[None], OFFLINE_IN_RATE, dsp.sample_rate)[0])
        y = y / y.abs().max()

        def analysis():
            spec = stft(y, dsp.n_fft, dsp.hop_length, dsp.win, window=win)
            mag = spec.abs()
            return spec, mag, pipeline._to_features(cfg, mag, fb)

        spec, mag, feats = stage("STFT and features", analysis)
        feats = feats.transpose(-1, -2)
        resid = stage("model scan", lambda: dev_model.apply(feats[None])[0])
        lin = stage("residual and inverse mel", lambda: pipeline._to_linear(
            cfg, torch.nn.functional.leaky_relu(
                feats[None] - resid, 0.2).transpose(-1, -2), inv))
        stage("gate scans (recommended gate)",
              lambda: pipeline._apply_snr_gate(gcfg, mag[None], lin))
        stage("iSTFT", lambda: istft(
            torch.polar(lin, torch.angle(spec)[None]), dsp.n_fft,
            dsp.hop_length, dsp.win, window=win, length=y.shape[-1]))
    say(f"  the chain by stage ({frames} frames, CUDA-synchronized wall "
        f"times): " + "; ".join(f"{k} {v * 1e3:.1f} ms ({v / frames * 1e6:.1f}"
                                f" us/frame)" for k, v in times.items()))

    fn = pipeline.offline_denoiser(cfg, model)
    xb = noisy_voice(OFFLINE_BATCH_S * dsp.sample_rate, dsp.sample_rate, 36,
                     channels=OFFLINE_BATCH)
    fn(xb[:, :dsp.sample_rate])                                 # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(xb)
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    clip_s = OFFLINE_BATCH * OFFLINE_BATCH_S
    say(f"  offline_denoiser, B={OFFLINE_BATCH} clips of {OFFLINE_BATCH_S} s "
        f"at 48 kHz: {bwall:.3f} s wall, {clip_s / bwall:.1f} s of audio a "
        f"second (real-time factor {bwall / clip_s:.4f} per clip-second)")


def profiled(torch, fn):
    """({kernel: device us} summed over one call of ``fn``, the call's
    wall seconds) under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rows[e.name] = rows.get(e.name, 0.0) + e.time_range.elapsed_us()
    return rows, wall


# -- timing -------------------------------------------------------------------

def time_launches(torch, fn, n):
    for _ in range(min(20, n)):
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


def hop_ops(hop, batch):
    """The operations one call of ``hop`` needs for ``batch`` streams, as
    (DSP, gate, plan): per hop 2 per multiply-add of the mel pair (none in
    the raw domain) and the transform and its inverse at the cost of a
    real FFT of n_fft points (2.5 N log2 N each); with the SNR gate
    GATE_FLOPS_PER_BIN per bin; 2 per multiply-add of the plan cell's
    matmuls. The kernel itself takes the transforms as dense matmuls,
    about twice this work; the int8 activations' quantization is not
    counted."""
    K = hop.hops_per_call
    mel = 0 if hop.raw else 2 * hop.F * hop.M    # no mel pair when raw
    plan = sum(w.numel() for w in hop.weights
               if w.dim() == 2 and w.shape[0] > 1)
    ffts = 2 * 2.5 * hop.n_fft * math.log2(hop.n_fft)
    gate = GATE_FLOPS_PER_BIN * hop.F if hop.gated else 0
    return (batch * K * (2 * mel + ffts), batch * K * gate,
            batch * K * 2 * plan)


def hop_work(hop, batch, fp32_dsp=False):
    """(flops, bytes, seconds) one call of ``hop`` needs for ``batch``
    streams: the operations of hop_ops; the weights (no DFT matrices) and
    every state plane read and written once per call, and each hop's
    chunk read and output written (2 bytes a sample with int16 IO), each
    operand at its own size (bf16 matrices 2 bytes, int8 1, their scale
    rows 4); and the least time the operations take at the published
    peak of each product's type (PEAK_BY_ITEMSIZE): in bf16 and int8 the
    DSP's products (bf16 DFT and mel matrices) at BF16_FLOPS and the
    plan's at BF16_FLOPS or INT8_OPS, the gate at FP32_FLOPS.
    ``fp32_dsp``: the DSP in fp32 (mode fast's)."""
    K = hop.hops_per_call
    dsp, gate, plan = hop_ops(hop, batch)
    size = hop.compute_dtype.itemsize
    dsp_bf16 = hop.dsp_bf16 and not fp32_dsp
    seconds = (dsp / (BF16_FLOPS if dsp_bf16 else FP32_FLOPS)
               + gate / FP32_FLOPS + plan / PEAK_BY_ITEMSIZE[size])
    weights = (sum(w.numel() * w.element_size() for w in hop.weights)
               + sum((2 if dsp_bf16 else 4) * t.numel()
                     for t in (hop.mel, hop.imel) if t is not None)
               + 4 * (hop.win.numel() + hop.env.numel()))
    state = 2 * sum(hop.widths.values())
    io = 2 * K * hop.hop * hop.io_dtype.itemsize
    return dsp + gate + plan, 4 * batch * state + weights + batch * io, \
        seconds


def instruction_seconds(hop, batch):
    """A yardstick, not a bound: hop_ops at the rates of the instructions
    the kernel runs them on (fp32 FMA; dp4a for the int8 plan)."""
    dsp, gate, plan = hop_ops(hop, batch)
    return ((dsp + gate) / FP32_FLOPS
            + plan / (DP4A_OPS if hop.compute_dtype.itemsize == 1
                      else FP32_FLOPS))


def webrtc_hop_work(hop, batch):
    """(flops, bytes) one call of the WebRTC hop (K = hops_per_call hops)
    needs per ``batch`` streams: per hop each of the 3 (n_iter + 2) real
    transforms of n_fft points at FFT cost (2.5 N log2 N: the analysis
    STFT, n_iter rounds of inverse STFT and STFT, the synthesis), 2 per
    multiply-add of the three plan-cell steps and of the mel pair over
    three frames; the state (ring, OLA, hx, both phase planes), the
    weights and tables read and the state written once per call, and each
    hop's chunk read and output written."""
    K = hop.hops_per_call
    transforms = 3 * (2 * hop.n_iter + 2)
    ffts = transforms * 2.5 * hop.n_fft * math.log2(hop.n_fft)
    cell = sum(w.numel() for w in hop.weights if w.dim() == 2)
    macs = 3 * cell + 3 * 2 * hop.F * hop.M
    weights = (sum(w.numel() for w in hop.weights)
               + sum(t.numel() for t in (hop.mel, hop.imel, hop.win,
                                         hop.env)))
    per_stream = (2 * 2 * hop.n_fft + 2 * hop.n + 2 * 2 * 3 * hop.F
                  + K * 2 * hop.hop)
    return (batch * K * (ffts + 2 * macs),
            4 * (batch * per_stream + weights))


def device_breakdown(torch, fn, n):
    """Device time per call (us) of each kernel ``fn`` launches, summed
    from torch.profiler's kernel events over ``n`` calls; empty if the
    profiler records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rows[e.name] = (rows.get(e.name, 0.0)
                            + e.time_range.elapsed_us() / n)
    return rows


def hop_inputs(torch, hop, init, batch):
    """Random state and chunk on the card for timing a hop."""
    g = torch.Generator(device="cuda").manual_seed(5)
    state = init(batch)
    state = state._replace(**{
        k: 0.1 * torch.randn(t.shape, generator=g, device="cuda")
        for k, t in planes(state).items()})
    chunk = 0.1 * torch.randn((batch, hop.hop), generator=g, device="cuda")
    return state, chunk


def timed(torch, run, plain, work, batch, launches, plain_launches=None,
          hops=1):
    """Kernel and plain times (ms per call) of ``run`` and ``plain``, and
    the bound from ``work`` = (flops, bytes[, seconds of the operations
    at their types' peaks; else all at FP32_FLOPS]);
    prints them (also per hop for ``hops`` hops per call) and the kernel
    breakdown."""
    ms = time_launches(torch, run, launches)
    plain_ms = time_launches(torch, plain, plain_launches or launches)
    flops, nbytes = work[:2]
    t_ops = (work[2] if len(work) > 2 else flops / FP32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    per_hop = (f" = {ms * 1e3 / hops:.2f} us/hop, plain "
               f"{plain_ms * 1e3 / hops:.1f}, bound "
               f"{bound_ms * 1e3 / hops:.2f} us/hop" if hops > 1 else "")
    say(f"  B={batch}: kernel {ms * 1e3:.1f} us/call, plain "
        f"{plain_ms * 1e3:.1f} us/call; bound {bound_ms * 1e3:.2f} us "
        f"({flops / 1e6:.1f} MFLOP -> {t_ops * 1e3:.2f} us, "
        f"{nbytes / 1e6:.2f} MB -> {t_bytes * 1e3:.2f} us); kernel at "
        f"{bound_ms / ms:.1%} of the bound{per_hop}")
    print_breakdown(device_breakdown(torch, run, 20), "call")
    return ms, plain_ms, bound_ms, ("operations" if t_ops >= t_bytes
                                    else "bytes")


def gl_round_yardstick(torch, hop, state, chunk, smi):
    """cuFFT's time for the transforms of one Griffin-Lim round at
    B=SLOTS: torch.fft.irfft of (B, 3, n_bins) complex to (B, 3, n_fft)
    real, then torch.fft.rfft back; beside it the single hop's GL launch
    per round (its profiler time over n_iter rounds). A stage yardstick
    only: no window, overlap-add or phase update, and the port never
    calls it."""
    g = torch.Generator(device="cuda").manual_seed(29)
    spec = torch.randn((SLOTS, 3, hop.F), dtype=torch.complex64,
                       generator=g, device="cuda")
    run = lambda: torch.fft.rfft(torch.fft.irfft(spec, n=hop.n_fft))
    ms = time_launches(torch, run, TIMED_LAUNCHES)
    fft_rows = device_breakdown(torch, run, TIMED_LAUNCHES)
    cufft = sum(fft_rows.values())
    rows = device_breakdown(torch, lambda: hop(state, chunk), 20)
    gl = sum(us for name, us in rows.items() if "gl_kernel" in name)
    if not cufft or not gl:
        say("  one GL round's transforms on cuFFT: not measured (no "
            "profiler rows)")
        return
    say(f"  one GL round's transforms on cuFFT ({smi}): irfft + rfft of "
        f"({SLOTS}, 3, {hop.F}) <-> ({SLOTS}, 3, {hop.n_fft}) {cufft:.2f} "
        f"us of device time ({len(fft_rows)} kernels; {ms * 1e3:.2f} us "
        f"per round by CUDA events, the host's dispatch included); the "
        f"GL launch {gl:.1f} us / {hop.n_iter} rounds = "
        f"{gl / hop.n_iter:.2f} us per round, {gl / hop.n_iter / cufft:.2f}x"
        f" cuFFT's device time")


def print_breakdown(rows, unit):
    if not rows:
        say("  torch.profiler saw no device time: breakdown not measured")
    for name, us in sorted(rows.items(), key=lambda kv: -kv[1]):
        say(f"    {us:9.1f} us/{unit}  {name[:90]}")


def cell_work(cell, batch):
    """(flops, bytes) one cell step needs: 2 per multiply-add of the
    plan's matmuls; x, hx (and prev for a delta plan) read, y and hx'
    written once per stream, and the plan's weights read once."""
    macs = sum(w.numel() for w in cell.weights if w.dim() == 2)
    weights = sum(w.numel() for w in cell.weights)
    io = 2 * (cell.n_feat + cell.n) + (cell.n_feat if cell.delta else 0)
    return 2 * macs * batch, 4 * (batch * io + weights)


def time_fast_step(torch, cfg, model, label):
    """ms per hop of the fast step at SLOTS streams, state carried: CUDA
    events around 100 hops, so the host's launch cost of every op is in
    it; with the torch.profiler's device time by kernel and the share of
    the hop the card is busy."""
    from audio_denoising_torch.runtime.engine import (
        fast_init_state, make_fast_step)
    step = make_fast_step(cfg, model)
    state = fast_init_state(cfg, model, SLOTS, "cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    chunk = 0.1 * torch.randn((SLOTS, cfg.dsp.hop_length), generator=g,
                              device="cuda")

    def run():
        nonlocal state
        state, _ = step(state, chunk)

    ms = time_launches(torch, run, 100)
    rows = device_breakdown(torch, run, 20)
    busy = sum(rows.values()) / 1e3
    say(f"  fast step, {label}, B={SLOTS}: {ms * 1e3:.1f} us/hop (CUDA "
        f"events over 100 hops, launch cost included); device busy "
        f"{busy * 1e3:.1f} us/hop by torch.profiler ({busy / ms:.1%}), "
        f"{len(rows)} kernels:")
    print_breakdown(rows, "hop")
    return ms


def time_fused_hops(torch, cfg, plan, smi):
    """The gated single hop, and the K-hop kernel per call (and per hop)
    in float32 (bench.py's fused_hop_resident), with the tuned gate
    (fused_hop_gated_both) and with int16 IO, each against its plain
    version and bound; then K_HOPS single-hop launches for comparison.
    bench.py's chunks: 0.1 x standard normal. Returns the float32 K-hop's
    (ms, plain ms, bound ms, bound by) per call."""
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    g = torch.Generator(device="cuda").manual_seed(12)
    chunks = 0.1 * torch.randn((K_HOPS, SLOTS, cfg.dsp.hop_length),
                               generator=g, device="cuda")
    gcfg = tuned_gate(cfg)
    g_hop = make_fused_hop(gcfg, plan, "cuda")
    state, _ = run_hops(g_hop, fused_hop_init_state(gcfg, plan, SLOTS, "cuda"),
                        chunks[:5])
    say(f"  fused hop with the tuned gate (both, 1 dB) ({smi}):")
    timed(torch, lambda: g_hop(state, chunks[0]),
          lambda: g_hop.reference(state, chunks[0]), hop_work(g_hop, SLOTS),
          SLOTS, TIMED_LAUNCHES)
    results = {}
    for label, c, io in (("float32 (fused_hop_resident)", cfg, torch.float32),
                         ("tuned gate, both (fused_hop_gated_both)", gcfg,
                          torch.float32),
                         ("int16 IO", cfg, torch.int16)):
        multi = make_fused_hop(c, plan, "cuda", hops_per_call=K_HOPS,
                               io_dtype=io)
        s0 = fused_hop_init_state(c, plan, SLOTS, "cuda")
        x = chunks if io == torch.float32 else (
            torch.clamp(chunks, -1, 1) * 32767).to(torch.int16)
        say(f"  K-hop kernel, K={K_HOPS}, {label} ({smi}):")
        results[label] = timed(
            torch, lambda: multi(s0, x), lambda: multi.plain(s0, x),
            hop_work(multi, SLOTS), SLOTS, 20, plain_launches=3, hops=K_HOPS)
    single = make_fused_hop(cfg, plan, "cuda")
    s0 = fused_hop_init_state(cfg, plan, SLOTS, "cuda")
    ms = time_launches(torch, lambda: run_hops(single, s0, chunks), 5)
    say(f"  {K_HOPS} single-hop launches carrying the state ({smi}): "
        f"{ms * 1e3:.1f} us, {ms * 1e3 / K_HOPS:.2f} us/hop")
    return results["float32 (fused_hop_resident)"]


def time_webrtc_multi(torch, cfg, plan, smi):
    """The K-hop WebRTC kernel per call and per hop at B=SLOTS, K=WEBRTC_K,
    at each of WEBRTC_GL rounds (GL-8 is bench.py's
    fused_webrtc_gl8_resident_k25), against its plain version and bound;
    then the same hops as WEBRTC_K chained single-hop calls. Returns {GL:
    (ms, plain ms, bound ms, bound by)} per call."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    g = torch.Generator(device="cuda").manual_seed(19)
    results = {}
    for n in WEBRTC_GL:
        c = warm_cfg(cfg, n)
        multi = make_webrtc_hop(c, plan, "cuda", hops_per_call=WEBRTC_K)
        single = make_webrtc_hop(c, plan, "cuda")
        state, _ = hop_inputs(
            torch, multi, lambda b: webrtc_hop_init_state(c, plan, b, "cuda"),
            SLOTS)
        chunks = 0.2 * torch.randn((WEBRTC_K, SLOTS, multi.hop), generator=g,
                                   device="cuda")
        say(f"  K-hop webrtc kernel, GL-{n}, K={WEBRTC_K} ({smi}):")
        results[n] = timed(torch, lambda: multi(state, chunks),
                           lambda: multi.plain(state, chunks),
                           webrtc_hop_work(multi, SLOTS), SLOTS, 10,
                           plain_launches=2, hops=WEBRTC_K)
        ms = time_launches(torch, lambda: run_hops(single, state, chunks), 5)
        say(f"  {WEBRTC_K} single-hop calls carrying the state, GL-{n} "
            f"({smi}): {ms * 1e3:.1f} us, {ms * 1e3 / WEBRTC_K:.2f} us/hop; "
            f"the K-hop call at {results[n][0] / ms:.1%} of it")
    return results


def ring_line(label, kernel):
    """Phase 1: the weight ring the fused cell's wrapper set up, and how
    many of its clusters the card holds at once for SLOTS streams."""
    from audio_denoising_torch.ops.kernels.weight_ring import KTILE
    r = kernel.ring
    blocks = SLOTS // KTILE
    cluster = r.args.cluster
    say(f"  {label}: weight ring kTile {KTILE}, C {cluster}, S "
        f"{r.stages} stages of {r.stage_bytes} B, {len(r.slabs)} slabs of "
        f"{min(x.nbytes for x in r.slabs)}-{max(x.nbytes for x in r.slabs)} "
        f"B, {r.smem_bytes} B of shared memory a block; "
        f"cudaOccupancyMaxActiveClusters for {blocks} blocks: "
        f"{kernel.max_active_clusters(blocks)} clusters of {cluster}")


# -- the serving surface: the WebSocket and socket daemons, the downgrades ----

WS_CLIENTS = 16      # WebSocket clients at once, one stream each
WS_HOPS = 50         # hops each client streams in phase 39
WS_WEBRTC_HOPS = 25  # hops each client streams in phase 40 (GL-32)
# a frame's samples about the hop (the browser page sends hop-sized
# frames), each odd at an even hop so the re-chunker carries residue
WS_JITTER = (-63, 41, -17, 39, -1)
# a reply in int16: OUT_ATOL in LSB plus one for the conversion's rounding
WS_LSB = math.ceil(OUT_ATOL * 32767) + 1
SOCKET_LENGTHS = (512, 1000, 2048, 777)   # samples per socket message


def ws_connect(address):
    """A browser's side of the WebSocket upgrade; -> the framed socket."""
    import base64
    import socket
    from audio_denoising_torch.io import websocket as ws
    sock = socket.create_connection(address, timeout=REPLY_DEADLINE_S)
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall((f"GET /stream HTTP/1.1\r\nHost: {address[0]}\r\n"
                  "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        part = sock.recv(4096)
        if not part:
            raise ConnectionError("the daemon closed the upgrade")
        resp += part
    head, leftover = resp.split(b"\r\n\r\n", 1)
    if b" 101 " not in head.split(b"\r\n", 1)[0]:
        raise ConnectionError(f"no upgrade: {head[:80]!r}")
    return ws.Buffered(sock, leftover)


def ws_send(conn, payload: bytes, text=False):
    """One masked client frame (RFC 6455 5.1)."""
    import struct
    from audio_denoising_torch.io import websocket as ws
    mask = os.urandom(4)
    data = np.frombuffer(payload, np.uint8)
    key = np.frombuffer((mask * (data.size // 4 + 1))[:data.size], np.uint8)
    n = data.size
    head = bytes([0x80 | (ws.OP_TEXT if text else ws.OP_BINARY)])
    if n < 126:
        head += bytes([0x80 | n])
    elif n < (1 << 16):
        head += bytes([0x80 | 126]) + struct.pack(">H", n)
    else:
        head += bytes([0x80 | 127]) + struct.pack(">Q", n)
    conn.sendall(head + mask + (data ^ key).tobytes())


def ws_frames(n, hop):
    """Frame sizes summing to n: hop + WS_JITTER in turn, the last cut
    short."""
    sizes, left, i = [], n, 0
    while left:
        sizes.append(min(hop + WS_JITTER[i % len(WS_JITTER)], left))
        left -= sizes[-1]
        i += 1
    return sizes


def hop_latencies(sizes, sent, arrived, hop):
    """Per hop, the seconds from sending the frame that completed the
    hop's samples to the hop's reply arriving (the daemon replies one
    frame per hop, in order)."""
    ends = np.cumsum(sizes)
    done = np.searchsorted(ends, hop * (np.arange(len(arrived)) + 1))
    return np.asarray(arrived) - np.asarray(sent)[done]


def ws_stream(conn, pcm, sr, hop, out, errors, cid):
    """Stream ``pcm`` in frames of odd sizes at the audio's own pace (a
    microphone's), while a second thread reads the replies; fills
    ``out[cid]`` with (replies int16, per-hop latency seconds)."""
    from audio_denoising_torch.io import websocket as ws
    sizes = ws_frames(pcm.size, hop)
    n_hops = pcm.size // hop
    sent, arrived, got = [], [], []

    def receive():
        try:
            while len(arrived) < n_hops:
                _, op, payload = ws.recv_frame(conn)
                if op != ws.OP_BINARY:
                    raise RuntimeError(f"client {cid}: opcode {op} mid-stream")
                arrived.append(time.perf_counter())
                got.append(np.frombuffer(payload, np.int16))
        except Exception as e:
            errors.append(f"client {cid} receiving: {e!r}")

    reader = threading.Thread(target=receive, daemon=True)
    reader.start()
    try:
        t0, edge = time.perf_counter(), 0
        for n in sizes:
            edge += n
            wait = t0 + edge / sr - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            ws_send(conn, pcm[edge - n:edge].tobytes())
            sent.append(time.perf_counter())
    except Exception as e:
        errors.append(f"client {cid} sending: {e!r}")
    reader.join(REPLY_DEADLINE_S)
    if reader.is_alive() or len(got) != n_hops:
        errors.append(f"client {cid}: {len(got)} of {n_hops} replies")
        return
    out[cid] = (np.concatenate(got), hop_latencies(sizes, sent, arrived, hop))


def http_get(address, path):
    import socket
    with socket.create_connection(address, timeout=REPLY_DEADLINE_S) as s:
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        data = b""
        while part := s.recv(65536):
            data += part
    head, body = data.split(b"\r\n\r\n", 1)
    return head.split(b"\r\n")[0], body.decode()


def ws_stats(conn):
    from audio_denoising_torch.io import websocket as ws
    ws_send(conn, b"stats", text=True)
    while True:
        _, op, payload = ws.recv_frame(conn)
        if op == ws.OP_TEXT:
            return json.loads(payload)


def ws_clients(address, pcm, sr, hop, pipe):
    """The WebSocket clients, run in a process of their own so that their
    work does not take the daemon's interpreter: connect one client per
    row of ``pcm`` in order (the parent acknowledges each once the daemon
    has admitted it, so client i holds slot i), wait for "go", stream
    every client at once, ask for ``stats``, send back (replies (clients,
    samples) int16, per-hop latencies, stats) and hold the connections
    until "close"."""
    conns, out, errors = [], {}, []
    try:
        for i in range(pcm.shape[0]):
            conns.append(ws_connect(address))
            pipe.send(("connected", i))
            pipe.recv()
        pipe.recv()
        threads = [threading.Thread(target=ws_stream, args=(
            conns[i], pcm[i], sr, hop, out, errors, i), daemon=True)
            for i in range(pcm.shape[0])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(REPLY_DEADLINE_S + pcm.shape[1] / sr)
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError("; ".join(errors) or "a client did not finish")
        pipe.send(("done", np.stack([out[i][0] for i in range(len(conns))]),
                   np.concatenate([out[i][1] for i in range(len(conns))]),
                   ws_stats(conns[0])))
        pipe.recv()
    except Exception as e:
        pipe.send(("error", repr(e)))
    finally:
        for c in conns:
            c.close()


def serve_ws(daemon, pcm):
    """Run ``daemon`` for one client per row of ``pcm`` (clients, samples
    int16), the clients in a child process (``ws_clients``): the page
    first, then every client connected in order, then all streaming at
    once. Returns (replies (clients, samples) int16, per-hop latencies,
    launches, the stats reply with every client connected, the slots in
    client order)."""
    import multiprocessing
    kernel = daemon.engine.hop_step
    server = threading.Thread(target=daemon.serve_forever, daemon=True)
    server.start()
    ctx = multiprocessing.get_context("spawn")
    pipe, child_end = ctx.Pipe()
    child = None

    def recv():
        if not pipe.poll(REPLY_DEADLINE_S + pcm.shape[1] / daemon.cfg.dsp
                         .sample_rate):
            raise TimeoutError("the clients' process did not answer")
        msg = pipe.recv()
        if msg[0] == "error":
            raise RuntimeError(f"clients: {msg[1]}")
        return msg

    try:
        if not daemon.listening.wait(60):
            raise TimeoutError("daemon did not start listening")
        status, page = http_get(daemon.address, "/")
        marks = [m for m in ("__SAMPLE_RATE__", "__HOP__", "__MODEL__")
                 if m in page]
        want = (f"const SR = {daemon.cfg.dsp.sample_rate};",
                f"const HOP = {daemon.hop};", f"<b>{daemon.spec}</b>")
        if status != b"HTTP/1.1 200 OK" or marks or not all(
                w in page for w in want):
            raise AssertionError(f"GET / gave {status!r}, placeholders "
                                 f"{marks} left")
        proc = ctx.Process(target=ws_clients, args=(
            daemon.address, pcm, daemon.cfg.dsp.sample_rate, daemon.hop,
            child_end), daemon=True)
        proc.start()
        child = proc
        for i in range(pcm.shape[0]):
            recv()
            deadline = time.monotonic() + REPLY_DEADLINE_S
            while daemon.engine.active_streams < i + 1:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"client {i} was not admitted")
                time.sleep(0.005)
            pipe.send("ok")
        slots = list(daemon.engine.slots.values())
        kernel.launches = 0
        pipe.send("go")
        _, got, lat, stats = recv()
        launches = kernel.launches
        pipe.send("close")
    finally:
        if child is not None:
            child.join(30)
            if child.is_alive():
                child.terminate()
                child.join(10)
        daemon.stop()
        server.join(10)
    if server.is_alive():
        raise TimeoutError("the daemon did not stop")
    return got, lat, launches, stats, slots


def ws_latency_line(lat, clients, n_hops, smi):
    p50, p99 = np.percentile(lat, [50, 99]) * 1e3
    return (f"reply latency per hop at the client ({clients} clients x "
            f"{n_hops} hops, streamed at the audio's pace): p50 {p50:.3f} "
            f"ms, p99 {p99:.3f} ms ({smi})")


def ws_pcm(clients, samples, seed):
    rng = np.random.default_rng(seed)
    return (np.clip(0.1 * rng.standard_normal((clients, samples)), -1, 1)
            * 32767).astype(np.int16)


def check_ws_stats(stats, clients):
    if stats["active_streams"] != clients or not stats["counters"]["hops"]:
        raise AssertionError(f"stats: {stats['active_streams']} active "
                             f"streams, {clients} connected")


def phase_ws_fused(torch, smi):
    """WSDaemon mode fused on gruunet2-stream16k with 256 slots: each
    client's int16 replies, in order, against its own sequence through
    the plain fused hop on the CPU (the same pcm_to_float32 chunks, its
    output through float32_to_pcm16), within WS_LSB."""
    from audio_denoising_torch.apps.ws_serve import WSDaemon
    from audio_denoising_torch.io.wavio import (
        float32_to_pcm16, pcm_to_float32)
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    daemon = WSDaemon("gruunet2-stream16k", "127.0.0.1", 0,
                      max_streams=SLOTS, mode="fused")
    hop, plan = daemon.hop, daemon.engine.plan
    pcm = ws_pcm(WS_CLIENTS, WS_HOPS * hop, 39)
    got, lat, launches, stats, _ = serve_ws(daemon, pcm)
    step = make_fused_hop(daemon.cfg, plan, "cpu")
    state = fused_hop_init_state(daemon.cfg, plan, WS_CLIENTS)
    chunks = pcm_to_float32(pcm.reshape(-1)).reshape(WS_CLIENTS, WS_HOPS, hop)
    want = []
    for k in range(WS_HOPS):
        state, out = step(state, torch.from_numpy(chunks[:, k].copy()))
        want.append(float32_to_pcm16(out.numpy()))
    want = np.stack(want, axis=1).reshape(WS_CLIENTS, -1)
    lsb = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    say(f"  GET / 200, placeholders replaced; stats: "
        f"{stats['active_streams']} active streams; int16 replies vs the "
        f"plain hop on the CPU {lsb} LSB (bound {WS_LSB}); {launches} "
        f"launches; " + ws_latency_line(lat, WS_CLIENTS, WS_HOPS, smi))
    check_ws_stats(stats, WS_CLIENTS)
    if lsb > WS_LSB:
        raise AssertionError("WebSocket replies disagree with the plain hop")
    if launches <= 0:
        raise AssertionError("the daemon never launched the kernel")
    return launches, np.percentile(lat, [50, 99]) * 1e3


def phase_ws_webrtc(torch, cfg, model, smi):
    """WSDaemon mode fused-webrtc on dari_tult with warm start (the
    checkpoint write_warm_checkpoint writes), 256 slots: by
    phase_daemon_webrtc's rule, each client's replies against its chunks
    replayed through the kernel on the card (1 LSB after int16), and the
    slots' hx against the plain version on the CPU within HX_ATOL."""
    from audio_denoising_torch.apps.ws_serve import WSDaemon
    from audio_denoising_torch.io.wavio import (
        float32_to_pcm16, pcm_to_float32)
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    with tempfile.TemporaryDirectory() as tmp:
        spec = write_warm_checkpoint(model, cfg, tmp)
        daemon = WSDaemon(spec, "127.0.0.1", 0, max_streams=SLOTS,
                          mode="fused-webrtc")
    hop, plan = daemon.hop, daemon.engine.plan
    pcm = ws_pcm(WS_CLIENTS, WS_WEBRTC_HOPS * hop, 40)
    got, lat, launches, stats, slots = serve_ws(daemon, pcm)
    chunks = torch.from_numpy(pcm_to_float32(pcm.reshape(-1)).reshape(
        WS_CLIENTS, WS_WEBRTC_HOPS, hop))
    want = {}
    for device in ("cuda", "cpu"):
        step = make_webrtc_hop(daemon.cfg, plan, device)
        state = webrtc_hop_init_state(daemon.cfg, plan, WS_CLIENTS, device)
        outs = []
        for k in range(WS_WEBRTC_HOPS):
            state, out = step(state, chunks[:, k].contiguous().to(device))
            outs.append(float32_to_pcm16(out.cpu().numpy()))
        want[device] = (state, np.stack(outs, axis=1).reshape(WS_CLIENTS, -1))
    lsb = int(np.abs(got.astype(np.int32)
                     - want["cuda"][1].astype(np.int32)).max())
    hx_err = max_err(daemon.engine.state.hx[slots].cpu(), want["cpu"][0].hx)
    say(f"  stats: {stats['active_streams']} active streams; int16 replies "
        f"vs the kernel replayed per stream {lsb} LSB (bound 1); hx vs the "
        f"plain version on the CPU {hx_err:.3e} (bound {HX_ATOL:g}); "
        f"{launches} launches; "
        + ws_latency_line(lat, WS_CLIENTS, WS_WEBRTC_HOPS, smi))
    check_ws_stats(stats, WS_CLIENTS)
    if lsb > 1 or hx_err > HX_ATOL:
        raise AssertionError("WebSocket replies disagree with the kernel "
                             "replayed per stream or with the plain version")
    if launches <= 0:
        raise AssertionError("the daemon never launched the kernel")
    return launches, np.percentile(lat, [50, 99]) * 1e3


def socket_messages(seed, channels=2):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal((n, channels))).astype(np.float32)
            for n in SOCKET_LENGTHS]


def socket_round(daemon, order, msgs):
    """Send each (connection, message) of ``order`` in turn and wait for
    its reply; -> replies per connection, round-trip seconds."""
    from multiprocessing.connection import Client
    conns = {c: Client(daemon.address) for c in {c for c, _ in order}}
    got, rtt = {c: [] for c in conns}, []
    try:
        for c, k in order:
            t0 = time.perf_counter()
            conns[c].send(msgs[c][k])
            if not conns[c].poll(REPLY_DEADLINE_S):
                raise TimeoutError(f"connection {c}: no reply")
            reply = conns[c].recv()
            rtt.append(time.perf_counter() - t0)
            if isinstance(reply, str):
                raise RuntimeError(f"connection {c}: {reply}")
            got[c].append(reply)
        for conn in conns.values():
            conn.send("close")
    finally:
        for conn in conns.values():
            conn.close()
    return got, rtt


def server_replies(torch, step, model, msgs, hx=None):
    """What SocketDaemon.process gives for ``msgs`` in turn: the first
    channel through ``step`` on the CPU, repeated over the channels."""
    hx = model.init_state(1) if hx is None else hx
    out = []
    for m in msgs:
        hx, y = step(hx, torch.from_numpy(np.ascontiguousarray(m[:, 0][None])))
        out.append(np.repeat(y.numpy()[0][:, None], m.shape[1], axis=1))
    return out, hx


def phase_serve(torch, smi):
    """SocketDaemon (the reference's wire format) on gruunet2-good on the
    card: three connections, interleaved (n, 2) messages of several
    lengths, each reply against make_server_step on the CPU with a state
    per connection; then --shared-state: two connections against one
    state carried over both in arrival order (and away from a state per
    connection)."""
    from audio_denoising_torch.apps.serve import SocketDaemon
    from audio_denoising_torch.pipeline import make_server_step

    def run(shared, names):
        daemon = SocketDaemon("gruunet2-good", ("127.0.0.1", 0),
                              shared_state=shared)
        server = threading.Thread(target=daemon.serve_forever, daemon=True)
        server.start()
        try:
            if not daemon.listening.wait(60):
                raise TimeoutError("socket daemon did not start listening")
            msgs = {c: socket_messages(41 + i) for i, c in enumerate(names)}
            order = [(c, k) for k in range(len(SOCKET_LENGTHS))
                     for c in names]
            got, rtt = socket_round(daemon, order, msgs)
        finally:
            daemon.stop()
            server.join(10)
        if daemon.device.type != "cuda":
            raise AssertionError("the socket daemon did not run on the card")
        return daemon, msgs, order, got, rtt

    daemon, msgs, order, got, rtt = run(False, "abc")
    step = make_server_step(daemon.cfg, daemon.model, "cpu")
    err = 0.0
    for c in "abc":
        want, _ = server_replies(torch, step, daemon.model, msgs[c])
        for g, w, m in zip(got[c], want, msgs[c]):
            if g.shape != m.shape:
                raise AssertionError(f"reply shape {g.shape} for {m.shape}")
            err = max(err, float(np.abs(g - w).max()))
    shared, smsgs, sorder, sgot, srtt = run(True, "ab")
    seq, _ = server_replies(torch, step, daemon.model,
                            [smsgs[c][k] for c, k in sorder])
    s_err = max(float(np.abs(sgot[c][i] - seq[2 * i + (c == "b")]).max())
                for c in "ab" for i in range(len(SOCKET_LENGTHS)))
    own, _ = server_replies(torch, step, daemon.model, smsgs["b"])
    apart = max(float(np.abs(g - w).max()) for g, w in zip(sgot["b"], own))
    p50, p99 = np.percentile(rtt + srtt, [50, 99]) * 1e3
    say(f"  3 connections x {len(SOCKET_LENGTHS)} messages of "
        f"{SOCKET_LENGTHS} samples x 2 channels: replies vs make_server_step "
        f"on the CPU {err:.3e} (bound {OUT_ATOL:g}); --shared-state vs one "
        f"state over both connections {s_err:.3e}, vs a state per "
        f"connection {apart:.3e}; round trip per message p50 {p50:.3f} ms, "
        f"p99 {p99:.3f} ms ({smi}); no hand-written kernel on this path")
    if err > OUT_ATOL or s_err > OUT_ATOL:
        raise AssertionError("socket daemon disagrees with the server step")
    if apart <= OUT_ATOL:
        raise AssertionError("--shared-state did not share the state")


def downgraded(make):
    """``make()`` with its warnings caught; -> (engine, messages)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = make()
    return eng, [str(w.message) for w in caught]


def check_downgrade(label, eng, said, want_mode, phrase):
    if eng.mode != want_mode or not any(phrase in m for m in said):
        raise AssertionError(f"{label}: mode {eng.mode}, warnings {said}")


def drive_against(torch, eng, step, state, ticks, seed, hop):
    """``ticks`` ticks of every slot through the engine and through
    ``step`` from ``state`` on the card; the largest output difference."""
    rng = np.random.default_rng(seed)
    err = 0.0
    for _ in range(ticks):
        batch = torch.from_numpy((0.1 * rng.standard_normal(
            (eng.n, hop))).astype(np.float32)).cuda()
        got = eng.process_batch(batch)
        state, want = step(state, batch)
        err = max(err, max_err(got, want))
    return err


def phase_downgrades(torch, dari_cfg, dari, good_cfg, good, flag_cfg, flag,
                     flag_plan):
    """The engine's downgrades on the card, each with its warning and
    engine.mode naming the mode served, its outputs against that mode's
    step run alone on the same chunks (0 expected: the same code)."""
    from audio_denoising_torch.pipeline import (
        make_webrtc_step, webrtc_init_state)
    from audio_denoising_torch.runtime.engine import (
        StreamEngine, fast_init_state, hop_smem_bytes, make_fast_step,
        shared_memory_limit)
    from audio_denoising_torch.runtime.plan import PlanModel
    cfg = tuned_gate(dari_cfg)
    eng, said = downgraded(lambda: StreamEngine(
        cfg, dari, mode="fused-webrtc", max_streams=SLOTS))
    check_downgrade("gated fused-webrtc", eng, said, "webrtc",
                    "'fused-webrtc' downgraded to 'webrtc'")
    e1 = drive_against(torch, eng, make_webrtc_step(cfg, dari, "cuda"),
                       webrtc_init_state(cfg, dari, SLOTS, "cuda"), 3, 421,
                       eng.hop)
    say(f"  gated fused-webrtc (gruunet2-dari_tult, warm): mode {eng.mode}, "
        f"warned; vs the gated webrtc step {e1:.3e}")
    cfg = with_dtype(good_cfg, "int8")
    eng, said = downgraded(lambda: StreamEngine(
        cfg, good, mode="webrtc", max_streams=SLOTS))
    check_downgrade("int8 webrtc", eng, said, "fast",
                    "'webrtc' downgraded to 'fast'")
    pm = PlanModel(good, quantized=True)
    e2 = drive_against(torch, eng, make_fast_step(cfg, pm, "cuda"),
                       fast_init_state(cfg, pm, SLOTS, "cuda"), 3, 422,
                       eng.hop)
    say(f"  int8 in mode webrtc (gruunet2-good): mode {eng.mode}, warned; "
        f"vs the fast step on the quantized plan {e2:.3e}")
    cfg = with_dtype(tuned_gate(flag_cfg), "int8")
    need = hop_smem_bytes(cfg, flag_plan, "fused")
    limit = shared_memory_limit("cuda")
    eng, said = downgraded(lambda: StreamEngine(
        cfg, flag, mode="fused", max_streams=SLOTS))
    check_downgrade("gated int8 flagship", eng, said, "fast",
                    "'fused' downgraded to 'fast'")
    pm = PlanModel(flag, quantized=True)
    e3 = drive_against(torch, eng, make_fast_step(cfg, pm, "cuda"),
                       fast_init_state(cfg, pm, SLOTS, "cuda"), 2, 423,
                       eng.hop)
    say(f"  gated int8 {FLAGSHIP} in mode fused: {need} B of shared memory "
        f"a block over the card's {limit} B: mode {eng.mode}, warned; vs "
        f"the fast step on the quantized plan {e3:.3e}")
    if max(e1, e2, e3) > REPLAY_ATOL:
        raise AssertionError("a downgraded engine disagrees with the step "
                             "of the mode it serves")


def phase_smem_mirror(torch, cases, limit):
    """The shared memory per block the built libraries count against
    fused_hop_smem_bytes and webrtc_hop_smem_bytes (the plain mirrors the
    engine decides by), for every configuration the script builds, in
    every compute mode and with the gates, one hop and K hops (also those
    over the card's limit, which no kernel can be built for: the
    arguments are filled on the CPU). ``cases``: (kernel, label, cfg,
    plan), kernel "fused_hop" or "webrtc_hop"."""
    from audio_denoising_torch.ops.kernels.build import load_kernel_library
    from audio_denoising_torch.ops.kernels.fused_hop import FusedHop
    from audio_denoising_torch.ops.kernels.webrtc_hop import WebRTCHop
    libs = {n: load_kernel_library(n).lib for n in ("fused_hop",
                                                    "webrtc_hop")}
    for name in libs:
        fn = getattr(libs[name], f"adt_{name}_smem_bytes")
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_longlong
    cpu, checked, over = torch.device("cpu"), 0, []
    for kind, label, cfg, plan in cases:
        if kind == "fused_hop":
            for est, dtype, k in itertools.product(
                    (None, "removed", "floor", "both"),
                    (torch.float32, torch.bfloat16, torch.int8),
                    (1, K_HOPS)):
                c = cfg if est is None else dataclasses.replace(
                    cfg, serving=dataclasses.replace(
                        cfg.serving, snr_gate_db=1.0,
                        snr_gate_estimator=est))
                hop = FusedHop(c, plan, cpu, hops_per_call=k,
                               compute_dtype=dtype)
                got = libs["fused_hop"].adt_fused_hop_smem_bytes(
                    ctypes.byref(hop._args()))
                if got != hop.smem_bytes:
                    raise AssertionError(
                        f"{label}, gate {est}, {dtype}, K={k}: the library "
                        f"counts {got} B, fused_hop_smem_bytes "
                        f"{hop.smem_bytes} B")
                checked += 1
                if got > limit:
                    over.append(f"{label} {dtype_name(dtype)} gate {est} "
                                f"K={k}: {got} B")
        else:
            for k in (1, WEBRTC_K):
                hop = WebRTCHop(cfg, plan, cpu, hops_per_call=k)
                got = libs["webrtc_hop"].adt_webrtc_hop_smem_bytes(
                    ctypes.byref(hop._args()))
                if got != hop.smem_bytes:
                    raise AssertionError(
                        f"{label}, K={k}: the library counts {got} B, "
                        f"webrtc_hop_smem_bytes {hop.smem_bytes} B")
                checked += 1
                if got > limit:
                    over.append(f"{label} webrtc K={k}: {got} B")
    say(f"  {checked} configurations: the libraries' count equals the "
        f"plain mirrors' on each; over the card's {limit} B: "
        + "; ".join(over))
    return checked


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from audio_denoising_torch.config import recommended_serving
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops.kernels.build import load_kernel_libraries
    from audio_denoising_torch.ops.kernels.fused_cell import make_fused_cell
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    from audio_denoising_torch.runtime.plan import PlanModel, build_cell_plan

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
    for name, built in zip(KERNELS, load_kernel_libraries(KERNELS)):
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"  ptxas ({name}): " + line.strip())
        say(f"  built {built.path} in {built.seconds:.1f} s")

    cfg, model = load_pretrained("gruunet2-stream16k")
    plan = build_cell_plan(model)
    hop = make_fused_hop(cfg, plan, "cuda")
    good_cfg, good = load_pretrained("gruunet2-good")
    ring_line("fused cell, gruunet2-good",
              make_fused_cell(build_cell_plan(good), "cuda"))

    say("phase 2: fused hop kernel vs its plain version on the card")
    err = phase_kernel_vs_plain(torch, hop, cfg, plan, (SLOTS, 3))[0]
    other_plans, built = [], [("fused_hop", S16K, cfg, plan)]
    for name in OTHER_CHECKPOINTS:
        other_cfg, other = load_pretrained(os.path.join(REPO, "runs", name))
        other_plan = build_cell_plan(other)
        other_plans.append((name, other_plan))
        built.append(("fused_hop", name, other_cfg, other_plan))
        say(f"  {name}: n_fft {other_cfg.dsp.n_fft}, {other_cfg.dsp.n_mels} "
            f"mels, hidden {other_cfg.model.hidden_sizes}")
        phase_kernel_vs_plain(
            torch, make_fused_hop(other_cfg, other_plan, "cuda"), other_cfg,
            other_plan, (64,))

    dari_cfg, dari = load_pretrained("gruunet2-dari_tult")
    dari_cfg = warm_cfg(dari_cfg)
    dari_plan = build_cell_plan(dari)
    say("phase 3: webrtc hop kernels vs their plain version on the card "
        f"(gruunet2-dari_tult, warm start, {dari_cfg.dsp.n_fft}/"
        f"{dari_cfg.dsp.hop_length}, {dari_cfg.dsp.n_mels} mels)")
    w_err = phase_webrtc_kernel(torch, dari_cfg, dari_plan)

    say(f"phase 4: StreamEngine mode fused, {SLOTS} slots, card vs CPU")
    launches = phase_engine(torch, cfg, model)
    say("phase 5: EngineDaemon mode fused on 127.0.0.1")
    launches += phase_daemon(torch)
    say(f"phase 6: StreamEngine mode fused-webrtc, {SLOTS} slots, card vs "
        "CPU")
    w_launches = phase_engine_webrtc(torch, dari_cfg, dari)
    say("phase 7: EngineDaemon mode fused-webrtc on 127.0.0.1")
    w_launches += phase_daemon_webrtc(torch, dari_cfg, dari)

    say("phase 8: fused cell kernel vs its plain version on the card")
    c_err = phase_fused_cell(torch, [("gruunet2-good", build_cell_plan(good))]
                             + other_plans)
    say(f"phase 9: profile --mode fast --fused --streams {SLOTS}, in process")
    c_launches, _ = phase_profile(torch)
    say(f"phase 10: fast step with the fused cell on the card vs the zoo "
        f"model on the CPU (gruunet2-good, {SLOTS} streams)")
    c_launches += phase_fast_step(torch, good_cfg, good)
    say(f"phase 11: StreamEngine mode fast, {SLOTS} slots, card vs CPU")
    phase_engine_fast(torch, good_cfg, good)
    say("phase 12: EngineDaemon mode fast on 127.0.0.1")
    phase_daemon_fast(torch)

    gated_path = os.path.join(REPO, "runs", GATED_CHECKPOINT)
    w40_cfg, w40 = load_pretrained(gated_path)
    w40_cfg = recommended_serving(w40_cfg)
    srv = w40_cfg.serving
    say("phase 13: the gated fused hop kernel vs its plain version on the "
        "card")
    g_err = phase_gated_hop(torch, [
        ("gruunet2-stream16k", cfg, model, plan, GATE_POINTS),
        (GATED_CHECKPOINT, w40_cfg, w40, build_cell_plan(w40),
         {e: (srv.snr_gate_db, srv.snr_gate_width_db)
          for e in ("removed", "floor", "both")})])
    say(f"phase 14: the resident K-hop kernel (gruunet2-stream16k, {SLOTS} "
        f"streams, K={K_HOPS})")
    m_launches, m_err = phase_multi(torch, cfg, plan)
    say(f"phase 15: StreamEngine mode fused, gated ({GATED_CHECKPOINT}), "
        f"{SLOTS} slots, card vs CPU")
    launches += phase_engine_gated(torch, w40_cfg, w40)
    say(f"phase 16: EngineDaemon mode fused, auto gate ({GATED_CHECKPOINT}) "
        "on 127.0.0.1")
    launches += phase_daemon_gated(torch, gated_path)
    say(f"phase 17: EngineDaemon with its defaults (mode fast, auto gate) on "
        f"{FAST_CHECKPOINT}, 127.0.0.1")
    phase_daemon_defaults(torch, os.path.join(REPO, "runs", FAST_CHECKPOINT))

    say("phase 18: timing")
    say(f"  fused hop ({smi}):")
    state, chunk = hop_inputs(
        torch, hop, lambda b: fused_hop_init_state(cfg, plan, b, "cuda"),
        SLOTS)
    fused = timed(torch, lambda: hop(state, chunk),
                  lambda: hop.reference(state, chunk), hop_work(hop, SLOTS),
                  SLOTS, TIMED_LAUNCHES)
    w_hop = make_webrtc_hop(dari_cfg, dari_plan, "cuda")
    say(f"  webrtc hop, GL-{w_hop.n_iter} ({smi}):")
    w_state, w_chunk = hop_inputs(
        torch, w_hop,
        lambda b: webrtc_hop_init_state(dari_cfg, dari_plan, b, "cuda"),
        SLOTS)
    webrtc = timed(torch, lambda: w_hop(w_state, w_chunk),
                   lambda: w_hop.reference(w_state, w_chunk),
                   webrtc_hop_work(w_hop, SLOTS), SLOTS, 50)
    gl_round_yardstick(torch, w_hop, w_state, w_chunk, smi)
    pm = PlanModel(good, fused=True)
    cell = pm.fused_cell
    say(f"  fused cell, gruunet2-good ({smi}):")
    x, hx, _ = cell_inputs(torch, SLOTS, cell.n_feat, cell.n, 7)
    fused_cell = timed(torch, lambda: cell(x, hx),
                       lambda: cell.reference(x, hx), cell_work(cell, SLOTS),
                       SLOTS, TIMED_LAUNCHES)
    say(f"  mode fast, gruunet2-good ({smi}):")
    time_fast_step(torch, good_cfg, good, "zoo model")
    time_fast_step(torch, good_cfg, pm, "PlanModel(fused=True)")
    multi = time_fused_hops(torch, cfg, plan, smi)
    w_multi = time_webrtc_multi(torch, dari_cfg, dari_plan, smi)
    momo_cfg, momo = load_pretrained(MOMO_SPEC)
    momo_plan = build_cell_plan(momo)
    momo_t = time_momo(torch, momo_cfg, momo, momo_plan, smi)
    flag_cfg, flag = load_pretrained(os.path.join(REPO, "runs", FLAGSHIP))
    flag_plan = build_cell_plan(flag)
    say(f"  bf16 and int8 ({smi}):")
    r_t = time_reduced(torch, [("gruunet2-stream16k", cfg, plan),
                               (FLAGSHIP, flag_cfg, flag_plan),
                               (MOMO_SPEC, momo_cfg, momo_plan)],
                       (good_cfg, good), smi)

    wm_launches, wm_err = phase_webrtc_multi(torch, dari_cfg, dari_plan)
    dari_gated = tuned_gate(load_pretrained("gruunet2-dari_tult")[0])
    say(f"phase 23: StreamEngine mode webrtc with the SNR gate "
        f"(gruunet2-dari_tult), {SLOTS} slots, card vs CPU")
    phase_engine_webrtc_gated(torch, dari_gated, dari)
    say("phase 24: EngineDaemon mode webrtc --snr-gate 1 (gruunet2-dari_tult) "
        "on 127.0.0.1")
    phase_daemon_webrtc_gated(torch, "gruunet2-dari_tult")

    trained_path = os.path.join(REPO, "runs", MOMO_TRAINED)
    trained_cfg, trained = load_pretrained(trained_path)
    trained_cfg = recommended_serving(trained_cfg)
    momo2_cfg, momo2 = momo2_model()
    say("phase 25: the fused hop kernel on the MOMO family (the raw domain "
        "and the delta carry) vs its plain version on the card")
    mh_err = phase_momo_hop(
        torch, (MOMO_SPEC, momo_cfg, momo_plan),
        (MOMO_TRAINED, trained_cfg, build_cell_plan(trained)),
        ("MOMO2, " + MOMO2_GOLDEN, momo2_cfg, build_cell_plan(momo2)))
    say(f"phase 26: the resident K-hop kernel ({MOMO_SPEC}, {SLOTS} streams, "
        f"K={K_HOPS}; bench.py's fused_hop_momo3_raw)")
    mm_launches, mm_err, _ = check_multi(
        torch, momo_cfg, momo_plan, MOMO_SPEC,
        momo_chunks(torch, momo_cfg, K_HOPS, 26))
    say(f"phase 27: the fused cell's delta branch vs its plain version, "
        f"then the fast step with the fused cell on the card vs the zoo "
        f"MOMO3 on the CPU ({SLOTS} streams)")
    mc_err = phase_fused_cell(torch, [(MOMO_SPEC, momo_plan),
                                      ("MOMO2", build_cell_plan(momo2))])
    mc_launches = phase_fast_step(torch, momo_cfg, momo)
    say(f"phase 28: StreamEngine modes fused and fast ({MOMO_SPEC}), "
        f"{SLOTS} slots, card vs CPU")
    me_launches = phase_engine_idle(torch, momo_cfg, momo, "fused", 50, 28)
    phase_engine_idle(torch, momo_cfg, momo, "fast", 50, 29)
    say(f"phase 29: EngineDaemon mode fused, auto gate ({MOMO_TRAINED}) on "
        "127.0.0.1")
    me_launches += phase_daemon_gated(torch, trained_path)

    with tempfile.TemporaryDirectory() as tmp:
        say(f"phase 30: denoise_file on the card ({OFFLINE_SPEC}, "
            f"{OFFLINE_FILE_S} s of 44.1 kHz stereo 16-bit PCM) vs the CPU")
        src, card_wav = phase_offline_file(torch, tmp)
        say(f"phase 31: offline Griffin-Lim ({OFFLINE_GL_SPEC}) on the card "
            "and the CPU vs float64")
        phase_offline_gl(torch)
        say(f"phase 32: the offline SNR gate ({FAST_CHECKPOINT}), card vs "
            "CPU")
        phase_offline_gate(torch, tmp)
        say(f"phase 33: offline lookahead ({OFFLINE_LA_CHECKPOINT}) and "
            f"MOMO3 ({MOMO_SPEC}), card vs CPU")
        phase_offline_lookahead(torch)
        say("phase 34: python -m audio_denoising_torch denoise in.wav "
            "out.wav, in a subprocess on the card")
        phase_offline_cli(torch, tmp, src, card_wav)
    say(f"offline timing, beside phase 30 ({smi}):")
    time_offline(torch, smi)

    say(f"phase 35: the fused hop kernel in bf16 and int8 vs its plain "
        f"version on the card ({HOPS} hops; {FLAGSHIP}: n_fft "
        f"{flag_cfg.dsp.n_fft}, {flag_cfg.dsp.n_mels} mels, hidden "
        f"{flag_cfg.model.hidden_sizes}, in fp32 too)")
    flag_err = phase_kernel_vs_plain(
        torch, make_fused_hop(flag_cfg, flag_plan, "cuda"), flag_cfg,
        flag_plan, (SLOTS,))[0]
    r_err = phase_reduced_hop(torch, [
        (S16K, S16K, cfg, plan, (SLOTS, 3), False),
        (S16K, f"{S16K}, tuned gate (both)", tuned_gate(cfg), plan,
         (SLOTS, 3), True),
        (FLAGSHIP, FLAGSHIP, flag_cfg, flag_plan, (SLOTS,), False),
        (MOMO_SPEC, MOMO_SPEC, momo_cfg, momo_plan, (SLOTS, 3), False)])
    say(f"phase 36: the resident K-hop kernel in bf16 and int8 ({SLOTS} "
        f"streams, K={K_HOPS})")
    rng = np.random.default_rng(36)
    flag_chunks = torch.from_numpy((0.1 * rng.standard_normal(
        (K_HOPS, SLOTS, flag_cfg.dsp.hop_length))).astype(np.float32)).cuda()
    r_multi = phase_reduced_multi(torch, [
        (S16K, cfg, plan, torch.from_numpy(voiced_chunks(
            SLOTS, K_HOPS, cfg.dsp.hop_length, cfg.dsp.sample_rate,
            36)).cuda()),
        (FLAGSHIP, flag_cfg, flag_plan, flag_chunks),
        (MOMO_SPEC, momo_cfg, momo_plan, momo_chunks(torch, momo_cfg, K_HOPS,
                                                     37))])
    say(f"phase 37: StreamEngine modes fused (bf16, int8; "
        f"gruunet2-stream16k) and fast (int8, the quantized plan; "
        f"gruunet2-good), {SLOTS} slots, card vs CPU")
    re_launches = {d: phase_engine_idle(
        torch, with_dtype(cfg, d), model, "fused", 50, 370 + i)
        for i, d in enumerate(REDUCED)}
    phase_engine_idle(torch, with_dtype(good_cfg, "int8"), good, "fast", 50,
                      373)
    say("phase 38: EngineDaemon from engine --dtype int8 (modes fused and "
        "fast) on 127.0.0.1")
    re_launches["int8"] += phase_daemon_dtype(
        torch, ["--model", "gruunet2-stream16k", "--mode", "fused",
                "--dtype", "int8"], 381)
    phase_daemon_dtype(torch, ["--dtype", "int8", "--mode", "fast"], 382)

    say(f"phase 39: WSDaemon mode fused ({S16K}, {SLOTS} slots), "
        f"{WS_CLIENTS} WebSocket clients on 127.0.0.1, int16 frames of odd "
        f"sizes")
    ws_launches, ws_lat = phase_ws_fused(torch, smi)
    say(f"phase 40: WSDaemon mode fused-webrtc (gruunet2-dari_tult, warm "
        f"GL-{dari_cfg.dsp.griffin_lim_iters}, {SLOTS} slots), {WS_CLIENTS} "
        f"WebSocket clients on 127.0.0.1")
    wws_launches, wws_lat = phase_ws_webrtc(torch, dari_cfg, dari, smi)
    say("phase 41: SocketDaemon (serve, the reference's wire format) on "
        "gruunet2-good, 127.0.0.1")
    phase_serve(torch, smi)
    say("phase 42: the engine's downgrades on the card; the shared memory "
        "per block, the libraries against the plain mirrors")
    phase_downgrades(torch, dari_cfg, dari, good_cfg, good, flag_cfg, flag,
                     flag_plan)
    small = [small_webrtc_model(torch, 4, n) for n in (64, RUNTIME_FFT)]
    mel128_cfg, mel128 = load_pretrained(os.path.join(
        REPO, "runs", OTHER_CHECKPOINTS[1]))
    phase_smem_mirror(torch, built + [
        ("fused_hop", FLAGSHIP, flag_cfg, flag_plan),
        ("fused_hop", MOMO_SPEC, momo_cfg, momo_plan),
        ("fused_hop", MOMO_TRAINED, trained_cfg, build_cell_plan(trained)),
        ("fused_hop", "MOMO2", momo2_cfg, build_cell_plan(momo2)),
        ("webrtc_hop", "gruunet2-dari_tult", dari_cfg, dari_plan),
        ("webrtc_hop", OTHER_CHECKPOINTS[1], warm_cfg(mel128_cfg),
         build_cell_plan(mel128))] + [
        ("webrtc_hop", f"n_fft {c.dsp.n_fft}", c, build_cell_plan(m))
        for c, m in small],
        torch.cuda.get_device_properties(0).shared_memory_per_block_optin)

    def variant(label, checked, timing=None, n=None):
        v = {"name": label, "checked": checked}
        if timing is not None:
            v.update(ms=timing[0], plain_ms=timing[1], bound_ms=timing[2],
                     bound_by=timing[3])
        if n is not None:
            v["launches"] = n
        return v

    momo_checked = "phases 25, 28, 29: ungated, gated, MOMO2, 256 and 3"

    def reduced(dtype, kind, n):
        """The dtype's variants of a row on stream16k, the flagship and
        MOMO3, each with its own time, worst reading (hop: the worst hop
        from the plain version's state, against FORCED_DB; K-hop: the
        worst stream carrying its own state, against FREE_DB's) and
        largest output error; launches: the single hop's main paths run
        on stream16k, each model's K-hop calls its own."""
        out = []
        for label in (S16K, FLAGSHIP, MOMO_SPEC):
            if kind == "hop":
                (db, e), limit = r_err[(label, dtype)], FORCED_DB[dtype]
                checked = ("phases 35, 37, 38; stream16k (ungated, tuned "
                           "gate), the flagship and MOMO3, 256 and 3")
                runs = n if label == S16K else None
            else:
                runs, e, db = r_multi[(label, dtype)]
                limit = FREE_DB[(label, dtype)][1]
                checked = "phase 36; fp32 and int16 IO"
            v = variant(f"{dtype}, {label}", checked,
                        r_t[(label, dtype, kind)], runs)
            v.update(max_abs_err=e, worst_db=db, limit_db=limit)
            out.append(v)
        return out

    rows = []
    for name, source, replaces, n, e, (ms, plain_ms, bound_ms, bound_by), \
            variants in (
            ("fused_hop", "fused_hop", "fused_hop.py:242",
             launches + me_launches + sum(re_launches.values())
             + ws_launches,
             max(err, g_err, mh_err, flag_err,
                 *(e for _, e in r_err.values())), fused,
             [variant("mel, gruunet2-stream16k and two runs/ widths",
                      "phases 2, 4, 5, 13, 15, 16"),
              variant(f"WebSocket daemon, {S16K}", "phase 39: "
                      f"{WS_CLIENTS} clients, int16 replies vs the plain "
                      f"hop; reply p50 {ws_lat[0]:.3f} ms, p99 "
                      f"{ws_lat[1]:.3f} ms", n=ws_launches),
              variant(f"raw + delta, {MOMO_SPEC}", momo_checked,
                      momo_t["hop"], me_launches),
              variant(f"raw + delta, {MOMO_SPEC}, tuned gate", momo_checked,
                      momo_t["hop, tuned gate"]),
              variant(f"float32, {FLAGSHIP}", "phase 35, 256 streams",
                      r_t[(FLAGSHIP, "float32", "hop")])]
             + reduced("bfloat16", "hop", re_launches["bfloat16"])
             + reduced("int8", "hop", re_launches["int8"])),
            ("fused_hop_multi", "fused_hop", "fused_hop.py:384",
             m_launches + mm_launches + sum(n for n, _, _ in
                                            r_multi.values()),
             max(m_err, mm_err, *(e for _, e, _ in r_multi.values())), multi,
             [variant("mel, gruunet2-stream16k, ungated and gated, fp32 and "
                      "int16 IO", "phase 14"),
              variant(f"raw + delta, {MOMO_SPEC}, fp32 and int16 IO",
                      "phase 26", momo_t["K-hop"], mm_launches),
              variant(f"float32, {FLAGSHIP}", "timed beside phase 36",
                      r_t[(FLAGSHIP, "float32", "K-hop")])]
             + reduced("bfloat16", "K-hop", None)
             + reduced("int8", "K-hop", None)),
            ("webrtc_hop", "webrtc_hop", "webrtc_hop.py:331",
             w_launches + wws_launches, w_err, webrtc,
             [variant("mel, gruunet2-dari_tult, warm GL", "phases 3, 6, 7; "
                      "not on a MOMO path (JAX refuses delta and raw)"),
              variant("WebSocket daemon, gruunet2-dari_tult, warm GL",
                      f"phase 40: {WS_CLIENTS} clients, replies vs the "
                      f"kernel replayed per stream; reply p50 "
                      f"{wws_lat[0]:.3f} ms, p99 {wws_lat[1]:.3f} ms",
                      n=wws_launches)]),
            ("webrtc_hop_multi", "webrtc_hop", "webrtc_hop.py:344",
             wm_launches, wm_err, w_multi[WEBRTC_GL[0]],
             [variant("mel, gruunet2-dari_tult, GL-8 and GL-32",
                      "phases 19-22; not on a MOMO path")]),
            ("fused_cell", "fused_cell", "gruunet_cell.py:58",
             c_launches + mc_launches, max(c_err, mc_err), fused_cell,
             [variant("gruunet2-good and two runs/ widths", "phases 8-10"),
              variant(f"delta, {MOMO_SPEC}; MOMO2", "phase 27",
                      momo_t["cell"], mc_launches)])):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"audio_denoising_torch/csrc/{source}.cu",
            "replaces": f"audio_denoising_tpu/ops/pallas/{replaces}",
            "launches": n, "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "variants": variants})
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
    mode ``webrtc`` serves ``fast`` on the quantized plan; each engine
    against its served mode's step run alone on the card (0 expected);
    the gated int8 flagship in mode ``fused`` stays ``fused``, within a
    block's shared memory, with no warning. Then, for every
    configuration the script builds, in each compute mode, gated and
    not, one hop and K hops, the libraries' shared memory per block
    against the plain mirrors the engine decides by
    (``fused_hop_smem_bytes``, ``webrtc_hop_smem_bytes``; each kernel's
    wrapper also holds them equal whenever it binds on the card);
43. the bounded-lookahead checkpoint
    runs/gruunet2mel128w64-mrstft-la4-50k.npz (4 frames, the flagship's
    widths) in mode ``fast``, whose step carries the delay rings:
    ``StreamEngine`` at 256 slots for 50 ticks with skipped slots on the
    zoo model, then on ``PlanModel(fused=True)`` (the fused cell's
    kernel, once a tick), each against the same run on the CPU, idle
    slots' planes (the rings among them) bit-identical; ``profile --mode
    fast --fused`` on it; ``engine --mode fused`` on it in a subprocess:
    the warning that mode fused is downgraded to fast, the banner naming
    mode fast, 2 clients x 4 streams x 12 chunks against the daemon's
    engine replayed on the CPU; the hop time;
44. the gated W8A8 fused hop on the quality flagship (the tuned gate,
    'both'), which fits a block since its floor planes stay in global
    memory: the libraries' shared memory per block; the single hop
    against its plain version at 256 streams on voiced input as phase 35
    holds the reduced modes (``FORCED_DB``, ``FREE_DB``, the control
    failing both, the gate blending); the K-hop kernel at K = 50 as phase
    36 runs it, and its control (the plain fp32 K-hop against the plain
    int8 one) failing ``FREE_DB``; ``StreamEngine`` mode ``fused`` at int8
    serving it at 256 slots for 20 ticks against the CPU; its times
    beside rows 1i and 2i;
45. the WebRTC hop's bf16 Griffin-Lim mode on gruunet2-dari_tult at 256
    streams: the single hop at GL-32 and GL-8, each hop from the plain
    bf16 version's state, the median over streams of the added frame's
    SNR against the plain version at ``BF16_GL_DB`` and its SNR against
    the bf16 mode's float64 witness less that against fp32's at
    ``BF16_NEARER_DB`` (the control, the fp32 kernel in its place, must
    miss both), the bf16 witness by ``forced_floor``, hx and unit phases,
    the spectral convergence printed beside the control's (no limit
    separates them); the K-hop kernel at K = 25, GL-8: two calls against
    50 single bf16 hops (0); ``StreamEngine`` mode ``fused-webrtc`` at
    serving.dtype bfloat16 as phase 6 holds fp32; the times;
46. the stateless segment family's window: ``offline_denoise_stateless``
    on one window of the recommended streaming geometry (48,576 samples,
    127 frames padded to 155) at 256 streams on the card, for UNet2d4
    (runs/unet4crop2s-mrstft-30k.npz) and UNet2d4Wide
    (runs/unet4wide-crop2s-mrstft-30k.npz): 4 of the streams against the
    CPU, the residual within SEG_RESID_ATOL and the waveform within
    SEG_OUT_ATOL; the control, the same window with TF32 allowed in the
    convolutions and matmuls, must miss both; the window's time and peak
    memory;
47. ``StreamEngine`` mode ``unet`` on unet4crop2s at 256 slots over 3
    cycles (24 ticks) at the recommended geometry (seg 8 hops, ctx 960,
    ctx_left 44544, xfade 384), with the tuned gate ('both') and ungated,
    streams missing ticks (zeros spliced in, cadence-locked): 4 streams
    spread over the noise levels against the CPU engine, a snapshot at
    phase 4 restored and the rest run again (equal), the ungated run's
    TF32 control missing SEG_OUT_ATOL; CUDA events on the boundary tick
    and a plain tick, their mean per hop against the 8 ms budget, the
    card's busy share on the boundary tick and the peak memory; the same
    timing for UNet2d4Wide;
48. the same for TRUNetDenoiser (runs/trunet-realnoise.npz, 16 kHz, its
    class-default geometry: seg 16 hops, ctx 960) over 2 cycles, ungated,
    against the 16 ms budget (a boundary runs 6,144 frames through its
    GRUs);
49. ``EngineDaemon`` and ``WSDaemon`` in mode ``unet`` on unet4crop2s with
    no geometry flag (the recommended 84 ms point), 256 slots, 4 clients
    streaming at the audio's pace; each daemon's rounds are logged and
    replayed on a CPU engine, and every reply is held against its
    stream's replay (the tick's carry and pipelining must keep the
    rounds' order); the reply latency per hop (p50, p99) beside the 84 ms
    of algorithmic latency; then ``denoise --streamed`` on 2 s at 48 kHz
    on the card against the CPU within OFFLINE_ATOL;
50. one training step (``TrainingContext``: the loss and its gradients,
    the model's output, the AdamW update) on the card against the same
    step on the CPU from the same state and batch, at full width, on
    the flagship recipe (runs/gruunet2mel128w64-mrstft-50k.npz: 128
    mels, hidden 64, recon_mrstft, the SNR curriculum, batch 64 x 48000),
    gruunet2-dari_tult (residual_mse), MOMO3 (9,600-sample crops),
    UNet2d4 (runs/unet4crop2s-mrstft-30k.npz, dropout 0) and TRUNet
    (runs/trunet-realnoise.npz), each batch from the device sampler on a
    corpus this phase writes (the vowel at several pitches, white and
    brown noise, 48 kHz WAVs); the TF32 control (cuDNN and matmul TF32
    on) must miss the limits (``TRAIN_LIMITS``, ``TRAIN_CONTROL_FAILS``);
51. ``python -m audio_denoising_torch train`` with the flagship recipe
    from scratch: 60 steps on ``--device-data`` (finite, the last 10
    losses below the first 10), ``--resume`` for 10 more (the checkpoint
    counts 70 iterations and optimizer steps, its moments nonzero), 10
    on the host sampler; then the step timed in process on both samplers
    (ms at the median, the card's busy share by torch.profiler, peak
    memory);
52. the trained checkpoint through ``hub.load_pretrained``, ``denoise``
    on the card, ``eval --manifest`` on a manifest over that corpus on
    the card and with ``--device cpu`` (the outputs within OFFLINE_ATOL,
    the per-example metrics within EVAL_DB, no significant paired
    difference) and the ``compare`` command;
53. the kernel wrappers' device: the fused hop, the WebRTC hop (no GL
    round) and the fused cell, each built for ``cuda:0``, for a bare
    ``cuda`` and for each other card, against its plain version on that
    card;
54. ``make_fused_hop_sharded`` at 256 slots over ``[cuda:0, cuda:0]``
    (and over every card where there are several) against
    ``make_fused_hop`` at 256 slots, every output and plane (0 expected:
    the kernel's tile is 2 streams), and one call from the plain
    version's state against the plain version: stream16k single hop and
    K = 50, bf16 and int8, the gated int8 flagship, MOMO3 (raw, delta);
    both calls timed;
55. ``StreamEngine(mesh=...)`` in modes ``fused``, ``fused-webrtc``,
    ``fast`` and ``unet`` at 256 slots over the same meshes against the
    unsharded engine on the card, tick by tick, streams leaving and
    joining, a NaN chunk (modes ``fused`` and ``fast`` also against the
    CPU engine); ``engine --multichip`` (one card: served unsharded, as
    its startup line says); ``EngineDaemon`` on a mesh answering 4
    clients, each reply against its stream through the plain version;
56. the tensor-parallel plan cell (``make_tp_plan_cell``) at D = 2 over
    ``[cuda:0, cuda:0]`` (and over every card) on the flagship's plan and
    gruunet2-good's against ``plan_cell`` over 8 frames, its schedule
    printed;
57. ``make_sharded_train_step`` against the single-card step by phase
    50's readings and limits: NCCL at world 1 through ``initialize()``
    (the flagship recipe), two gloo ranks sharing ``cuda:0`` (the
    flagship recipe and UNet2d4; NCCL refuses two ranks on one card),
    each rank this script run with ``--dp-worker``; where there are
    several cards, NCCL over all of them and ``train --data-parallel``;
58. ONNX: momo3-4d4ea0 and gruunet2-good exported by the port's
    exporter, ``run_graph`` on the card at 256 streams against each
    model's own cell step on the card and against ``run_graph`` on the
    CPU; the MOMO3 graph through the hub served by ``StreamEngine`` mode
    ``fused`` and mode ``fast`` on ``PlanModel(fused=True)`` at 256 slots
    for 50 ticks, some streams skipping ticks, bit for bit against the
    same engine on checkpoints/momo3-4d4ea0.npz and against the CPU; the
    K-hop kernel on the graph's plan against its plain version and bit
    for bit against the .npz plan's;
59. ``loopback`` (``apps.loopback.main``, gruunet2-good, the fast step on
    the card) on a stand-in ``sounddevice`` module for 20 blocks against
    the same blocks with ``--torch-device cpu``; ``--no-denoise`` exactly
    the reference's raw loopback;
60. the WebRTC hop at the geometries radix 5 and the lifted mel caps
    opened: n_fft 640 (gruunet2-stream16k on gruunet2-good's weights,
    warm GL-32; M = 320 = 8 x 8 x 5 on the M = 0 instantiation) at 256
    and 3 streams, and on random weights 160 mels at n_fft 1024 and 64
    mels at n_fft 160 at 64 streams: the kernels' radices, both entry
    points in fp32 and the bf16 GL mode, each hop (or call) from the
    plain version's state against the plain version and a float64
    witness (the bf16 mode also at a limit per geometry that its control,
    the fp32 kernel in its place, misses), the K-hop kernel against
    single hops (0); mode
    ``fused-webrtc`` at n_fft 640 and 256 slots against the CPU engine;
    rows 4 and 5 timed at n_fft 640.

Phases 30-34 drive the offline path, which launches none of the
hand-written kernels: the JAX offline graph reaches no Pallas kernel
(``offline_denoise`` runs ``model.apply``, JAX pipeline.py:140). Phases
46-49 drive the stateless segment family (the U-Nets and TRUNet, mode
``unet``, ``denoise --streamed``), which launches none either: JAX's
segment path is ``lax.conv_general_dilated``, ``lax.scan`` GRUs and
elementwise ops (JAX ops/convs.py:85-125, models/unet2d.py,
models/trunet.py), reaching no Pallas kernel; the port runs PyTorch's
convolutions (fp32, under ``pipeline.fp32_convs``) and matmuls.

Phases 4 to 7, 9 to 12, 15 to 17, 27 to 29, 37 to 40, the engines and
the profile of phase 43, the engines of phases 44 and 45, the first
three calls of phases 14, 26, 44 and of each case of 36, and the calls
of phase 19 and of phase 45's K-hop kernel, the sharded engines and
daemon of phase 55, the ONNX-loaded engines and the first three K-hop
calls of phase 58, and phase 60's engine and the calls of its first
K-hop check are the main paths: each
kernel's launch counter is set to 0 just before each (a new wrapper
starts at 0) and read just after (the single WebRTC hop counts its three
kernels, the K-hop call one). Mode ``fast`` with the zoo model (phases
11, 12, 17, 28, and 43 on the lookahead checkpoint), mode ``fast`` on
the quantized plan (phases 37, 38, 42), mode ``webrtc`` (phases 23, 24,
42) and the socket daemon's server step (phase 41) run no hand-written
kernel, as the JAX package's modes ``fast`` and
``webrtc`` and its ``serve`` run no Pallas kernel; nor does mode ``unet``
(phases 47-49), as JAX's mode ``unet`` runs none, nor training and
evaluation (phases 50-52), as JAX's training reaches no Pallas kernel
(``TrainingContext`` runs the probed plan or ``model.apply``); nor
loopback on the zoo model (phase 59), as JAX's loopback runs its
op-by-op fast step.
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
import io
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import types

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
# the clip torch.profiler records the card's busy share on: profiling all
# of OFFLINE_TIMED_S took about 160 s of an H100 host's time
OFFLINE_PROFILED_S = 15
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
# phases 43-45
LA_TICKS = 50        # the lookahead checkpoint's engine runs (phase 43)
FLAG_TICKS = 20      # the gated int8 flagship's engine run (phase 44)
# The bf16 GL mode's kernel against its plain version on the card, one
# hop from the plain version's state (check_webrtc_bf16): the median over
# streams of the added frame's SNR, by GL rounds. Each limit sits between
# the kernel's lowest reading and the control's highest, the port's fp32
# kernel in the bf16 kernel's place. On an NVIDIA H100 80GB HBM3 at 700 W
# with this script's inputs, hops 2-5 at 256 streams: GL-32 the kernel
# 23.7-24.5 dB, the control 19.7-21.4; GL-8 34.0-36.1 and 27.4-28.4. The
# mode's bf16 roundings flip where the two fp32 FFTs differ in the last
# place, and 32 rounds with momentum spread each flip: the plain bf16
# hop reads 24.3-26.0 dB against its float64 witness on the CPU.
BF16_GL_DB = {32: 22.5, 8: 31.0}
# ... and the kernel's frame nearer the bf16 mode's float64 witness than
# fp32's: the median over streams of the SNR against the first less that
# against the second (the same runs: the kernel +2.1 to +2.9 dB at GL-32
# and +6.1 to +6.9 at GL-8, the control -78.3 to -75.4)
BF16_NEARER_DB = 0.0
# ... at GL-32 on phase 60's geometries, by (n_fft, n_mels), the same way
# (the same card, hops 2-5, the kernel's lowest median | the control's
# highest): n_fft 640 with 64 mels 14.5 | 9.8 dB at 256 streams and
# 16.6 | 10.1 at 3 (gruunet2-good's weights, whose plain bf16 hop reads
# 15.1 dB against its float64 witness); random weights at n_fft 1024
# with 160 mels 17.7 | 13.6 and at n_fft 160 with 64 mels 127 | 53.1 at
# 64 streams. The nearer readings there: the kernel +0.6 dB or more, the
# control -55.7 or less, so BF16_NEARER_DB holds as it is.
BF16_GEO_GL32_DB = {(640, 64): 12.0, (1024, 160): 15.5, (160, 64): 90.0}


_T0 = time.perf_counter()


def say(*parts):
    """Print a line now; a phase's title line ("phase N: ...", "offline
    timing ...", "done") ends with the seconds since the script started."""
    if isinstance(parts[0], str) and parts[0].startswith(
            ("phase ", "offline timing", "done")):
        parts = (*parts, f"[{time.perf_counter() - _T0:.0f} s]")
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


def small_webrtc_model(torch, n_iter, n_fft=64, n_mels=16):
    """The JAX webrtc tests' geometry (tests/test_webrtc_hop.py
    _small_setup: n_fft 64, 16 mels, hidden (5, 5)) with random weights
    from a seed: a point where warm GL is not chaotic, so the waveform is
    a surface to hold. Another ``n_fft`` keeps the model and weights;
    another ``n_mels`` keeps the model's shape at that width."""
    from audio_denoising_torch.config import Config, DSPConfig, ModelConfig
    from audio_denoising_torch.models import build_model
    compressed = ((n_mels - 1) // 2) // 2 + 1   # two k3 s2 p1 levels
    cfg = Config(
        dsp=DSPConfig(sample_rate=16000, n_fft=n_fft, hop_length=n_fft // 2,
                      n_mels=n_mels,
                      reconstruction="griffin_lim", griffin_lim_iters=n_iter,
                      griffin_lim_warm_start=True),
        model=ModelConfig(arch="GRUUNet2", num_compressed_bins=compressed,
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


def float64_plain(torch, cfg, plan, hops_per_call=1,
                  compute_dtype=None):
    """The plain version on the CPU in float64: a witness of how far each
    fp32 version departs. ``compute_dtype=torch.bfloat16``: the bf16 GL
    mode's witness, its GL rounds' transform inputs rounded to bf16 as the
    mode defines, the rest in float64."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import make_webrtc_hop
    hop = make_webrtc_hop(cfg, plan, "cpu", hops_per_call=hops_per_call,
                          compute_dtype=compute_dtype or torch.float32)
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


def check_webrtc_exact(torch, cfg, plan, batch, relative=False):
    """No GL round: the seed, analysis, cell and synthesis only, every
    surface exact to fp32 round-off; each version carries its own state.
    ``relative``: out and ola held at their bounds times the plain
    version's largest magnitude where above 1 (random weights at a few
    bins per mel synthesize samples of hundreds, where fp32 spaces its
    values 3e-5 and more apart)."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    cfg = warm_cfg(cfg, 0)
    hop = make_webrtc_hop(cfg, plan, "cuda")
    s_k = s_p = webrtc_hop_init_state(cfg, plan, batch, "cuda")
    e = {"out": 0.0, "ola": 0.0, "hx": 0.0, "phases": 0.0}
    scale = {"out": 1.0, "ola": 1.0}
    for c in webrtc_chunks(torch, batch, WEBRTC_HOPS, batch, hop.hop):
        c = c.cuda()
        s_k, o_k = hop(s_k, c)
        s_p, o_p = hop.reference(s_p, c)
        if relative:
            scale["out"] = max(scale["out"], float(o_p.abs().max()))
            scale["ola"] = max(scale["ola"], float(s_p.ola.abs().max()))
        e["out"] = max(e["out"], max_err(o_k, o_p))
        e["ola"] = max(e["ola"], max_err(s_k.ola, s_p.ola))
        e["hx"] = max(e["hx"], max_err(s_k.hx, s_p.hx))
        e["phases"] = max(e["phases"], max_err(s_k.ang_re, s_p.ang_re),
                          max_err(s_k.ang_im, s_p.ang_im))
        if max_err(s_k.ring, s_p.ring) != 0:
            raise AssertionError("webrtc kernel's ring differs")
    out_b, ola_b = OUT_ATOL * scale["out"], STATE_ATOL * scale["ola"]
    say(f"  GL-0  B={batch:3d}, {fft_label(hop)}: out {e['out']:.3e} (bound "
        f"{out_b:g}), ola {e['ola']:.3e} (bound {ola_b:g}), hx "
        f"{e['hx']:.3e} "
        f"(bound {HX_ATOL:g}), phases {e['phases']:.3e} (bound "
        f"{PHASE_ATOL:g})")
    if (e["out"] > out_b or e["ola"] > ola_b or e["hx"] > HX_ATOL
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


def check_fft_plans(hop, sizes=FFT_SIZES):
    """The kernels' pass radices for each FFT size the checks run equal
    ``fft_radices``, the plain schedule the CPU tests hold against
    torch.fft."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import fft_radices
    for m in sizes:
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


def phase_engine_webrtc(torch, cfg, model, bound=SNR_GL32_DB):
    """Mode fused-webrtc on the card against the CPU engine, the CPU engine
    given the card's state before every tick: each tick's outputs equal,
    hx within HX_ATOL, from tick 2 on the frame each active slot adds to
    its OLA buffer held by ``forced_floor`` at ``bound`` (the float64
    plain version run from the same state, in the engine's GL mode, is
    the witness), idle slots untouched."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import KERNELS_PER_HOP
    from audio_denoising_torch.runtime.engine import StreamEngine
    n, ticks = SLOTS, 8
    gpu = StreamEngine(cfg, model, mode="fused-webrtc", max_streams=n)
    cpu = StreamEngine(cfg, model, mode="fused-webrtc", max_streams=n,
                       device="cpu")
    if gpu.mode != "fused-webrtc":
        raise AssertionError(f"mode fused-webrtc served as {gpu.mode}")
    sids = [f"s{i}" for i in range(n)]
    for sid in sids:
        gpu.add_stream(sid)
        cpu.add_stream(sid)
    f64 = float64_plain(torch, cfg, gpu.plan,
                        compute_dtype=gpu.hop_step.compute_dtype)
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
            rules.append(forced_floor(f_gpu, f_cpu, f_d, bound))
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


def phase_profile(torch, spec="gruunet2-good"):
    """Phases 9 and 43: the profile command in mode fast on the fused
    cell, in this process, on ``spec``; returns the cell's launches (one
    per hop it ran) and the report."""
    import contextlib
    import io
    from audio_denoising_torch.apps import profile_app
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = profile_app.main(["--model", spec, "--streams", str(SLOTS),
                               "--mode", "fast", "--fused"])
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
    ring, ola, hx and prev (ABS_PLANES); for the gate's planes the
    largest |a - b| / (PLANE_ATOL / PLANE_RTOL + |b|), which stays under
    PLANE_RTOL exactly when |a - b| <= PLANE_ATOL + PLANE_RTOL |b|; for
    the lookahead rings, spectra of the analysis frames, each stream's
    largest error over its largest bin (an FFT's error scales with the
    frame, not with the bin), the phases on the complex bins mag
    e^(i phase) (a phase of pi and of -pi is one bin)."""
    import torch
    errs = {}
    p_got, p_want = planes(got), planes(want)
    for k, a in p_got.items():
        b = p_want[k].to(a.device).double()
        a = a.double()
        if k in ABS_PLANES:
            errs[k] = max_err(a, b)
        elif k in ("la_mag", "la_phase"):
            m_a = p_got["la_mag"].double()
            m_b = p_want["la_mag"].to(a.device).double()
            if k == "la_phase":
                a, b = torch.polar(m_a, a), torch.polar(m_b, b)
            d = (a - b).abs().flatten(1).amax(dim=1)
            scale = m_b.flatten(1).amax(dim=1).clamp_min(PLANE_ATOL)
            errs[k] = float((d / scale).max().cpu())
        else:
            d = (a - b).abs()
            errs[k] = float((d / (PLANE_ATOL / PLANE_RTOL + b.abs())
                             ).max().cpu())
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

def check_webrtc_multi_exact(torch, cfg, plan, batch, calls,
                             compute_dtype=None):
    """``calls`` calls of the K-hop kernel (K = WEBRTC_K) carrying the
    state, each one launch (the main path where batch = SLOTS), against
    the same hops as single-hop calls from the same state: every output
    and every plane must be equal (0 expected); in ``compute_dtype``
    (float32, or bfloat16 for the bf16 GL mode). Returns the launches."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    dt = compute_dtype or torch.float32
    multi = make_webrtc_hop(cfg, plan, "cuda", hops_per_call=WEBRTC_K,
                            compute_dtype=dt)
    single = make_webrtc_hop(cfg, plan, "cuda", compute_dtype=dt)
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
    say(f"  {'bf16 ' if multi.gl_bf16 else ''}GL-{multi.n_iter:<2d} "
        f"B={batch:3d}, {fft_label(multi)}: {calls} calls of K={WEBRTC_K} "
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


def phase_engine_idle(torch, cfg, model, mode, ticks, seed, cpu_model=None):
    """StreamEngine ``mode`` on the card against the CPU engine, each
    carrying its own state, SLOTS slots for ``ticks`` ticks with skipped
    slots: outputs and every plane (hold_free, in the compute dtype the
    engine serves: cfg.serving.dtype in mode fused, int8 or float32 in
    mode fast), and on the card the idle slots' planes (hx, prev and the
    lookahead rings among them) bit-identical; each engine must serve
    ``mode`` itself. ``cpu_model``: the CPU engine's model where ``model``
    is built for the card (a PlanModel). Returns the kernel's launches in
    mode fused (None in mode fast: the zoo model and the quantized plan
    run no hand-written kernel; a PlanModel(fused=True) counts its cell's
    own)."""
    from audio_denoising_torch.runtime.engine import StreamEngine
    gpu = StreamEngine(cfg, model, mode=mode, max_streams=SLOTS)
    cpu = StreamEngine(cfg, model if cpu_model is None else cpu_model,
                       mode=mode, max_streams=SLOTS, device="cpu")
    if gpu.mode != mode or cpu.mode != mode:
        raise AssertionError(f"mode {mode} served as {gpu.mode} on the card, "
                             f"{cpu.mode} on the CPU")
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
def normalized_outputs(name="offline_denoise"):
    """Collect, in call order, the peak-normalized output (on the CPU) of
    every ``name`` (``offline_denoise``, or the segment family's
    ``offline_denoise_streamed``) that ``apps.offline``'s chain runs, so
    two runs of an entry point are compared before de-normalization."""
    from audio_denoising_torch.apps import offline
    real, seen = getattr(offline, name), []

    def spy(cfg, model, audio, *args, **kw):
        y = real(cfg, model, audio, *args, **kw)
        seen.append(y.detach().cpu())
        return y

    setattr(offline, name, spy)
    try:
        yield seen
    finally:
        setattr(offline, name, real)


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
    the real-time factor, and the share of a call the card is busy (by
    torch.profiler, on the clip's first OFFLINE_PROFILED_S s); the chain
    stage by stage; ``offline_denoiser`` on a batch of OFFLINE_BATCH clips
    of OFFLINE_BATCH_S s."""
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
        cfg, model, x[:, :OFFLINE_PROFILED_S * OFFLINE_IN_RATE],
        OFFLINE_IN_RATE))
    busy = sum(rows.values()) / 1e6
    span = wall * OFFLINE_PROFILED_S / secs   # the median call's share
    frames = resampled_length(x.shape[-1], OFFLINE_IN_RATE,
                              dsp.sample_rate) // dsp.hop_length + 1
    say(f"  denoise_array, {OFFLINE_SPEC}, {secs} s of 44.1 kHz stereo, "
        f"{frames} frames ({smi}): calls of "
        + ", ".join(f"{w:.3f}" for w in walls)
        + f" s wall, median {wall:.3f} s: real-time factor "
        f"{wall / secs:.4f} ({secs / wall:.1f}x real time); on its first "
        f"{OFFLINE_PROFILED_S} s the card busy {busy:.3f} s by "
        f"torch.profiler, {busy / span:.1%} of the median call's "
        f"{span:.3f} s for that span ({prof_wall:.3f} s under the "
        f"profiler), {len(rows)} kernels; top:")
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
    if eng.mode != "fused" or said or need > limit:
        raise AssertionError(f"gated int8 flagship: {need} B against "
                             f"{limit} B, mode {eng.mode}, warnings {said}")
    say(f"  gated int8 {FLAGSHIP} in mode fused: {need} B of shared memory "
        f"a block within the card's {limit} B: mode {eng.mode}, no "
        f"downgrade (phase 44 holds it)")
    if max(e1, e2) > REPLAY_ATOL:
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


# -- lookahead, the gated int8 flagship, the bf16 GL mode (phases 43-45) -----

def phase_lookahead(torch, smi):
    """Phase 43: the bounded-lookahead checkpoint OFFLINE_LA_CHECKPOINT in
    mode fast (its delay rings): StreamEngine at SLOTS slots for LA_TICKS
    ticks with skipped slots on the zoo model, then on
    ``PlanModel(fused=True)`` (the fused cell's kernel), each against the
    same run on the CPU with idle slots bit-identical; ``profile`` on it;
    ``engine --mode fused`` in a subprocess (phase_lookahead_daemon); the
    hop time. Returns the fused cell's launches on those paths."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.runtime.plan import PlanModel
    spec = os.path.join(REPO, "runs", OFFLINE_LA_CHECKPOINT)
    cfg, model = load_pretrained(spec)
    say(f"  {OFFLINE_LA_CHECKPOINT}: {cfg.model.lookahead_frames} frames "
        f"of lookahead, n_fft {cfg.dsp.n_fft}, hop {cfg.dsp.hop_length}, "
        f"{cfg.dsp.n_mels} mels, hidden {cfg.model.hidden_sizes}")
    phase_engine_idle(torch, cfg, model, "fast", LA_TICKS, 430)
    pm = PlanModel(model, fused=True)
    pm.fused_cell.launches = 0
    phase_engine_idle(torch, cfg, pm, "fast", LA_TICKS, 431,
                      cpu_model=PlanModel(model, fused=True, device="cpu"))
    launches = pm.fused_cell.launches
    flops, nbytes = cell_work(pm.fused_cell, SLOTS)
    say(f"  PlanModel(fused=True): {launches} fused-cell launches; the "
        f"fused cell's bound at B={SLOTS} on this plan "
        f"{max(flops / FP32_FLOPS, nbytes / HBM_BYTES_S) * 1e6:.2f} us "
        f"({flops / 1e6:.1f} MFLOP at fp32, {nbytes / 1e6:.2f} MB)")
    if launches != LA_TICKS:
        raise AssertionError(f"expected {LA_TICKS} fused-cell launches, saw "
                             f"{launches}")
    profiled_launches, _ = phase_profile(torch, spec)
    phase_lookahead_daemon(torch, spec)
    say(f"  the lookahead hop ({smi}):")
    time_fast_step(torch, cfg, model, f"{OFFLINE_LA_CHECKPOINT} zoo model")
    time_fast_step(torch, cfg, pm,
                   f"{OFFLINE_LA_CHECKPOINT} PlanModel(fused=True)")
    return launches + profiled_launches


def phase_lookahead_daemon(torch, spec):
    """``python -m audio_denoising_torch engine --mode fused`` on the
    lookahead checkpoint in a subprocess on the card: it warns that mode
    fused is downgraded to fast and says it serves mode fast; a few
    clients' replies against the same daemon's engine built on the CPU
    (the daemon's own profile: the tuned gate) replaying each stream."""
    import re
    import signal
    from audio_denoising_torch.apps.engine_serve import EngineDaemon
    clients, streams, n_chunks = 2, 4, 12
    proc = subprocess.Popen(
        [sys.executable, "-m", "audio_denoising_torch", "engine", "--model",
         spec, "--mode", "fused", "--max-streams", str(SLOTS), "--host",
         "127.0.0.1", "--port", "0"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        banner = proc.stdout.readline()
        found = re.search(r"listening on \('([\d.]+)', (\d+)\) \(mode (\w+)",
                          banner)
        if not found:
            raise AssertionError(f"the daemon did not start: {banner!r}")
        address = (found.group(1), int(found.group(2)))
        served = found.group(3)
        cpu = EngineDaemon(spec, max_streams=clients * streams,
                           mode="fused", device="cpu")
        data = daemon_data(cpu.cfg, clients, streams, n_chunks, 432)
        results, errors = {}, []
        threads = [threading.Thread(target=_client, args=(
            address, c, data[c], results, errors), daemon=True)
            for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(REPLY_DEADLINE_S * (n_chunks + 4))
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError("; ".join(errors) or "a client hung")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            _, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
    got = np.concatenate([results[c] for c in range(clients)])
    eng = cpu.engine
    sids = [f"s{i}" for i in range(clients * streams)]
    for sid in sids:
        eng.add_stream(sid)
    seqs = data.reshape(clients * streams, n_chunks, -1)
    want = np.zeros_like(got)
    for k in range(n_chunks):
        out = eng.process({sid: seqs[i, k] for i, sid in enumerate(sids)})
        for i, sid in enumerate(sids):
            want[i, k] = out[sid]
    e = float(np.abs(got - want).max())
    warned = "'fused' downgraded to 'fast'" in err
    say(f"  engine --mode fused in a subprocess: serves mode {served}, "
        f"warned {warned}; {clients} clients x {streams} streams x "
        f"{n_chunks} chunks against the CPU replay (gate "
        f"{cpu.cfg.serving.snr_gate_db} dB, "
        f"{cpu.cfg.serving.snr_gate_estimator}): out {e:.3e} (bound "
        f"{OUT_ATOL:g})")
    if served != "fast" or not warned or cpu.engine.mode != "fast":
        raise AssertionError("the lookahead daemon did not downgrade mode "
                             "fused to fast")
    if e > OUT_ATOL or not np.all(np.isfinite(got)):
        raise AssertionError("the lookahead daemon's replies disagree with "
                             "the CPU")


def phase_int8_flagship(torch, flag_cfg, flag, flag_plan, smi):
    """Phase 44: the gated W8A8 fused hop on the quality flagship (the
    tuned gate, 'both'), whose floor planes stay in global memory: its
    shared memory per block against the library's and the card's; the
    single hop against its plain version at SLOTS streams on voiced input
    (phase_kernel_vs_plain: FORCED_DB, FREE_DB, the control must fail
    both, the gate must blend); the K-hop kernel at K = 50 (check_multi),
    its control (the plain fp32 K-hop against the plain int8 one) failing
    FREE_DB; StreamEngine mode fused at int8 serving it at SLOTS slots
    against the CPU (phase_engine_idle); the times beside rows 1i and 2i.
    Returns (single-hop launches, K-hop launches, largest output error
    from the plain state, worst forced hop dB, K-hop (launches, error,
    worst stream dB), timings)."""
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, fused_hop_smem_bytes, make_fused_hop)
    cfg = tuned_gate(flag_cfg)
    label = f"{FLAGSHIP}, tuned gate (both)"
    hop = make_fused_hop(cfg, flag_plan, "cuda", compute_dtype=torch.int8)
    multi = make_fused_hop(cfg, flag_plan, "cuda", hops_per_call=K_HOPS,
                           compute_dtype=torch.int8)
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = [int(h._lib.adt_fused_hop_smem_bytes(ctypes.byref(h._base_args)))
           for h in (hop, multi)]
    say(f"  {label}, int8: shared memory per block {lib[0]} B (one hop), "
        f"{lib[1]} B (K={K_HOPS}) from the library; "
        f"fused_hop_smem_bytes "
        f"{fused_hop_smem_bytes(cfg, flag_plan, torch.int8)}"
        f" B; the card allows {limit} B; ungated "
        f"{fused_hop_smem_bytes(flag_cfg, flag_plan, torch.int8)} B, fp32 "
        f"gated {fused_hop_smem_bytes(cfg, flag_plan)} B")
    if max(lib) > limit or lib[0] != hop.smem_bytes:
        raise AssertionError("the gated int8 flagship does not fit a block")
    e, db = phase_kernel_vs_plain(torch, hop, cfg, flag_plan, (SLOTS,),
                                  label, voiced_input=True)
    chunks = torch.from_numpy(voiced_chunks(
        SLOTS, K_HOPS, cfg.dsp.hop_length, cfg.dsp.sample_rate, 44)).cuda()
    k_run = check_multi(torch, cfg, flag_plan, label, chunks, "int8")
    s0 = fused_hop_init_state(cfg, flag_plan, SLOTS, "cuda")
    fp32 = make_fused_hop(cfg, flag_plan, "cuda", hops_per_call=K_HOPS)
    runs = []
    for h in (multi, fp32):
        s, o1 = h.plain(s0, chunks)
        _, o2 = h.plain(s, chunks)
        runs.append(torch.cat([o1, o2]))
    c_ok, c_text = free_verdict(stream_dbs(runs[0], runs[1]), cfg, "int8")
    say(f"  K-hop control, the plain fp32 K-hop against the plain int8 "
        f"one over 2 calls: {c_text}")
    if c_ok:
        raise AssertionError("FREE_DB would pass fp32 in the int8 K-hop "
                             "kernel's place")
    say(f"  StreamEngine mode fused at int8, {label}, {SLOTS} slots:")
    engine_launches = phase_engine_idle(
        torch, with_dtype(cfg, "int8"), flag, "fused", FLAG_TICKS, 440)
    say(f"  the gated int8 flagship ({smi}):")
    s_t, c_t = hop_inputs(
        torch, hop, lambda b: fused_hop_init_state(cfg, flag_plan, b,
                                                   "cuda"), SLOTS)
    s_t = s_t._replace(**{k: v.abs() for k, v in planes(s_t).items()
                          if k.startswith(("nf_", "em_"))})
    t_hop = timed(torch, lambda: hop(s_t, c_t),
                  lambda: hop.reference(s_t, c_t), hop_work(hop, SLOTS),
                  SLOTS, 5, plain_launches=5)
    t_multi = timed(torch, lambda: multi(s0, chunks),
                    lambda: multi.plain(s0, chunks), hop_work(multi, SLOTS),
                    SLOTS, 3, plain_launches=1, hops=K_HOPS)
    return engine_launches, k_run[0], e, db, k_run, (t_hop, t_multi)


def check_webrtc_bf16(torch, cfg, plan, batch, hops, plain_db=None):
    """The bf16 GL mode's kernel held by the warm-GL rule at the served
    geometry: along the plain bf16 version's trajectory on the card, at
    every hop the kernel, the plain version, the control (the port's fp32
    kernel in the bf16 kernel's place) and two float64 witnesses, of the
    bf16 mode and of fp32, start from its state and take the same chunk.
    On hops 2 on, per stream, the SNR of the frame each adds to its OLA
    buffer: against the plain version (median over streams at
    ``plain_db``, by default BF16_GL_DB[n_iter]), and against the bf16
    witness less against the
    fp32 witness (median over streams at BF16_NEARER_DB: nearer the mode
    it runs); the control must miss both at every hop; the kernel against
    the bf16 witness by forced_floor; each stream's spectral convergence
    against the plain version's, beside the control's (printed); at every
    hop hx within HX_ATOL and unit phases. Returns the readings: {statistic: (kernel's worst hop, control's best hop)}
    and the largest ola error against the plain version."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    hop = make_webrtc_hop(cfg, plan, "cuda", compute_dtype=torch.bfloat16)
    control = make_webrtc_hop(cfg, plan, "cuda")
    w16 = float64_plain(torch, cfg, plan, compute_dtype=torch.bfloat16)
    w32 = float64_plain(torch, cfg, plan)
    limit = BF16_GL_DB[hop.n_iter]
    plain_db = limit if plain_db is None else plain_db
    s = webrtc_hop_init_state(cfg, plan, batch, "cuda")
    stats = {k: ([], []) for k in ("plain", "nearer", "sc")}
    rules, worst_hx, worst_ola = [], 0.0, 0.0
    for t, c in enumerate(webrtc_chunks(torch, batch, hops, batch + 45,
                                        hop.hop)):
        s_k, _ = hop(s, c.cuda())
        s_p, _ = hop.reference(s, c.cuda())
        s_c, _ = control(s, c.cuda())
        s64 = to(s, "cpu", torch.float64)
        s_16, _ = w16.reference(s64, c.double())
        s_32, _ = w32.reference(s64, c.double())
        torch.cuda.synchronize()
        worst_hx = max(worst_hx, max_err(s_k.hx, s_p.hx))
        worst_ola = max(worst_ola, max_err(s_k.ola, s_p.ola))
        if not phases_ok(torch, s_k) or not bool(torch.isfinite(
                s_k.ola).all()):
            raise AssertionError(f"bf16 webrtc kernel: non-unit phases or a "
                                 f"non-finite frame at hop {t}")
        fk, fp, fc, f16, f32 = (added_frame(s, x, hop.hop)
                                for x in (s_k, s_p, s_c, s_16, s_32))
        if t < 2:          # a stream's first window is half silence
            s = s_p
            continue
        _, peak, _, lin = w16.targets(s64, c.double())
        sc_p = spectral_convergence(torch, w16, fp, peak, lin)
        for i, f in enumerate((fk, fc)):
            stats["plain"][i].append(float(np.median(stream_snrs(fp, f))))
            stats["nearer"][i].append(float(np.median(
                stream_snrs(f16, f) - stream_snrs(f32, f))))
            stats["sc"][i].append(float(np.abs(spectral_convergence(
                torch, w16, f, peak, lin) - sc_p).max()))
        rules.append(forced_floor(fk, fp, f16, limit))
        s = s_p
    readings = {k: (min(v[0]) if k != "sc" else max(v[0]),
                    max(v[1]) if k != "sc" else min(v[1]))
                for k, v in stats.items()}
    worst = min(rules, key=lambda r: r[0] - r[2])
    say(f"  bf16 GL-{hop.n_iter} B={batch:3d}, {fft_label(hop)}, each hop "
        f"from the plain bf16 version's state, hops 2-{hops - 1}, median "
        f"over streams per hop, kernel | control (the fp32 kernel):")
    for k, unit in (("plain", "dB"), ("nearer", "dB"), ("sc", "")):
        say(f"    {k:6s} " + ", ".join(f"{v:.3g}" for v in stats[k][0])
            + " | " + ", ".join(f"{v:.3g}" for v in stats[k][1])
            + f" {unit}")
    say(f"    limits: plain {plain_db:g} dB, nearer {BF16_NEARER_DB:g} dB; "
        f"kernel/f64 witness closest hop {worst[0]:.1f} (plain/f64 "
        f"{worst[1]:.1f}, floor {worst[2]:.1f}) dB; hx {worst_hx:.3e} "
        f"(bound {HX_ATOL:g}); ola {worst_ola:.3e}; phases unit")
    if worst_hx > HX_ATOL or any(k < f for k, _, f in rules):
        raise AssertionError(f"the bf16 webrtc kernel disagrees with its "
                             f"plain version (GL-{hop.n_iter}, B={batch})")
    check_gl_bf16(hop.n_iter, readings, plain_db)
    return readings, worst_ola


def check_gl_bf16(n_iter, readings, plain_db=None):
    """Raises unless the kernel's worst hop meets ``plain_db`` (by default
    BF16_GL_DB[n_iter]) and BF16_NEARER_DB and the control's best hop
    misses both."""
    plain_db = BF16_GL_DB[n_iter] if plain_db is None else plain_db
    (k_plain, c_plain), (k_near, c_near) = (readings["plain"],
                                            readings["nearer"])
    if k_plain < plain_db or k_near < BF16_NEARER_DB:
        raise AssertionError(f"the bf16 webrtc kernel (GL-{n_iter}) misses "
                             f"its limits: {readings}")
    if c_plain >= plain_db or c_near >= BF16_NEARER_DB:
        raise AssertionError(f"the bf16 limits (GL-{n_iter}) would pass the "
                             f"fp32 kernel in the bf16 kernel's place: "
                             f"{readings}")


def phase_webrtc_bf16(torch, dari_cfg, dari, dari_plan, smi):
    """Phase 45: the WebRTC hop's bf16 GL mode on gruunet2-dari_tult at
    SLOTS streams: the single hop at GL-32 and at GL-8 by the warm-GL
    rule (check_webrtc_bf16); the K-hop kernel at K = 25, GL-8: two calls
    carrying the state, each one launch, against 50 single bf16 hops from
    the same state (0 on every output and plane); StreamEngine
    fused-webrtc at serving.dtype bfloat16 (phase_engine_webrtc, the
    witness in the bf16 mode); the times beside rows 4 and 5. Returns
    (single-hop launches, K-hop launches, worst ola error, timings,
    readings)."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    readings = {}
    for n_iter in (dari_cfg.dsp.griffin_lim_iters, WEBRTC_GL[0]):
        readings[n_iter] = check_webrtc_bf16(
            torch, warm_cfg(dari_cfg, n_iter), dari_plan, SLOTS, WEBRTC_HOPS)
    cfg8 = warm_cfg(dari_cfg, WEBRTC_GL[0])
    multi = make_webrtc_hop(cfg8, dari_plan, "cuda",
                            compute_dtype=torch.bfloat16,
                            hops_per_call=WEBRTC_K)
    single = make_webrtc_hop(cfg8, dari_plan, "cuda",
                             compute_dtype=torch.bfloat16)
    s0 = webrtc_hop_init_state(cfg8, dari_plan, SLOTS, "cuda")
    chunks = torch.stack(webrtc_chunks(torch, SLOTS, 2 * WEBRTC_K, 451,
                                       multi.hop)).cuda()
    multi.launches = 0
    s_m, o_m = multi(s0, chunks[:WEBRTC_K])
    s_m, o_m2 = multi(s_m, chunks[WEBRTC_K:])
    torch.cuda.synchronize()
    k_launches = multi.launches
    s_s, o_s = run_hops(single, s0, chunks)
    exact = {k: max_err(planes(s_m)[k], v) for k, v in planes(s_s).items()}
    exact["out"] = max_err(torch.cat([o_m, o_m2]), torch.stack(o_s))
    say(f"  bf16 K-hop, GL-{WEBRTC_GL[0]}, K={WEBRTC_K}, B={SLOTS}: 2 calls "
        f"against {2 * WEBRTC_K} single hops from one state: {fmt(exact)} "
        f"(0 expected); {k_launches} launches for 2 calls")
    if max(exact.values()) > KHOP_EXACT or k_launches != 2:
        raise AssertionError("the bf16 K-hop webrtc kernel differs from "
                             "single hops")
    say(f"  StreamEngine mode fused-webrtc at bfloat16, {SLOTS} slots, the "
        f"CPU engine given the card's state each tick:")
    cfg16 = with_dtype(dari_cfg, "bfloat16")
    e_launches = phase_engine_webrtc(
        torch, cfg16, dari, BF16_GL_DB[dari_cfg.dsp.griffin_lim_iters])
    say(f"  the bf16 GL mode ({smi}):")
    hop = make_webrtc_hop(dari_cfg, dari_plan, "cuda",
                          compute_dtype=torch.bfloat16)
    w_state, w_chunk = hop_inputs(
        torch, hop, lambda b: webrtc_hop_init_state(dari_cfg, dari_plan, b,
                                                    "cuda"), SLOTS)
    t_hop = timed(torch, lambda: hop(w_state, w_chunk),
                  lambda: hop.reference(w_state, w_chunk),
                  webrtc_hop_work(hop, SLOTS), SLOTS, 50)
    t_multi = timed(torch, lambda: multi(s0, chunks[:WEBRTC_K]),
                    lambda: multi.plain(s0, chunks[:WEBRTC_K]),
                    webrtc_hop_work(multi, SLOTS), SLOTS, 5,
                    plain_launches=1, hops=WEBRTC_K)
    worst_ola = max(ola for _, ola in readings.values())
    return e_launches, k_launches, worst_ola, (t_hop, t_multi), readings


# -- phases 46-49: the stateless segment family -----------------------------

SEG_UNET = "unet4crop2s-mrstft-30k.npz"         # UNet2d4, the crop-2 s run
SEG_WIDE = "unet4wide-crop2s-mrstft-30k.npz"    # UNet2d4Wide
SEG_TRUNET = "trunet-realnoise.npz"             # TRUNetDenoiser, 16 kHz
SEG_CHECK = 4        # streams of 256 replayed on the CPU (windows are
                     # independent, so a subset holds the batch)
SEG_UNET_CYCLES = 3  # engine cycles (8 hops each at the recommended point)
SEG_TRUNET_CYCLES = 2    # 16 hops each at TRUNet's class defaults
SEG_TIMED_CYCLES = 2     # cycles timed after one warm cycle
# The segment path on the card against the CPU, max abs error. cuDNN and
# the CPU sum each conv in their own order, so fp32 differs by round-off;
# the TF32 control (the same window or run with TF32 allowed in the convs
# and matmuls) must miss each limit. Each sits near the geometric middle
# of the fp32 runs' worst reading and the controls' best, on an NVIDIA
# H100 80GB HBM3 at 700 W with this script's inputs: the waveform of the
# window (phase 46) 4.8e-7 and 1.6e-4, of the engines (47-48) 1.4e-6 and
# 3.0e-4 (UNet2d4), 1.0e-5 and 2.9e-3 (TRUNet, the largest fp32
# reading); the residual 1.4e-5 and 2.4e-3.
SEG_OUT_ATOL = 4e-5      # waveforms
SEG_RESID_ATOL = 2e-4    # a window's residual log-magnitude (up to ~10)
SEG_CLIENTS = 4          # daemon clients at the audio's pace, one stream
SEG_CLIENT_HOPS = 33     # hops each client streams (4 cycles and one)
SEG_OFFLINE_S = 2        # the clip of denoise --streamed


@contextlib.contextmanager
def tf32_allowed(torch):
    """The control of phases 46-48: the segment path with TF32 allowed in
    its convolutions (pipeline.fp32_convs, which the path scopes them
    with) and matmuls (the GRU's)."""
    from audio_denoising_torch import pipeline
    real, mm = pipeline.fp32_convs, torch.backends.cuda.matmul.allow_tf32
    pipeline.fp32_convs = lambda: torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=False, allow_tf32=True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        pipeline.fp32_convs = real
        torch.backends.cuda.matmul.allow_tf32 = mm


def segment_cfg(torch, name, gated=False):
    """(cfg, zoo model on the CPU) of a runs/ checkpoint at the geometry
    the daemons serve it (recommended_streaming_geometry: the U-Nets'
    84 ms point, TRUNet's class defaults), optionally with the tuned gate
    ('both', 1 dB, width 6)."""
    from audio_denoising_torch.config import recommended_streaming_geometry
    from audio_denoising_torch.hub import load_pretrained
    cfg, model = load_pretrained(os.path.join(REPO, "runs", name))
    cfg = recommended_streaming_geometry(cfg)
    if gated:
        cfg = with_gate(cfg, "both", 1.0, 6.0)
    return cfg, model


def segment_image(torch, cfg, model, audio):
    """The padded log1p magnitude offline_denoise_stateless hands the
    model, for ``audio`` (B, L) on its device."""
    from audio_denoising_torch.ops import hann_window, stft
    dsp = cfg.dsp
    win = hann_window(dsp.win).to(audio.device)
    logmag = torch.log1p(stft(audio, dsp.n_fft, dsp.hop_length, dsp.win,
                              window=win).abs())
    t = logmag.shape[-1]
    return torch.nn.functional.pad(logmag, (0, model.compatible_frames(t)
                                            - t))


def phase_segment_window(torch, smi):
    """Phase 46: offline_denoise_stateless on one window of the
    recommended geometry (48,576 samples, 127 frames padded to 155) at
    SLOTS streams on the card, for UNet2d4 and UNet2d4Wide: SEG_CHECK
    streams against the CPU (residual and waveform), the TF32 control
    missing the limits the fp32 run meets, the window's time and peak
    memory. Returns {name: (ms, peak GB)}."""
    from audio_denoising_torch.pipeline import (
        fp32_convs, offline_denoise_stateless, serving_model)
    out = {}
    for name in (SEG_UNET, SEG_WIDE):
        cfg, model = segment_cfg(torch, name)
        srv = cfg.serving
        n = (srv.unet_ctx_left_samples + srv.unet_seg_hops
             * cfg.dsp.hop_length + srv.unet_ctx_samples)
        audio = noisy_voice(n, cfg.dsp.sample_rate, 46, channels=SLOTS)
        card = serving_model(model, torch.device("cuda"))
        x = torch.from_numpy(audio).cuda()
        img = segment_image(torch, cfg, card, x[:SEG_CHECK])
        with torch.no_grad():
            with fp32_convs():
                res = card.apply(img).cpu()
            res_plain = model.apply(img.cpu())
            y = offline_denoise_stateless(cfg, card, x)
            plain = offline_denoise_stateless(cfg, model,
                                              x[:SEG_CHECK].cpu())
            with tf32_allowed(torch):
                with torch.backends.cudnn.flags(allow_tf32=True):
                    res_tf32 = card.apply(img).cpu()
                y_tf32 = offline_denoise_stateless(cfg, card, x)
        errs = (max_err(res, res_plain),
                max_err(y[:SEG_CHECK].cpu(), plain))
        ctrl = (max_err(res_tf32, res_plain),
                max_err(y_tf32[:SEG_CHECK].cpu(), plain))
        torch.cuda.reset_peak_memory_stats()
        ms = time_launches(torch, lambda: offline_denoise_stateless(
            cfg, card, x), 5)
        peak = torch.cuda.max_memory_allocated() / 1e9
        finite = bool(torch.isfinite(y).all())
        say(f"  {card.arch}, {name}: {SLOTS} windows of {n} samples "
            f"({img.shape[-1]} frames padded); {SEG_CHECK} streams vs the "
            f"CPU: residual {errs[0]:.3e} (bound {SEG_RESID_ATOL:g}), "
            f"waveform {errs[1]:.3e} (bound {SEG_OUT_ATOL:g}); TF32 control "
            f"{ctrl[0]:.3e}, {ctrl[1]:.3e}; the window at {SLOTS} streams "
            f"{ms:.2f} ms, peak memory {peak:.2f} GB ({smi})")
        if not finite or y.shape != x.shape or errs[0] > SEG_RESID_ATOL \
                or errs[1] > SEG_OUT_ATOL:
            raise AssertionError(f"{name}: the window on the card disagrees "
                                 f"with the CPU")
        if ctrl[0] <= SEG_RESID_ATOL or ctrl[1] <= SEG_OUT_ATOL:
            raise AssertionError(f"{name}: the TF32 control meets a limit: "
                                 f"the limits separate nothing")
        out[name] = (ms, peak)
    return out


def segment_ticks(cfg, ticks, seed):
    """Per tick {stream: chunk} for SLOTS streams of the vowel at spread
    noise levels; stream i misses the ticks where (7 i + t) % 5 == 0 (the
    cadence-locked engine gives it zeros there)."""
    hop = cfg.dsp.hop_length
    v = voiced_chunks(SLOTS, ticks, hop, cfg.dsp.sample_rate, seed)
    return [{f"s{i}": v[t, i] for i in range(SLOTS) if (7 * i + t) % 5}
            for t in range(ticks)]


def checked_sids():
    """The SEG_CHECK streams replayed on the CPU, spread over the noise
    levels of segment_ticks."""
    return [f"s{i}" for i in np.linspace(0, SLOTS - 1, SEG_CHECK).astype(int)]


def run_segment_engine(eng, schedule, sids):
    """(ticks, len(sids), hop) outputs of ``eng`` over ``schedule`` (zeros
    where a stream missed a tick)."""
    out = np.zeros((len(schedule), len(sids), eng.hop), np.float32)
    for t, chunks in enumerate(schedule):
        got = eng.process({s: c for s, c in chunks.items()
                           if s in eng.slots})
        for i, sid in enumerate(sids):
            if sid in got:
                out[t, i] = got[sid]
    return out


def time_segment_engine(torch, eng, seg_hops, budget, smi):
    """CUDA events around each tick of ``eng`` (process_batch, SLOTS
    random chunks on the card) over SEG_TIMED_CYCLES cycles after a warm
    one: the boundary tick, the plain ticks, the mean per hop against the
    hop's real-time budget; the card's busy share on a boundary tick
    (torch.profiler's kernel time over the tick's wall time) and the peak
    memory across it. -> (boundary ms, plain ms, mean ms, busy, peak GB)."""
    batch = torch.from_numpy((0.1 * np.random.default_rng(47).standard_normal(
        (SLOTS, eng.hop))).astype(np.float32)).cuda()
    while eng._phase:
        eng.process_batch(batch)
    for _ in range(seg_hops):
        eng.process_batch(batch)
    torch.cuda.synchronize()
    times = {}
    for _ in range(SEG_TIMED_CYCLES):
        for phase in range(seg_hops):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            eng.process_batch(batch)
            b.record()
            b.synchronize()
            times.setdefault(phase, []).append(a.elapsed_time(b))
    boundary = float(np.median(times[seg_hops - 1]))
    plain = float(np.median([t for p in range(seg_hops - 1)
                             for t in times[p]]))
    mean = float(np.mean([np.mean(times[p]) for p in range(seg_hops)]))
    for _ in range(seg_hops - 1):
        eng.process_batch(batch)
    torch.cuda.reset_peak_memory_stats()
    rows, wall = profiled(torch, lambda: eng.process_batch(batch))
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy = sum(rows.values()) / 1e6 / wall
    say(f"  timing at {SLOTS} streams ({smi}): boundary tick {boundary:.3f} "
        f"ms, plain tick {plain:.3f} ms, mean per hop {mean:.3f} ms against "
        f"the {budget:g} ms budget ({mean / budget:.1%}); the card "
        f"busy {busy:.1%} of the boundary tick ({wall * 1e3:.3f} ms under "
        f"the profiler); peak memory {peak:.2f} GB")
    print_breakdown(rows, "boundary tick")
    return boundary, plain, mean, busy, peak


def budget_ms(cfg) -> float:
    """A hop's real-time budget."""
    return cfg.dsp.hop_length / cfg.dsp.sample_rate * 1e3


def time_segment_only(torch, name, smi):
    """Phase 47's timing of another checkpoint's engine (no CPU replay:
    phase 46 holds its window)."""
    from audio_denoising_torch.runtime.engine import StreamEngine
    cfg, model = segment_cfg(torch, name)
    eng = StreamEngine(cfg, model, mode="unet", max_streams=SLOTS,
                       device="cuda")
    for i in range(SLOTS):
        eng.add_stream(f"s{i}")
    say(f"  {name}:")
    return time_segment_engine(torch, eng, cfg.serving.unet_seg_hops,
                               budget_ms(cfg), smi)


def phase_segment_engine(torch, name, cycles, smi, gates=(True, False)):
    """Phases 47-48: StreamEngine mode unet at SLOTS slots on the card for
    ``cycles`` cycles with skipped ticks (zeros spliced in), with the
    tuned gate and ungated, against the CPU engine on SEG_CHECK streams; a
    snapshot mid-cycle restored and the rest run again (equal outputs);
    the ungated run again with TF32 allowed, the control, missing
    SEG_OUT_ATOL; then the ungated engine's ticks timed against the hop's
    budget. -> the timing tuple."""
    from audio_denoising_torch.runtime.engine import StreamEngine
    for gated in gates:
        cfg, model = segment_cfg(torch, name, gated)
        seg_hops = cfg.serving.unet_seg_hops
        ticks = cycles * seg_hops
        gpu = StreamEngine(cfg, model, mode="unet", max_streams=SLOTS,
                           device="cuda")
        cpu = StreamEngine(cfg, model, mode="unet", max_streams=SEG_CHECK,
                           device="cpu")
        sids, check = [f"s{i}" for i in range(SLOTS)], checked_sids()
        for sid in sids:
            gpu.add_stream(sid)
        for sid in check:
            cpu.add_stream(sid)
        schedule = segment_ticks(cfg, ticks, 47 + gated)
        mid = seg_hops + seg_hops // 2
        got = run_segment_engine(gpu, schedule[:mid], sids)
        snap = gpu.snapshot()
        got = np.concatenate([got, run_segment_engine(gpu, schedule[mid:],
                                                      sids)])
        gpu.restore(snap)
        again = run_segment_engine(gpu, schedule[mid:], sids)
        want = run_segment_engine(cpu, schedule, check)
        cols = [sids.index(s) for s in check]
        err = float(np.abs(got[:, cols] - want).max())
        rerun = float(np.abs(again - got[mid:]).max())
        finite = bool(np.isfinite(got).all())
        text = (f"  {name}, {'tuned gate (both)' if gated else 'ungated'}: "
                f"{SLOTS} streams x {ticks} ticks (seg {seg_hops} hops, "
                f"ctx {cfg.serving.unet_ctx_samples}, ctx_left "
                f"{cfg.serving.unet_ctx_left_samples}, xfade "
                f"{cfg.serving.unet_xfade_samples}); {SEG_CHECK} streams vs "
                f"the CPU engine {err:.3e} (bound {SEG_OUT_ATOL:g}); restored "
                f"at phase {snap['phase']}, the rest again {rerun:.3e}")
        if not gated:
            ctrl_eng = StreamEngine(cfg, model, mode="unet",
                                    max_streams=SLOTS, device="cuda")
            for sid in sids:
                ctrl_eng.add_stream(sid)
            with tf32_allowed(torch):
                ctrl = run_segment_engine(ctrl_eng, schedule, check)
            ctrl_err = float(np.abs(ctrl - want).max())
            text += f"; TF32 control {ctrl_err:.3e}"
            del ctrl_eng
        say(text + "; no hand-written kernel on this path")
        if gpu.mode != "unet" or not finite or err > SEG_OUT_ATOL \
                or rerun > REPLAY_ATOL:
            raise AssertionError(f"{name}: mode unet on the card disagrees "
                                 f"with the CPU or with its own restore")
        if not gated and ctrl_err <= SEG_OUT_ATOL:
            raise AssertionError(f"{name}: the TF32 control meets "
                                 f"SEG_OUT_ATOL")
        if gated and (gpu.state.em_out is None or gpu.state.nf_floor is
                      None):
            raise AssertionError("the gated engine carries no gate planes")
    return time_segment_engine(torch, gpu, seg_hops, budget_ms(cfg), smi)


def recorded_rounds(engine):
    """Log ``engine``'s slot changes and rounds in order (from the tick
    thread and the connections' threads), to replay a daemon's run."""
    log, lock = [], threading.Lock()
    add, remove, run = (engine.add_stream, engine.remove_stream,
                        engine.process_async)

    def logged(op, fn):
        def call(arg):
            with lock:
                log.append((op, {s: np.array(c) for s, c in arg.items()}
                            if op == "tick" else arg))
                return fn(arg)
        return call

    engine.add_stream = logged("add", add)
    engine.remove_stream = logged("remove", remove)
    engine.process_async = logged("tick", run)
    return log


def replay_rounds(log, engine):
    """{sid: (rounds, hop) outputs} of ``log`` replayed on ``engine``."""
    outs = {}
    for op, arg in log:
        if op == "add":
            engine.add_stream(arg)
        elif op == "remove":
            engine.remove_stream(arg)
        else:
            for s, o in engine.process(arg).items():
                outs.setdefault(s, []).append(np.asarray(o))
    return {s: np.stack(o) for s, o in outs.items()}


def _paced_client(address, cid, chunks, sr, results, errors):
    """One stream streamed at the audio's pace over the engine daemon's
    wire protocol, a reader thread taking the replies: (replies, per-hop
    latency from sending a chunk to its reply)."""
    from multiprocessing.connection import Client
    try:
        with Client(address) as conn:
            sid = f"c{cid}"
            conn.send(("open", sid))
            if not conn.poll(REPLY_DEADLINE_S) or conn.recv()[0] != "ok":
                raise RuntimeError(f"open {sid} failed")
            sent, arrived, outs = [], [], []

            def receive():
                while len(outs) < len(chunks):
                    if not conn.poll(REPLY_DEADLINE_S):
                        raise TimeoutError(f"{sid}: no reply")
                    msg = conn.recv()
                    if msg[0] != "out":
                        raise RuntimeError(f"{sid}: {msg}")
                    arrived.append(time.perf_counter())
                    outs.append(msg[2])

            reader = threading.Thread(target=receive, daemon=True)
            reader.start()
            t0 = time.perf_counter()
            for k, chunk in enumerate(chunks):
                wait = t0 + k * chunk.size / sr - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent.append(time.perf_counter())
                conn.send(("chunk", sid, chunk))
            reader.join(REPLY_DEADLINE_S * 2)
            if len(outs) != len(chunks):
                raise RuntimeError(f"{sid}: {len(outs)} of {len(chunks)} "
                                   f"replies")
            if cid == 0:
                conn.send(("stats",))
                results["stats"] = conn.recv()[1]
            results[cid] = (np.stack(outs),
                            np.asarray(arrived) - np.asarray(sent))
            conn.send(("close", sid))
            conn.recv()
    except Exception as e:
        errors.append(f"client {cid}: {e!r}")


def seg_latency_line(lat, latency_ms, smi):
    p50, p99 = np.percentile(lat, [50, 99]) * 1e3
    return (f"reply latency per hop (from sending a chunk to its reply, "
            f"{lat.size} hops at the audio's pace) p50 {p50:.3f} ms, p99 "
            f"{p99:.3f} ms, beside {latency_ms:g} ms of algorithmic latency "
            f"({smi})")


def phase_segment_daemons(torch, smi):
    """Phase 49: EngineDaemon and WSDaemon in mode unet on unet4crop2s
    with no geometry flag (the recommended 84 ms point), SLOTS slots,
    SEG_CLIENTS clients streaming at the audio's pace; each daemon's
    rounds are logged and replayed on a CPU engine, and every reply held
    against its stream's replay (the engine daemon within SEG_OUT_ATOL,
    the WebSocket one within WS_LSB after int16); then ``denoise
    --streamed`` on SEG_OFFLINE_S s of 48 kHz on the card against the CPU
    (the chain's peak-normalized outputs within OFFLINE_ATOL). Returns
    (engine p50, p99, ws p50, p99) in ms."""
    from audio_denoising_torch.apps import offline
    from audio_denoising_torch.apps.engine_serve import EngineDaemon
    from audio_denoising_torch.apps.ws_serve import WSDaemon
    from audio_denoising_torch.io import write_wav
    from audio_denoising_torch.io.wavio import (
        float32_to_pcm16, pcm_to_float32)
    from audio_denoising_torch.runtime.engine import StreamEngine
    path = os.path.join(REPO, "runs", SEG_UNET)
    lat_out = []
    daemon = EngineDaemon(path, max_streams=SLOTS, address=("127.0.0.1", 0),
                          mode="unet", device="cuda")
    cfg, hop, sr = daemon.cfg, daemon.engine.hop, daemon.cfg.dsp.sample_rate
    latency_ms = daemon.engine.algorithmic_latency_ms
    log = recorded_rounds(daemon.engine)
    data = voiced_chunks(SEG_CLIENTS, SEG_CLIENT_HOPS, hop, sr, 49)
    server = threading.Thread(target=daemon.serve_forever, daemon=True)
    results, errors = {}, []
    server.start()
    try:
        if not daemon.listening.wait(60):
            raise TimeoutError("daemon did not start listening")
        threads = [threading.Thread(target=_paced_client, args=(
            daemon.address, c, data[:, c], sr, results, errors), daemon=True)
            for c in range(SEG_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(REPLY_DEADLINE_S * 4)
    finally:
        daemon.stop()
        server.join(10)
    if errors or server.is_alive():
        raise RuntimeError("; ".join(errors) or "the daemon did not stop")
    want = replay_rounds(log, StreamEngine(cfg, daemon.model, mode="unet",
                                           max_streams=SEG_CLIENTS,
                                           device="cpu"))
    err = max(float(np.abs(results[c][0] - want[f"c{c}"]).max())
              for c in range(SEG_CLIENTS))
    lat = np.concatenate([results[c][1] for c in range(SEG_CLIENTS)])
    rounds = sum(op == "tick" for op, _ in log)
    say(f"  engine daemon: {SEG_CLIENTS} clients x {SEG_CLIENT_HOPS} hops in "
        f"{rounds} rounds; replies vs the rounds replayed on the CPU "
        f"{err:.3e} (bound {SEG_OUT_ATOL:g}); stats latency "
        f"{results['stats']['algorithmic_latency_ms']} ms; "
        + seg_latency_line(lat, latency_ms, smi))
    if err > SEG_OUT_ATOL or daemon.engine.mode != "unet":
        raise AssertionError("the engine daemon's replies disagree with "
                             "its rounds replayed")
    lat_out += list(np.percentile(lat, [50, 99]) * 1e3)

    ws = WSDaemon(path, "127.0.0.1", 0, max_streams=SLOTS, mode="unet",
                  device="cuda")
    log = recorded_rounds(ws.engine)
    pcm = ws_pcm(SEG_CLIENTS, SEG_CLIENT_HOPS * hop, 49)
    got, lat, _, stats, _ = serve_ws(ws, pcm)
    want = replay_rounds(log, StreamEngine(ws.cfg, ws.model, mode="unet",
                                           max_streams=SEG_CLIENTS,
                                           device="cpu"))
    lsb = 0
    for c in range(SEG_CLIENTS):
        first = pcm_to_float32(pcm[c, :hop])
        sid, = {s for op, arg in log if op == "tick"
                for s, chunk in arg.items() if np.array_equal(chunk, first)}
        w = float32_to_pcm16(want[sid].reshape(-1))
        lsb = max(lsb, int(np.abs(got[c].astype(np.int32)
                                  - w.astype(np.int32)).max()))
    say(f"  WebSocket daemon: GET / 200; {SEG_CLIENTS} clients x "
        f"{SEG_CLIENT_HOPS} hops in {sum(op == 'tick' for op, _ in log)} "
        f"rounds; int16 replies vs the rounds replayed on the CPU {lsb} LSB "
        f"(bound {WS_LSB}); " + seg_latency_line(lat, latency_ms, smi))
    check_ws_stats(stats, SEG_CLIENTS)
    if lsb > WS_LSB:
        raise AssertionError("the WebSocket daemon's replies disagree with "
                             "its rounds replayed")
    lat_out += list(np.percentile(lat, [50, 99]) * 1e3)

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.wav")
        n = SEG_OFFLINE_S * 48000
        write_wav(src, noisy_voice(n, 48000, 49), 48000)
        t0 = time.perf_counter()
        with normalized_outputs("offline_denoise_streamed") as outs:
            offline.main([src, os.path.join(tmp, "card.wav"), "--model",
                          path, "--streamed"])
            card_s = time.perf_counter() - t0
            offline.main([src, os.path.join(tmp, "cpu.wav"), "--model",
                          path, "--streamed", "--device", "cpu"])
    check_offline(f"denoise --streamed, {SEG_UNET}, {SEG_OFFLINE_S} s at 48 "
                  f"kHz (the card {card_s:.2f} s)", outs[0], outs[1], n)
    return lat_out



# -- phases 50-52: training and evaluation ------------------------------------

TRAIN_CORPUS_FILES = 4     # clean WAVs of the synthesized corpus
TRAIN_CORPUS_S = 3         # seconds each, 48 kHz
TRAIN_NOISE_S = 4          # seconds of each of the two noise WAVs
TRAIN_FLAGSHIP = "gruunet2mel128w64-mrstft-50k.npz"
# phase 50's cases: (label, checkpoint under the repo, the preset whose
# config a config-less checkpoint trains under or None for its own, the
# crop in samples where it is cut: MOMO3's 21-sample hop makes 48,000
# samples 2,286 steps of recurrence, two minutes a step on the CPU)
TRAIN_CASES = (
    ("flagship", os.path.join("runs", TRAIN_FLAGSHIP), None, None),
    ("dari_tult", os.path.join("checkpoints", "gruunet2-dari_tult.npz"),
     "gruunet2-dari_tult", None),
    ("momo3", os.path.join("checkpoints", "momo3-4d4ea0.npz"),
     "momo3-4d4ea0", 9600),
    ("unet2d4", os.path.join("runs", SEG_UNET), None, None),
    ("trunet", os.path.join("runs", SEG_TRUNET), None, None))
# One training step on the card against the CPU, from the same state and
# batch: the loss relative to the CPU's; the model's output (its residual
# prediction on the batch's features) relative to its largest magnitude;
# each gradient relative to its largest magnitude, floored at
# TRAIN_GRAD_FLOOR of the median over the model's tensors of their
# largest gradient (a conv bias in front of an InstanceNorm has a zero
# gradient in exact arithmetic: on UNet2d4 those read 1e-8 against a
# median of 0.1); each parameter after the step relative to its largest
# magnitude, for the tensors whose gradient clears the floor. The step
# starts from the checkpoint's AdamW moments (runs/ carry them) or, for a
# checkpoint without, from the state after one step on the card, so
# Adam's first step (lr * g / |g| whatever g's size) does not turn
# round-off into a full step. The TF32 control (cuDNN and matmul TF32 on
# for the card's step) must miss each limit of the residual objective.
# The reconstruction objective's log(|E| + 1e-5) terms turn float32
# round-off in a near-zero estimate bin into percent of a gradient, so
# fp32 alone sits as far from exact as TF32 on its loss and gradients
# (the flagship at batch 8 on the CPU: fp32 against float64 4.8e-5 on the
# loss, 2.3e-2 on the gradients): there the control must miss the output
# and parameter limits. Limits: {objective: (loss, output, gradients,
# parameters)}; the readings the control must fail, by index. Each such
# limit sits near the geometric middle of the fp32 runs' largest reading
# and the controls' smallest (this phase with the limits unset, NVIDIA
# H100 80GB HBM3, 700.00 W): the loss 8.1e-7 and 1.9e-4 (residual), the
# output 5.6e-6 and 7.2e-4 (every case), the gradients 4.2e-4 and
# 1.15e-3 (residual), the parameters 7.6e-7 and 9.9e-5 (residual),
# 2.2e-5 and 3.8e-4 (reconstruction). The reconstruction objective's
# loss and gradients are held at about 3x its largest fp32 reading
# (6.0e-5, the flagship; 7.2e-2, UNet2d4); fp32 itself reads 3.4e-4 and
# 7.5e-2 against float64 there (UNet2d4 at batch 2 on the CPU).
TRAIN_GRAD_FLOOR = 1e-4
TRAIN_LIMITS = {"residual_mse": (1e-5, 6e-5, 7e-4, 9e-6),
                "recon_mrstft": (2e-4, 6e-5, 0.2, 9e-5)}
TRAIN_CONTROL_FAILS = {"residual_mse": (0, 1, 2, 3),
                       "recon_mrstft": (1, 3)}
TRAIN_READINGS = ("loss", "output", "gradients", "parameters")
TRAIN_CLI_STEPS = 60       # phase 51's first run, --device-data
TRAIN_RESUME_STEPS = 10    # then --resume, and 10 on the host sampler
TRAIN_TREND = 10           # losses averaged at each end of the run
TRAIN_TIMED_DISPATCHES = 5  # of 10 steps each, after a warm dispatch
TRAIN_TIMED_HOST = 10      # host-sampler steps timed one by one
EVAL_BLOCK_N = 8           # examples per block of phase 52's manifest
EVAL_DB = 1e-2             # a per-example metric, card vs CPU (dB; LSD)
# the flagship recipe (runs/gruunet2mel128w64-mrstft-50k.npz's
# full_config.train) as train flags, from scratch
FLAGSHIP_RECIPE = ("--preset", "gruunet2-mel128", "--hidden", "64",
                   "--objective", "recon_mrstft", "--snr-range", "-10", "15",
                   "--lr-gamma", "0.97", "--batch-size", "64",
                   "--crop-samples", "48000", "--log-every", "10")


def write_train_corpus(root):
    """The synthesized corpus of phases 50-52 under ``root``: clean WAVs
    of the vowel (``voiced``) at several pitches and syllable rates, a
    -60 dB floor under each, and ``noise/`` with white and brown noise,
    all 48 kHz, from fixed seeds. -> (clean paths, noise paths)."""
    from audio_denoising_torch.io.wavio import write_wav
    sr = 48000
    os.makedirs(os.path.join(root, "noise"), exist_ok=True)
    rng = np.random.default_rng(50)
    clean = []
    base = voiced(TRAIN_CORPUS_S * sr, sr)
    for i in range(TRAIN_CORPUS_FILES):
        # a pitch and tempo per file: resample the vowel's time axis
        t = np.arange(TRAIN_CORPUS_S * sr) * (0.8 + 0.15 * i)
        x = np.interp(t % len(base), np.arange(len(base)), base)
        x = x * (0.6 + 0.4 * np.sin(2 * np.pi * (0.5 + 0.3 * i)
                                    * np.arange(len(x)) / sr)) ** 2
        x = x + 1e-3 * rng.standard_normal(len(x))
        path = os.path.join(root, f"voice{i}.wav")
        write_wav(path, x.astype(np.float32), sr)
        clean.append(path)
    white = rng.standard_normal(TRAIN_NOISE_S * sr)
    brown = np.cumsum(rng.standard_normal(TRAIN_NOISE_S * sr))
    noise = []
    for name, x in (("white", white), ("brown", brown - brown.mean())):
        path = os.path.join(root, "noise", f"{name}.wav")
        write_wav(path, (0.5 * x / np.abs(x).max()).astype(np.float32), sr)
        noise.append(path)
    return clean, noise


def train_case(name, path, preset, crop=None):
    """(cfg, model, the checkpoint path) of a phase-50 case at its full
    width and training config (its crop cut to ``crop``), dropout 0 (the
    mask has its own test)."""
    from audio_denoising_torch.compat import load_params_npz
    from audio_denoising_torch.config import Config, PRESETS
    from audio_denoising_torch.models import build_model
    if preset is None:
        meta = load_params_npz(os.path.join(REPO, path))[1]
        cfg = Config.from_json(json.dumps(meta["full_config"]))
    else:
        cfg = PRESETS[preset]
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=0.0),
        train=dataclasses.replace(
            cfg.train, crop_samples=crop or cfg.train.crop_samples))
    return cfg, build_model(cfg.model, num_bins=cfg.dsp.n_mels), \
        os.path.join(REPO, path)


def train_batch(torch, cfg, corpus, seed):
    """One batch of the case's recipe from the device sampler on the CPU
    (the corpus at the case's rate, the SNR curriculum where its config
    has one), the same tensors for both sides."""
    from audio_denoising_torch.train.device_data import (
        DeviceCorpus, make_device_sampler)
    clean, noise = corpus
    sr = cfg.dsp.sample_rate
    sample = make_device_sampler(
        DeviceCorpus.from_paths(clean, sr, device="cpu"),
        cfg.train.crop_samples, cfg.train.batch_size,
        noise_corpus=DeviceCorpus.from_paths(noise, sr, device="cpu"),
        snr_range_db=cfg.train.snr_range_db,
        identity_prob=cfg.train.identity_prob)
    return sample(torch.Generator().manual_seed(seed))


def train_readings(cpu, card):
    """(loss, output, gradients, parameters errors), [round-off
    tensors]) of the card's step against the CPU's by phase 50's rule;
    each side is (loss, output, {key: gradient}, {key: param after})."""
    (l_cpu, y_cpu, g_cpu, p_cpu), (l_card, y_card, g_card, p_card) = \
        cpu, card
    floor = TRAIN_GRAD_FLOOR * float(np.median(
        [float(g.abs().max()) for g in g_cpu.values()]))
    loss_err = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    out_err = max_err(y_card, y_cpu) / float(y_cpu.abs().max())
    grad_err, param_err, roundoff = 0.0, 0.0, []
    for k, g in g_cpu.items():
        grad_err = max(grad_err, max_err(g_card[k], g)
                       / max(float(g.abs().max()), floor))
        if float(g.abs().max()) < floor:
            roundoff.append(k)
            continue
        param_err = max(param_err, max_err(p_card[k], p_cpu[k])
                        / float(p_cpu[k].abs().max()))
    return (loss_err, out_err, grad_err, param_err), roundoff


@contextlib.contextmanager
def train_tf32(torch):
    """Phase 50's control: the training step's fp32 scope replaced by
    one with TF32 on in cuDNN's convolutions and in matmuls."""
    from audio_denoising_torch.train import context

    @contextlib.contextmanager
    def tf32():
        mm = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with torch.backends.cudnn.flags(
                    enabled=True, benchmark=False, deterministic=False,
                    allow_tf32=True):
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = mm

    real = context.fp32_scope
    context.fp32_scope = tf32
    try:
        yield
    finally:
        context.fp32_scope = real


def train_step_on(torch, state, cfg, model, dev, batch):
    """(loss, the model's output, {key: gradient}, {key: param after the
    step}), all on the CPU, of one step of a context loaded from
    ``state`` on ``dev``, and the step's seconds."""
    from audio_denoising_torch.train import context
    ctx = context.TrainingContext.load(state, cfg, model, device=dev)
    mix, clean = (t.to(dev) for t in batch)
    t0 = time.perf_counter()
    loss, grads = ctx.loss_and_grads(mix, clean)
    with torch.no_grad(), context.fp32_scope():
        out, _ = ctx._forward(ctx.state.params, ctx.features(mix))
    ctx._step(mix, clean)
    params = {k: v.detach().cpu() for k, v in ctx.state.params.items()}
    seconds = time.perf_counter() - t0
    return (loss.cpu(), out.cpu(), {k: g.cpu() for k, g in grads.items()},
            params), seconds


def check_train_limits(readings, controls, objectives):
    """Phase 50's verdict: every case's readings within its objective's
    limits; every case's TF32 control beyond the limits
    TRAIN_CONTROL_FAILS names. ``readings``/``controls``: {case: (loss,
    output, gradients, parameters)}; ``objectives``: {case: objective}."""
    for name, got in readings.items():
        limits = TRAIN_LIMITS[objectives[name]]
        if any(r > lim for r, lim in zip(got, limits)):
            raise AssertionError(f"{name}: the card's training step "
                                 f"disagrees with the CPU's: {got}")
        for i in TRAIN_CONTROL_FAILS[objectives[name]]:
            if controls[name][i] <= limits[i]:
                raise AssertionError(
                    f"{name}: the TF32 control meets the "
                    f"{TRAIN_READINGS[i]} limit ({controls[name][i]:.3e} <= "
                    f"{limits[i]:g}): the limit separates nothing")


def phase_train_step(torch, tmp, corpus, dev="cuda"):
    """Phase 50: one training step of each case on the card and on the
    CPU from the same state and batch: the loss, the model's output,
    every gradient and every parameter after the step, then the TF32
    control on the card."""
    from audio_denoising_torch.train.context import TrainingContext
    readings, controls, objectives = {}, {}, {}
    for i, (name, path, preset, crop) in enumerate(TRAIN_CASES):
        cfg, model, path = train_case(name, path, preset, crop)
        batch = train_batch(torch, cfg, corpus, 500 + i)
        ctx = TrainingContext.load(path, cfg, model, device=dev)
        warm = ctx.state.step == 0
        if warm:                     # no stored moments: one step first
            ctx.train_step(*train_batch(torch, cfg, corpus, 550 + i))
        state = os.path.join(tmp, f"state-{name}.npz")
        ctx.save(state)
        cpu, cpu_s = train_step_on(torch, state, cfg, model, "cpu", batch)
        card, card_s = train_step_on(torch, state, cfg, model, dev, batch)
        got, roundoff = train_readings(cpu, card)
        with train_tf32(torch):
            tf32, _ = train_step_on(torch, state, cfg, model, dev, batch)
        ctrl, _ = train_readings(cpu, tf32)
        if not math.isfinite(float(card[0])) or not all(
                bool(torch.isfinite(g).all()) for g in card[2].values()):
            raise AssertionError(f"{name}: a non-finite loss or gradient")
        readings[name], controls[name] = got, ctrl
        objectives[name] = cfg.train.objective
        start = ("after one step on the card" if warm else
                 f"the checkpoint's moments at step {ctx.state.step}")
        say(f"  {name} ({cfg.model.arch}, {cfg.train.objective}, batch "
            f"{cfg.train.batch_size} x {cfg.train.crop_samples}, "
            f"{len(cpu[2])} tensors, from {start}): loss "
            f"{float(cpu[0]):.6f}; card vs CPU "
            + ", ".join(f"{n} {v:.3e}" for n, v in zip(TRAIN_READINGS, got))
            + "; TF32 control " + ", ".join(f"{v:.3e}" for v in ctrl)
            + f"; round-off gradients in {len(roundoff)} tensors; the step "
            f"(loss and gradients, output, update) {cpu_s:.2f} s on the "
            f"CPU, {card_s:.3f} s on the card")
    for obj, lim in TRAIN_LIMITS.items():
        say(f"  limits, {obj}: " + ", ".join(
            f"{n} {v:g}" for n, v in zip(TRAIN_READINGS, lim)))
    check_train_limits(readings, controls, objectives)


def run_cli(argv, dev, what):
    """``python -m audio_denoising_torch`` with ``argv`` in a subprocess
    (``--device cpu`` added off the card); raises unless it exits 0.
    -> its stdout."""
    extra = [] if dev == "cuda" else ["--device", "cpu"]
    proc = subprocess.run([sys.executable, "-m", "audio_denoising_torch",
                           *argv, *extra], cwd=REPO, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return proc.stdout


def check_loss_trend(losses, n=TRAIN_TREND):
    """Phase 51's trend: every loss finite and the mean of the last n
    below the mean of the first n, over at least 2 n steps. -> (the two
    means)."""
    losses = [float(v) for v in losses]
    first, last = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
    finite = all(math.isfinite(v) for v in losses)
    if not finite or not last < first or len(losses) < 2 * n:
        raise AssertionError(f"the losses do not fall: first {n} "
                             f"{first:.5f}, last {n} {last:.5f}, finite "
                             f"{finite}, {len(losses)} steps")
    return first, last


def train_record(path):
    """(meta, the train losses in iteration order, the __opt__ leaves)
    of a checkpoint."""
    from audio_denoising_torch.compat import load_params_npz
    params, meta = load_params_npz(path)
    rec = meta["loss_record"]["train"]
    leaves = [params[f"__opt__{i}"] for i in range(meta["opt_n_leaves"])]
    return meta, [rec[k] for k in sorted(rec, key=int)], leaves


def time_training(torch, ckpt, corpus, smi, dev="cuda"):
    """The flagship recipe's step on the card, in process from phase 51's
    checkpoint: ms per step at the median on the device sampler (per
    dispatch of 10 steps, which ends in the losses' copy to the host)
    and on the host sampler (per step, which ends in the loss's), the
    card's busy share under torch.profiler for each, peak memory."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.train import MixtureSampler
    from audio_denoising_torch.train.context import TrainingContext
    from audio_denoising_torch.train.device_data import DeviceCorpus
    cfg, model = load_pretrained(ckpt)
    ctx = TrainingContext.load(ckpt, cfg, model, device=dev)
    clean, noise = corpus
    buf = DeviceCorpus.from_paths(clean, cfg.dsp.sample_rate, device=dev)
    nbuf = DeviceCorpus.from_paths(noise, cfg.dsp.sample_rate, device=dev)

    def dispatch():
        ctx.fit_on_device(buf, iters=10, steps_per_dispatch=10,
                          noise_corpus=nbuf)

    dispatch()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(TRAIN_TIMED_DISPATCHES):
        t0 = time.perf_counter()
        dispatch()
        walls.append((time.perf_counter() - t0) / 10)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rows, wall = profiled(torch, dispatch)
    device = (1e3 * float(np.median(walls)), sum(rows.values()) / 1e6 / wall)

    sampler = MixtureSampler(clean, noise, crop_samples=cfg.train
                             .crop_samples, batch_size=cfg.train.batch_size,
                             seed=cfg.train.seed, sample_rate=48000)

    def host_step():                 # the sampler's draw, then the step
        ctx.train_step(*sampler.sample())

    host_step()
    host_step()
    walls = []
    for _ in range(TRAIN_TIMED_HOST):
        t0 = time.perf_counter()
        host_step()
        walls.append(time.perf_counter() - t0)
    rows, wall = profiled(torch, host_step)
    host = (1e3 * float(np.median(walls)), sum(rows.values()) / 1e6 / wall)
    say(f"  flagship recipe ({cfg.model.arch}, hidden "
        f"{cfg.model.hidden_sizes}, batch {cfg.train.batch_size} x "
        f"{cfg.train.crop_samples}, {cfg.train.objective}), {smi}: device "
        f"sampler {device[0]:.2f} ms/step at the median of "
        f"{TRAIN_TIMED_DISPATCHES} dispatches of 10, card busy "
        f"{device[1]:.1%} of a dispatch; host sampler {host[0]:.2f} "
        f"ms/step at the median of {TRAIN_TIMED_HOST} steps (sampling "
        f"included), card busy {host[1]:.1%} of a step; peak memory "
        f"{peak:.2f} GB")


def phase_train_cli(torch, tmp, corpus_dir, corpus, smi, dev="cuda"):
    """Phase 51: ``python -m audio_denoising_torch train`` with the
    flagship recipe from scratch: TRAIN_CLI_STEPS steps on the device
    sampler (every loss finite, the last TRAIN_TREND below the first),
    then ``--resume`` for TRAIN_RESUME_STEPS more (the checkpoint counts
    70 iterations and 70 optimizer steps, its moments nonzero), then
    TRAIN_RESUME_STEPS on the host sampler; then the step timed in
    process. -> the last checkpoint."""
    first = os.path.join(tmp, "flagship-60.npz")
    base = ["train", *FLAGSHIP_RECIPE, "--data", corpus_dir]
    t0 = time.perf_counter()
    run_cli(base + ["--device-data", "--iters", str(TRAIN_CLI_STEPS),
                    "--save", first], dev, "train --device-data")
    wall = time.perf_counter() - t0
    meta, losses, _ = train_record(first)
    lo, hi = check_loss_trend(losses)
    say(f"  train --device-data, {TRAIN_CLI_STEPS} steps from scratch: "
        f"{wall:.1f} s of command; mean loss of the first {TRAIN_TREND} "
        f"{lo:.4f}, of the last {hi:.4f}; {len(losses)} losses finite")
    second = os.path.join(tmp, "flagship-70.npz")
    out = run_cli(base + ["--device-data", "--iters",
                          str(TRAIN_RESUME_STEPS), "--resume", first,
                          "--save", second], dev, "train --resume")
    meta, losses, leaves = train_record(second)
    want = TRAIN_CLI_STEPS + TRAIN_RESUME_STEPS
    moments = max(float(np.abs(v).max()) for v in leaves[1:-1])
    counts = (int(leaves[0]), int(leaves[-1]))
    say(f"  --resume, {TRAIN_RESUME_STEPS} more: "
        f"{out.strip().splitlines()[0]}; total_training_iters "
        f"{meta['total_training_iters']}, opt_step {meta['opt_step']}, "
        f"AdamW and schedule counts {counts}, largest moment {moments:.3e}")
    if (meta["total_training_iters"], meta["opt_step"]) != (want, want) \
            or counts != (want, want) or not moments > 0 \
            or len(losses) != want:
        raise AssertionError("the resumed run does not continue the count")
    third = os.path.join(tmp, "flagship-80.npz")
    run_cli(base + ["--iters", str(TRAIN_RESUME_STEPS), "--eval-every",
                    "5", "--resume", second, "--save", third], dev,
            "train on the host sampler")
    meta, losses, _ = train_record(third)
    tail = losses[want:]
    say(f"  host sampler, {TRAIN_RESUME_STEPS} more: "
        f"total_training_iters {meta['total_training_iters']}, losses "
        f"{min(tail):.4f} to {max(tail):.4f}, eval records "
        f"{sorted(int(k) for k in meta['loss_record']['test'])}")
    if meta["total_training_iters"] != want + TRAIN_RESUME_STEPS or not all(
            math.isfinite(v) for v in tail) or len(tail) != \
            TRAIN_RESUME_STEPS:
        raise AssertionError("the host-sampler run went wrong")
    time_training(torch, third, corpus, smi, dev)
    return third


def phase_train_eval(torch, tmp, corpus_dir, ckpt, dev="cuda"):
    """Phase 52: the trained checkpoint through the hub, ``denoise`` on
    the card, ``eval --manifest`` on the card and with ``--device cpu``
    (per-example metrics within EVAL_DB; the chain's outputs within
    OFFLINE_ATOL in process), ``compare`` of the two per-example files
    (no significant difference) and the ``compare`` command."""
    from audio_denoising_torch.apps.compare import METRICS, paired_report
    from audio_denoising_torch.apps.evaluate import (
        _denoiser, build_manifest_set)
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.io import read_wav
    cfg, model = load_pretrained(ckpt)
    src = os.path.join(tmp, "eval-in.wav")
    from audio_denoising_torch.io.wavio import write_wav
    write_wav(src, noisy_voice(2 * 48000, 48000, 52)[0], 48000)
    out = os.path.join(tmp, "eval-out.wav")
    run_cli(["denoise", src, out, "--model", ckpt], dev, "denoise")
    den, sr = read_wav(out)
    say(f"  hub: {cfg.model.arch} hidden {cfg.model.hidden_sizes}, "
        f"{cfg.dsp.n_mels} mels; denoise: {den.shape} at {sr} Hz, peak "
        f"{float(np.abs(den).max()):.3f}")
    if den.shape != (1, 2 * 48000) or not np.isfinite(den).all():
        raise AssertionError("denoise of the trained checkpoint failed")
    manifest = {"version": 0, "data_dir": corpus_dir,
                "noise_dir": os.path.join(corpus_dir, "noise"),
                "crop_seconds": 1.0,
                "blocks": [{"seed": 1, "noise_gain": 0.5, "n": EVAL_BLOCK_N},
                           {"seed": 2, "target_snr_db": 5.0,
                            "n": EVAL_BLOCK_N}]}
    man = os.path.join(tmp, "manifest.json")
    with open(man, "w") as f:
        json.dump(manifest, f)
    mixture, *_ = build_manifest_set(manifest)
    card_fn, cpu_fn = _denoiser(cfg, model, torch.device(dev)), \
        _denoiser(cfg, model, torch.device("cpu"))
    out_err = max(float(np.abs(card_fn(m, 48000) - cpu_fn(m, 48000)).max())
                  for m in mixture)
    reports, files = {}, {}
    for side, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        files[side] = os.path.join(tmp, f"per-{side}.npz")
        argv = ["eval", "--model", ckpt, "--manifest", man, "--bootstrap",
                "500", "--save-per-example", files[side], *extra]
        text = run_cli(argv, dev if side == "card" else "cuda", "eval")
        reports[side] = json.loads(text[text.index("{"):])
    a, b = np.load(files["card"]), np.load(files["cpu"])
    metric_err = max(float(np.abs(a[k] - b[k]).max()) for k in METRICS)
    paired = paired_report(files["card"], files["cpu"], n_boot=2000)
    # significant at the report's resolution (ci95 in 0.001 dB): the
    # card and the CPU differ by round-off (1e-5 dB), which can share one
    # sign over every example and so lie wholly on one side of 0
    signif = [m for m, r in paired.items()
              if r["ci95"][0] > 0 or r["ci95"][1] < 0]
    deltas = {m: (float(np.mean(a[m] - b[m])), r["significant"])
              for m, r in paired.items()}
    text = run_cli(["compare", ckpt, ckpt, "--manifest", man, "--bootstrap",
                    "200"], dev, "compare")
    cmp_rep = json.loads(text[text.index("{"):])
    zero = all(v["mean_delta"] == 0.0
               for v in cmp_rep["delta_a_minus_b"].values())
    m = reports["card"]["metrics"]
    say(f"  eval --manifest ({2 * EVAL_BLOCK_N} mixtures of 1 s): "
        f"SI-SDR in {m['si_sdr_in']['mean']:.3f} dB, out "
        f"{m['si_sdr_out']['mean']:.3f} dB, improvement "
        f"{m['si_sdr_improvement']['mean']:.3f} dB "
        f"{m['si_sdr_improvement']['ci95']}; card vs CPU: outputs "
        f"{out_err:.3e} (bound {OFFLINE_ATOL:g}), per-example metrics "
        f"{metric_err:.3e} (bound {EVAL_DB:g}), paired differences "
        f"significant at 0.001 dB in {signif or 'none'} (mean delta and "
        f"the unrounded interval's verdict: "
        + ", ".join(f"{k} {d:.3e} {v}" for k, (d, v) in deltas.items())
        + "); compare A A on the card: "
        f"deltas {'all 0' if zero else 'nonzero'}")
    if out_err > OFFLINE_ATOL or metric_err > EVAL_DB or signif or not zero \
            or reports["card"]["manifest_hash"] != \
            reports["cpu"]["manifest_hash"]:
        raise AssertionError("eval on the card disagrees with the CPU")


# -- phases 53-57: the multi-device paths (ROADMAP A12, B7) ------------------

MESH_SLOTS = SLOTS   # slots of phases 54-55, split over the mesh's entries
MESH_HOPS = 8        # single hops of each phase-54 case
MESH_TICKS = {"fused": 30, "fast": 20, "fused-webrtc": 10, "unet": 17}
TP_FRAMES = 8        # the TP cell's rollout (phase 56)
TP_BATCH = 64
TP_RTOL = 2e-5       # y and hx', relative to the largest |y| (test_tp.py's
                     # 2e-5 on outputs of order 1)
DP_TIMEOUT_S = 600   # a data-parallel worker's whole run (phase 57)
DP_CASES = ("flagship", "unet2d4")


def mesh_sets(torch):
    """Phases 53-57's device sets: cuda:0 listed twice (the split, the
    per-shard launches and the combine on one card) and, where the
    machine has several cards, every card once."""
    from audio_denoising_torch.parallel import make_mesh
    meshes = [make_mesh(devices=["cuda:0", "cuda:0"])]
    if torch.cuda.device_count() > 1:
        meshes.append(make_mesh())
    return meshes


def mesh_label(mesh):
    return "[" + ", ".join(map(str, mesh.devices)) + "]"


def phase_device_guard(torch, cfg, plan, dari_cfg, dari_plan, good_plan):
    """Phase 53: each kernel wrapper built with an explicit cuda:0, a bare
    cuda (the current card) and, with several cards, each other card;
    each launches on its tensors' card and is held against its plain
    version there: the fused hop one hop at SLOTS streams, the WebRTC hop
    with no GL round (exact surfaces), the fused cell one step."""
    from audio_denoising_torch.ops.kernels.fused_cell import make_fused_cell
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    names = ["cuda:0", "cuda"] + [f"cuda:{i}" for i in
                                  range(1, torch.cuda.device_count())]
    w_cfg = warm_cfg(dari_cfg, 0)
    rng = np.random.default_rng(53)
    for name in names:
        hop = make_fused_hop(cfg, plan, name)
        dev = hop.device
        if dev.index is None:
            raise AssertionError(f"{name}: the hop kept an unindexed device")
        s = fused_hop_init_state(cfg, plan, SLOTS, dev)
        c = torch.from_numpy((0.1 * rng.standard_normal(
            (SLOTS, hop.hop))).astype(np.float32)).to(dev)
        (s_k, o_k), (s_p, o_p) = hop(s, c), hop.reference(s, c)
        e_hop = max_err(o_k, o_p)
        st = max(plane_errors(s_k, s_p).values())
        w_hop = make_webrtc_hop(w_cfg, dari_plan, name)
        ws = webrtc_hop_init_state(w_cfg, dari_plan, SLOTS, w_hop.device)
        wc = webrtc_chunks(torch, SLOTS, 1, 53, w_hop.hop)[0].to(dev)
        (ws_k, wo_k), (ws_p, wo_p) = w_hop(ws, wc), w_hop.reference(ws, wc)
        e_w = max(max_err(wo_k, wo_p), max_err(ws_k.ola, ws_p.ola))
        cell = make_fused_cell(good_plan, name)
        x, hx, _ = cell_inputs(torch, SLOTS, cell.n_feat, cell.n, 53)
        x, hx = x.to(dev), hx.to(dev)
        e_c = max(max_err(a, b) for a, b in zip(cell(x, hx),
                                                cell.reference(x, hx)))
        torch.cuda.synchronize(dev)
        say(f"  {name} -> {dev} (current card {torch.cuda.current_device()}"
            f"): fused hop out {e_hop:.3e}, planes {st:.3e}; WebRTC hop "
            f"GL-0 out/ola {e_w:.3e}; fused cell {e_c:.3e} (bounds "
            f"{OUT_ATOL:g}, {STATE_ATOL:g}, {CELL_ATOL:g})")
        if e_hop > OUT_ATOL or st > STATE_ATOL or e_w > OUT_ATOL \
                or e_c > CELL_ATOL:
            raise AssertionError(f"a kernel built for {name} disagrees with "
                                 f"its plain version")


def sharded_cases(cfg, plan, flag_cfg, flag_plan, momo_cfg, momo_plan):
    """Phase 54's cases: (label, cfg, plan, hops per call, compute)."""
    import torch
    return [(S16K, cfg, plan, 1, torch.float32),
            (f"{S16K}, K={K_HOPS}", cfg, plan, K_HOPS, torch.float32),
            (f"{S16K}, bf16", cfg, plan, 1, torch.bfloat16),
            (f"{S16K}, int8", cfg, plan, 1, torch.int8),
            (f"{FLAGSHIP}, int8, tuned gate", tuned_gate(flag_cfg),
             flag_plan, 1, torch.int8),
            (f"{MOMO_SPEC} (raw, delta)", momo_cfg, momo_plan, 1,
             torch.float32)]


def phase_sharded_hop(torch, cases, smi):
    """Phase 54: make_fused_hop_sharded at MESH_SLOTS slots over each mesh
    against make_fused_hop at MESH_SLOTS on cuda:0 from the same inputs,
    each carrying its own state: every output and plane bit-equal
    expected (the kernel's tile is 2 streams, so a stream's arithmetic
    does not depend on the batch); then the sharded hop one call from
    the plain version's state against the plain version (fp32 within
    OUT_ATOL, bf16 and int8 by SNR at FORCED_DB); the calls timed.
    Returns {label: (largest sharded-unsharded difference, sharded ms,
    unsharded ms)}."""
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop, make_fused_hop_sharded)
    from audio_denoising_torch.parallel.mesh import gather
    out = {}
    for mesh in mesh_sets(torch):
        for label, cfg, plan, K, dt in cases:
            single = make_fused_hop(cfg, plan, "cuda:0", hops_per_call=K,
                                    compute_dtype=dt)
            sharded = make_fused_hop_sharded(cfg, plan, mesh,
                                             hops_per_call=K,
                                             compute_dtype=dt)
            hop_len = cfg.dsp.hop_length
            calls = 2 if K > 1 else MESH_HOPS
            rng = np.random.default_rng(54)
            shape = (calls, K, MESH_SLOTS, hop_len) if K > 1 else \
                (calls, MESH_SLOTS, hop_len)
            chunks = torch.from_numpy((0.1 * rng.standard_normal(shape))
                                      .astype(np.float32)).to("cuda:0")
            s1 = fused_hop_init_state(cfg, plan, MESH_SLOTS, "cuda:0")
            states = sharded.split_state(s1)
            diff = 0.0
            for c in chunks:
                s1, o1 = single(s1, c)
                states, outs = sharded(states, sharded.split_chunks(c))
                diff = max(diff, max_err(sharded.gather(outs), o1))
            whole = gather(states, torch.device("cuda:0"))
            diff = max([diff] + [max_err(a, planes(s1)[k])
                                 for k, a in planes(whole).items()])
            # one call from the plain version's state
            c = chunks[0]
            s_p, want = single.plain(s1, c)
            _, got = sharded(sharded.split_state(s1),
                             sharded.split_chunks(c))
            got = sharded.gather(got)
            dtype = dtype_name(dt)
            if dtype == "float32":
                plain = f"out {max_err(got, want):.3e} (bound {OUT_ATOL:g})"
                ok = max_err(got, want) <= OUT_ATOL
            else:
                db = tensor_db(want, got)
                plain = f"{db:.1f} dB (limit {FORCED_DB[dtype]:g})"
                ok = db >= FORCED_DB[dtype]
            split = sharded.split_state(s1)
            chunk_shards = sharded.split_chunks(c)
            ms_sh = time_launches(torch, lambda: sharded(split, chunk_shards),
                                  20)
            ms_1 = time_launches(torch, lambda: single(s1, c), 20)
            say(f"  {mesh_label(mesh)}, {label}: sharded against unsharded "
                f"{diff:.3e} over {calls} calls (0 expected); against the "
                f"plain version from one state {plain}; a call "
                f"{ms_sh * 1e3:.1f} us sharded, {ms_1 * 1e3:.1f} us "
                f"unsharded ({smi})")
            if not ok:
                raise AssertionError(f"sharded hop ({label}) disagrees with "
                                     f"the plain version")
            out[(mesh_label(mesh), label)] = (diff, ms_sh, ms_1)
    return out


def mesh_schedule(sids, hop, ticks, seed):
    """Ticks of {sid: chunk}: every slot live but some skip (7 i + t) % 5
    == 0; a third of the streams leave at tick 3 and come back as new
    streams at tick 5; a NaN in one chunk at tick 2."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        chunks = {s: (0.1 * rng.standard_normal(hop)).astype(np.float32)
                  for i, s in enumerate(sids) if (7 * i + t) % 5}
        if t == 2 and sids[1] in chunks:
            chunks[sids[1]][5] = np.nan
        out.append(chunks)
    return out


def run_mesh_engines(engines, sids, ticks, hop, seed):
    """Both engines through mesh_schedule; every third stream leaves at
    tick 3 and a new stream takes its slot at tick 5 (renamed in later
    ticks). -> per engine, a list of {sid: out} per tick."""
    for e in engines:
        for s in sids:
            e.add_stream(s)
    leaving = sids[::3]
    outs = [[] for _ in engines]
    live = list(sids)
    for t, chunks in enumerate(mesh_schedule(sids, hop, ticks, seed)):
        if t == 3:
            for e in engines:
                for s in leaving:
                    e.remove_stream(s)
            live = [s for s in live if s not in leaving]
        if t == 5:
            for e in engines:
                for s in leaving:
                    e.add_stream(s + "'")
            live += [s + "'" for s in leaving]
        chunks = {(s + "'" if s in leaving and t >= 5 else s): c
                  for s, c in chunks.items()
                  if s not in leaving or t < 3 or t >= 5}
        for o, e in zip(outs, engines):
            o.append(e.process(chunks))
    return outs


def phase_mesh_engines(torch, specs):
    """Phase 55: StreamEngine(mesh) in modes fused, fused-webrtc, fast and
    unet at MESH_SLOTS slots over [cuda:0, cuda:0] (and every card where
    there are several) against the unsharded engine on the card, hop by
    hop, with streams leaving and joining, a NaN chunk and skipped ticks;
    in modes fused and fast also against the CPU engine. The kernel modes
    expect bit equality with the unsharded engine; modes fast and unet
    (cuBLAS and cuDNN, whose algorithms may change with the batch) are
    held within OUT_ATOL and SEG_OUT_ATOL. Returns {mode: the mesh
    engines' kernel launches}."""
    from audio_denoising_torch.runtime.engine import StreamEngine
    launches = {}
    for mode, (cfg, model) in specs.items():
        for mesh in mesh_sets(torch):
            ticks = MESH_TICKS[mode]
            eng = StreamEngine(cfg, model, mode=mode, max_streams=MESH_SLOTS,
                               mesh=mesh)
            ref = StreamEngine(cfg, model, mode=mode, max_streams=MESH_SLOTS,
                               device="cuda:0")
            engines = [eng, ref]
            if mode in ("fused", "fast"):
                engines.append(StreamEngine(cfg, model, mode=mode,
                                            max_streams=MESH_SLOTS,
                                            device="cpu"))
            if any(e.mode != mode for e in engines):
                raise AssertionError(f"mode {mode} not served as itself")
            # one kernel wrapper per mesh entry (a card listed twice gets
            # two), each counted once; the unsharded engine's count is
            # what every entry must show: one step per tick on each
            kernels = mode in ("fused", "fused-webrtc")
            if kernels:
                eng.hop_step.launches = 0
                ref.hop_step.launches = 0
            sids = [f"s{i}" for i in range(MESH_SLOTS)]
            runs = run_mesh_engines(engines, sids, ticks, cfg.dsp.hop_length,
                                    55)
            n = per_entry = None
            if kernels:
                per_entry = [k.launches for k in eng.hop_step.steps]
                n = sum(per_entry)
                launches[mode] = launches.get(mode, 0) + n
            diff = max(float(np.abs(ta[s] - tb[s]).max())
                       for ta, tb in zip(runs[0], runs[1]) for s in ta)
            cpu = None
            if len(runs) == 3:
                cpu = max(float(np.abs(ta[s] - tc[s]).max())
                          for ta, tc in zip(runs[0], runs[2]) for s in ta)
            snap_m, snap_r = eng.snapshot(), ref.snapshot()
            sdiff = max(float(np.abs(v - snap_r["state"][k]).max())
                        for k, v in snap_m["state"].items())
            bound = {"fast": OUT_ATOL, "unet": SEG_OUT_ATOL}.get(mode, 0.0)
            s_bound = {"fast": STATE_ATOL, "unet": SEG_OUT_ATOL}.get(mode,
                                                                    0.0)
            say(f"  mode {mode}, {mesh_label(mesh)}, {MESH_SLOTS} slots x "
                f"{ticks} ticks: against the unsharded engine out {diff:.3e}"
                f" (bound {bound:g}), snapshot {sdiff:.3e} (bound "
                f"{s_bound:g})"
                + ("" if cpu is None else
                   f"; against the CPU out {cpu:.3e} (bound {OUT_ATOL:g})")
                + ("; no hand-written kernel on this path" if n is None
                   else f"; {n} launches, per entry {per_entry} (the "
                   f"unsharded engine {ref.hop_step.launches})"))
            if diff > bound or sdiff > s_bound or (cpu or 0.0) > OUT_ATOL:
                raise AssertionError(f"mode {mode} on {mesh_label(mesh)} "
                                     f"disagrees")
            if kernels and (ref.hop_step.launches < ticks or any(
                    k != ref.hop_step.launches for k in per_entry)):
                raise AssertionError(
                    f"mode {mode}: launches per entry {per_entry} for "
                    f"{ticks} ticks, the unsharded engine "
                    f"{ref.hop_step.launches}")
            if snap_m["slots"] != snap_r["slots"]:
                raise AssertionError("the mesh engine's slot table differs")
    return launches


def phase_mesh_daemon(torch):
    """Phase 55's daemons: ``engine --multichip`` (with one card it serves
    unsharded and says so), then EngineDaemon mode fused over [cuda:0,
    cuda:0] (every card where there are several) answering 4 clients x
    SLOTS / 16 streams in as many slots, every reply against its stream
    through the plain version on the CPU. Returns the kernel's
    launches."""
    from audio_denoising_torch.apps.engine_serve import (
        EngineDaemon, daemon_from_args, parser)
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    args = parser().parse_args(["--model", S16K, "--mode", "fused",
                                "--host", "127.0.0.1", "--port", "0",
                                "--multichip"])
    d = daemon_from_args(args)
    say(f"  engine --multichip: {d.placement}")
    if (d.engine.mesh is None) != (torch.cuda.device_count() == 1):
        raise AssertionError("--multichip did not shard over the cards")
    total, clients, streams = 0, 4, SLOTS // 16
    for mesh in mesh_sets(torch):
        # as many slots as streams, so that every shard serves some
        daemon = EngineDaemon(S16K, max_streams=clients * streams,
                              address=("127.0.0.1", 0), mode="fused",
                              mesh=mesh)
        data = daemon_data(daemon.cfg, clients, streams, 20, 55)
        got, slots, rounds, n, wall = serve_clients(daemon, data,
                                                    daemon.engine.hop_step)
        ref = make_fused_hop(daemon.cfg, daemon.engine.plan, "cpu")
        want = replay(ref, fused_hop_init_state(
            daemon.cfg, daemon.engine.plan, data.shape[0] * data.shape[1]),
            data)
        err = float(np.abs(got - want).max())
        say(f"  {daemon.placement}: out {err:.3e} (bound {OUT_ATOL:g}); "
            + latency_line(data, rounds, n, wall))
        shards = {slot // daemon.engine._per for slot in slots}
        per_entry = [k.launches for k in daemon.engine.hop_step.steps]
        if err > OUT_ATOL or min(per_entry) <= 0 or \
                len(shards) != mesh.size:
            raise AssertionError(f"the sharded daemon disagrees ({err:.3e}),"
                                 f" launched {per_entry} times per entry, "
                                 f"or served shards {sorted(shards)} of "
                                 f"{mesh.size}")
        total += n
    return total


def phase_tp(torch, plans, smi):
    """Phase 56: make_tp_plan_cell over [cuda:0, cuda:0] (D = 2) and over
    every card where there are several, against plan_cell on cuda:0 over a
    TP_FRAMES-frame rollout at TP_BATCH streams, each carrying its own
    hx; its schedule printed."""
    from audio_denoising_torch.parallel import make_tp_plan_cell
    from audio_denoising_torch.runtime.plan import plan_cell
    for name, plan in plans:
        p0 = plan.to(device="cuda:0")
        F = plan.up_h_mats[-1].shape[1]
        n = plan.hidden * plan.compressed
        for mesh in mesh_sets(torch):
            step = make_tp_plan_cell(plan, mesh)
            g = torch.Generator(device="cuda:0").manual_seed(56)
            hx_r = hx_t = 0.1 * torch.randn((TP_BATCH, n), generator=g,
                                            device="cuda:0")
            err = 0.0
            t0 = time.perf_counter()
            for _ in range(TP_FRAMES):
                x = torch.log1p(4 * torch.rand((TP_BATCH, F), generator=g,
                                               device="cuda:0"))
                y_r, hx_r = plan_cell(p0, x, hx_r)
                y_t, hx_t = step(x, hx_t)
                scale = max(1.0, float(y_r.abs().max()))
                err = max(err, max_err(y_t, y_r) / scale,
                          max_err(hx_t, hx_r) / scale)
            torch.cuda.synchronize()
            say(f"  {name}, D={mesh.size} {mesh_label(mesh)}: modes "
                f"{json.dumps(step.modes)}; y and hx' against plan_cell "
                f"{err:.3e} of the largest |y| (bound {TP_RTOL:g}) over "
                f"{TP_FRAMES} frames at B={TP_BATCH}, "
                f"{(time.perf_counter() - t0) * 1e3 / TP_FRAMES:.1f} ms a "
                f"frame ({smi})")
            if err > TP_RTOL:
                raise AssertionError(f"TP cell ({name}) disagrees")


def dp_worker(argv):
    """One rank of phase 57 (``chip_smoke.py --dp-worker BACKEND DIR
    CASES``, the rendezvous in the environment): each case's state and
    batch from DIR, one make_sharded_train_step step; rank 0 writes the
    loss, the model's output before the step, the averaged gradients and
    the parameters after it."""
    import torch
    import torch.distributed as dist
    from audio_denoising_torch.parallel import distributed
    from audio_denoising_torch.train import context
    backend, tmp, cases = argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(device="cuda:0" if backend == "gloo" else None,
                           backend=backend)
    rank, dev = dist.get_rank(), distributed.local_device()
    try:
        for name in cases.split(","):
            case = next(c for c in TRAIN_CASES if c[0] == name)
            cfg, model, _ = train_case(*case)
            ctx = context.TrainingContext.load(
                os.path.join(tmp, f"state-{name}.npz"), cfg, model,
                device=dev)
            batch = np.load(os.path.join(tmp, f"batch-{name}.npz"))
            mix, clean = (torch.from_numpy(batch[k]).to(dev)
                          for k in ("mix", "clean"))
            with torch.no_grad(), context.fp32_scope():
                out, _ = ctx._forward(ctx.state.params, ctx.features(mix))
            step = context.make_sharded_train_step(ctx,
                                                   distributed.global_mesh())
            loss = step(mix, clean)
            if rank == 0:
                p = ctx.state.params
                np.savez(os.path.join(tmp, f"dp-{backend}-{name}.npz"),
                         loss=float(loss), out=out.cpu().numpy(),
                         **{f"g:{k}": v.grad.cpu().numpy()
                            for k, v in p.items()},
                         **{f"p:{k}": v.detach().cpu().numpy()
                            for k, v in p.items()})
    finally:
        distributed.shutdown()
    return 0


def run_dp_workers(backend, world, tmp, cases, local_ranks):
    """Start ``world`` phase-57 workers (this script with --dp-worker),
    wait for them (DP_TIMEOUT_S), kill any left; raises if one fails."""
    store = "file://" + os.path.join(tmp, f"store-{backend}-{world}")
    procs = []
    for rank in range(world):
        env = dict(os.environ, ADT_COORDINATOR=store, RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(local_ranks[rank]))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-worker",
             backend, tmp, ",".join(cases)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{backend} rank {rank} of {world} exited "
                                 f"{p.returncode}:\n{out[-3000:]}")


def dp_readings(torch, tmp, backend, name, single):
    """phase 50's four readings of the data-parallel step (``backend``)
    against the single-card step ``single``."""
    got = np.load(os.path.join(tmp, f"dp-{backend}-{name}.npz"))
    t = lambda a: torch.from_numpy(np.asarray(a))
    dp = (t(got["loss"]), t(got["out"]),
          {k[2:]: t(got[k]) for k in got.files if k.startswith("g:")},
          {k[2:]: t(got[k]) for k in got.files if k.startswith("p:")})
    return train_readings(single, dp)[0]


def phase_data_parallel(torch, tmp, corpus, corpus_dir):
    """Phase 57: make_sharded_train_step against the single-card step
    (phase 50's readings under TRAIN_LIMITS): NCCL at world 1 through
    initialize() on the flagship recipe; two gloo ranks sharing cuda:0
    on the flagship recipe and UNet2d4 (NCCL refuses two ranks on one
    card); with several cards, NCCL over all of them and then ``train
    --data-parallel`` for a few steps."""
    from audio_denoising_torch.train.context import TrainingContext
    singles, objectives = {}, {}
    for i, name in enumerate(DP_CASES):
        case = next(c for c in TRAIN_CASES if c[0] == name)
        cfg, model, path = train_case(*case)
        mix, clean = train_batch(torch, cfg, corpus, 570 + i)
        np.savez(os.path.join(tmp, f"batch-{name}.npz"), mix=mix.numpy(),
                 clean=clean.numpy())
        ctx = TrainingContext.load(path, cfg, model, device="cuda")
        if ctx.state.step == 0:
            ctx.train_step(*train_batch(torch, cfg, corpus, 580 + i))
        state = os.path.join(tmp, f"state-{name}.npz")
        ctx.save(state)
        singles[name], _ = train_step_on(torch, state, cfg, model, "cuda",
                                         (mix, clean))
        objectives[name] = cfg.train.objective
    runs = [("nccl", 1, DP_CASES[:1], [0]),
            ("gloo", 2, DP_CASES, [0, 0])]
    count = torch.cuda.device_count()
    if count > 1:
        runs.append(("nccl", count, DP_CASES, list(range(count))))
    for backend, world, cases, local in runs:
        t0 = time.perf_counter()
        run_dp_workers(backend, world, tmp, cases, local)
        for name in cases:
            got = dp_readings(torch, tmp, backend, name, singles[name])
            limits = TRAIN_LIMITS[objectives[name]]
            say(f"  {backend}, world {world} (cards {sorted(set(local))}), "
                f"{name}: against the single-card step "
                + ", ".join(f"{n} {v:.3e}" for n, v in
                            zip(TRAIN_READINGS, got))
                + " (limits " + ", ".join(f"{v:g}" for v in limits)
                + f"); the workers {time.perf_counter() - t0:.1f} s")
            if any(r > lim for r, lim in zip(got, limits)):
                raise AssertionError(f"{backend} data-parallel step ({name}) "
                                     f"disagrees with the single-card step")
    if count > 1:
        out = run_cli(["train", "--data", corpus_dir, "--data-parallel",
                       "--iters", "3", "--eval-every", "0", "--log-every",
                       "1", "--batch-size", str(2 * count),
                       "--crop-samples", "48000", "--save",
                       os.path.join(tmp, "dp.npz")], "cuda",
                      "train --data-parallel")
        say(f"  train --data-parallel over {count} cards: "
            + " | ".join(out.strip().splitlines()[-4:]))
    else:
        say("  one card: NCCL over several cards and train --data-parallel "
            "across cards not run")


# -- phases 58-60: ONNX, loopback, the WebRTC hop's wider geometries -------

ONNX_SPECS = (MOMO_SPEC, "gruunet2-good")   # the cells phase 58 exports
ONNX_TICKS = 50      # ticks of each engine of phase 58
LOOPBACK_FRAMES = 20  # callbacks of phase 59's stand-in sound card
GEO_SPEC = S16K      # n_fft 640 (M = 320 = 8 x 8 x 5), 64 mels
# random-weight geometries past the caps the kernels had before radix 5
# (3 n_mels at most min(n_fft, 384)): 3 x 160 mels above 384 at n_fft
# 1024, 3 x 64 mels above n_fft 160 (whose M = 80 = 8 x 2 x 5)
GEO_CASES = ((1024, 160), (160, 64))
GEO_FFT_SIZES = (320, 512, 80)   # their n_fft / 2
GEO_BATCH = 64        # streams of the random-weight geometries' checks


def batched_graph(g, batch):
    """A cell graph exported at batch 1, for ``batch`` streams: the
    batch-1 initializers that a Concat joins to the streams' tensors (the
    smearing fields) tiled to the batch, since ONNX's Concat broadcasts
    nothing."""
    joined = {i for n in g.nodes if n.op_type == "Concat" for i in n.inputs}
    return g._replace(initializers={
        k: np.repeat(v, batch, axis=0) if k in joined and v.shape[0] == 1
        else v for k, v in g.initializers.items()})


def onnx_cell(model, feeds):
    """A model's own cell step on a cell graph's inputs (tensors)."""
    carry = (feeds["h0"], feeds["prev"]) if "prev" in feeds else feeds["h0"]
    y, carry = model.cell(feeds["input"], carry)
    return {"output": y,
            "hx": carry[0] if isinstance(carry, tuple) else carry}


def phase_onnx_graphs(torch, tmp):
    """Phase 58's graphs: each of ONNX_SPECS written by the port's
    exporter; ``run_graph`` on the card at SLOTS streams (the batch-1
    graph's smearing fields tiled by ``batched_graph``) against the
    model's own cell step
    on the card and against ``run_graph`` on the CPU, each within
    CELL_ATOL. Returns {spec: path}."""
    from audio_denoising_torch.compat import (
        export_cell, parse_onnx, run_graph)
    from audio_denoising_torch.hub import load_pretrained
    paths = {}
    for spec in ONNX_SPECS:
        model = load_pretrained(spec)[1]
        paths[spec] = export_cell(model, os.path.join(tmp, f"{spec}.onnx"))
        g = batched_graph(parse_onnx(paths[spec]), SLOTS)
        rng = np.random.default_rng(58)
        feeds = {n: (0.5 * rng.standard_normal((SLOTS,) + tuple(s[1:])))
                 .astype(np.float32) for n, s in g.inputs}
        card = run_graph(g, feeds, "cuda")
        cpu = run_graph(g, feeds, "cpu")
        with torch.no_grad():
            own = onnx_cell(model.cuda(), {k: torch.from_numpy(v).cuda()
                                           for k, v in feeds.items()})
        torch.cuda.synchronize()
        e_own = max(max_err(card[k], own[k]) for k in g.outputs)
        e_cpu = max(max_err(card[k].cpu(), cpu[k]) for k in g.outputs)
        say(f"  {spec}: {len(g.nodes)} nodes, "
            f"{os.path.getsize(paths[spec])} B, inputs "
            f"{', '.join(n for n, _ in g.inputs)}; run_graph on the card at "
            f"{SLOTS} streams vs the model's cell step on the card "
            f"{e_own:.3e}, vs run_graph on the CPU {e_cpu:.3e} (bound "
            f"{CELL_ATOL:g})")
        if not all(card[k].is_cuda for k in g.outputs) or max(
                e_own, e_cpu) > CELL_ATOL:
            raise AssertionError(f"run_graph on the card disagrees ({spec})")
    return paths


def phase_onnx_engines(torch, path):
    """Phase 58's serving: the MOMO3 graph through the hub (its assumed
    raw front-end is the preset's own), served by StreamEngine mode fused
    and mode fast on PlanModel(fused=True), SLOTS slots for ONNX_TICKS
    ticks with skipped slots, against the same engine on
    checkpoints/momo3-4d4ea0.npz under the same config (bit for bit: the
    same weights, the same kernel) and against the CPU engine (hold_free,
    phase 4's bounds); then the K-hop kernel on the graph's plan
    (check_multi) and bit for bit against the .npz plan's. Returns
    (fused hop launches, K-hop launches, fused cell launches, largest
    error against the plain version)."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    from audio_denoising_torch.runtime.engine import StreamEngine
    from audio_denoising_torch.runtime.plan import PlanModel, build_cell_plan
    cfg, model = load_pretrained(path)
    pcfg = load_pretrained(MOMO_SPEC)[0]
    npz = load_pretrained(os.path.join(REPO, "checkpoints",
                                       f"{MOMO_SPEC}.npz"), cfg=cfg)[1]
    if (type(model).__name__, cfg.model, cfg.dsp) != (
            "MOMO3", pcfg.model, pcfg.dsp):
        raise AssertionError(f"the hub read {path} as {cfg.model}, "
                             f"{cfg.dsp}")
    launches, worst = {}, 0.0
    for mode in ("fused", "fast"):
        served = [PlanModel(m, fused=True) if mode == "fast" else m
                  for m in (model, npz)]
        onnx, ref = (StreamEngine(cfg, m, mode=mode, max_streams=SLOTS)
                     for m in served)
        cpu = StreamEngine(cfg, PlanModel(model, fused=True, device="cpu")
                           if mode == "fast" else model, mode=mode,
                           max_streams=SLOTS, device="cpu")
        if {onnx.mode, ref.mode, cpu.mode} != {mode}:
            raise AssertionError(f"mode {mode} served as {onnx.mode}")
        counter = onnx.hop_step if mode == "fused" else served[0].fused_cell
        sids = [f"s{i}" for i in range(SLOTS)]
        for e in (onnx, ref, cpu):
            for sid in sids:
                e.add_stream(sid)
        rng = np.random.default_rng(580 + len(mode))
        got = np.zeros((ONNX_TICKS, SLOTS, cfg.dsp.hop_length))
        want = np.zeros_like(got)
        counter.launches = 0
        for t in range(ONNX_TICKS):
            chunks = {sid: (0.1 * rng.standard_normal(cfg.dsp.hop_length)
                            ).astype(np.float32)
                      for i, sid in enumerate(sids) if (7 * i + t) % 5}
            a, b, c = (e.process(chunks) for e in (onnx, ref, cpu))
            for i, sid in enumerate(sids):
                if sid in chunks:
                    if not np.array_equal(a[sid], b[sid]):
                        raise AssertionError(
                            f"mode {mode}: the ONNX-loaded engine differs "
                            f"from the .npz engine at tick {t}")
                    got[t, i], want[t, i] = a[sid], c[sid]
        torch.cuda.synchronize()
        launches[mode] = counter.launches
        same = all(torch.equal(x, y) for x, y in zip(
            planes(onnx.state).values(), planes(ref.state).values()))
        text, e, _ = hold_free(f"ONNX engine mode {mode}", "float32", cfg,
                               want, got, cpu.state, onnx.state)
        worst = max(worst, e)
        on = " on PlanModel(fused=True)" if mode == "fast" else ""
        say(f"  mode {mode}{on}, {SLOTS} streams x {ONNX_TICKS} ticks: the "
            f"ONNX-loaded "
            f"engine bit for bit the .npz engine's (outputs and "
            f"{', '.join(planes(onnx.state))}: {same}); vs the CPU {text}; "
            f"{launches[mode]} launches")
        if not same or launches[mode] != ONNX_TICKS:
            raise AssertionError(f"mode {mode}: the ONNX engine's state "
                                 f"differs or {launches[mode]} launches")
    plan, plan_n = build_cell_plan(model), build_cell_plan(npz)
    chunks = momo_chunks(torch, cfg, K_HOPS, 58)
    k_launches, k_err, _ = check_multi(torch, cfg, plan, "MOMO3 from ONNX",
                                       chunks)
    s0 = fused_hop_init_state(cfg, plan, SLOTS, "cuda")
    s_o, o_o = make_fused_hop(cfg, plan, "cuda", hops_per_call=K_HOPS)(
        s0, chunks)
    s_n, o_n = make_fused_hop(cfg, plan_n, "cuda", hops_per_call=K_HOPS)(
        s0, chunks)
    exact = {k: max_err(v, planes(s_n)[k]) for k, v in planes(s_o).items()}
    exact["out"] = max_err(o_o, o_n)
    say(f"  K-hop K={K_HOPS} on the graph's plan vs the .npz plan's: "
        f"{fmt(exact)} (0 expected)")
    if max(exact.values()) != 0:
        raise AssertionError("the K-hop kernel differs between the ONNX "
                             "and .npz plans")
    return launches["fused"], k_launches, launches["fast"], max(worst,
                                                                k_err)


class StandInSoundcard(types.ModuleType):
    """A stand-in ``sounddevice`` module for ``apps.loopback.main``
    (tests/test_torch_loopback.py's pattern): the duplex stream records
    its callback; ``sleep`` fires it once per 10 ms asked for with a
    seeded tone-plus-noise mic block and keeps what was fed and
    written."""

    def __init__(self, seed):
        super().__init__("sounddevice")
        self.fed, self.written, self.stream_kw, self._cb = [], [], None, None
        self._rng, self._t = np.random.default_rng(seed), 0
        outer = self

        class Stream:
            def __init__(self, samplerate, blocksize, channels, dtype,
                         callback, device=None):
                outer.stream_kw = dict(samplerate=samplerate,
                                       blocksize=blocksize)
                outer._cb = callback

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                outer._cb = None
                return False

        self.Stream = Stream

    def sleep(self, ms):
        for _ in range(max(1, int(ms) // 10)):
            bs, sr = self.stream_kw["blocksize"], self.stream_kw["samplerate"]
            tone = 0.3 * np.sin(2 * np.pi * 440.0 * (self._t + np.arange(bs))
                                / sr)
            self._t += bs
            mic = (tone + 0.05 * self._rng.standard_normal(bs)).astype(
                np.float32)[:, None]
            out = np.zeros_like(mic)
            self._cb(mic, out, bs, None, None)
            self.fed.append(mic[:, 0].copy())
            self.written.append(out[:, 0].copy())


def run_loopback(argv, seed):
    """``apps.loopback.main(argv)`` on a StandInSoundcard: (the card,
    what it printed)."""
    from audio_denoising_torch.apps import loopback
    card = StandInSoundcard(seed)
    sys.modules["sounddevice"] = card
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            rc = loopback.main(argv)
    finally:
        del sys.modules["sounddevice"]
    if rc != 0:
        raise AssertionError(f"loopback {argv} returned {rc}")
    return card, printed.getvalue()


def phase_loopback(torch):
    """Phase 59: ``apps.loopback.main`` with its defaults (gruunet2-good,
    the fast step on the card) for LOOPBACK_FRAMES callbacks of a
    stand-in sound card, against the same frames with ``--torch-device
    cpu`` (each written block within OUT_ATOL); ``--no-denoise``, the
    reference's raw loopback at 48 kHz and 768-sample blocks, exactly
    twice the mic clipped."""
    argv = ["--seconds", f"{LOOPBACK_FRAMES / 100}", "--gain", "1.0"]
    card, said = run_loopback(argv, 59)
    cpu, said_cpu = run_loopback(argv + ["--torch-device", "cpu"], 59)
    if "cuda" not in said or "cpu" not in said_cpu:
        raise AssertionError(f"loopback ran on {said!r} / {said_cpu!r}")
    e = max(float(np.abs(a - b).max()) for a, b in zip(card.written,
                                                       cpu.written))
    moved = not np.allclose(card.written[-1], card.fed[-1], atol=1e-4)
    raw, _ = run_loopback(["--no-denoise", "--seconds", "0.05"], 591)
    exact = all(np.array_equal(o, np.clip(2.0 * m, -1.0, 1.0))
                for o, m in zip(raw.written, raw.fed))
    say(f"  {said.strip()}: {len(card.written)} blocks of "
        f"{card.stream_kw['blocksize']} at {card.stream_kw['samplerate']} "
        f"Hz, card vs CPU {e:.3e} (bound {OUT_ATOL:g}), the denoiser in "
        f"the path: {moved}; --no-denoise ({raw.stream_kw['samplerate']} Hz, "
        f"{raw.stream_kw['blocksize']}-sample blocks, {len(raw.written)} "
        f"blocks) exactly 2x the mic clipped: {exact}")
    if (len(card.written) != LOOPBACK_FRAMES or e > OUT_ATOL or not moved
            or not exact or raw.stream_kw != {"samplerate": 48000,
                                              "blocksize": 768}):
        raise AssertionError("loopback on the card disagrees")


def geometry_models(torch, n_iter):
    """Phase 60's geometries: gruunet2-stream16k on gruunet2-good's
    weights with warm GL, then GEO_CASES on random weights: [(label,
    cfg, model, plan)]."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.runtime.plan import build_cell_plan
    cfg, model = load_pretrained(GEO_SPEC)
    out = [(f"{GEO_SPEC}, gruunet2-good's weights", warm_cfg(cfg, n_iter),
            model, build_cell_plan(model))]
    for n_fft, n_mels in GEO_CASES:
        c, m = small_webrtc_model(torch, n_iter, n_fft, n_mels)
        out.append((f"random weights, n_fft {n_fft}, {n_mels} mels", c, m,
                    build_cell_plan(m)))
    return out


def phase_webrtc_geometries(torch, smi):
    """Phase 60: the WebRTC hop at the geometries the kernels took only
    after radix 5 and the mel caps went. At n_fft 640 (gruunet2-stream16k
    on gruunet2-good's weights, warm GL-32): the kernels' FFT radices;
    the single hop at SLOTS and 3 streams, each hop from the plain
    version's state against the plain version and a float64 witness
    (check_webrtc_forced); the K-hop kernel K = 25 against single hops
    (0; its calls the main path's launches) and, each call from a shared
    state, against its plain version and the witness; the bf16 GL mode
    the same ways (the witness rule, and BF16_GEO_GL32_DB, which the
    control must miss); StreamEngine mode fused-webrtc at SLOTS slots
    against the CPU engine, in fp32 and
    at bfloat16; both entry points timed in both modes. Then the same
    checks at GEO_BATCH streams on the random-weight geometries, and with
    no GL round every surface exact. Returns {(entry, dtype):
    (main-path launches, worst ola error against the plain version, the
    timing)}, entry "hop" or "K-hop", dtype "float32" or "bfloat16"."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        make_webrtc_hop, webrtc_hop_init_state)
    cases = geometry_models(torch, 32)
    modes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    launches = {(e, d): 0 for e in ("hop", "K-hop") for d in modes}
    errs = dict.fromkeys(launches, 0.0)
    for i, (label, cfg, model, plan) in enumerate(cases):
        hop = make_webrtc_hop(cfg, plan, "cuda")
        passes = " x ".join(map(str, hop.kernel_radices(hop.hop)))
        say(f"  {label}: n_fft {cfg.dsp.n_fft}, {cfg.dsp.n_mels} mels "
            f"({3 * cfg.dsp.n_mels} mel outputs a window), "
            f"{fft_label(hop)}, passes {passes}; {hop.smem_bytes} B of "
            f"shared memory a block")
        batches = (SLOTS, 3) if i == 0 else (GEO_BATCH,)
        if i == 0:
            check_fft_plans(hop, GEO_FFT_SIZES)
        else:
            check_webrtc_exact(torch, cfg, plan, GEO_BATCH, relative=True)
        for b in batches:
            errs["hop", "float32"] = max(errs["hop", "float32"],
                                         check_webrtc_forced(
                                             torch, cfg, plan, b,
                                             WEBRTC_HOPS, SNR_GL32_DB))
            errs["K-hop", "float32"] = max(errs["K-hop", "float32"],
                                           check_webrtc_multi_forced(
                                               torch, cfg, plan, b, 4,
                                               SNR_GL32_DB))
            errs["hop", "bfloat16"] = max(errs["hop", "bfloat16"],
                                          check_webrtc_bf16(
                                              torch, cfg, plan, b,
                                              WEBRTC_HOPS, BF16_GEO_GL32_DB[
                                                  cfg.dsp.n_fft,
                                                  cfg.dsp.n_mels])[1])
        for d, dt in modes.items():
            n = check_webrtc_multi_exact(torch, warm_cfg(cfg, WEBRTC_GL[0]),
                                         plan, batches[0], 2,
                                         compute_dtype=dt)
            if i == 0:
                launches["K-hop", d] = n
                say(f"  StreamEngine mode fused-webrtc at {d}, {label}, "
                    f"{SLOTS} slots, card vs CPU:")
                launches["hop", d] = phase_engine_webrtc(
                    torch, with_dtype(cfg, d), model,
                    SNR_GL32_DB if d == "float32" else BF16_GL_DB[32])
    label, cfg, _, plan = cases[0]
    c8 = warm_cfg(cfg, WEBRTC_GL[0])
    g = torch.Generator(device="cuda").manual_seed(60)
    chunks = 0.2 * torch.randn((WEBRTC_K, SLOTS, cfg.dsp.hop_length),
                               generator=g, device="cuda")
    out = {}
    for d, dt in modes.items():
        hop = make_webrtc_hop(cfg, plan, "cuda", compute_dtype=dt)
        say(f"  webrtc hop at n_fft {cfg.dsp.n_fft}, {d}, GL-{hop.n_iter} "
            f"({smi}):")
        w_state, w_chunk = hop_inputs(
            torch, hop, lambda b: webrtc_hop_init_state(cfg, plan, b,
                                                        "cuda"), SLOTS)
        t = timed(torch, lambda: hop(w_state, w_chunk),
                  lambda: hop.reference(w_state, w_chunk),
                  webrtc_hop_work(hop, SLOTS), SLOTS, 50, plain_launches=5)
        out["hop", d] = (launches["hop", d], errs["hop", d], t)
        multi = make_webrtc_hop(c8, plan, "cuda", hops_per_call=WEBRTC_K,
                                compute_dtype=dt)
        m_state, _ = hop_inputs(
            torch, multi, lambda b: webrtc_hop_init_state(c8, plan, b,
                                                          "cuda"), SLOTS)
        say(f"  K-hop webrtc kernel at n_fft {cfg.dsp.n_fft}, {d}, "
            f"GL-{WEBRTC_GL[0]}, K={WEBRTC_K} ({smi}):")
        t = timed(torch, lambda: multi(m_state, chunks),
                  lambda: multi.plain(m_state, chunks),
                  webrtc_hop_work(multi, SLOTS), SLOTS, 10,
                  plain_launches=1, hops=WEBRTC_K)
        out["K-hop", d] = (launches["K-hop", d], errs["K-hop", d], t)
    return out


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
    geo_cases = [("webrtc_hop", label, c, p)
                for label, c, _, p in geometry_models(torch, 32)]
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
        for c, m in small] + geo_cases,
        torch.cuda.get_device_properties(0).shared_memory_per_block_optin)

    say(f"phase 43: the lookahead checkpoint {OFFLINE_LA_CHECKPOINT} in mode "
        f"fast (its delay rings), {SLOTS} slots, card vs CPU; profile; "
        f"engine --mode fused downgraded to fast")
    la_launches = phase_lookahead(torch, smi)
    say(f"phase 44: the gated W8A8 fused hop on {FLAGSHIP} (its floor "
        f"planes in global memory) vs its plain version on the card")
    (fi_launches, fim_launches, fi_err, fi_db, fi_multi,
     fi_t) = phase_int8_flagship(torch, flag_cfg, flag, flag_plan, smi)
    say(f"phase 45: the WebRTC hop's bf16 Griffin-Lim mode "
        f"(gruunet2-dari_tult, warm) vs its plain version on the card")
    (wb_launches, wbm_launches, wb_err, wb_t,
     wb_read) = phase_webrtc_bf16(torch, dari_cfg, dari, dari_plan, smi)

    say(f"phase 46: offline_denoise_stateless, one window of the "
        f"recommended geometry at {SLOTS} streams ({SEG_UNET}, {SEG_WIDE}), "
        f"card vs CPU, the TF32 control")
    phase_segment_window(torch, smi)
    say(f"phase 47: StreamEngine mode unet ({SEG_UNET}, the recommended "
        f"geometry), {SLOTS} slots, card vs CPU, gated and ungated; the "
        f"ticks timed, and {SEG_WIDE}'s")
    phase_segment_engine(torch, SEG_UNET, SEG_UNET_CYCLES, smi)
    time_segment_only(torch, SEG_WIDE, smi)
    say(f"phase 48: StreamEngine mode unet ({SEG_TRUNET}, TRUNetDenoiser at "
        f"its class-default geometry), {SLOTS} slots, card vs CPU")
    phase_segment_engine(torch, SEG_TRUNET, SEG_TRUNET_CYCLES, smi,
                         gates=(False,))
    say(f"phase 49: EngineDaemon and WSDaemon mode unet ({SEG_UNET}, "
        f"{SEG_CLIENTS} clients at the audio's pace) against their rounds "
        f"replayed on the CPU; denoise --streamed, card vs CPU")
    phase_segment_daemons(torch, smi)

    with tempfile.TemporaryDirectory() as tmp:
        corpus_dir = os.path.join(tmp, "corpus")
        corpus = write_train_corpus(corpus_dir)
        say(f"phase 50: one training step on the card against the CPU at "
            f"full width ({', '.join(c[0] for c in TRAIN_CASES)}), the "
            f"TF32 control")
        phase_train_step(torch, tmp, corpus)
        say(f"phase 51: train with the flagship recipe, --device-data "
            f"{TRAIN_CLI_STEPS} steps, --resume {TRAIN_RESUME_STEPS}, the "
            f"host sampler {TRAIN_RESUME_STEPS}; the step timed")
        trained = phase_train_cli(torch, tmp, corpus_dir, corpus, smi)
        say("phase 52: the trained checkpoint: hub, denoise, eval --manifest "
            "on the card and the CPU, compare")
        phase_train_eval(torch, tmp, corpus_dir, trained)

        say(f"phase 53: the kernel wrappers' device: each built for cuda:0, "
            f"for a bare cuda and for each other card, against its plain "
            f"version there ({torch.cuda.device_count()} card(s))")
        phase_device_guard(torch, cfg, plan, dari_cfg, dari_plan,
                           build_cell_plan(good))
        say(f"phase 54: make_fused_hop_sharded at {MESH_SLOTS} slots against "
            f"make_fused_hop, bit for bit, and against the plain version")
        sharded = phase_sharded_hop(torch, sharded_cases(
            cfg, plan, flag_cfg, flag_plan, momo_cfg, momo_plan), smi)
        say(f"phase 55: StreamEngine(mesh) modes fused, fused-webrtc, fast "
            f"and unet at {MESH_SLOTS} slots against the unsharded engine "
            f"(and the CPU); engine --multichip; the daemon on a mesh")
        seg_cfg, seg_model = segment_cfg(torch, SEG_UNET)
        mesh_l = phase_mesh_engines(torch, {
            "fused": (cfg, model), "fused-webrtc": (dari_cfg, dari),
            "fast": (good_cfg, good), "unet": (seg_cfg, seg_model)})
        mesh_l["daemon"] = phase_mesh_daemon(torch)
        say(f"phase 56: the tensor-parallel plan cell against plan_cell "
            f"({FLAGSHIP}, gruunet2-good)")
        phase_tp(torch, [(FLAGSHIP, flag_plan),
                         ("gruunet2-good", build_cell_plan(good))], smi)
        say("phase 57: make_sharded_train_step against the single-card "
            "step: NCCL at world 1, two gloo ranks on cuda:0")
        phase_data_parallel(torch, tmp, corpus, corpus_dir)

    with tempfile.TemporaryDirectory() as tmp:
        say(f"phase 58: ONNX: {' and '.join(ONNX_SPECS)} exported by the "
            f"port, run_graph on the card at {SLOTS} streams; the MOMO3 "
            f"graph through the hub in StreamEngine modes fused and fast "
            f"(PlanModel(fused=True)) against the .npz engine and the CPU; "
            f"the K-hop kernel on its plan")
        onnx_paths = phase_onnx_graphs(torch, tmp)
        (ox_launches, oxm_launches, oxc_launches,
         ox_err) = phase_onnx_engines(torch, onnx_paths[MOMO_SPEC])
    say("phase 59: loopback (gruunet2-good, the fast step on the card) on a "
        "stand-in sound card against the CPU; --no-denoise")
    phase_loopback(torch)
    wide = ", ".join(f"n_fft {n}, {m} mels" for n, m in GEO_CASES)
    say(f"phase 60: the WebRTC hop at n_fft 640 ({GEO_SPEC}) and past the "
        f"old mel caps ({wide}), both entry points, fp32 and bf16 GL, vs "
        f"the plain version and a float64 witness; mode fused-webrtc; "
        f"timed")
    geo = phase_webrtc_geometries(torch, smi)

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

    def gl_bf16(n_iter, n, timing, checked):
        stats, ola = wb_read[n_iter]
        v = variant(f"bf16 GL, gruunet2-dari_tult, GL-{n_iter}", checked,
                    timing, n)
        v.update(max_abs_err=ola, worst_db=stats["plain"][0],
                 control_db=stats["plain"][1], limit_db=BF16_GL_DB[n_iter],
                 nearer_db=stats["nearer"][0],
                 control_nearer_db=stats["nearer"][1],
                 limit_nearer_db=BF16_NEARER_DB)
        return v

    def sharded_variants(multi):
        """Phase 54's cases of one row: each mesh's largest difference
        from the unsharded kernel and both call times."""
        out = []
        for (mesh, label), (diff, ms_sh, ms_1) in sharded.items():
            if (f"K={K_HOPS}" in label) != multi:
                continue
            out.append({"name": f"sharded over {mesh}, {label}",
                        "checked": "phase 54: against the unsharded kernel "
                        "and the plain version", "sharded_vs_unsharded":
                        diff, "ms": ms_sh, "unsharded_ms": ms_1})
        return out

    mesh_runs = "phase 55: StreamEngine(mesh) against the unsharded engine"

    def geo_variant(entry, dtype, gl):
        """Phase 60's n_fft 640 run of ``entry`` in ``dtype``."""
        n, e, timing = geo[entry, dtype]
        checked = ("phase 60: each hop from the plain state with a float64 "
                   "witness at 256 and 3 streams, and at 160 mels (n_fft "
                   "1024) and 64 (n_fft 160); the engine" if entry == "hop"
                   else "phase 60: against single hops (0); each call from "
                   "the plain state with a float64 witness (fp32)")
        v = variant(f"n_fft 640 (radix 5), {GEO_SPEC}, {dtype}, {gl}",
                    checked, timing, n)
        if entry == "hop" or dtype == "float32":   # held against plain
            v["max_abs_err"] = e
        return v
    flag_i8 = f"int8, {FLAGSHIP}, tuned gate (both)"
    v_fi = variant(flag_i8, "phase 44: 256 streams, voiced, the control "
                   "failing", fi_t[0], fi_launches)
    v_fi.update(max_abs_err=fi_err, worst_db=fi_db,
                limit_db=FORCED_DB["int8"])
    v_fim = variant(flag_i8, "phase 44: K = 50, fp32 and int16 IO, the "
                    "control failing", fi_t[1], fim_launches)
    v_fim.update(max_abs_err=fi_multi[1], worst_db=fi_multi[2],
                 limit_db=FREE_DB[(FLAGSHIP, "int8")][1])
    rows = []
    for name, source, replaces, n, e, (ms, plain_ms, bound_ms, bound_by), \
            variants in (
            ("fused_hop", "fused_hop", "fused_hop.py:242",
             launches + me_launches + sum(re_launches.values())
             + ws_launches + fi_launches + mesh_l["fused"]
             + mesh_l["daemon"] + ox_launches,
             max(err, g_err, mh_err, flag_err, fi_err, ox_err,
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
             + reduced("int8", "hop", re_launches["int8"]) + [v_fi]
             + sharded_variants(False)
             + [variant(f"sharded, {S16K}", mesh_runs + " and the CPU; "
                        "the daemon on a mesh", n=mesh_l["fused"]
                        + mesh_l["daemon"]),
                variant(f"ONNX, the {MOMO_SPEC} graph through the hub",
                        "phase 58: mode fused bit for bit the .npz "
                        "engine's; vs the CPU", n=ox_launches)]),
            ("fused_hop_multi", "fused_hop", "fused_hop.py:384",
             m_launches + mm_launches + fim_launches + oxm_launches
             + sum(n for n, _, _ in r_multi.values()),
             max(m_err, mm_err, fi_multi[1],
                 *(e for _, e, _ in r_multi.values())), multi,
             [variant("mel, gruunet2-stream16k, ungated and gated, fp32 and "
                      "int16 IO", "phase 14"),
              variant(f"raw + delta, {MOMO_SPEC}, fp32 and int16 IO",
                      "phase 26", momo_t["K-hop"], mm_launches),
              variant(f"float32, {FLAGSHIP}", "timed beside phase 36",
                      r_t[(FLAGSHIP, "float32", "K-hop")])]
             + reduced("bfloat16", "K-hop", None)
             + reduced("int8", "K-hop", None) + [v_fim]
             + sharded_variants(True)
             + [variant(f"ONNX, the {MOMO_SPEC} graph's plan", "phase 58: "
                        "vs the plain version; bit for bit the .npz "
                        "plan's", n=oxm_launches)]),
            ("webrtc_hop", "webrtc_hop", "webrtc_hop.py:331",
             w_launches + wws_launches + wb_launches
             + mesh_l["fused-webrtc"] + geo["hop", "float32"][0]
             + geo["hop", "bfloat16"][0],
             max(w_err, wb_err, geo["hop", "float32"][1],
                 geo["hop", "bfloat16"][1]), webrtc,
             [variant("mel, gruunet2-dari_tult, warm GL", "phases 3, 6, 7; "
                      "not on a MOMO path (JAX refuses delta and raw)"),
              variant("WebSocket daemon, gruunet2-dari_tult, warm GL",
                      f"phase 40: {WS_CLIENTS} clients, replies vs the "
                      f"kernel replayed per stream; reply p50 "
                      f"{wws_lat[0]:.3f} ms, p99 {wws_lat[1]:.3f} ms",
                      n=wws_launches),
              gl_bf16(dari_cfg.dsp.griffin_lim_iters, wb_launches, wb_t[0],
                      "phase 45: each hop from the plain state, 256 "
                      "streams, the control failing; the engine at "
                      "bfloat16"),
              gl_bf16(WEBRTC_GL[0], None, None, "phase 45: each hop from "
                      "the plain state, 256 streams, the control failing"),
              variant("sharded, gruunet2-dari_tult, warm GL", mesh_runs,
                      n=mesh_l["fused-webrtc"]),
              geo_variant("hop", "float32", "GL-32"),
              geo_variant("hop", "bfloat16", "GL-32")]),
            ("webrtc_hop_multi", "webrtc_hop", "webrtc_hop.py:344",
             wm_launches + wbm_launches + geo["K-hop", "float32"][0]
             + geo["K-hop", "bfloat16"][0],
             max(wm_err, geo["K-hop", "float32"][1]),
             w_multi[WEBRTC_GL[0]],
             [variant("mel, gruunet2-dari_tult, GL-8 and GL-32",
                      "phases 19-22; not on a MOMO path"),
              variant(f"bf16 GL, gruunet2-dari_tult, GL-{WEBRTC_GL[0]}, "
                      f"K={WEBRTC_K}", f"phase 45: 2 calls against "
                      f"{2 * WEBRTC_K} single bf16 hops (0)", wb_t[1],
                      wbm_launches),
              geo_variant("K-hop", "float32", f"GL-{WEBRTC_GL[0]}, "
                          f"K={WEBRTC_K}"),
              geo_variant("K-hop", "bfloat16", f"GL-{WEBRTC_GL[0]}, "
                          f"K={WEBRTC_K}")]),
            ("fused_cell", "fused_cell", "gruunet_cell.py:58",
             c_launches + mc_launches + la_launches + oxc_launches,
             max(c_err, mc_err), fused_cell,
             [variant("gruunet2-good and two runs/ widths", "phases 8-10"),
              variant(f"delta, {MOMO_SPEC}; MOMO2", "phase 27",
                      momo_t["cell"], mc_launches),
              variant(f"lookahead, {OFFLINE_LA_CHECKPOINT}, mode fast",
                      "phase 43: the engine against the CPU, profile",
                      n=la_launches),
              variant(f"ONNX, the {MOMO_SPEC} graph, mode fast on "
                      "PlanModel(fused=True)", "phase 58: bit for bit the "
                      ".npz engine's; vs the CPU", n=oxc_launches)])):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"audio_denoising_torch/csrc/{source}.cu",
            "replaces": f"audio_denoising_tpu/ops/pallas/{replaces}",
            "launches": n, "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "variants": variants})
    say("done")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2:]))
    sys.exit(main())

"""The surfaces chip_smoke.py holds the WebRTC kernel to, checked on the CPU
with the plain version at the JAX tests' small geometry (n_fft 64, 16
mels, hidden (5, 5), random weights from a seed): the float64 witness,
the frame a hop adds to its OLA buffer, the spectral convergence that
Griffin-Lim lowers, and the waveform rule for a hop taken from a shared
state; and the rules it holds the fast step's lookahead rings, the
bf16 Griffin-Lim mode and the mode-unet daemons (their rounds replayed)
to."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from audio_denoising_torch.ops import griffin_lim
from audio_denoising_torch.ops.kernels.webrtc_hop import (
    make_webrtc_hop, webrtc_hop_init_state)
from audio_denoising_torch.runtime.plan import build_cell_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNR_DB = 40.0      # two versions of one algorithm where GL is stable
HX_ATOL = 1e-5


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small(smoke, n_iter):
    cfg, model = smoke.small_webrtc_model(torch, n_iter)
    return cfg, build_cell_plan(model)


def _chunks(n, batch, hop, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((0.2 * rng.standard_normal((batch, hop)))
                             .astype(np.float32)) for _ in range(n)]


def test_griffin_lim_keeps_float64():
    rng = np.random.default_rng(1)
    mag = np.abs(rng.standard_normal((2, 33, 10)))
    out32, ang32 = griffin_lim(torch.from_numpy(mag.astype(np.float32)), 64,
                               32, n_iter=4, return_angles=True)
    out64, ang64 = griffin_lim(torch.from_numpy(mag), 64, 32, n_iter=4,
                               return_angles=True)
    assert out64.dtype == torch.float64 and ang64.dtype == torch.complex128
    assert out32.dtype == torch.float32 and ang32.dtype == torch.complex64
    assert torch.allclose(out64.float(), out32, atol=1e-4)


def test_float64_witness_tracks_the_plain_hop(smoke):
    """Where GL is stable the float64 witness and the fp32 plain version
    agree to SNR_DB on every hop after the first two, hx to HX_ATOL."""
    cfg, plan = _small(smoke, 32)
    hop = make_webrtc_hop(cfg, plan, "cpu")
    f64 = smoke.float64_plain(torch, cfg, plan)
    s = webrtc_hop_init_state(cfg, plan, 3)
    d = smoke.to(s, "cpu", torch.float64)
    for t, c in enumerate(_chunks(6, 3, hop.hop)):
        s, out = hop(s, c)
        d, out_d = f64.reference(d, c.double())
        assert out_d.dtype == torch.float64
        assert (d.hx - s.hx.double()).abs().max() < HX_ATOL
        if t >= 2:
            assert smoke.snr_db(out_d.numpy(), out.numpy()) > SNR_DB


def test_added_frame_is_what_the_hop_adds(smoke):
    cfg, plan = _small(smoke, 4)
    hop = make_webrtc_hop(cfg, plan, "cpu")
    s = webrtc_hop_init_state(cfg, plan, 2)
    for c in _chunks(3, 2, hop.hop):
        s2, out = hop(s, c)
        frame = smoke.added_frame(s, s2, hop.hop)
        # out is the old buffer's head; the new buffer is the old tail,
        # zero-padded, plus the frame
        tail = np.concatenate([s.ola[:, hop.hop:].numpy(),
                               np.zeros((2, hop.hop))], axis=1)
        np.testing.assert_allclose(tail + frame, s2.ola.numpy(), atol=1e-6)
        np.testing.assert_array_equal(out.numpy(), s.ola[:, :hop.hop])
        s = s2


def test_griffin_lim_lowers_spectral_convergence(smoke):
    """From a state whose carried phases no GL round has touched, 32 rounds
    bring every stream's frame closer to its target magnitudes than none;
    the float64 witness reads the same convergence."""
    cfg0, plan = _small(smoke, 0)
    cfg32 = smoke.warm_cfg(cfg0, 32)
    hop0 = make_webrtc_hop(cfg0, plan, "cpu")
    hop32 = make_webrtc_hop(cfg32, plan, "cpu")
    f64 = smoke.float64_plain(torch, cfg32, plan)
    s = webrtc_hop_init_state(cfg0, plan, 4)
    *warm, c = _chunks(4, 4, hop0.hop, seed=2)
    for x in warm:
        s, _ = hop0(s, x)
    d = smoke.to(s, "cpu", torch.float64)
    _, peak, _, lin = f64.targets(d, c.double())
    sc = {}
    for name, step, state, chunk in (("0", hop0, s, c), ("32", hop32, s, c),
                                     ("f64", f64.reference, d, c.double())):
        s2, _ = step(state, chunk)
        sc[name] = smoke.spectral_convergence(
            torch, f64, smoke.added_frame(state, s2, hop0.hop), peak, lin)
    assert np.all(sc["32"] < sc["0"])
    assert np.abs(sc["32"] - sc["f64"]).max() < 1e-4


@pytest.mark.parametrize("kernel_db,plain_db,held", [
    (60.0, 60.0, True),     # both near float64
    (5.0, 60.0, False),     # a wrong loop
    (25.0, 28.0, True),     # a hop where every fp32 version departs
    (5.0, 28.0, False),     # a wrong loop on such a hop
])
def test_forced_floor(smoke, kernel_db, plain_db, held):
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((8, 64))
    noise = lambda db: ref + 10 ** (-db / 20) * rng.standard_normal(
        ref.shape) * np.sqrt((ref ** 2).mean(axis=1, keepdims=True))
    k, p, floor = smoke.forced_floor(noise(kernel_db), noise(plain_db), ref)
    assert abs(k - kernel_db) < 3 and abs(p - plain_db) < 3
    assert (k >= floor) == held


def test_cell_bound_counts_the_plan(smoke):
    """chip_smoke's bound of the fused cell at gruunet2-good's plan and 256
    streams: 2 x 710,192 multiply-adds per stream, the 712,568 plan
    floats read once, x, hx, y and hx' once per stream."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops.kernels.fused_cell import make_fused_cell
    _, model = load_pretrained("gruunet2-good")
    cell = make_fused_cell(build_cell_plan(model), "cpu")
    assert sum(w.numel() for w in cell.weights) == 712_568
    flops, nbytes = smoke.cell_work(cell, 256)
    assert flops == 2 * 710_192 * 256
    assert nbytes == 4 * (712_568 + 256 * 2 * (64 + 68))
    assert flops / smoke.FP32_FLOPS > nbytes / smoke.HBM_BYTES_S


def test_hop_bound_counts_k_hops_the_gate_and_int16(smoke):
    """chip_smoke's bound of the fused hop at gruunet2-stream16k and 256
    streams: 392.3 MFLOP per hop; K hops per call move the weights and
    the state once and K chunks in and out (2 bytes a sample with int16
    IO); the gate adds GATE_FLOPS_PER_BIN per bin and its 2F + 3 floats
    of state."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops.kernels.fused_hop import make_fused_hop
    cfg, model = load_pretrained("gruunet2-stream16k")
    plan = build_cell_plan(model)
    B, K, F, hop = 256, smoke.K_HOPS, cfg.dsp.n_stft, cfg.dsp.hop_length
    one = smoke.hop_work(make_fused_hop(cfg, plan, "cpu"), B)
    multi = smoke.hop_work(make_fused_hop(cfg, plan, "cpu", hops_per_call=K),
                           B)
    pcm = smoke.hop_work(make_fused_hop(cfg, plan, "cpu", hops_per_call=K,
                                        io_dtype=torch.int16), B)
    gated = smoke.hop_work(make_fused_hop(smoke.tuned_gate(cfg), plan, "cpu",
                                          hops_per_call=K), B)
    assert one[0] / 1e6 == pytest.approx(392.3, abs=0.05)
    assert multi[0] == pytest.approx(K * one[0])
    assert multi[1] - one[1] == B * (K - 1) * 2 * hop * 4
    assert multi[1] - pcm[1] == B * K * 2 * hop * 2
    assert gated[0] - multi[0] == pytest.approx(
        B * K * smoke.GATE_FLOPS_PER_BIN * F)
    assert gated[1] - multi[1] == B * 2 * (2 * F + 3) * 4
    # bound by operations: 293 us of FMA per call against 12 us of bytes
    assert multi[0] / smoke.FP32_FLOPS * 1e6 == pytest.approx(292.8, abs=0.1)
    assert multi[1] / smoke.HBM_BYTES_S * 1e6 < 12


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_hop_bound_takes_each_types_peak(smoke, dtype):
    """chip_smoke's bound of the fused hop in each compute mode: in fp32
    every operation at the fp32 rate; in bf16 and int8 the DSP's products
    (bf16 DFT and mel matrices) at the bf16 tensor-core peak and the
    plan's at its type's peak, the gate at fp32; the plan's matrices at
    their own bytes (bf16 2, int8 1 plus a 4-byte scale per column); the
    fp32 hop's FFT twiddles, which the reduced modes' dense DFT does not
    read."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops.kernels.fused_hop import make_fused_hop
    cfg, model = load_pretrained("gruunet2-stream16k")
    plan = build_cell_plan(model)
    B = 256
    hop = make_fused_hop(smoke.tuned_gate(cfg), plan, "cpu",
                         compute_dtype=dtype)
    fp32 = make_fused_hop(smoke.tuned_gate(cfg), plan, "cpu")
    dsp, gate, ops = smoke.hop_ops(hop, B)
    flops, nbytes, seconds = smoke.hop_work(hop, B)
    assert (dsp, gate, ops) == smoke.hop_ops(fp32, B)
    assert flops == dsp + gate + ops
    peak = {torch.float32: smoke.FP32_FLOPS, torch.bfloat16:
            smoke.BF16_FLOPS, torch.int8: smoke.INT8_OPS}[dtype]
    dsp_peak = smoke.FP32_FLOPS if dtype == torch.float32 else \
        smoke.BF16_FLOPS
    assert seconds == pytest.approx(dsp / dsp_peak + gate / smoke.FP32_FLOPS
                                    + ops / peak)
    matrices = [*plan.down_mats, plan.reset_mat, *plan.up_h_mats,
                *(m for m in plan.up_s_mats if m is not None)]
    mats = sum(m.numel() for m in matrices)
    cols = sum(m.shape[1] for m in matrices)
    mel = hop.mel.numel() + hop.imel.numel()
    saved = {torch.float32: 0, torch.bfloat16: 2 * mats + 2 * mel,
             torch.int8: 3 * mats - 4 * cols + 2 * mel}[dtype]
    if dtype != torch.float32:
        assert fp32.transform == "fft" and hop.transform == "dense"
        saved += 4 * fp32.twiddle.numel()
    assert smoke.hop_work(fp32, B)[1] - nbytes == saved
    # the yardstick of the kernel's instructions is no bound
    assert smoke.instruction_seconds(hop, B) >= seconds


@pytest.mark.parametrize("case", ["sound", "cascades", "spread", "floor",
                                  "control"])
def test_free_verdict_holds_the_median_and_the_worst_stream(smoke, case):
    """A reduced mode's free run passes where a few streams cascade to
    the mode's own noise and the rest stay near the forced readings; it
    fails where an error spreads over every stream (a fault, or the fp32
    control) or one stream falls below the floor."""
    from audio_denoising_torch.hub import load_pretrained
    cfg, _ = load_pretrained("gruunet2-stream16k")
    assert smoke.limits_of(cfg) == smoke.S16K
    median, floor = smoke.FREE_DB[(smoke.S16K, "int8")]
    dbs = np.full(256, 120.0)
    if case == "cascades":
        dbs[:25] = floor + 1
    elif case == "spread":
        dbs[:] = median - 1
    elif case == "floor":
        dbs[0] = floor - 1
    elif case == "control":
        dbs[:] = 40.0
    ok, text = smoke.free_verdict(dbs, cfg, "int8")
    assert ok == (case in ("sound", "cascades")), text


def test_voiced_chunks_spread_the_gate(smoke):
    """The input the gated phases use makes the gate blend (0 < alpha < 1)
    on the unit-gain checkpoint with its recommended gate, where a steady
    or bursty tone reads as noise."""
    from audio_denoising_torch.config import recommended_serving
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.ops.kernels.fused_hop import (
        fused_hop_init_state, make_fused_hop)
    cfg, model = load_pretrained(os.path.join(REPO, "runs",
                                              smoke.GATED_CHECKPOINT))
    cfg = recommended_serving(cfg)
    assert cfg.serving.snr_gate_db == 1.0
    plan = build_cell_plan(model)
    hop = make_fused_hop(cfg, plan, "cpu")
    chunks = smoke.voiced_chunks(3, 12, hop.hop, cfg.dsp.sample_rate, 3)
    assert chunks.shape == (12, 3, hop.hop) and chunks.dtype == np.float32
    state, alphas = fused_hop_init_state(cfg, plan, 3), []
    for c in chunks:
        state, _ = hop(state, torch.from_numpy(c))
        alphas.append(hop.alpha(state))
    alphas = torch.cat(alphas)
    assert bool(((alphas > 0) & (alphas < 1)).any())


def test_plane_errors_hold_the_gate_planes_relative(smoke):
    """ring/ola/hx by max abs; a gate plane passes check_state exactly when
    |a - b| <= PLANE_ATOL + PLANE_RTOL |b| elementwise."""
    from audio_denoising_torch.ops.kernels.fused_hop import FusedHopState
    b = torch.tensor([[1e3, 1e-3, 0.0]])
    want = FusedHopState(ring=b, ola=b, hx=b, nf_floor=b)
    ok = b + 0.9 * (smoke.PLANE_ATOL + smoke.PLANE_RTOL * b.abs())
    bad = b + 1.1 * (smoke.PLANE_ATOL + smoke.PLANE_RTOL * b.abs())
    errs = smoke.plane_errors(want._replace(nf_floor=ok), want)
    assert errs["ring"] == 0 and errs["nf_floor"] < smoke.PLANE_RTOL
    smoke.check_state(errs, "ok")
    errs = smoke.plane_errors(want._replace(nf_floor=bad), want)
    assert errs["nf_floor"] > smoke.PLANE_RTOL
    with pytest.raises(AssertionError, match="nf_floor"):
        smoke.check_state(errs, "bad")


def test_plane_errors_hold_the_lookahead_rings_by_the_frames_scale(smoke):
    """The lookahead rings are analysis spectra: a bin's error counts
    against its stream's largest bin, and a phase of pi against one of
    -pi is the same bin; an error of 1e-3 of the largest bin fails."""
    from audio_denoising_torch.runtime.engine import FastState
    z = torch.zeros(2, 4)
    mag = torch.tensor([[[50.0, 1e-6, 2.0], [3.0, 0.5, 1e-3]]] * 2)
    phase = torch.tensor([[[0.1, 3.0, np.pi], [-1.0, 2.0, 0.0]]] * 2)
    want = FastState(ring=z, ola=z, hx=z, la_mag=mag, la_phase=phase)
    near = mag.clone()
    near[:, 0, 1] += 1e-5              # far from the tiny bin, not the frame
    flipped = phase.clone()
    flipped[:, 0, 2] = -np.pi
    errs = smoke.plane_errors(want._replace(la_mag=near, la_phase=flipped),
                              want)
    assert errs["la_mag"] < 1e-6 and errs["la_phase"] < 1e-6
    smoke.check_state(errs, "ok")
    far = mag.clone()
    far[:, 1, 0] += 1e-3 * 50.0
    errs = smoke.plane_errors(want._replace(la_mag=far), want)
    with pytest.raises(AssertionError, match="la_mag"):
        smoke.check_state(errs, "bad")


def test_the_bf16_gl_limits_need_the_control_to_fail(smoke):
    """check_gl_bf16 passes a kernel above both limits with the control
    below them, and raises where the kernel misses one or where a limit
    would pass the control."""
    lim = smoke.BF16_GL_DB[32]
    ok = {"plain": (lim + 1, lim - 1), "nearer": (1.0, -70.0),
          "sc": (0.1, 0.1)}
    smoke.check_gl_bf16(32, ok)
    for bad in ({**ok, "plain": (lim - 0.1, lim - 1)},
                {**ok, "nearer": (-0.1, -70.0)},
                {**ok, "plain": (lim + 1, lim + 0.1)},
                {**ok, "nearer": (1.0, 0.5)}):
        with pytest.raises(AssertionError):
            smoke.check_gl_bf16(32, bad)


@pytest.mark.parametrize("geometry", [(640, 64), (1024, 160), (160, 64),
                                      (882, 64), (44, 16), (1018, 64)])
def test_the_bf16_geometry_limits_need_the_control_to_fail(smoke,
                                                           geometry):
    """Phases 60 and 61's bf16 limit at each geometry sits between the
    kernel's lowest reading and the control's highest at its GL rounds
    (chip_smoke.py's comments beside BF16_GEO_GL32_DB; n_fft 882 at GL-8),
    and check_gl_bf16 holds a reading to it, not to BF16_GL_DB."""
    kernel, control = {(640, 64): (14.5, 10.1), (1024, 160): (17.7, 13.6),
                       (160, 64): (127.0, 53.1), (882, 64): (38.9, 35.4),
                       (44, 16): (131.0, 41.5),
                       (1018, 64): (13.8, 10.0)}[geometry]
    n_iter, lim = smoke.bf16_geometry_limit(*geometry)
    assert n_iter == (8 if geometry == (882, 64) else 32)
    assert control < lim < kernel
    ok = {"plain": (kernel, control), "nearer": (0.6, -55.7),
          "sc": (0.1, 0.1)}
    smoke.check_gl_bf16(n_iter, ok, lim)
    for bad in ({**ok, "plain": (lim - 0.1, control)},
                {**ok, "plain": (kernel, lim + 0.1)}):
        with pytest.raises(AssertionError):
            smoke.check_gl_bf16(n_iter, bad, lim)


@pytest.mark.parametrize("calls", [1, 3])
def test_bf16_check_pools_small_calls(smoke, monkeypatch, calls):
    """check_webrtc_bf16 with ``calls`` trajectories of 3 streams each:
    the first takes the chunks of a single call (seed batch + 45), each
    other its own, and every hop's readings (the witness rule, the limits)
    are taken over the streams of all calls. On the CPU the wrappers run
    their plain version, so the kernel reads far above the limits and the
    control (the fp32 hop) below them."""
    import audio_denoising_torch.ops.kernels.webrtc_hop as wh
    make, init = wh.make_webrtc_hop, wh.webrtc_hop_init_state
    monkeypatch.setattr(wh, "make_webrtc_hop", lambda cfg, plan, device,
                        **kw: make(cfg, plan, "cpu", **kw))
    monkeypatch.setattr(wh, "webrtc_hop_init_state", lambda cfg, plan, b,
                        device: init(cfg, plan, b, "cpu"))
    monkeypatch.setattr(torch.Tensor, "cuda", lambda t, *a, **k: t)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    seeds, streams, held = [], [], []
    chunks, floor = smoke.webrtc_chunks, smoke.forced_floor
    monkeypatch.setattr(smoke, "webrtc_chunks", lambda torch, b, h, seed, n:
                        seeds.append(seed) or chunks(torch, b, h, seed, n))
    monkeypatch.setattr(smoke, "forced_floor", lambda fk, fp, f16, lim:
                        streams.append(len(fk)) or floor(fk, fp, f16, lim))
    monkeypatch.setattr(smoke, "check_gl_bf16",
                        lambda n_iter, r, lim: held.append(r))
    cfg, plan = _small(smoke, 8)   # GL-8, as n_fft 882 is held
    smoke.check_webrtc_bf16(torch, cfg, plan, 3, smoke.WEBRTC_HOPS, 12.0,
                            calls)
    assert seeds == [48 + 1000 * c for c in range(calls)]
    assert streams == [3 * calls] * (smoke.WEBRTC_HOPS - 2)
    (k_plain, c_plain), (k_near, c_near) = held[0]["plain"], \
        held[0]["nearer"]
    assert k_plain > 100 and c_plain < k_plain and k_near > c_near


def test_prime_models_take_the_kernels(smoke):
    """Phase 61's geometries: n_fft 882 at 44.1 kHz on gruunet2-dari_tult
    (64 mels) with two radix-7 passes, n_fft 44 (2 x 11) and the prime
    M = 509 on random weights; each takes the kernels (shared memory
    counted) and one warm hop of its plain version is finite; the
    kernels' attributes are read for eight kernels (the M = 0 and
    M = 441 instantiations', and the single hop's cell launch in each
    walk)."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        fft_radices, webrtc_hop_smem_bytes)
    cases = smoke.prime_models(torch, 2)
    dsp = [c.dsp for _, c, _, _ in cases]
    assert [(d.n_fft, d.n_mels) for d in dsp] == \
        [(smoke.PRIME_N_FFT, 64)] + list(smoke.PRIME_CASES)
    assert dsp[0].sample_rate == 44100 and dsp[0].hop_length == 441
    assert [d.n_fft // 2 for d in dsp] == list(smoke.PRIME_FFT_SIZES)
    assert fft_radices(441) == smoke.PRIME_RADICES
    assert fft_radices(509) == [509] and fft_radices(22) == [2, 11]
    assert len(smoke.KERNEL_ATTRS) == 8
    for _, cfg, _, plan in cases:
        assert cfg.dsp.griffin_lim_warm_start
        assert webrtc_hop_smem_bytes(cfg, plan) > 0
        hop = make_webrtc_hop(cfg, plan, "cpu")
        s = webrtc_hop_init_state(cfg, plan, 2)
        for c in _chunks(2, 2, cfg.dsp.hop_length, 61):
            s, out = hop(s, c)
        assert torch.isfinite(out).all() and torch.isfinite(s.ola).all()


@pytest.mark.parametrize("K", [1, 2, 3])
def test_call_signal_is_what_a_call_adds(smoke, K):
    """What a call of K hops adds to the output stream is its K frames
    overlap-added: at K = 1 the frame added_frame reads; at any K the
    outputs of the next call (zero chunks aside) start with its tail."""
    cfg, plan = _small(smoke, 4)
    multi = make_webrtc_hop(cfg, plan, "cpu", hops_per_call=K)
    single = make_webrtc_hop(cfg, plan, "cpu")
    s = webrtc_hop_init_state(cfg, plan, 2)
    for c in _chunks(2, 2, multi.hop, seed=4):     # a state with an OLA tail
        s, _ = single(s, c)
    chunks = torch.stack(_chunks(K, 2, multi.hop, seed=5))
    s2, outs = multi(s, chunks[0] if K == 1 else chunks)
    outs = outs.reshape(K, 2, multi.hop)
    y = smoke.call_signal(s, s2, outs, multi.hop)
    assert y.shape == (2, (K + 1) * multi.hop)
    frames, st = [], s
    for c in chunks:
        st2, _ = single(st, c)
        frames.append(smoke.added_frame(st, st2, multi.hop))
        st = st2
    want = np.zeros_like(y)
    for k, f in enumerate(frames):
        want[:, k * multi.hop:(k + 2) * multi.hop] += f
    np.testing.assert_allclose(y, want, atol=1e-6 * np.abs(want).max())


def test_webrtc_bound_counts_k_hops(smoke):
    """chip_smoke's bound of the WebRTC hop at gruunet2-dari_tult and 256
    streams: 3302.3 MFLOP per hop at GL-32, 1803.9 at GL-8 (bench.py's
    resident shape), each bound by operations; K hops per call do K times
    the operations and move the state once and K chunks in and out."""
    from audio_denoising_torch.hub import load_pretrained
    cfg, model = load_pretrained("gruunet2-dari_tult")
    plan = build_cell_plan(model)
    B, K, hop = 256, smoke.WEBRTC_K, cfg.dsp.hop_length
    for n_iter, mflop in ((32, 3302.3), (8, 1803.9)):
        c = smoke.warm_cfg(cfg, n_iter)
        one = smoke.webrtc_hop_work(make_webrtc_hop(c, plan, "cpu"), B)
        multi = smoke.webrtc_hop_work(
            make_webrtc_hop(c, plan, "cpu", hops_per_call=K), B)
        assert one[0] / 1e6 == pytest.approx(mflop, abs=0.05)
        assert multi[0] == pytest.approx(K * one[0])
        assert multi[1] - one[1] == B * (K - 1) * 2 * hop * 4
        assert multi[0] / smoke.FP32_FLOPS > multi[1] / smoke.HBM_BYTES_S


@pytest.mark.parametrize("n,hop", [(320 * 50, 320), (768 * 25, 768),
                                   (97, 320)])
def test_ws_frames_are_odd_and_cover_the_stream(smoke, n, hop):
    """Phases 39-40 send each client's PCM in frames about the hop (the
    browser page's size) whose sizes sum to the stream and, but for the
    last, are odd, so the daemon's re-chunker carries residue across
    hops."""
    sizes = smoke.ws_frames(n, hop)
    assert sum(sizes) == n
    assert all(s % 2 == 1 for s in sizes[:-1])
    assert all(abs(s - hop) < hop // 4 for s in sizes[:-1])


def test_hop_latencies_start_at_the_frame_that_completes_a_hop(smoke):
    """A hop's latency runs from sending the frame that brought its last
    sample to the hop's reply: frames of 5, 2, 5 samples at hop 4 end
    hop 0 in frame 0 (5 >= 4), hop 1 in frame 2 (12 >= 8), hop 2 there
    too."""
    lat = smoke.hop_latencies([5, 2, 5], [1.0, 2.0, 3.0],
                              [1.5, 3.25, 3.5], 4)
    np.testing.assert_allclose(lat, [0.5, 0.25, 0.5])


def test_server_replies_repeat_the_first_channel(smoke):
    """What phase 41 holds the socket daemon to: the first channel
    through the server step, repeated over the channels, shaped as each
    message."""
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.pipeline import make_server_step
    cfg, model = load_pretrained("gruunet2-good")
    msgs = smoke.socket_messages(5)
    out, hx = smoke.server_replies(torch, make_server_step(cfg, model, "cpu"),
                                   model, msgs)
    for o, m in zip(out, msgs):
        assert o.shape == m.shape
        np.testing.assert_array_equal(o[:, 0], o[:, 1])
    assert tuple(hx.shape) == tuple(model.init_state(1).shape)


def test_segment_rounds_replay_exactly(smoke):
    """What phase 49 holds the mode-unet daemons to: the rounds an engine
    ran (streams added and removed between them, one missing a round,
    which the cadence lock fills with zeros), logged by
    ``recorded_rounds`` and replayed on a fresh engine by
    ``replay_rounds``, give every stream the outputs it got (0)."""
    from audio_denoising_torch.config import with_unet_geometry
    from audio_denoising_torch.hub import load_pretrained
    from audio_denoising_torch.runtime.engine import StreamEngine
    cfg, model = load_pretrained(os.path.join(
        REPO, "runs", "unet4crop2s-mrstft-30k.npz"))
    cfg = with_unet_geometry(cfg, seg_hops=2, ctx=384, ctx_left=384)

    def engine():
        return StreamEngine(cfg, model, mode="unet", max_streams=3,
                            device="cpu")

    live = engine()
    log = smoke.recorded_rounds(live)
    rng = np.random.default_rng(49)
    got = {}
    live.add_stream("a")
    for t in range(9):
        if t == 2:
            live.add_stream("b")
        if t == 6:
            live.remove_stream("a")
        chunks = {s: (0.1 * rng.standard_normal(live.hop)).astype(
            np.float32) for s in live.slots if not (s == "b" and t == 4)}
        out, slots = live.process_async(chunks)
        for s, slot in slots.items():
            got.setdefault(s, []).append(out[slot].numpy())
    want = smoke.replay_rounds(log, engine())
    assert set(want) == {"a", "b"}
    for s in want:
        np.testing.assert_array_equal(np.stack(got[s]), want[s])


def test_tf32_control_restores_the_fp32_scope(smoke):
    """Phases 46-48's control turns TF32 on for the segment path's convs
    and matmuls, and back off afterwards."""
    from audio_denoising_torch import pipeline
    fp32 = pipeline.fp32_convs
    mm = torch.backends.cuda.matmul.allow_tf32
    with smoke.tf32_allowed(torch):
        assert pipeline.fp32_convs is not fp32
        assert torch.backends.cuda.matmul.allow_tf32
        with pipeline.fp32_convs():
            assert torch.backends.cudnn.allow_tf32
    assert pipeline.fp32_convs is fp32
    assert torch.backends.cuda.matmul.allow_tf32 == mm
    with pipeline.fp32_convs():
        assert not torch.backends.cudnn.allow_tf32


def _fabricated_step(scale_err, roundoff=1e-9):
    """Phase 50's two sides, fabricated: (loss, output, gradients,
    parameters after the step), the card's off by ``scale_err`` of each
    tensor's largest magnitude, one tensor's gradient round-off (its sign
    flipped on the card, its parameters moved by Adam's noise)."""
    g = {"a": torch.tensor([1.0, -0.5]), "b": torch.tensor([0.2, 0.1]),
         "c": torch.tensor([roundoff, -roundoff])}
    p = {"a": torch.tensor([2.0, 1.0]), "b": torch.tensor([0.5, 0.0]),
         "c": torch.tensor([0.1, 0.1])}
    y = torch.tensor([[0.5, -2.0], [1.0, 0.0]])

    def off(d):
        return {k: v + scale_err * v.abs().max() for k, v in d.items()}
    g_card, p_card = off(g), off(p)
    g_card["c"] = -g["c"]
    p_card["c"] = torch.tensor([0.3, -0.1])
    return ((torch.tensor(4.0), y, g, p),
            (torch.tensor(4.0 * (1 + scale_err)), y + 2.0 * scale_err,
             g_card, p_card))


def test_train_readings_rule(smoke):
    """Phase 50's comparison: the loss relative to the CPU's, the output
    and each gradient relative to its largest magnitude (a gradient
    floored at TRAIN_GRAD_FLOOR of the tensors' median, so a round-off
    one is read against the floor), each parameter relative to its
    largest magnitude for the tensors whose gradient clears the floor."""
    cpu, card = _fabricated_step(1e-4)
    (loss, out, grad, param), roundoff = smoke.train_readings(cpu, card)
    assert loss == pytest.approx(1e-4, rel=1e-3)
    assert out == pytest.approx(1e-4, rel=1e-3)
    floor = smoke.TRAIN_GRAD_FLOOR * 0.2           # the median tensor: b
    assert grad == pytest.approx(max(1e-4, 2e-9 / floor), rel=1e-3)
    assert param == pytest.approx(1e-4, rel=1e-3)  # "c" is not held
    assert roundoff == ["c"]


def test_train_limits_need_the_control_to_fail(smoke, monkeypatch):
    """Every case within its objective's limits and every control beyond
    the limits TRAIN_CONTROL_FAILS names passes; a case beyond a limit,
    or a control within a named one, raises; the reconstruction
    objective's control may meet its loss and gradient limits."""
    monkeypatch.setattr(smoke, "TRAIN_LIMITS", {
        "residual_mse": (1e-5, 1e-5, 1e-3, 1e-5),
        "recon_mrstft": (2e-4, 1e-5, 1e-1, 1e-4)})
    objectives = {"dari": "residual_mse", "flag": "recon_mrstft"}
    sound = {"dari": (1e-7, 1e-7, 1e-5, 1e-7),
             "flag": (6e-5, 1e-7, 3e-2, 2e-5)}
    control = {"dari": (1e-4, 1e-3, 1e-2, 1e-4),
               "flag": (4e-5, 1e-3, 4e-2, 4e-4)}
    smoke.check_train_limits(sound, control, objectives)
    with pytest.raises(AssertionError, match="disagrees"):
        smoke.check_train_limits(dict(sound, dari=(1e-7, 1e-7, 2e-3, 1e-7)),
                                 control, objectives)
    with pytest.raises(AssertionError, match="parameters limit"):
        smoke.check_train_limits(sound, dict(
            control, flag=(4e-5, 1e-3, 4e-2, 5e-5)), objectives)
    with pytest.raises(AssertionError, match="loss limit"):
        smoke.check_train_limits(sound, dict(
            control, dari=(1e-6, 1e-3, 1e-2, 1e-4)), objectives)


@pytest.mark.parametrize("losses,falls", [
    ([10.0 - 0.1 * i for i in range(60)], True),
    ([5.0 + (-1) ** i for i in range(60)], False),          # flat
    ([1.0 + 0.01 * i for i in range(60)], False),           # rising
    ([10.0 - 0.1 * i for i in range(59)] + [float("nan")], False),
    ([10.0 - i for i in range(15)], False)])                 # too short
def test_loss_trend_check(smoke, losses, falls):
    """Phase 51's trend: every loss finite and the mean of the last
    TRAIN_TREND below the mean of the first, over at least twice that."""
    if falls:
        first, last = smoke.check_loss_trend(losses)
        assert last < first
    else:
        with pytest.raises(AssertionError, match="do not fall"):
            smoke.check_loss_trend(losses)


def test_train_tf32_control_restores_the_fp32_scope(smoke):
    """Phase 50's control swaps the training step's fp32 scope for one
    with TF32 on, and restores it."""
    from audio_denoising_torch.train import context
    real = context.fp32_scope
    mm = torch.backends.cuda.matmul.allow_tf32
    with smoke.train_tf32(torch):
        assert context.fp32_scope is not real
        with context.fp32_scope():
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32
    assert context.fp32_scope is real
    with context.fp32_scope():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == mm


# -- phases 58-60 ------------------------------------------------------------

def test_onnx_cell_is_the_graphs_function(smoke, tmp_path):
    """Phase 58 holds run_graph on the card against ``onnx_cell``, the
    model's own cell step on the graph's inputs: on the CPU the two are
    equal on MOMO3's graph (delta carry) and gruunet2-good's, at a batch
    of 3 through ``batched_graph``, which tiles only the batch-1
    initializers a Concat joins."""
    from audio_denoising_torch.compat import export_cell, parse_onnx, \
        run_graph
    from audio_denoising_torch.hub import load_pretrained
    for spec in smoke.ONNX_SPECS:
        model = load_pretrained(spec)[1]
        g1 = parse_onnx(export_cell(model, str(tmp_path / f"{spec}.onnx")))
        g = smoke.batched_graph(g1, 3)
        tiled = {k for k, v in g.initializers.items()
                 if v.shape != g1.initializers[k].shape}
        assert tiled and all(k.startswith("smear_") for k in tiled)
        for k in tiled:
            np.testing.assert_array_equal(g.initializers[k][2],
                                          g1.initializers[k][0])
        rng = np.random.default_rng(3)
        feeds = {n: torch.from_numpy(rng.standard_normal(
            (3,) + tuple(s[1:])).astype(np.float32)) for n, s in g.inputs}
        got = run_graph(g, feeds, "cpu")
        with torch.no_grad():
            own = smoke.onnx_cell(model, feeds)
        assert set(own) == set(g.outputs)
        for k in g.outputs:
            assert torch.equal(got[k], own[k])


def test_stand_in_soundcard_drives_loopback(smoke):
    """Phase 59's stand-in sound card: ``--no-denoise`` writes exactly
    twice the mic, clipped, at the reference's clock; the denoising run
    (on the CPU here) writes one block per callback and says where its
    fast step runs; the stand-in module is gone afterwards."""
    import sys
    raw, said = smoke.run_loopback(["--no-denoise", "--seconds", "0.03"], 5)
    assert raw.stream_kw == {"samplerate": 48000, "blocksize": 768}
    assert len(raw.written) == 3
    for out, mic in zip(raw.written, raw.fed):
        np.testing.assert_array_equal(out, np.clip(2.0 * mic, -1.0, 1.0))
    card, said = smoke.run_loopback(["--seconds", "0.02", "--torch-device",
                                     "cpu"], 5)
    assert "the fast step on cpu" in said and len(card.written) == 2
    assert not np.allclose(card.written[-1], card.fed[-1], atol=1e-4)
    assert "sounddevice" not in sys.modules


def test_geometry_models_reach_the_lifted_caps(smoke):
    """Phase 60's geometries: n_fft 640 with a radix-5 pass on the shipped
    weights, and random weights whose 3 n_mels exceed 384 and n_fft; each
    takes the kernels (shared memory counted) and one warm hop of its
    plain version is finite."""
    from audio_denoising_torch.ops.kernels.webrtc_hop import (
        fft_radices, webrtc_hop_smem_bytes)
    cases = smoke.geometry_models(torch, 2)
    n_ffts = [c.dsp.n_fft for _, c, _, _ in cases]
    assert n_ffts == [640] + [n for n, _ in smoke.GEO_CASES]
    assert sorted(n // 2 for n in n_ffts) == sorted(smoke.GEO_FFT_SIZES)
    assert 5 in fft_radices(320) and 5 in fft_radices(80)
    (_, c1, _, _), (_, c2, _, _) = cases[1:]
    assert 3 * c1.dsp.n_mels > 384 and 3 * c2.dsp.n_mels > c2.dsp.n_fft
    for _, cfg, _, plan in cases:
        assert cfg.dsp.griffin_lim_warm_start
        assert webrtc_hop_smem_bytes(cfg, plan) > 0
        hop = make_webrtc_hop(cfg, plan, "cpu")
        s = webrtc_hop_init_state(cfg, plan, 2)
        for c in _chunks(2, 2, cfg.dsp.hop_length, 60):
            s, out = hop(s, c)
        assert torch.isfinite(out).all() and torch.isfinite(s.ola).all()

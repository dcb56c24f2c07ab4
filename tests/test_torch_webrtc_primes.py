"""The WebRTC hop at an n_fft / 2 with a prime factor above 5
(``csrc/webrtc_hop.cu``'s compiled-in M = 441, radices 9 and 7 in
registers, its M = 0 instantiation's prime pass, and their plain mirrors
in ``ops/kernels/webrtc_hop.py``) on the CPU: the pass schedule against
numpy's FFT at m = 7, 21, 22, 28, 49, 63, 143, 441 (n_fft 882, WebRTC's
10 ms frame at 44.1 kHz: 9 x 7 x 7) and the prime 509, the real-input
formulas around it, the plain
hop against JAX's ``make_webrtc_hop`` in interpret mode and JAX's op-by-op
step at n_fft 56, 44, 42 and 882, fp32 and the bf16 Griffin-Lim mode, and
the shared-memory count at the 44.1 kHz geometry on gruunet2-dari_tult's
plan. The CUDA kernels at these geometries are held against the plain
version on the card by chip_smoke.py phase 61."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu.ops.pallas.webrtc_hop import (
    make_webrtc_hop as jax_make_hop)
from audio_denoising_tpu.pipeline import make_webrtc_step as jax_make_step

from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.ops.kernels.common import (
    cell_layout_floats, plan_shape)
from audio_denoising_torch.ops.kernels.webrtc_hop import (
    FRAMES, KTILE, fft_passes, fft_radices, inverse_input, make_webrtc_hop,
    pass_twiddle_table, real_bins, twiddle_table, webrtc_hop_smem_bytes)
from audio_denoising_torch.runtime.plan import build_cell_plan
from tests.test_torch_webrtc_geometries import (
    FFT_REL, FRAME_DB, KERNEL_HX, KERNEL_OUT, SMEM_LIMIT, _added, _small,
    _snr, _step_state, _to_jax, _warm_state)

# m = 509 is one pass of 509-term sums in fp32: against numpy's float64
# FFT it reads 3.7e-7 of a frame's peak, the 441-point schedule 1.5e-7,
# the others 1.7e-7 or less; FFT_REL holds 509 too, with room. Only the
# compiled-in 441 takes 9 (before 3) and runs 7 in registers; at run time
# (63 is 3 x 3 x 7) 7 and any larger prime are prime passes
PRIME_SIZES = [(7, [7]), (21, [3, 7]), (22, [2, 11]), (28, [4, 7]),
               (49, [7, 7]), (63, [3, 3, 7]), (143, [11, 13]),
               (441, [9, 7, 7]), (509, [509])]
# (n_fft, mels): m = 28 = 4 x 7, 22 = 2 x 11, 21 = 3 x 7 (odd), 441
GEOMETRIES = [(56, 16), (44, 16), (42, 16), (882, 16)]


@pytest.mark.parametrize("m,radices", PRIME_SIZES)
def test_prime_pass_schedule_matches_numpy_fft(m, radices):
    """The kernels' complex FFT with a radix-7 pass (a prime pass, or in
    registers at the compiled-in 441) or a larger prime pass, pass by
    pass, on three complex64 frames with the float32 pass-twiddle table,
    against numpy's fft and m * ifft in float64, within FFT_REL of each
    frame's peak."""
    assert fft_radices(m) == radices
    rng = np.random.default_rng(m)
    z = rng.standard_normal((3, m)) + 1j * rng.standard_normal((3, m))
    tw = torch.from_numpy(pass_twiddle_table(m)).float()
    zt = torch.from_numpy(z).to(torch.complex64)
    for inverse, want in ((False, np.fft.fft(z)),
                          (True, np.fft.ifft(z) * m)):
        got = fft_passes(zt, tw, inverse).numpy()
        peak = np.abs(want).max(axis=1, keepdims=True)
        assert float((np.abs(got - want) / peak).max()) < FFT_REL, inverse


@pytest.mark.parametrize("n_fft", [n for n, _ in GEOMETRIES])
def test_real_split_gives_rfft_and_irfft_with_prime_passes(n_fft):
    """The real-input formulas around a half-length FFT with a prime
    pass, in float64: rfft from the packed frame, irfft back."""
    rng = np.random.default_rng(n_fft)
    x = torch.from_numpy(rng.standard_normal((3, n_fft)))
    tw = torch.from_numpy(twiddle_table(n_fft))
    ptw = torch.from_numpy(pass_twiddle_table(n_fft // 2))
    spec = real_bins(fft_passes(torch.complex(x[:, 0::2], x[:, 1::2]), ptw),
                     tw)
    want = np.fft.rfft(x.numpy())
    assert np.abs(spec.numpy() - want).max() < 1e-10 * np.abs(want).max()
    back = fft_passes(inverse_input(torch.from_numpy(want), tw), ptw,
                      inverse=True)
    y = torch.stack([back.real, back.imag], dim=-1).reshape(3, n_fft) / n_fft
    ref = np.fft.irfft(want, n=n_fft)
    assert np.abs(y.numpy() - ref).max() < 1e-10 * np.abs(ref).max()


def _close(got, want):
    """Within KERNEL_OUT's rtol of the reference's scale plus its atol."""
    assert np.abs(got - want).max() <= \
        KERNEL_OUT["rtol"] * np.abs(want).max() + KERNEL_OUT["atol"]


@pytest.mark.parametrize("n_fft,n_mels,K", [
    (56, 16, 1), (44, 16, 1), (42, 16, 1), (882, 16, 1), (56, 16, 2),
    (44, 16, 2)])
def test_plain_hop_matches_jax_kernel_at_prime_geometries(rng, n_fft,
                                                          n_mels, K):
    """The plain hop (one hop, or K = 2 per call) against JAX's
    interpret-mode kernel, each call from one shared state with converged
    phases, at test_plain_hop_matches_jax_kernel_at_wide_geometries'
    bounds: the frames a call adds and its outputs after the first within
    KERNEL_OUT of the scale, hx within KERNEL_HX, the ring exact, the
    phases unit vectors. Not K = 2 at n_fft 42: there JAX's K-hop kernel
    reads 1.19x the bound from the port, which holds that geometry at
    K = 3 against JAX's op-by-op step (ROADMAP C: JAX's K-hop kernel
    departs at small n_fft)."""
    (jcfg, jplan, *_), (cfg, _, plan) = _small(n_fft, n_mels)
    hop, F, B = n_fft // 2, cfg.dsp.n_stft, 3
    kw = {} if K == 1 else dict(hops_per_call=K)
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True, block_b=8, **kw)
    port = make_webrtc_hop(cfg, plan, "cpu", **kw)
    s = _warm_state(cfg, plan, rng, B)
    for _ in range(3):
        c = (0.2 * rng.standard_normal((K, B, hop))).astype(np.float32)
        c = c[0] if K == 1 else c
        js, jout = jax_hop(_to_jax(s, F), jnp.asarray(c))
        s2, out = port(s, torch.from_numpy(c))
        _close(_added(s, s2.ola, K * hop), _added(s, js.ola, K * hop))
        for got, want in zip(out.numpy().reshape(K, B, hop)[1:],
                             np.asarray(jout).reshape(K, B, hop)[1:]):
            _close(got, want)
        np.testing.assert_allclose(s2.hx.numpy(), np.asarray(js.hx),
                                   atol=KERNEL_HX)
        np.testing.assert_array_equal(s2.ring.numpy(), np.asarray(js.ring))
        nrm = np.hypot(s2.ang_re.numpy(), s2.ang_im.numpy())
        assert np.all((np.abs(nrm - 1) < 1e-3) | (nrm < 1e-3))
        s = s2
    assert port.launches == 0


@pytest.mark.parametrize("n_fft,n_mels", GEOMETRIES)
def test_plain_k_hop_matches_jax_op_by_op_step_at_prime_geometries(
        rng, n_fft, n_mels):
    """The plain K-hop at K = 3 against JAX's op-by-op
    ``make_webrtc_step`` taking the same 3 hops from the same shared
    state with converged phases, at the same bounds: the frames a call
    adds and its outputs after the first, hx within KERNEL_HX."""
    (jcfg, _, jmodel, params), (cfg, _, plan) = _small(n_fft, n_mels)
    hop, F, B, K = n_fft // 2, cfg.dsp.n_stft, 3, 3
    jstep = jax.jit(jax_make_step(jcfg, jmodel))
    hx_shape = (B,) + tuple(jmodel.init_state(1).shape[1:])
    port = make_webrtc_hop(cfg, plan, "cpu", hops_per_call=K)
    s = _warm_state(cfg, plan, rng, B)
    for _ in range(3):
        c = (0.2 * rng.standard_normal((K, B, hop))).astype(np.float32)
        js, jouts = _step_state(s, F, hx_shape), []
        for k in range(K):
            js, jout = jstep(params, js, jnp.asarray(c[k]))
            jouts.append(np.asarray(jout))
        s2, out = port(s, torch.from_numpy(c))
        _close(_added(s, s2.ola, K * hop), _added(s, js.ola, K * hop))
        for got, want in zip(out.numpy()[1:], jouts[1:]):
            _close(got, want)
        np.testing.assert_allclose(s2.hx.numpy(),
                                   np.asarray(js.hx).reshape(B, -1),
                                   atol=KERNEL_HX)
        s = s2
    assert port.launches == 0


@pytest.mark.parametrize("n_fft,n_mels", GEOMETRIES[:2])
@pytest.mark.parametrize("K", [1, 3])
def test_bf16_gl_hop_matches_jax_kernel_at_prime_geometries(rng, n_fft,
                                                            n_mels, K):
    """The bf16 GL mode, one GL round, each call from the port's state:
    the frames a call adds (and, K = 3, its outputs after the first)
    within FRAME_DB of JAX's bf16 kernel's, hx within KERNEL_HX; a K-hop
    call equals K single hops of the mode bit for bit. Small n_fft only:
    at n_fft 800-1024 the two bf16 definitions part over three hops as
    far as JAX's own bf16 kernel parts from its fp32 step (ROADMAP C)."""
    (jcfg, jplan, *_), (cfg, _, plan) = _small(n_fft, n_mels, n_iter=1)
    hop, F, B = n_fft // 2, cfg.dsp.n_stft, 3
    kw = {} if K == 1 else dict(hops_per_call=K)
    j16 = jax_make_hop(jcfg, jplan, interpret=True, block_b=8,
                       compute_dtype=jnp.bfloat16, **kw)
    p16 = make_webrtc_hop(cfg, plan, "cpu", compute_dtype=torch.bfloat16,
                          **kw)
    one = make_webrtc_hop(cfg, plan, "cpu", compute_dtype=torch.bfloat16)
    s = _warm_state(cfg, plan, rng, B)
    for _ in range(3):
        c = (0.2 * rng.standard_normal((K, B, hop))).astype(np.float32)
        c = c[0] if K == 1 else c
        js, jout = j16(_to_jax(s, F), jnp.asarray(c))
        s2, out = p16(s, torch.from_numpy(c))
        assert _snr(_added(s, js.ola, K * hop),
                    _added(s, s2.ola, K * hop)) >= FRAME_DB
        if K > 1:
            assert _snr(np.asarray(jout)[1:], out.numpy()[1:]) >= FRAME_DB
            s1 = s
            for k in range(K):
                s1, o1 = one(s1, torch.from_numpy(c[k]))
                assert torch.equal(o1, out[k])
            for a, b in zip(s1, s2):
                assert torch.equal(a, b)
        np.testing.assert_allclose(s2.hx.numpy(), np.asarray(js.hx),
                                   atol=KERNEL_HX)
        s = s2


@pytest.mark.parametrize("n_fft", [882, 1024])
def test_bf16_k_hop_at_wide_n_fft_is_as_near_fp32_as_jax_kernel(rng,
                                                               n_fft):
    """Why the bf16 tests stay at small n_fft: at n_fft 882 (and 1024,
    radix 2 only), K = 3, one GL round, each call from a shared converged
    state, the port's plain bf16 K-hop reads below FRAME_DB against JAX's
    bf16 K-hop kernel, but JAX's kernel itself is as far from JAX's fp32
    op-by-op step (the witness): per call the port's SNR against the
    witness is at least JAX's kernel's, and the port's fp32 K-hop reads
    at least 20 dB above the port's bf16 (the witness is not what parts).
    The two bf16 definitions each part from fp32 over three hops at a
    wide n_fft; neither is the other's witness there."""
    (jcfg, jplan, jmodel, params), (cfg, _, plan) = _small(n_fft, 16,
                                                           n_iter=1)
    hop, F, B, K = n_fft // 2, cfg.dsp.n_stft, 3, 3
    j16 = jax_make_hop(jcfg, jplan, interpret=True, block_b=8,
                       compute_dtype=jnp.bfloat16, hops_per_call=K)
    p16 = make_webrtc_hop(cfg, plan, "cpu", compute_dtype=torch.bfloat16,
                          hops_per_call=K)
    p32 = make_webrtc_hop(cfg, plan, "cpu", hops_per_call=K)
    jstep = jax.jit(jax_make_step(jcfg, jmodel))
    hx_shape = (B,) + tuple(jmodel.init_state(1).shape[1:])
    s = _warm_state(cfg, plan, rng, B)
    for _ in range(3):
        c = (0.2 * rng.standard_normal((K, B, hop))).astype(np.float32)
        js = _step_state(s, F, hx_shape)
        for k in range(K):
            js, _ = jstep(params, js, jnp.asarray(c[k]))
        witness = _added(s, js.ola, K * hop)
        jk, _ = j16(_to_jax(s, F), jnp.asarray(c))
        s16, _ = p16(s, torch.from_numpy(c))
        s32, _ = p32(s, torch.from_numpy(c))
        port_db = _snr(witness, _added(s, s16.ola, K * hop))
        assert port_db >= _snr(witness, _added(s, jk.ola, K * hop))
        assert _snr(witness, _added(s, s32.ola, K * hop)) >= port_db + 20
        s = s32


def test_smem_bytes_at_the_44k1_geometry():
    """gruunet2-dari_tult's plan (64 mels) with sample_rate 44,100, n_fft
    882 and hop 441, warm GL (chip_smoke.py phase 61's headline): the
    kernels take it, within a block of an H100 for one hop and for the
    K-hop kernel at K = 25; the count is the library's rule
    (make_spec_layout, make_multi_layout; chip_smoke.py phase 61 holds it
    equal to the library's)."""
    cfg, model = load_pretrained("gruunet2-dari_tult")
    cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, sample_rate=44100, n_fft=882, hop_length=441,
        griffin_lim_warm_start=True))
    assert (cfg.dsp.n_stft, cfg.dsp.n_mels) == (442, 64)
    plan = build_cell_plan(model)
    one = webrtc_hop_smem_bytes(cfg, plan)
    multi = webrtc_hop_smem_bytes(cfg, plan, hops_per_call=25)
    assert 0 < one < multi <= SMEM_LIMIT
    r4 = lambda v: -(-v // 4) * 4
    F, m, n_fft = 442, 441, 882
    are = 4 * FRAMES * m + r4(n_fft) + 288 + r4(FRAMES * F)
    spec = are + 4 * r4(FRAMES * F)
    shape = plan_shape(plan, 64)
    cell = cell_layout_floats(shape)
    assert one == 4 * max(spec, cell)
    tile = (KTILE * spec + 2 * KTILE * r4(n_fft)
            + r4(KTILE * shape.n_hidden) + 2 * r4(KTILE * FRAMES * 64)
            + r4(KTILE))
    assert multi == 4 * (tile + (0 if cell <= are else cell))

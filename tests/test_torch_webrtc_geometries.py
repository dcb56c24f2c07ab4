"""The WebRTC hop's geometries beyond radices 2 and 3 and beyond 3 * n_mels
<= min(n_fft, 384) (``csrc/webrtc_hop.cu`` and its plain mirrors in
``ops/kernels/webrtc_hop.py``) on the CPU: the radix-5 pass schedule
against numpy's FFT, the real-input formulas at n_fft 640, the plain hop
against JAX's ``make_webrtc_hop`` in interpret mode at n_fft 80 (m = 40 =
8 x 5) and n_fft 40 with 16 mels (3 * 16 above n_fft), one hop and K hops,
fp32 and the bf16 Griffin-Lim mode, and the shared-memory count at
n_fft 640 (the gruunet2-stream16k geometry). The CUDA kernels at these
geometries are held against the plain version on the card by
chip_smoke.py phase 60."""

import ctypes
import dataclasses
import math
import types
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu.config import (
    Config as JaxConfig, DSPConfig as JaxDSPConfig,
    ModelConfig as JaxModelConfig)
from audio_denoising_tpu.models import build_model as jax_build_model
from audio_denoising_tpu.pipeline import (
    WebRTCState as JaxStepState, make_webrtc_step as jax_make_step)
from audio_denoising_tpu.ops.pallas.webrtc_hop import (
    WebRTCHopState as JaxHopState, _fpad, make_webrtc_hop as jax_make_hop)
from audio_denoising_tpu.runtime.plan import (
    build_cell_plan as jax_build_cell_plan)

from audio_denoising_torch.compat import params_from_jax
from audio_denoising_torch.config import Config, DSPConfig, ModelConfig
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.models import build_model
from audio_denoising_torch.ops.kernels.common import (
    cell_layout_floats, plan_shape)
from audio_denoising_torch.ops.kernels.webrtc_hop import (
    FRAMES, cell_walk, fft_passes, fft_radices, inverse_input,
    make_webrtc_hop,
    pass_twiddle_table, real_bins, twiddle_table, webrtc_hop_init_state,
    webrtc_hop_smem_bytes)
from audio_denoising_torch.ops.kernels import webrtc_hop as webrtc_hop_mod
from audio_denoising_torch.runtime import engine as engine_mod
from audio_denoising_torch.runtime.engine import StreamEngine, hop_smem_bytes
from audio_denoising_torch.runtime.plan import build_cell_plan, plan_from_numpy

FFT_REL = 1e-5    # fp32 passes against numpy's FFT, relative to a frame's peak
# tests/test_torch_webrtc.py's bounds for the plain hop against JAX's kernel
KERNEL_OUT = dict(rtol=2e-3, atol=1e-3)
KERNEL_HX = 5e-4
FRAME_DB = 30.0   # tests/test_torch_webrtc_bf16.py's bf16 frame bound
SMEM_LIMIT = 232448  # an H100 block's opt-in shared memory, bytes


@pytest.mark.parametrize("m,radices", [(5, [5]), (20, [4, 5]),
                                       (40, [8, 5]), (320, [8, 8, 5])])
def test_radix5_pass_schedule_matches_numpy_fft(m, radices):
    """The kernels' complex FFT with a radix-5 pass, pass by pass, on
    three complex64 frames with the float32 pass-twiddle table, against
    numpy's fft and m * ifft in float64."""
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


@pytest.mark.parametrize("n_fft", [640, 80, 40])
def test_real_split_gives_rfft_and_irfft_with_radix5(n_fft):
    """The real-input formulas around a half-length FFT with a radix-5
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


@pytest.mark.parametrize("m", [28, 22, 441])
def test_other_primes_keep_fused_webrtc_and_bind(monkeypatch, m):
    """n_fft / 2 with a prime factor above 5 (m = 28 = 4 x 7, 22 = 2 x
    11, 441 = 9 x 7 x 7) is a geometry the kernels take: its shared
    memory is counted, the engine keeps mode fused-webrtc on a card (no
    downgrade warning), and binding a library gets past the geometry:
    with a stand-in library that agrees on the layout and the count (in
    the cell walk the card's limit gives), the hop binds and names the
    instantiation the library gives it (M = 441 compiled in, else M = 0)
    and that walk."""
    _, (cfg, model, plan) = _small(2 * m, 16)
    need = webrtc_hop_smem_bytes(cfg, plan)
    assert 0 < need == hop_smem_bytes(cfg, plan, "fused-webrtc")
    monkeypatch.setattr(engine_mod, "shared_memory_limit",
                        lambda device: SMEM_LIMIT)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = StreamEngine(cfg, model, mode="fused-webrtc", max_streams=1,
                           device="cpu")
    assert eng.mode == "fused-webrtc"
    hop = make_webrtc_hop(cfg, plan, "cpu")
    answers = {"adt_webrtc_hop_args_size": ctypes.sizeof(
                   webrtc_hop_mod._Args),
               "adt_webrtc_hop_smem_bytes": webrtc_hop_smem_bytes(
                   cfg, plan, limit=SMEM_LIMIT),
               "adt_webrtc_hop_fft_instance": 441 if m == 441 else 0}
    lib = types.SimpleNamespace(**{f: (lambda *a, v=v: v) for f, v in (
        *answers.items(), ("adt_webrtc_hop_fft_radices", -1),
        ("adt_webrtc_hop", 1), ("adt_webrtc_hop_multi", 1))})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            shared_memory_per_block_optin=SMEM_LIMIT))
    hop._bind(lib)
    assert hop.fft_instance == answers["adt_webrtc_hop_fft_instance"]
    assert hop.cell_walk == cell_walk(cfg, plan, SMEM_LIMIT)
    assert hop._base_args.cell_batched == (hop.cell_walk == "batched")
    assert hop._base_args.hop == m
    assert fft_radices(m)[-1] in (7, 11)


# -- the plain hop against JAX's kernel at the new geometries ----------------

def _small(n_fft, n_mels, n_iter=4):
    """JAX's (cfg, plan, model, params) and the port's (cfg, model, plan)
    on the same random GRUUNet2 weights at ``n_fft``, hop n_fft / 2, warm
    GL."""
    d = dict(n_fft=n_fft, hop_length=n_fft // 2, n_mels=n_mels,
             sample_rate=16000, reconstruction="griffin_lim",
             griffin_lim_iters=n_iter, griffin_lim_warm_start=True)
    m = dict(arch="GRUUNet2", num_compressed_bins=4, hidden_sizes=(5, 5),
             kernel_sizes=(3, 3), strides=(2, 2), paddings=(1, 1),
             num_gaussians=3)
    jcfg = JaxConfig(dsp=JaxDSPConfig(**d), model=JaxModelConfig(**m))
    jmodel = jax_build_model(jcfg.model, num_bins=n_mels)
    params = jmodel.init(jax.random.PRNGKey(0))
    jplan = jax_build_cell_plan(jmodel, params)
    cfg = Config(dsp=DSPConfig(**d), model=ModelConfig(**m))
    model = build_model(cfg.model, num_bins=n_mels).load_params(
        params_from_jax({k: np.asarray(v) for k, v in params.items()}))
    return ((jcfg, jplan, jmodel, params),
            (cfg, model, plan_from_numpy(jplan)))



def _to_jax(state, F):
    """The port's state as the JAX kernel's (frames padded to FP lanes)."""
    FP = _fpad(F)

    def pad(a):
        a = a.numpy()
        return jnp.asarray(np.concatenate(
            [np.pad(a[:, t * F:(t + 1) * F], ((0, 0), (0, FP - F)))
             for t in range(3)], axis=1))

    return JaxHopState(*(jnp.asarray(t.numpy()) for t in state[:3]),
                       pad(state.ang_re), pad(state.ang_im))


def _added(state, ola, shift):
    """What a call added to the OLA buffer: ola' minus the buffer it
    started from, shifted by the call's samples."""
    before = state.ola.numpy().astype(np.float64)
    shifted = np.zeros_like(before)
    if shift < before.shape[1]:
        shifted[:, :before.shape[1] - shift] = before[:, shift:]
    return np.asarray(ola, np.float64) - shifted


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * math.log10((ref ** 2).sum()
                           / max(((ref - got) ** 2).sum(), 1e-30))


GEOMETRIES = [(80, 16), (40, 16)]   # m = 40 = 8 x 5; 3 * 16 above n_fft 40


def _warm_state(cfg, plan, rng, B, hops=4):
    """A state whose phases have converged: ``hops`` hops of the plain
    fp32 hop from the cold seed."""
    step = make_webrtc_hop(cfg, plan, "cpu")
    s = webrtc_hop_init_state(cfg, plan, B)
    for _ in range(hops):
        c = (0.2 * rng.standard_normal((B, cfg.dsp.hop_length))).astype(
            np.float32)
        s, _ = step(s, torch.from_numpy(c))
    return s


@pytest.mark.parametrize("n_fft,n_mels", GEOMETRIES)
@pytest.mark.parametrize("K", [1, 2])
def test_plain_hop_matches_jax_kernel_at_wide_geometries(rng, n_fft, n_mels,
                                                        K):
    """The plain hop (one hop, or K per call) against JAX's interpret-mode
    kernel, each call from one shared state with converged phases. Warm
    GL is chaotic at n_fft 80 on these weights: free-running from the
    cold seed, JAX's kernel leaves JAX's own op-by-op step by 0.19 of the
    output scale within 6 hops (its bf16 3-pass error amplified hop by
    hop), where the port's plain version stays within 5.4e-3 of that
    step; inside one call of 3 hops the frames JAX's K-hop kernel adds
    read 1.2x the bound from the port's, of 2 hops within it, and as far
    from JAX's op-by-op step (test_plain_k_hop_matches_jax_op_by_op_step
    holds K = 3 there). Held at test_plain_hop_matches_jax_kernel's
    bounds: the frames a call adds
    and its outputs after the first within its rtol and atol of the
    scale, hx within KERNEL_HX, the ring exact, the phases unit vectors."""
    (jcfg, jplan, *_), (cfg, _, plan) = _small(n_fft, n_mels)
    hop, F, B = n_fft // 2, cfg.dsp.n_stft, 3
    kw = {} if K == 1 else dict(hops_per_call=K)
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True, block_b=8, **kw)
    port = make_webrtc_hop(cfg, plan, "cpu", **kw)
    s = _warm_state(cfg, plan, rng, B)

    def close(got, want):
        assert np.abs(got - want).max() <= \
            KERNEL_OUT["rtol"] * np.abs(want).max() + KERNEL_OUT["atol"]

    for _ in range(3):
        c = (0.2 * rng.standard_normal((K, B, hop))).astype(np.float32)
        c = c[0] if K == 1 else c
        js, jout = jax_hop(_to_jax(s, F), jnp.asarray(c))
        s2, out = port(s, torch.from_numpy(c))
        close(_added(s, s2.ola, K * hop), _added(s, js.ola, K * hop))
        for got, want in zip(out.numpy().reshape(K, B, hop)[1:],
                             np.asarray(jout).reshape(K, B, hop)[1:]):
            close(got, want)
        np.testing.assert_allclose(s2.hx.numpy(), np.asarray(js.hx),
                                   atol=KERNEL_HX)
        np.testing.assert_array_equal(s2.ring.numpy(), np.asarray(js.ring))
        nrm = np.hypot(s2.ang_re.numpy(), s2.ang_im.numpy())
        assert np.all((np.abs(nrm - 1) < 1e-3) | (nrm < 1e-3))
        assert s2.ang_re.shape == (B, FRAMES * F)
        s = s2
    assert port.launches == 0


def _step_state(state, F, hx_shape):
    """The port's hop state as JAX's op-by-op step's (its conv model's hx
    shape, the phases as (B, F, 3, 2) planes)."""
    B = state.ring.shape[0]
    planes = [a.numpy().reshape(B, FRAMES, F).transpose(0, 2, 1)
              for a in (state.ang_re, state.ang_im)]
    return JaxStepState(ring=jnp.asarray(state.ring.numpy()),
                        ola=jnp.asarray(state.ola.numpy()),
                        hx=jnp.asarray(state.hx.numpy().reshape(hx_shape)),
                        gl_angles=jnp.asarray(np.stack(planes, axis=-1)))


@pytest.mark.parametrize("n_fft,n_mels", GEOMETRIES)
def test_plain_k_hop_matches_jax_op_by_op_step(rng, n_fft, n_mels):
    """The plain K-hop at K = 3 against JAX's op-by-op
    ``make_webrtc_step`` (its conv model) taking the same 3 hops from the
    same shared state with converged phases, at
    test_plain_hop_matches_jax_kernel's bounds: the frames a call adds and
    its outputs after the first, hx within KERNEL_HX. JAX's K-hop kernel
    in interpret mode is not the witness here: at n_fft 80 the frames its
    third call adds read 1.20x the bound from this step's, the port's
    0.004x; every other reading of both is under 0.1x."""
    (jcfg, _, jmodel, params), (cfg, _, plan) = _small(n_fft, n_mels)
    hop, F, B, K = n_fft // 2, cfg.dsp.n_stft, 3, 3
    jstep = jax.jit(jax_make_step(jcfg, jmodel))
    hx_shape = (B,) + tuple(jmodel.init_state(1).shape[1:])
    port = make_webrtc_hop(cfg, plan, "cpu", hops_per_call=K)
    s = _warm_state(cfg, plan, rng, B)

    def close(got, want):
        assert np.abs(got - want).max() <= \
            KERNEL_OUT["rtol"] * np.abs(want).max() + KERNEL_OUT["atol"]

    for _ in range(3):
        c = (0.2 * rng.standard_normal((K, B, hop))).astype(np.float32)
        js, jouts = _step_state(s, F, hx_shape), []
        for k in range(K):
            js, jout = jstep(params, js, jnp.asarray(c[k]))
            jouts.append(np.asarray(jout))
        s2, out = port(s, torch.from_numpy(c))
        close(_added(s, s2.ola, K * hop), _added(s, js.ola, K * hop))
        for got, want in zip(out.numpy()[1:], jouts[1:]):
            close(got, want)
        np.testing.assert_allclose(s2.hx.numpy(),
                                   np.asarray(js.hx).reshape(B, -1),
                                   atol=KERNEL_HX)
        s = s2
    assert port.launches == 0


@pytest.mark.parametrize("n_fft,n_mels", GEOMETRIES)
@pytest.mark.parametrize("K", [1, 3])
def test_bf16_gl_hop_matches_jax_kernel_at_wide_geometries(rng, n_fft,
                                                         n_mels, K):
    """The bf16 GL mode, one GL round (where the two bf16 definitions'
    traces are still readable, tests/test_torch_webrtc_bf16.py), each call
    from the port's state: the frames a call adds to the OLA buffer within
    FRAME_DB of JAX's bf16 kernel's, hx within KERNEL_HX; a K-hop call
    equals K single hops of the mode bit for bit."""
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
        js = _to_jax(s, F)
        js, jout = j16(js, jnp.asarray(c))
        s2, out = p16(s, torch.from_numpy(c))
        assert _snr(_added(s, js.ola, K * hop),
                    _added(s, s2.ola, K * hop)) >= FRAME_DB
        if K > 1:    # a call's first output is the carried buffer's
            assert _snr(np.asarray(jout)[1:], out.numpy()[1:]) >= FRAME_DB
        np.testing.assert_allclose(s2.hx.numpy(), np.asarray(js.hx),
                                   atol=KERNEL_HX)
        if K > 1:
            s1 = s
            for k in range(K):
                s1, o1 = one(s1, torch.from_numpy(c[k]))
                assert torch.equal(o1, out[k])
            for a, b in zip(s1, s2):
                assert torch.equal(a, b)
        s = s2


def test_smem_bytes_at_the_stream16k_geometry():
    """n_fft 640, 64 mels, the shipped gruunet2-good plan with warm GL (the
    gruunet2-stream16k geometry phase 60 serves): the kernels take it,
    within a block of an H100 (232,448 B) for one hop and for the K-hop
    kernel; the count grows with the K-hop's tile and is the library's
    rule (chip_smoke.py phase 60 holds it equal to the library's)."""
    cfg, model = load_pretrained("gruunet2-stream16k")
    cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, griffin_lim_warm_start=True))
    assert (cfg.dsp.n_fft, cfg.dsp.n_mels) == (640, 64)
    plan = build_cell_plan(model)
    one = webrtc_hop_smem_bytes(cfg, plan)
    multi = webrtc_hop_smem_bytes(cfg, plan, hops_per_call=25)
    assert 0 < one < multi <= 232448
    # the single hop's three kernels: the GL stage's spectra or the cell
    F, m = cfg.dsp.n_stft, 320
    r4 = lambda v: -(-v // 4) * 4
    spec = 4 * 3 * m + r4(640) + 288 + 5 * r4(3 * F)
    cell = cell_layout_floats(plan_shape(plan, 64))
    assert one == 4 * max(spec, cell)

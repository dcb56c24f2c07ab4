"""The fused hop's fp32 transforms as in-kernel FFTs (``csrc/fft.cuh`` in
``csrc/fused_hop.cu``'s walks) on the CPU: the plain version in the
kernels' transform (``FusedHop.reference``: the FFT of n_fft / 2 points
mirrored pass by pass, the real-input split and its inverse) against the
dense DFT's plain version and JAX's interpret-mode kernel, single hop and
K-hop, gated and in the raw domain with the delta carry, at n_fft 640,
1024 and 42; a mirror in the kernels' transform and order of addition
(each matmul's k ranges, ``split_schedule``) against them; the FFT mirror
against numpy's; the transform and split schedules the host gives every
shipped configuration; and the shared memory, which the FFTs do not grow.
The kernels themselves are held against the plain version on the card by
chip_smoke.py."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.ops.pallas.fused_hop import (
    fused_hop_init_state as jax_init_state, make_fused_hop as jax_make_hop)
from audio_denoising_tpu.runtime.plan import (
    build_cell_plan as jax_build_cell_plan,
    build_cell_plan_momo as jax_build_cell_plan_momo)

from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.ops.kernels.common import (
    KTHREADS, KTILE, plan_cell_math, round4, split_gemm, split_schedule)
from audio_denoising_torch.ops.kernels.fft import (
    fft_passes, fft_radices, inverse_input, pass_twiddle_table, real_bins,
    twiddle_table)
from audio_denoising_torch.ops.kernels.fused_hop import (
    FFT_MAX_N_FFT, GROUP, TRANSFORMS, fused_hop_init_state,
    fused_hop_smem_bytes, hop_group, hop_stages, hop_transform,
    make_fused_hop)
from audio_denoising_torch.runtime.plan import plan_from_numpy
from tests.test_torch_fused_hop_frames import (
    NOT_FUSED, SERVED_GROUPS, SMEM_LIMIT, _shipped)

# the existing fused-hop tests' bounds against JAX's kernel: the mel hop's
# output and state, MOMO3's, the gate's planes relative
# (tests/test_torch_fused_hop.py)
OUT_ATOL, STATE_ATOL, MOMO_ATOL = 2e-4, 2e-5, 1e-5
GATED_OUT_ATOL = 3e-4
PLANE_RTOL, PLANE_ATOL = 2e-4, 1e-9
B, HOPS, K = 3, 6, 4
# (spec, the JAX plan builder, n_fft): n_fft 640, 1024 (gruunet2-good's
# own geometry) and MOMO3's 42 (3 x 7: a prime pass)
CASES = {"640": ("gruunet2-stream16k", jax_build_cell_plan, 640),
         "1024": ("gruunet2-good", jax_build_cell_plan, 1024),
         "42": ("momo3-4d4ea0", jax_build_cell_plan_momo, 42)}


@pytest.fixture(scope="module")
def models():
    out = {}
    for key, (spec, build, n_fft) in CASES.items():
        jcfg, model, params = jax_load_pretrained(spec)
        jplan = build(model, params)
        cfg, _ = load_pretrained(spec)
        assert cfg.dsp.n_fft == n_fft
        out[key] = (jcfg, jplan, cfg, plan_from_numpy(jplan))
    return out


def _gated(cfg):
    """``cfg`` (either package's) with the gate on, estimator 'both', at
    a point where the bursty input below spreads alpha over (0, 1)."""
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, snr_gate_db=1.0, snr_gate_width_db=6.0,
        snr_gate_estimator="both"))


def _chunks(rng, n, hop_len, sr):
    """Voiced bursts over per-stream noise levels (n, B, hop)."""
    t_ax = np.arange(n * hop_len).reshape(n, 1, hop_len) / sr
    burst = (np.sin(2 * np.pi * 220 * t_ax) * 0.3
             * (np.arange(n)[:, None, None] // 2 % 2))
    lv = np.array([0.001, 0.03, 0.3])[None, :B, None]
    return (burst + lv * rng.standard_normal((n, B, hop_len))
            ).astype(np.float32)


def _close(state, want, outs, wouts, raw, gated):
    """Every output and plane within the existing tests' bounds: MOMO3's
    (raw + delta) everywhere, else the mel hop's; the gate's planes
    relative, its per-stream EMAs against JAX's column 0 (the Pallas
    kernel keeps them as 128-lane broadcasts)."""
    out_atol = MOMO_ATOL if raw else (GATED_OUT_ATOL if gated else OUT_ATOL)
    np.testing.assert_allclose(outs, wouts, rtol=0, atol=out_atol)
    for name, t in state._asdict().items():
        w = getattr(want, name)
        assert (t is None) == (w is None), name
        if t is None:
            continue
        got, w = t.numpy(), np.asarray(w)
        if name in ("ring", "ola", "hx", "prev"):
            np.testing.assert_allclose(got, w, rtol=0,
                                       atol=MOMO_ATOL if raw else STATE_ATOL,
                                       err_msg=name)
        else:
            got, w = (got[:, 0], w[:, 0]) if got.shape[1] == 1 else (got, w)
            np.testing.assert_allclose(got, w, rtol=PLANE_RTOL,
                                       atol=PLANE_ATOL, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("gate", [None, "both"])
def test_fft_plain_hop_matches_jax_and_the_dense_plain_hop(models, case,
                                                           gate):
    """HOPS single hops at B = 3, each side carrying its own state: the
    plain version in the kernels' transform (the FFT) against JAX's
    interpret-mode kernel (its dense DFT matmuls) and against the port's
    dense plain version (``reference(..., transform="dense")``), every
    output and plane within the existing fused-hop tests' bounds."""
    jcfg, jplan, cfg, plan = models[case]
    if gate:
        jcfg, cfg = _gated(jcfg), _gated(cfg)
    hop = make_fused_hop(cfg, plan, device="cpu")
    assert hop.transform == "fft"
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True)
    data = _chunks(np.random.default_rng(26), HOPS, cfg.dsp.hop_length,
                   cfg.dsp.sample_rate)
    js = jax_init_state(jcfg, jplan, B)
    s = d = fused_hop_init_state(cfg, plan, B)
    for chunk in data:
        js, jout = jax_hop(js, jnp.asarray(chunk))
        s, out = hop.reference(s, torch.from_numpy(chunk))
        d, dout = hop.reference(d, torch.from_numpy(chunk), "dense")
        _close(s, js, out.numpy(), np.asarray(jout), hop.raw, gate)
        _close(s, d, out.numpy(), dout.numpy(), hop.raw, gate)
    if gate:   # the gate took part: a stream is not fully denoised
        assert (hop.alpha(s) < 1).any()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("gate", [None, "both"])
def test_fft_plain_k_hop_matches_jax_k_hop_kernel(models, case, gate):
    """K = 4 hops a call, two calls carrying the state: the K-hop plain
    version (K hops of the FFT ``reference``, what the K-hop kernel's
    hops each equal) against JAX's resident kernel in interpret mode."""
    jcfg, jplan, cfg, plan = models[case]
    if gate:
        jcfg, cfg = _gated(jcfg), _gated(cfg)
    hop = make_fused_hop(cfg, plan, device="cpu", hops_per_call=K)
    jax_multi = jax_make_hop(jcfg, jplan, interpret=True, hops_per_call=K)
    data = _chunks(np.random.default_rng(27), 2 * K, cfg.dsp.hop_length,
                   cfg.dsp.sample_rate)
    js = jax_init_state(jcfg, jplan, B)
    s = fused_hop_init_state(cfg, plan, B)
    for call in range(2):
        chunks = data[call * K:(call + 1) * K]
        js, jouts = jax_multi(js, jnp.asarray(chunks))
        s, outs = hop(s, torch.from_numpy(chunks))
        _close(s, js, outs.numpy(), np.asarray(jouts), hop.raw, gate)


def kernel_order_math(hop, state, chunk):
    """One hop as the fp32 kernels add it, in plain PyTorch: the
    transforms as the FFT mirror, and every matmul (the mel pair, the
    plan cell's) as ``split_gemm``: the sources laid end to end, each k
    range of ``split_schedule`` one product, the ranges' sums added in
    order, then the bias."""
    gemm = split_gemm
    zero = lambda n: torch.zeros(n)
    ring = torch.cat([state.ring[:, hop.hop:], chunk], dim=-1)
    re, im = hop._rfft(ring * hop.win)
    mag = torch.sqrt(re * re + im * im)
    x = torch.log(1.0 + (mag if hop.raw else gemm([(mag, hop.mel)],
                                                  zero(hop.M))))
    y, hi = plan_cell_math(hop.weights, hop.skip_flags, hop.n, x, state.hx,
                           gemm=gemm, prev=state.prev)
    rec = x - y
    rec = torch.where(rec >= 0, rec, 0.2 * rec)
    feat = torch.clamp(torch.exp(rec) - 1.0, min=0.0)
    lin = (feat if hop.raw else torch.clamp(
        gemm([(feat, hop.imel)], zero(hop.F)), min=0.0)) * hop.output_gain
    planes = {"prev": x} if hop.delta else {}
    if hop.gated:
        estimated, lin = hop._gate(state, mag, lin)
        planes.update(estimated)
    safe = mag > 1e-8
    scale = lin / torch.where(safe, mag, torch.ones_like(mag))
    synth = hop._irfft(torch.where(safe, re * scale, lin),
                       torch.where(safe, im * scale,
                                   torch.zeros_like(im))) * hop.win
    acc = state.ola + synth
    ola = torch.cat([acc[:, hop.hop:], torch.zeros_like(acc[:, :hop.hop])],
                    dim=-1)
    return state._replace(ring=ring, ola=ola, hx=hi * hop.state_decay,
                          **planes), acc[:, :hop.hop] / hop.env


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_order_mirror_matches_the_plain_versions(models, case):
    """The kernels' order of addition moves nothing past round-off: the
    mirror in their transform and k ranges, gated, against the FFT plain
    version, the dense one and JAX's kernel over HOPS hops, within the
    existing bounds."""
    jcfg, jplan, cfg, plan = models[case]
    jcfg, cfg = _gated(jcfg), _gated(cfg)
    hop = make_fused_hop(cfg, plan, device="cpu")
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True)
    data = _chunks(np.random.default_rng(28), HOPS, cfg.dsp.hop_length,
                   cfg.dsp.sample_rate)
    js = jax_init_state(jcfg, jplan, B)
    m = s = d = fused_hop_init_state(cfg, plan, B)
    for chunk in data:
        c = torch.from_numpy(chunk)
        js, jout = jax_hop(js, jnp.asarray(chunk))
        m, out = kernel_order_math(hop, m, c)
        s, sout = hop.reference(s, c)
        d, dout = hop.reference(d, c, "dense")
        for want, wout in ((js, np.asarray(jout)), (s, sout.numpy()),
                           (d, dout.numpy())):
            _close(m, want, out.numpy(), wout, hop.raw, True)


@pytest.mark.parametrize("n_fft", [640, 1024, 42, 882, 2048])
def test_fft_mirror_on_the_fused_hops_schedule_is_rfft(n_fft):
    """The fused hop's FFTs (the M = 0 schedule, ``compiled=False``: 882
    runs 3 x 3 x 7 x 7 with two prime passes) in float64: the real-input
    split of the packed frame's FFT is rfft, the inverse FFT of the
    pre-twiddled bins read as sample pairs is n_fft times irfft (DC's and
    Nyquist's imaginary parts dropped)."""
    m = n_fft // 2
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal((3, n_fft))
    tw = torch.from_numpy(twiddle_table(n_fft))
    ptw = torch.from_numpy(pass_twiddle_table(m, compiled=False))
    z = torch.complex(torch.from_numpy(x[:, 0::2]),
                      torch.from_numpy(x[:, 1::2]))
    spec = real_bins(fft_passes(z, ptw, compiled=False), tw).numpy()
    np.testing.assert_allclose(spec, np.fft.rfft(x), atol=1e-9 * n_fft)
    want = np.fft.rfft(x)
    back = fft_passes(inverse_input(torch.from_numpy(want), tw), ptw,
                      inverse=True, compiled=False)
    np.testing.assert_allclose(
        torch.view_as_real(back).reshape(3, n_fft).numpy() / n_fft,
        np.fft.irfft(want, n_fft), atol=1e-12 * n_fft)
    assert fft_radices(m, compiled=False) == {
        640: [8, 8, 5], 1024: [8, 8, 8], 42: [3, 7], 882: [3, 3, 7, 7],
        2048: [8, 8, 8, 2]}[n_fft]


def test_transform_choice_and_what_the_kernel_reads(models):
    """fp32 takes the FFTs up to FFT_MAX_N_FFT (their buffers of kF n_fft
    floats within the scratch of kF rows), the reduced modes and wider
    frames the dense matmuls; an FFT hop hands the kernel its twiddles
    and no dense DFT matrix, a dense one the four matrices."""
    _, _, cfg, plan = models["640"]
    assert FFT_MAX_N_FFT == 4 * KTHREADS
    wide = dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, n_fft=2 * FFT_MAX_N_FFT, hop_length=FFT_MAX_N_FFT))
    assert hop_transform(cfg) == "fft"
    assert hop_transform(wide) == "dense"
    for dtype in (torch.bfloat16, torch.int8):
        assert hop_transform(cfg, dtype) == "dense"
    for transform in TRANSFORMS:
        hop = make_fused_hop(cfg, plan, "cpu")
        hop.transform = transform
        a = hop._args()
        fft = transform == "fft"
        assert a.transform == int(fft)
        assert all((getattr(a, name) is None) == fft
                   for name in ("cf", "sf", "ic", "is_"))
        assert (a.twiddle is not None) == fft
        assert a.mel is not None and a.imel is not None
    # the twiddles: the n_fft-point table, then the passes' of n_fft / 2
    assert tuple(hop.twiddle.shape) == (640 + 319, 2)


def _brute_force_ks(n, k):
    """The ks_n rule as csrc/plan_cell.cuh words it, recomputed: the
    fewest rounds of work items times k an item."""
    n4 = round4(n) // 4
    costs = {ks: -(-n4 * ks // KTHREADS) * -(-k // ks)
             for ks in range(1, max(1, min(k // 16, 4 * KTHREADS // (4 * n4)))
                             + 1)}
    return min(costs, key=lambda ks: (costs[ks], ks))


@pytest.fixture(scope="module")
def shipped():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return list(_shipped())


def test_split_schedule_of_every_shipped_plan(shipped):
    """Each fp32 matmul of every shipped checkpoint's hop (``hop_stages``
    in its transform) gets from the mirror the ks_n the kernels' rule
    gives (recomputed here) and k ranges that cover the depth in order,
    each a multiple of 4 long and at least 16 where split; the rows never
    enter it, so both walks add each row alike. The card holds the
    library's split_ks to the mirror on the same stages
    (chip_smoke.check_fused_schedules)."""
    stages = 0
    for label, cfg, plan in shipped:
        for name, n, k in hop_stages(cfg, plan):
            sc = split_schedule(n, k)
            assert sc.ks_n == _brute_force_ks(n, k), (label, name)
            assert sc.chunk % 4 == 0 and len(sc.ranges) == sc.ks_n
            assert sc.ranges[0][0] == 0 and sc.ranges[-1][1] == k
            assert all(a[1] == b[0] for a, b in zip(sc.ranges,
                                                    sc.ranges[1:]))
            assert sc.ks_n == 1 or sc.chunk >= 16
            stages += 1
    assert stages >= 200
    # gruunet2-good's plan (stream16k's weights): decoder level 2 and
    # encoder level 1, the plan's longest chains, pinned
    good = dict((name, (n, k)) for name, n, k in hop_stages(
        *next((c, p) for label, c, p in shipped
              if label == "gruunet2-good.npz")))
    assert [split_schedule(*good[st]).ks_n for st in ("up 2", "down 1")] \
        == [3, 7]


def test_fft_buffers_fit_both_walks_of_every_shipped_checkpoint(shipped):
    """The FFTs take no shared memory of their own: for every shipped
    checkpoint whose fp32 hop transforms by FFT, the two buffers of nf
    n_fft floats fit the split-K scratch of nf rows and the frames' own
    buffer in both walks (nf = KTILE, GROUP KTILE); so the engine's
    capacity rule and the K-hop kernel's group are those of the dense
    transform, NOT_FUSED and SERVED_GROUPS (every mode fused where the
    per-frame walk fits an H100 block, the walk's both entry points within
    it)."""
    ffts = 0
    for label, cfg, plan in shipped:
        if hop_transform(cfg) != "fft":
            continue
        ffts += 1
        n_fft = cfg.dsp.n_fft
        for nf in (KTILE, GROUP * KTILE):
            assert nf * n_fft <= nf * 4 * KTHREADS
            assert nf * n_fft <= nf * round4(n_fft)
        fits = fused_hop_smem_bytes(cfg, plan) <= SMEM_LIMIT
        assert fits == (label not in NOT_FUSED), label
        if fits:
            for k in (1, 50):
                assert fused_hop_smem_bytes(cfg, plan, torch.float32, k,
                                            SMEM_LIMIT) <= SMEM_LIMIT
    assert ffts >= 20
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for spec, group in SERVED_GROUPS:
            cfg, model = load_pretrained(spec)
            from audio_denoising_torch.runtime.plan import build_cell_plan
            assert hop_transform(cfg) == "fft"
            assert hop_group(cfg, build_cell_plan(model), SMEM_LIMIT,
                             50) == group, spec

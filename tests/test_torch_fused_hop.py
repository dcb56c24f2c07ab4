"""The port's fused hop: its plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) fed the identical plan, with and
without the SNR gate, in the single-hop and the resident K-hop form and
with int16 IO, on gruunet2-stream16k and on MOMO3 (the delta carry and
the raw domain); the gated hop against the port's gated fast step; engine
mode 'fused' gated against the JAX engine; and the wrapper's checks. The
CUDA kernels themselves are held against the plain version on the card
by chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.ops.pallas.fused_hop import (
    fused_hop_init_state as jax_init_state, make_fused_hop as jax_make_hop)
from audio_denoising_tpu.runtime.engine import StreamEngine as JaxEngine
from audio_denoising_tpu.runtime.plan import (
    build_cell_plan as jax_build_cell_plan,
    build_cell_plan_momo as jax_build_cell_plan_momo)

from audio_denoising_torch.config import PRESETS
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.ops.kernels.fused_hop import (
    FusedHopState, fused_hop_init_state, make_fused_hop)
from audio_denoising_torch.runtime.engine import (
    StreamEngine, fast_init_state, make_fast_step)
from audio_denoising_torch.runtime.plan import plan_from_numpy

SPEC = "gruunet2-stream16k"   # gruunet2-good's weights at 16 kHz, 640/320
OUT_ATOL = 2e-4      # tests/test_fused_hop.py's bounds for the fused hop
STATE_ATOL = 2e-5
GATED_OUT_ATOL = 3e-4    # tests/test_fused_hop.py's bounds with the gate
PLANE_RTOL, PLANE_ATOL = 2e-4, 1e-9
LSB = 1              # int16 outputs: at most one step apart
ESTIMATORS = ("removed", "floor", "both")
# (gate, width) per estimator: tests/test_fused_hop.py's 10 dB / 4 where
# the bursty input spreads alpha over (0, 1) with it; 'removed' reads
# 15-41 dB on this x3-gain checkpoint, so its ramp sits higher
GATE_POINTS = {"removed": (30.0, 10.0), "floor": (10.0, 4.0),
               "both": (10.0, 4.0)}


@pytest.fixture(scope="module")
def plans():
    cfg, model, params = jax_load_pretrained(SPEC)
    jplan = jax_build_cell_plan(model, params)
    return cfg, jplan, PRESETS[SPEC], plan_from_numpy(jplan)


def _gated(cfg, estimator, gate_db=None, width_db=None):
    """``cfg`` (either package's Config) with the gate on at
    GATE_POINTS[estimator] unless given."""
    point = GATE_POINTS[estimator]
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, snr_gate_db=point[0] if gate_db is None else gate_db,
        snr_gate_width_db=point[1] if width_db is None else width_db,
        snr_gate_estimator=estimator))


def _bursty(rng, B, hop, t):
    """tests/test_fused_hop.py's _bursty: a tone on every other 3 hops
    over per-stream noise levels that spread alpha over (0, 1)."""
    t_ax = np.arange(t * hop, (t + 1) * hop) / 16000.0
    base = (0.3 * np.sin(2 * np.pi * 440 * t_ax)
            * (1.0 if (t // 3) % 2 else 0.0))
    lv = np.array([0.001, 0.01, 0.1, 0.3])[:B, None]
    return (base[None, :] + lv * rng.standard_normal((B, hop))
            ).astype(np.float32)


def _assert_state_close(state, jstate, plane_only=False):
    """ring/ola/hx within STATE_ATOL; the gate's (B, F) planes relative,
    its per-stream planes against the JAX kernel's column 0."""
    for name, t in state._asdict().items():
        if t is None:
            assert getattr(jstate, name) is None, name
            continue
        want = np.asarray(getattr(jstate, name))
        got = t.numpy()
        if name in ("ring", "ola", "hx", "prev"):
            if not plane_only:
                np.testing.assert_allclose(got, want, atol=STATE_ATOL,
                                           err_msg=name)
        elif got.shape[1] == 1:
            np.testing.assert_allclose(got[:, 0], want[:, 0],
                                       rtol=PLANE_RTOL, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=PLANE_RTOL,
                                       atol=PLANE_ATOL, err_msg=name)


@pytest.mark.parametrize("batch", [4, 3])
def test_plain_hop_matches_jax_kernel(plans, batch):
    """B=3 is not a multiple of the JAX kernel's tile: its padding path."""
    jcfg, jplan, cfg, plan = plans
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True)
    hop = make_fused_hop(cfg, plan, device="cpu")
    js = jax_init_state(jcfg, jplan, batch)
    s = fused_hop_init_state(cfg, plan, batch)
    rng = np.random.default_rng(batch)
    for _ in range(8):
        chunk = (0.1 * rng.standard_normal((batch, 320))).astype(np.float32)
        js, jout = jax_hop(js, jnp.asarray(chunk))
        s, out = hop(s, torch.from_numpy(chunk))
        assert out.shape == (batch, 320) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=OUT_ATOL)
        for name in ("ring", "ola", "hx"):
            np.testing.assert_allclose(getattr(s, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       atol=STATE_ATOL)
    assert hop.launches == 0      # the plain version is not a launch


def _bad_inputs(hop, cfg, plan):
    s = fused_hop_init_state(cfg, plan, 2)
    c = torch.zeros(2, cfg.dsp.hop_length)
    return {
        "chunk dtype": (s, c.double(), TypeError),
        "chunk width": (s, torch.zeros(2, cfg.dsp.hop_length + 1),
                        ValueError),
        "chunk rank": (s, torch.zeros(cfg.dsp.hop_length), ValueError),
        "state batch": (fused_hop_init_state(cfg, plan, 3), c, ValueError),
        "hx dtype": (s._replace(hx=s.hx.half()), c, TypeError),
        "ring width": (s._replace(ring=torch.zeros(2, 7)), c, ValueError),
    }


@pytest.mark.parametrize("case", ["chunk dtype", "chunk width", "chunk rank",
                                  "state batch", "hx dtype", "ring width"])
def test_wrapper_rejects_bad_inputs(plans, case):
    _, _, cfg, plan = plans
    hop = make_fused_hop(cfg, plan, device="cpu")
    state, chunk, err = _bad_inputs(hop, cfg, plan)[case]
    with pytest.raises(err):
        hop(state, chunk)


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_gated_plain_hop_matches_jax_kernel(plans, estimator):
    """12 bursty hops at B=4 (tests/test_fused_hop.py's gated setup): the
    gate blends (0 < alpha < 1 on some stream-hops) and the plain version
    follows the Pallas kernel's gate."""
    jcfg, jplan, cfg, plan = plans
    jcfg, cfg = _gated(jcfg, estimator), _gated(cfg, estimator)
    B, hop_len = 4, cfg.dsp.hop_length
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True)
    hop = make_fused_hop(cfg, plan, device="cpu")
    js = jax_init_state(jcfg, jplan, B)
    s = fused_hop_init_state(cfg, plan, B)
    rng = np.random.default_rng(0)
    alphas = []
    for t in range(12):
        chunk = _bursty(rng, B, hop_len, t)
        js, jout = jax_hop(js, jnp.asarray(chunk))
        s, out = hop(s, torch.from_numpy(chunk))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=GATED_OUT_ATOL)
        alphas.append(hop.alpha(s).numpy())
    _assert_state_close(s, js)
    alphas = np.concatenate(alphas)
    assert np.any((alphas > 0) & (alphas < 1)), alphas.ravel()


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_gated_hop_matches_the_gated_fast_step(plans, estimator):
    """The independent oracle, as tests/test_fused_hop.py uses it: the
    port's op-by-op fast step with the same gate (out 3e-4, planes
    relative 2e-4)."""
    _, _, cfg, plan = plans
    cfg = _gated(cfg, estimator)
    _, model = load_pretrained(SPEC)
    B, hop_len = 4, cfg.dsp.hop_length
    fast = make_fast_step(cfg, model, "cpu")
    hop = make_fused_hop(cfg, plan, device="cpu")
    s0 = fast_init_state(cfg, model, B)
    s1 = fused_hop_init_state(cfg, plan, B)
    rng = np.random.default_rng(1)
    for t in range(12):
        chunk = torch.from_numpy(_bursty(rng, B, hop_len, t))
        s0, out0 = fast(s0, chunk)
        s1, out1 = hop(s1, chunk)
        np.testing.assert_allclose(out1.numpy(), out0.numpy(),
                                   atol=GATED_OUT_ATOL)
    for name in ("nf_smooth", "nf_floor", "nf_total", "em_out", "em_rem"):
        a, b = getattr(s1, name), getattr(s0, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.reshape(b.shape).numpy(), b.numpy(),
                                       rtol=PLANE_RTOL, atol=PLANE_ATOL,
                                       err_msg=name)


def _multi_case(case):
    """(estimator or None, io dtype) of a K-hop test case."""
    return {"ungated": (None, torch.float32), "both": ("both", torch.float32),
            "int16": ("both", torch.int16)}[case]


def _pcm(rng, K, B, hop):
    return (np.clip(np.stack([_bursty(rng, B, hop, t) for t in range(K)]),
                    -1, 1) * 32767).astype(np.int16)


@pytest.mark.parametrize("case", ["ungated", "both", "int16"])
def test_multi_hop_matches_jax_kernel(plans, case):
    """K=4 hops in one call at B=3 against JAX's resident kernel
    (hops_per_call=4): out 2e-4 and state 2e-5, the gate's planes
    relative 2e-4; with int16 IO the outputs at most 1 LSB apart."""
    jcfg, jplan, cfg, plan = plans
    estimator, io = _multi_case(case)
    if estimator:
        jcfg, cfg = _gated(jcfg, estimator), _gated(cfg, estimator)
    K, B, hop_len = 4, 3, cfg.dsp.hop_length
    jio = jnp.int16 if io == torch.int16 else jnp.float32
    jax_multi = jax_make_hop(jcfg, jplan, interpret=True, hops_per_call=K,
                             io_dtype=jio)
    multi = make_fused_hop(cfg, plan, device="cpu", hops_per_call=K,
                           io_dtype=io)
    rng = np.random.default_rng(2)
    js, s = jax_init_state(jcfg, jplan, B), fused_hop_init_state(cfg, plan, B)
    for _ in range(2):            # the second call starts from carried state
        if io == torch.int16:
            chunks = _pcm(rng, K, B, hop_len)
        else:
            chunks = np.stack([_bursty(rng, B, hop_len, t) for t in range(K)])
        js, jouts = jax_multi(js, jnp.asarray(chunks))
        s, outs = multi(s, torch.from_numpy(chunks))
        assert outs.shape == (K, B, hop_len) and outs.dtype == io
        if io == torch.int16:
            diff = np.abs(outs.numpy().astype(np.int32)
                          - np.asarray(jouts).astype(np.int32))
            assert diff.max() <= LSB
        else:
            np.testing.assert_allclose(outs.numpy(), np.asarray(jouts),
                                       atol=OUT_ATOL)
        _assert_state_close(s, js)
    assert multi.launches == 0      # the plain version is not a launch


@pytest.mark.parametrize("case", ["ungated", "both", "int16"])
def test_multi_hop_equals_single_hops(plans, case):
    """On the CPU a K-hop call is K single hops of the plain version, with
    the int16 conversion at each hop's boundary: exactly equal."""
    _, _, cfg, plan = plans
    estimator, io = _multi_case(case)
    if estimator:
        cfg = _gated(cfg, estimator)
    K, B, hop_len = 4, 3, cfg.dsp.hop_length
    multi = make_fused_hop(cfg, plan, device="cpu", hops_per_call=K,
                           io_dtype=io)
    single = make_fused_hop(cfg, plan, device="cpu", io_dtype=io)
    rng = np.random.default_rng(3)
    chunks = (_pcm(rng, K, B, hop_len) if io == torch.int16 else
              np.stack([_bursty(rng, B, hop_len, t) for t in range(K)]))
    chunks = torch.from_numpy(chunks)
    s_m, outs = multi(fused_hop_init_state(cfg, plan, B), chunks)
    s_s = fused_hop_init_state(cfg, plan, B)
    for k in range(K):
        s_s, out = single(s_s, chunks[k])
        assert torch.equal(outs[k], out)
    for a, b in zip(s_m, s_s):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("case", ["gate", "multi", "int16"])
def test_gate_multi_and_int16_are_served(plans, case):
    """What the first slices refused: a gated configuration, K hops per
    call and int16 IO each build and run a call on the CPU."""
    _, _, cfg, plan = plans
    kw, B, hop_len = {}, 2, cfg.dsp.hop_length
    shape, dtype = (B, hop_len), torch.float32
    if case == "gate":
        cfg = _gated(cfg, "both", gate_db=1.0, width_db=6.0)
    elif case == "multi":
        kw["hops_per_call"] = 50
        shape = (50, B, hop_len)
    else:
        kw["io_dtype"] = dtype = torch.int16
    hop = make_fused_hop(cfg, plan, device="cpu", **kw)
    state = fused_hop_init_state(cfg, plan, B)
    assert (state.em_out is not None) == (case == "gate")
    new, out = hop(state, torch.ones(shape, dtype=dtype))
    assert out.shape == shape and out.dtype == dtype
    assert bool(torch.isfinite(new.ola).all())


@pytest.mark.parametrize("case", ["raw", "bf16", "int8", "delta"])
def test_later_slices_raise(plans, case):
    """What the hop still refuses. bf16 and int8 compute are served (the
    reduced-precision tests below), but no other compute dtype: float16
    (which JAX's kernel would take as bf16) and uint8 are refused. The raw
    domain and delta plans are served (the MOMO3 tests below), but a raw
    config whose n_mels is not n_stft, or a delta plan whose level 0 does
    not take cat(x, prev), is refused."""
    _, _, cfg, plan = plans
    kw = {}
    err, match = ValueError, "compute dtype must be float32, bfloat16 or int8"
    if case == "raw":
        cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
            cfg.dsp, domain="raw"))
        err, match = ValueError, "n_mels must equal n_stft"
    elif case in ("bf16", "int8"):
        kw["compute_dtype"] = {"bf16": torch.float16,
                               "int8": torch.uint8}[case]
    else:
        plan = plan._replace(delta=True)
        err, match = ValueError, "needs 128 level-0 rows"
    with pytest.raises(err, match=match):
        make_fused_hop(cfg, plan, device="cpu", **kw)


def test_wrapper_rejects_missing_gate_planes(plans):
    _, _, cfg, plan = plans
    hop = make_fused_hop(_gated(cfg, "both"), plan, device="cpu")
    with pytest.raises(ValueError, match="nf_smooth is missing"):
        hop(fused_hop_init_state(cfg, plan, 2), torch.zeros(2, 320))


@pytest.mark.parametrize("estimator", ["both", "removed"])
def test_engine_fused_gated_matches_jax_with_masked_commit(estimator):
    """Engine mode 'fused' with the gate against the JAX engine (its
    kernel in interpret mode), 2 slots: 'b' idles for 4 ticks and its
    planes stay bit-identical (tests/test_fused_hop.py's masked-commit
    tests); then 'b' leaves and 'c' takes its slot with zeroed planes."""
    jcfg, jmodel, jparams = jax_load_pretrained(SPEC)
    cfg, model = load_pretrained(SPEC)
    jcfg, cfg = _gated(jcfg, estimator), _gated(cfg, estimator)
    jeng = JaxEngine(jcfg, jmodel, jparams, mode="fused", max_streams=2,
                     pallas_interpret=True)
    eng = StreamEngine(cfg, model, mode="fused", max_streams=2, device="cpu")
    assert jeng.mode == eng.mode == "fused"
    rng = np.random.default_rng(4)
    hop_len = cfg.dsp.hop_length
    for e in (jeng, eng):
        e.add_stream("a")
        e.add_stream("b")
    for t in range(8):
        if t == 6:
            for e in (jeng, eng):
                e.remove_stream("b")
                assert e.add_stream("c") == eng.slots["a"] ^ 1
            slot = eng.slots["c"]
            for name in ("em_out", "em_rem", "nf_floor"):
                plane = getattr(eng.state, name)
                if plane is not None:
                    assert not bool(plane[slot].any()), name
        both = _bursty(rng, 2, hop_len, t)
        chunks = {"a": both[0]}
        if t == 0 or t >= 5:
            chunks["b" if t < 6 else "c"] = both[1]
        idle = eng.slots["b"] if "b" not in chunks and "b" in eng.slots \
            else None
        before = {k: v.clone() for k, v in eng.state._asdict().items()
                  if v is not None}
        want, got = jeng.process(chunks), eng.process(chunks)
        for sid in chunks:
            np.testing.assert_allclose(got[sid], want[sid],
                                       atol=GATED_OUT_ATOL)
        if idle is not None:
            for k, v in before.items():
                assert torch.equal(getattr(eng.state, k)[idle], v[idle]), k
        _assert_state_close(eng.state, jeng.state, plane_only=True)


def test_hop_needs_a_card_unless_cpu_is_asked(plans, monkeypatch):
    _, _, cfg, plan = plans
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fused_hop(cfg, plan)


def test_cpu_hop_refuses_cuda_tensors_it_was_not_built_for(plans):
    _, _, cfg, plan = plans
    hop = make_fused_hop(cfg, plan, device="cpu")
    state = FusedHopState(*(torch.empty(2, w, device="meta")
                            for w in (640, 640, 68)))
    with pytest.raises(ValueError, match="built for cpu"):
        hop(state, torch.empty(2, 320, device="meta"))


# -- MOMO3: the delta carry and the raw-spectrogram domain -------------------

MOMO_SPEC = "momo3-4d4ea0"
REALNOISE = "runs/momo3-realnoise.npz"
MOMO_ATOL = 1e-5     # tests/test_fused_hop.py:233-243 (kernel vs fast step)
KHOP_ATOL = 1e-6     # :245-265 (K hops in one call vs K single hops)


def _momo(spec):
    """JAX (cfg, plan), the port's (cfg, the identical plan), and the
    port's zoo model, for a MOMO3 checkpoint."""
    jcfg, jmodel, params = jax_load_pretrained(spec)
    jplan = jax_build_cell_plan_momo(jmodel, params)
    cfg, model = load_pretrained(spec)
    return jcfg, jplan, cfg, plan_from_numpy(jplan), model


@pytest.fixture(scope="module")
def momo():
    return _momo(MOMO_SPEC)


def _momo_chunks(rng, K, B):
    return (0.1 * rng.standard_normal((K, B, 21))).astype(np.float32)


@pytest.mark.parametrize("batch", [4, 3])
def test_momo3_plain_hop_matches_jax_kernel(momo, batch):
    """Every plane, prev included, and the output over 8 hops."""
    jcfg, jplan, cfg, plan, _ = momo
    assert plan.delta and cfg.dsp.domain == "raw"
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True)
    hop = make_fused_hop(cfg, plan, device="cpu")
    assert hop.mel is None and hop.imel is None and hop.M == 22
    js, s = jax_init_state(jcfg, jplan, batch), fused_hop_init_state(
        cfg, plan, batch)
    assert s.prev.shape == (batch, 22) and not s.prev.any()
    for chunk in _momo_chunks(np.random.default_rng(batch), 8, batch):
        js, jout = jax_hop(js, jnp.asarray(chunk))
        s, out = hop(s, torch.from_numpy(chunk))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=MOMO_ATOL)
        for name in ("ring", "ola", "hx", "prev"):
            np.testing.assert_allclose(getattr(s, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       atol=MOMO_ATOL, err_msg=name)
    assert hop.launches == 0


def test_momo3_plain_hop_matches_the_fast_step(momo):
    """The raw-domain fast step with the zoo model's (hx, prev) carry as
    the oracle (tests/test_fused_hop.py:220-243): output, hx and prev."""
    _, _, cfg, plan, model = momo
    B = 4
    fast, hop = make_fast_step(cfg, model, "cpu"), make_fused_hop(
        cfg, plan, device="cpu")
    s0, s1 = fast_init_state(cfg, model, B), fused_hop_init_state(cfg, plan,
                                                                  B)
    for chunk in _momo_chunks(np.random.default_rng(5), 5, B):
        s0, out0 = fast(s0, torch.from_numpy(chunk))
        s1, out1 = hop(s1, torch.from_numpy(chunk))
        np.testing.assert_allclose(out1.numpy(), out0.numpy(),
                                   atol=MOMO_ATOL)
        np.testing.assert_allclose(s1.hx.numpy(),
                                   s0.hx.reshape(B, -1).numpy(),
                                   atol=MOMO_ATOL)
        np.testing.assert_allclose(s1.prev.numpy(), s0.prev.numpy(),
                                   atol=MOMO_ATOL)


@pytest.mark.parametrize("case", ["ungated", "both", "int16"])
def test_momo3_multi_hop_matches_jax_kernel(momo, case):
    """K=4 hops in one call at B=3, two calls carrying the state, against
    JAX's resident kernel; with int16 IO at most 1 LSB apart."""
    jcfg, jplan, cfg, plan, _ = momo
    estimator, io = _multi_case(case)
    if estimator:
        jcfg, cfg = (_gated(c, estimator, 1.0, 6.0) for c in (jcfg, cfg))
    K, B = 4, 3
    jio = jnp.int16 if io == torch.int16 else jnp.float32
    jax_multi = jax_make_hop(jcfg, jplan, interpret=True, hops_per_call=K,
                             io_dtype=jio)
    multi = make_fused_hop(cfg, plan, device="cpu", hops_per_call=K,
                           io_dtype=io)
    rng = np.random.default_rng(6)
    js, s = jax_init_state(jcfg, jplan, B), fused_hop_init_state(cfg, plan, B)
    for _ in range(2):
        chunks = _momo_chunks(rng, K, B)
        if io == torch.int16:
            chunks = (np.clip(3 * chunks, -1, 1) * 32767).astype(np.int16)
        js, jouts = jax_multi(js, jnp.asarray(chunks))
        s, outs = multi(s, torch.from_numpy(chunks))
        if io == torch.int16:
            diff = np.abs(outs.numpy().astype(np.int32)
                          - np.asarray(jouts).astype(np.int32))
            assert diff.max() <= LSB
        else:
            np.testing.assert_allclose(outs.numpy(), np.asarray(jouts),
                                       atol=MOMO_ATOL)
        for name in ("hx", "prev"):
            np.testing.assert_allclose(getattr(s, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       atol=MOMO_ATOL, err_msg=name)
        _assert_state_close(s, js, plane_only=True)


def test_momo3_multi_hop_equals_single_hops(momo):
    """K hops in one call against K single hops, prev included."""
    _, _, cfg, plan, _ = momo
    K, B = 4, 3
    multi = make_fused_hop(cfg, plan, device="cpu", hops_per_call=K)
    single = make_fused_hop(cfg, plan, device="cpu")
    chunks = torch.from_numpy(_momo_chunks(np.random.default_rng(7), K, B))
    s_m, outs = multi(fused_hop_init_state(cfg, plan, B), chunks)
    s_s = fused_hop_init_state(cfg, plan, B)
    for k in range(K):
        s_s, out = single(s_s, chunks[k])
        np.testing.assert_allclose(outs[k].numpy(), out.numpy(),
                                   atol=KHOP_ATOL)
    for name, a in s_m._asdict().items():
        b = getattr(s_s, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=KHOP_ATOL,
                                       err_msg=name)


def test_momo3_gated_plain_hop_matches_jax_kernel():
    """The training checkpoint with the daemon's auto gate (1 dB, width 6,
    'both'): the gated hop with the delta carry and the raw domain
    together, 12 bursty hops at B=4; the gate blends on some
    stream-hops."""
    from audio_denoising_torch.config import recommended_serving
    jcfg, jplan, cfg, plan, _ = _momo(REALNOISE)
    cfg = recommended_serving(cfg)
    jcfg = _gated(jcfg, cfg.serving.snr_gate_estimator,
                  cfg.serving.snr_gate_db, cfg.serving.snr_gate_width_db)
    B = 4
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True)
    hop = make_fused_hop(cfg, plan, device="cpu")
    js, s = jax_init_state(jcfg, jplan, B), fused_hop_init_state(cfg, plan, B)
    rng = np.random.default_rng(8)
    alphas = []
    for t in range(12):
        chunk = _bursty(rng, B, 21, t)
        js, jout = jax_hop(js, jnp.asarray(chunk))
        s, out = hop(s, torch.from_numpy(chunk))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=GATED_OUT_ATOL)
        alphas.append(hop.alpha(s).numpy())
    _assert_state_close(s, js)
    alphas = np.concatenate(alphas)
    assert np.any((alphas > 0) & (alphas < 1)), alphas.ravel()


# -- bf16 and W8A8 int8 compute (fused_hop.py:138-153, :205-223) -------------

REDUCED = {"bf16": (torch.bfloat16, jnp.bfloat16),
           "int8": (torch.int8, jnp.int8)}
# The port's plain version against JAX's interpret-mode kernel of the same
# compute dtype. Both round the same fp32 values to bf16 or int8, but XLA
# and PyTorch sum fp32 matmuls in other orders, so a value can land on the
# other side of a bf16 rounding tie or an int8 quant step: one element
# then moves by 2^-8 of itself (bf16) or 1/127 of its row's max (int8),
# and a step in hx is carried to later hops. Each limit sits between the
# worst reading of these tests and that of the control, the plain fp32
# hop in the reduced hop's place on the same inputs, which every test
# below also runs and which must miss the limit (on this CPU, over the
# tests' inputs): bf16 outputs within 3e-3 of each hop's largest |out|
# (worst 1.1e-3; control 1.1e-2 at best), planes ola, hx and prev within
# 1e-3 (worst 2.2e-4; control 5.0e-4 on MOMO3, 2.4e-3 on stream16k);
# int8 outputs above 45 dB per hop (worst 50.8 dB; control 34.4 dB at
# best), planes within 5e-3 (worst 3.2e-3); the ring is the input's,
# exact; the gate's planes relative 5e-3 (they read the bf16 DFT's
# magnitude).
REDUCED_BF16_RTOL = 3e-3
REDUCED_INT8_DB = 45.0
REDUCED_STATE_ATOL = {"bf16": 1e-3, "int8": 5e-3}
REDUCED_PLANE_RTOL = 5e-3


def _within(got, want, mode):
    """(within the mode's limit, the reading): in bf16 the largest error
    over the hop's largest |out|, in int8 the SNR in dB."""
    want = np.asarray(want).astype(np.float64)
    diff = np.asarray(got, np.float64) - want
    if mode == "bf16":
        err = float(np.abs(diff).max()) / max(float(np.abs(want).max()),
                                              1e-3)
        return err <= REDUCED_BF16_RTOL, err
    db = 10 * np.log10(max(float((want ** 2).sum()), 1e-20)
                       / max(float((diff ** 2).sum()), 1e-30))
    return db >= REDUCED_INT8_DB, db


def _close(got, want, mode):
    ok, reading = _within(got, want, mode)
    assert ok, reading


class _Control:
    """The plain fp32 hop run in the reduced hop's place on the same
    inputs (its own state); ``missed`` asserts the limits fail it."""

    def __init__(self, cfg, plan, B, K=1):
        self.hop = make_fused_hop(cfg, plan, device="cpu", hops_per_call=K)
        self.state = fused_hop_init_state(cfg, plan, B)
        self.readings = []

    def __call__(self, chunk, jouts, mode):
        self.state, outs = self.hop(self.state, torch.from_numpy(chunk))
        outs, jouts = outs.numpy(), np.asarray(jouts)
        if self.hop.hops_per_call == 1:
            outs, jouts = outs[None], jouts[None]
        self.readings += [_within(o, j, mode) for o, j in zip(outs, jouts)]

    def missed(self):
        assert not all(ok for ok, _ in self.readings), self.readings


def _reduced_state_close(state, jstate, mode):
    for name, t in state._asdict().items():
        if t is None:
            continue
        want = np.asarray(getattr(jstate, name))
        if name in ("ring", "ola", "hx", "prev"):
            np.testing.assert_allclose(t.numpy(), want,
                                       atol=REDUCED_STATE_ATOL[mode],
                                       err_msg=name)
        else:
            np.testing.assert_allclose(t.numpy(), want[:, :t.shape[1]],
                                       rtol=REDUCED_PLANE_RTOL,
                                       atol=PLANE_ATOL, err_msg=name)


@pytest.mark.parametrize("mode,batch", [("bf16", 4), ("bf16", 3),
                                        ("int8", 4), ("int8", 3)])
def test_reduced_plain_hop_matches_jax_kernel(plans, mode, batch):
    """8 hops on gruunet2-stream16k against make_fused_hop(...,
    interpret=True, compute_dtype=...), each carrying its own state."""
    jcfg, jplan, cfg, plan = plans
    tdt, jdt = REDUCED[mode]
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True, compute_dtype=jdt)
    hop = make_fused_hop(cfg, plan, device="cpu", compute_dtype=tdt)
    assert hop.cf.dtype == torch.float32 and torch.equal(
        hop.cf, hop.cf.bfloat16().float())
    js, s = jax_init_state(jcfg, jplan, batch), fused_hop_init_state(
        cfg, plan, batch)
    control = _Control(cfg, plan, batch)
    rng = np.random.default_rng(batch)
    for _ in range(8):
        chunk = (0.1 * rng.standard_normal((batch, 320))).astype(np.float32)
        js, jout = jax_hop(js, jnp.asarray(chunk))
        s, out = hop(s, torch.from_numpy(chunk))
        assert out.dtype == torch.float32
        _close(out.numpy(), jout, mode)
        control(chunk, jout, mode)
    _reduced_state_close(s, js, mode)
    control.missed()
    assert hop.launches == 0


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_reduced_gated_plain_hop_matches_jax_kernel(plans, mode):
    """The SNR gate (estimator 'both') in the reduced modes: 10 bursty
    hops at B=4, every plane (the gate itself is fp32)."""
    jcfg, jplan, cfg, plan = plans
    tdt, jdt = REDUCED[mode]
    jcfg, cfg = _gated(jcfg, "both"), _gated(cfg, "both")
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True, compute_dtype=jdt)
    hop = make_fused_hop(cfg, plan, device="cpu", compute_dtype=tdt)
    B = 4
    js, s = jax_init_state(jcfg, jplan, B), fused_hop_init_state(cfg, plan, B)
    control = _Control(cfg, plan, B)
    rng = np.random.default_rng(9)
    for t in range(10):
        chunk = _bursty(rng, B, 320, t)
        js, jout = jax_hop(js, jnp.asarray(chunk))
        s, out = hop(s, torch.from_numpy(chunk))
        _close(out.numpy(), jout, mode)
        control(chunk, jout, mode)
    _reduced_state_close(s, js, mode)
    control.missed()


@pytest.mark.parametrize("case", ["bf16", "int8", "int8-int16"])
def test_reduced_multi_hop_matches_jax_kernel(plans, case):
    """K=4 hops in one call at B=3, two calls carrying the state, against
    JAX's resident kernel of the same compute dtype; with int16 IO at most
    1 LSB apart."""
    jcfg, jplan, cfg, plan = plans
    mode = case.split("-")[0]
    tdt, jdt = REDUCED[mode]
    pcm = case.endswith("int16")
    K, B, hop_len = 4, 3, cfg.dsp.hop_length
    jax_multi = jax_make_hop(jcfg, jplan, interpret=True, hops_per_call=K,
                             compute_dtype=jdt,
                             io_dtype=jnp.int16 if pcm else jnp.float32)
    multi = make_fused_hop(cfg, plan, device="cpu", hops_per_call=K,
                           compute_dtype=tdt,
                           io_dtype=torch.int16 if pcm else torch.float32)
    rng = np.random.default_rng(10)
    js, s = jax_init_state(jcfg, jplan, B), fused_hop_init_state(cfg, plan, B)
    control = _Control(cfg, plan, B, K)
    for _ in range(2):
        chunks = (_pcm(rng, K, B, hop_len) if pcm else
                  np.stack([_bursty(rng, B, hop_len, t) for t in range(K)]))
        js, jouts = jax_multi(js, jnp.asarray(chunks))
        s, outs = multi(s, torch.from_numpy(chunks))
        assert outs.shape == (K, B, hop_len)
        if pcm:
            diff = np.abs(outs.numpy().astype(np.int32)
                          - np.asarray(jouts).astype(np.int32))
            assert diff.max() <= LSB
        else:
            for k in range(K):
                _close(outs[k].numpy(), jouts[k], mode)
            control(chunks, jouts, mode)
    _reduced_state_close(s, js, mode)
    if not pcm:
        control.missed()


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_reduced_multi_hop_equals_single_hops(plans, mode):
    """On the CPU a K-hop call is K single hops of the plain version in
    the same compute dtype: exactly equal."""
    _, _, cfg, plan = plans
    tdt, _ = REDUCED[mode]
    K, B = 4, 3
    multi = make_fused_hop(cfg, plan, device="cpu", hops_per_call=K,
                           compute_dtype=tdt)
    single = make_fused_hop(cfg, plan, device="cpu", compute_dtype=tdt)
    chunks = torch.from_numpy(np.stack([
        _bursty(np.random.default_rng(11), B, 320, t) for t in range(K)]))
    s_m, outs = multi(fused_hop_init_state(cfg, plan, B), chunks)
    s_s = fused_hop_init_state(cfg, plan, B)
    for k in range(K):
        s_s, out = single(s_s, chunks[k])
        assert torch.equal(outs[k], out)
    for a, b in zip(s_m, s_s):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_momo3_reduced_plain_hop_matches_jax_kernel(momo, mode):
    """MOMO3 (raw domain, delta carry) in the reduced modes, 8 hops at
    B=3: in int8 level 0 quantizes x and prev each with its own row scale
    (common.py:128-136); every plane, prev included."""
    jcfg, jplan, cfg, plan, _ = momo
    tdt, jdt = REDUCED[mode]
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True, compute_dtype=jdt)
    hop = make_fused_hop(cfg, plan, device="cpu", compute_dtype=tdt)
    B = 3
    js, s = jax_init_state(jcfg, jplan, B), fused_hop_init_state(cfg, plan, B)
    control = _Control(cfg, plan, B)
    for chunk in _momo_chunks(np.random.default_rng(12), 8, B):
        js, jout = jax_hop(js, jnp.asarray(chunk))
        s, out = hop(s, torch.from_numpy(chunk))
        _close(out.numpy(), jout, mode)
        control(chunk, jout, mode)
    _reduced_state_close(s, js, mode)
    control.missed()


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_momo3_reduced_multi_hop_matches_jax_kernel(momo, mode):
    """K=4 hops in one call at B=3 on MOMO3, against JAX's resident
    kernel of the same compute dtype."""
    jcfg, jplan, cfg, plan, _ = momo
    tdt, jdt = REDUCED[mode]
    K, B = 4, 3
    jax_multi = jax_make_hop(jcfg, jplan, interpret=True, hops_per_call=K,
                             compute_dtype=jdt)
    multi = make_fused_hop(cfg, plan, device="cpu", hops_per_call=K,
                           compute_dtype=tdt)
    js, s = jax_init_state(jcfg, jplan, B), fused_hop_init_state(cfg, plan, B)
    chunks = _momo_chunks(np.random.default_rng(13), K, B)
    js, jouts = jax_multi(js, jnp.asarray(chunks))
    s, outs = multi(s, torch.from_numpy(chunks))
    for k in range(K):
        _close(outs[k].numpy(), jouts[k], mode)
    control = _Control(cfg, plan, B, K)
    control(chunks, jouts, mode)
    _reduced_state_close(s, js, mode)
    control.missed()


@pytest.mark.parametrize("case", ["bf16", "int8", "momo3-int8"])
def test_reduced_hop_agrees_with_fp32(plans, momo, case):
    """The port's own bounds of each variant against its fp32 hop, as
    JAX's tests hold its kernel (tests/test_fused_hop.py): bf16 within
    5e-2 of each hop's largest |out| and hx within 5e-2 over 4 hops; int8
    above 25 dB per hop over 15 hops; MOMO3 int8 (raw domain, small delta
    features) above 15 dB over 10 hops."""
    if case.startswith("momo3"):
        _, _, cfg, plan, _ = momo
    else:
        _, _, cfg, plan = plans
    mode = case.split("-")[-1]
    hops = {"bf16": 4, "int8": 15, "momo3-int8": 10}[case]
    f32 = make_fused_hop(cfg, plan, device="cpu")
    low = make_fused_hop(cfg, plan, device="cpu",
                         compute_dtype=REDUCED[mode][0])
    B, hop_len = 4, cfg.dsp.hop_length
    s0 = s1 = fused_hop_init_state(cfg, plan, B)
    rng = np.random.default_rng(14)
    worst_rel, worst_db = 0.0, np.inf
    for _ in range(hops):
        chunk = torch.from_numpy(
            (0.1 * rng.standard_normal((B, hop_len))).astype(np.float32))
        s0, o0 = f32(s0, chunk)
        s1, o1 = low(s1, chunk)
        worst_rel = max(worst_rel, float((o0 - o1).abs().max())
                        / max(float(o0.abs().max()), 1e-3))
        num = float(((o0 - o1) ** 2).sum())
        worst_db = min(worst_db, 10 * np.log10(float((o0 ** 2).sum())
                                               / max(num, 1e-20)))
    if mode == "bf16":
        assert worst_rel < 5e-2, worst_rel
        np.testing.assert_allclose(s1.hx.numpy(), s0.hx.numpy(), atol=5e-2)
    else:
        assert worst_db > (15.0 if case.startswith("momo3") else 25.0), \
            worst_db


@pytest.mark.parametrize("case", ["bf16", "int8", "momo3-bf16",
                                  "momo3-int8"])
def test_reduced_cell_math_matches_jax(plans, momo, case):
    """plan_cell_math in the reduced dtypes against JAX's plan_cell_math
    (common.py:56-160) called directly on the same packed weights and
    inputs, one step: in bf16 the products are exact in fp32 and only the
    order of addition differs; in int8 the integer sums are exact, so
    only a value on a quant step's tie could differ."""
    from audio_denoising_tpu.ops.pallas.common import (
        pack_plan_weights as jax_pack, plan_cell_math as jax_cell)
    from audio_denoising_torch.ops.kernels.common import (
        pack_plan_weights, plan_cell_math)
    if case.startswith("momo3"):
        _, jplan, _, plan, _ = momo
    else:
        _, jplan, _, plan = plans
    mode = case.split("-")[-1]
    tdt, jdt = REDUCED[mode]
    quantize = mode == "int8"
    jw, flags = jax_pack(jplan, quantize=quantize)
    if mode == "bf16":
        jw = [w.astype(jnp.bfloat16) if w.shape[0] > 1 else w for w in jw]
    w, tflags = pack_plan_weights(plan, quantize=quantize)
    if mode == "bf16":
        w = [t.bfloat16() if t.dim() == 2 else t for t in w]
    assert list(flags) == list(tflags)
    n = plan.hidden * plan.compressed
    feat = plan.up_h_mats[-1].shape[1]
    rng = np.random.default_rng(15)
    B = 3
    x = (np.abs(rng.standard_normal((B, feat))) * 1.5).astype(np.float32)
    hx = (0.5 * rng.standard_normal((B, n))).astype(np.float32)
    prev = ((np.abs(rng.standard_normal((B, feat))) * 0.3).astype(np.float32)
            if plan.delta else None)
    jy, jhi = jax_cell(jw, flags, n, feat, plan.delta, jnp.asarray(x),
                       jnp.asarray(hx),
                       None if prev is None else jnp.asarray(prev),
                       compute_dtype=jdt)
    y, hi = plan_cell_math(w, tflags, n, torch.from_numpy(x),
                           torch.from_numpy(hx),
                           prev=None if prev is None else torch.from_numpy(
                               prev), compute_dtype=tdt)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), atol=1e-5)


@pytest.mark.parametrize("spec", [SPEC, MOMO_SPEC])
def test_pack_plan_weights_quantized_equals_jax(spec):
    """pack_plan_weights(plan, quantize=True): every matrix slot is (int8
    matrix, (1, cols) fp32 column scale row), equal to JAX's; biases as
    they were."""
    from audio_denoising_tpu.ops.pallas.common import (
        pack_plan_weights as jax_pack)
    from audio_denoising_torch.ops.kernels.common import pack_plan_weights
    jcfg, jmodel, params = jax_load_pretrained(spec)
    jplan = (jax_build_cell_plan_momo(jmodel, params) if spec == MOMO_SPEC
             else jax_build_cell_plan(jmodel, params))
    jw, jflags = jax_pack(jplan, quantize=True)
    w, flags = pack_plan_weights(plan_from_numpy(jplan), quantize=True)
    assert list(flags) == list(jflags) and len(w) == len(jw)
    for a, b in zip(w, jw):
        b = np.asarray(b)
        if a.dtype == torch.int8:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_array_equal(a.numpy().reshape(b.shape), b)


def test_plan_args_q_pads_and_splits_the_delta_matrix(momo):
    """The int8 kernel operands: rows and columns padded to multiples of
    4 with zeros; MOMO3's level-0 matrix laid out as its x rows, padded,
    then its prev rows, padded; the scale rows padded alike."""
    from audio_denoising_torch.ops.kernels.common import (
        pack_plan_weights, plan_args_q)
    _, _, _, plan, _ = momo
    w, flags = pack_plan_weights(plan, quantize=True)
    keep = []
    p, sc = plan_args_q(w, flags, 22, plan.hidden * plan.compressed, keep,
                        delta=True)
    by_ptr = {t.data_ptr(): t for t in keep}
    q0, s0 = w[0], w[1]
    f, cols = 22, q0.shape[1]
    got = by_ptr[p.down_w[0]]
    r4 = lambda v: (v + 3) // 4 * 4
    assert tuple(got.shape) == (2 * r4(f), r4(cols))
    assert torch.equal(got[:f, :cols], q0[:f])
    assert torch.equal(got[r4(f):r4(f) + f, :cols], q0[f:])
    assert not got[f:r4(f)].any() and not got[:, cols:].any()
    scale = by_ptr[sc.down[0]]
    assert tuple(scale.shape) == (1, r4(cols))
    assert torch.equal(scale[0, :cols], s0[0])
    assert p.down_n[0] == 2 * f and p.delta == 1
    for i in range(p.levels):
        m = by_ptr[p.up_w[i]]
        assert m.shape[0] % 4 == 0 and m.shape[1] % 4 == 0
        assert (p.up_s[i] is None) == (sc.skip[i] is None)

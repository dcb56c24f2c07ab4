"""The port's W8A8 int8 serving plan (runtime/quant.py) against the JAX
package's runtime/quant.py on the same numpy inputs: quantize_mat and
qdot exactly, plan_cell_q over a rollout, plan_apply_parallel_q,
PlanModel(quantized=True) (MOMO3's delta with its single row scale), and
StreamEngine mode 'fast' at serving.dtype 'int8' (and 'bfloat16', which
mode 'fast' serves in fp32, as JAX's fast step does)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.runtime import quant as jq
from audio_denoising_tpu.runtime.engine import StreamEngine as JaxEngine
from audio_denoising_tpu.runtime.plan import (
    PlanModel as JaxPlanModel, build_cell_plan as jax_build_cell_plan,
    build_cell_plan_momo as jax_build_cell_plan_momo)

from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.runtime import quant
from audio_denoising_torch.runtime.engine import StreamEngine
from audio_denoising_torch.runtime.plan import (
    PlanModel, plan_cell, plan_from_numpy)

SPEC = "gruunet2-good"
MOMO_SPEC = "momo3-4d4ea0"
# The port against JAX on the same quantized plan: both sum the int8
# products exactly and round each sum once, so a dot agrees bit for bit on
# equal inputs. Over a recurrent rollout the fp32 gating (XLA's and
# PyTorch's sigmoid and tanh differ in the last ulp) can move a value
# across a rounding tie of the next frame's quantization: one quant step
# (1/127 of the row's max) in one element. CELL_ATOL holds y and hx with
# room for a few such steps; a wrong scale or rounding misses by 1e-2.
CELL_ATOL = 2e-4
# The engines add the DSP around the cell: tests/test_fused_hop.py's bound
ENGINE_ATOL = 2e-4


@pytest.fixture(scope="module")
def good():
    jcfg, jmodel, jparams = jax_load_pretrained(SPEC)
    jplan = jax_build_cell_plan(jmodel, jparams)
    cfg, model = load_pretrained(SPEC)
    return (jcfg, jmodel, jparams, jplan), (cfg, model, plan_from_numpy(jplan))


@pytest.fixture(scope="module")
def momo():
    jcfg, jmodel, jparams = jax_load_pretrained(MOMO_SPEC)
    jplan = jax_build_cell_plan_momo(jmodel, jparams)
    cfg, model = load_pretrained(MOMO_SPEC)
    return (jcfg, jmodel, jparams, jplan), (cfg, model, plan_from_numpy(jplan))


def _matrix(rng, rows, cols):
    """Columns of spread scales, one all-zero column (scale 1)."""
    m = rng.standard_normal((rows, cols)) * rng.uniform(0.01, 10, (1, cols))
    m[:, 3] = 0.0
    return m.astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 48), (7, 5)])
def test_quantize_mat_equals_jax(shape):
    m = _matrix(np.random.default_rng(1), *shape)
    want = jq.quantize_mat(jnp.asarray(m))
    got = quant.quantize_mat(torch.from_numpy(m))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert float(got.scale[3]) == 1.0 and not got.q[:, 3].any()


@pytest.mark.parametrize("rows", [64, 2048])
def test_qdot_is_bit_equal_to_jax(rows):
    """On identical inputs, bit for bit, with a zero row (scale 1); at
    2048 rows of full-scale values the integer sums pass 2^24, where an
    fp32 product would round and the exact sum rounds once."""
    rng = np.random.default_rng(rows)
    m = _matrix(rng, rows, 40)
    x = (rng.standard_normal((6, rows)) * 3.0).astype(np.float32)
    x[2] = 0.0
    if rows == 2048:   # full-scale values; row 0 aligned with column 0
        m = np.sign(m) * np.abs(m).max(axis=0, keepdims=True)
        x = np.sign(x) * 3.0
        x[0] = 3.0 * np.sign(m[:, 0])
    want = jq.qdot(jnp.asarray(x), jq.quantize_mat(jnp.asarray(m)))
    got = quant.qdot(torch.from_numpy(x),
                     quant.quantize_mat(torch.from_numpy(m)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if rows == 2048:
        xq, _ = quant.quantize_rows(torch.from_numpy(x))
        acc = xq.double() @ quant.quantize_mat(
            torch.from_numpy(m)).q.double()
        assert float(acc.abs().max()) > 2 ** 24


def test_plan_cell_q_matches_jax_over_a_rollout(good):
    """20 frames, each port's state fed back to itself, y and hx held
    every frame (CELL_ATOL); the int8 plan tracks the fp32 plan above
    20 dB per frame, as tests/test_quant.py holds JAX's."""
    (_, _, _, jplan), (_, _, plan) = good
    jqplan, qplan = jq.quantize_plan(jplan), quant.quantize_plan(plan)
    rng = np.random.default_rng(2)
    B, n = 4, plan.hidden * plan.compressed
    jh = jnp.zeros((B, n), jnp.float32)
    h = h32 = torch.zeros(B, n)
    worst = np.inf
    for _ in range(20):
        x = (np.abs(rng.standard_normal((B, 64))) * 1.5).astype(np.float32)
        jy, jh = jq.plan_cell_q(jqplan, jnp.asarray(x), jh)
        y, h = quant.plan_cell_q(qplan, torch.from_numpy(x), h)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=CELL_ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=CELL_ATOL)
        y32, h32 = plan_cell(plan, torch.from_numpy(x), h32)
        err = float(((y32 - y) ** 2).sum())
        worst = min(worst, 10 * np.log10(float((y32 ** 2).sum())
                                         / max(err, 1e-20)))
    assert worst > 20.0, worst


def test_plan_apply_parallel_q_matches_the_cell_and_jax(good):
    """The sequence form lifts the encoder and decoder out of the scan:
    per-row scales and exact integer sums make it equal the cell frame by
    frame; and it matches JAX's plan_apply_parallel_q."""
    (_, _, _, jplan), (_, _, plan) = good
    qplan = quant.quantize_plan(plan)
    rng = np.random.default_rng(3)
    B, T, n = 2, 6, plan.hidden * plan.compressed
    x = (np.abs(rng.standard_normal((B, T, 64))) * 1.5).astype(np.float32)
    y_seq, h_seq = quant.plan_apply_parallel_q(qplan, torch.from_numpy(x),
                                               torch.zeros(B, n))
    h = torch.zeros(B, n)
    for t in range(T):
        y_t, h = quant.plan_cell_q(qplan, torch.from_numpy(x[:, t]), h)
        np.testing.assert_array_equal(y_seq[:, t].numpy(), y_t.numpy())
    np.testing.assert_array_equal(h_seq.numpy(), h.numpy())
    jy, jh = jq.plan_apply_parallel_q(jq.quantize_plan(jplan),
                                      jnp.asarray(x),
                                      jnp.zeros((B, n), jnp.float32))
    np.testing.assert_allclose(y_seq.numpy(), np.asarray(jy), atol=CELL_ATOL)
    np.testing.assert_allclose(h_seq.numpy(), np.asarray(jh), atol=CELL_ATOL)


def test_plan_model_quantized_matches_jax(good):
    """PlanModel(quantized=True): the zoo interface on the W8A8 plan,
    apply (sequence) and cell (one frame) against JAX's; it refuses
    fused=True, as JAX's does."""
    (_, jmodel, jparams, _), (_, model, _) = good
    jpm = JaxPlanModel(jmodel, jparams, quantized=True)
    pm = PlanModel(model, device="cpu", quantized=True)
    assert pm.quantized and pm.fused_cell is None
    rng = np.random.default_rng(4)
    x = (np.abs(rng.standard_normal((2, 5, 64))) * 1.5).astype(np.float32)
    jy, jh = jpm.apply(None, jnp.asarray(x))
    y, h = pm.apply(torch.from_numpy(x))
    assert y.shape == (2, 5, 64) and bool(torch.isfinite(y).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=CELL_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=CELL_ATOL)
    jy1, _ = jpm.cell(None, jnp.asarray(x[:, 0]), jpm.init_carry(2))
    y1, _ = pm.cell(torch.from_numpy(x[:, 0]), pm.init_carry(2))
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), atol=CELL_ATOL)
    with pytest.raises(ValueError, match="fused"):
        PlanModel(model, device="cpu", quantized=True, fused=True)


def test_plan_model_quantized_momo3_delta_scale(momo):
    """MOMO3's delta plan quantizes cat(x, prev) with one row scale
    (quant.py:93): the port's cell equals JAX's, and differs from the
    fused hop's split (x and prev each with its own scale) when prev's
    range is not x's."""
    from audio_denoising_torch.ops.kernels.common import (
        pack_plan_weights, plan_cell_math)
    (_, jmodel, jparams, _), (_, model, plan) = momo
    jpm = JaxPlanModel(jmodel, jparams, quantized=True)
    pm = PlanModel(model, device="cpu", quantized=True)
    assert pm.qplan.delta
    rng = np.random.default_rng(5)
    B, F = 3, model.num_bins
    x = (np.abs(rng.standard_normal((B, F))) * 1.5).astype(np.float32)
    prev = (np.abs(rng.standard_normal((B, F))) * 0.1).astype(np.float32)
    hx, _ = pm.init_carry(B)
    jy, (jh, jprev) = jpm.cell(None, jnp.asarray(x),
                               (jnp.zeros(tuple(hx.shape)), jnp.asarray(prev)))
    y, (h, prev_out) = pm.cell(torch.from_numpy(x),
                               (hx, torch.from_numpy(prev)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=CELL_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=CELL_ATOL)
    assert torch.equal(prev_out, torch.from_numpy(x))
    w, flags = pack_plan_weights(plan, quantize=True)
    y_split, _ = plan_cell_math(w, flags, plan.hidden * plan.compressed,
                                torch.from_numpy(x), hx,
                                prev=torch.from_numpy(prev),
                                compute_dtype=torch.int8)
    assert float((y_split - y).abs().max()) > 1e-4


def _int8(cfg):
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, dtype="int8"))


def test_engine_fast_int8_matches_jax(good):
    """serving.dtype 'int8' in mode 'fast': both engines swap the zoo
    model for the quantized plan; 2 slots over 10 ticks, 'b' idling on
    ticks 3-5 with its state bit-identical; and the int8 engine tracks
    the fp32 engine above 25 dB (tests/test_quant.py's bound)."""
    (jcfg, jmodel, jparams, _), (cfg, model, _) = good
    jeng = JaxEngine(_int8(jcfg), jmodel, jparams, mode="fast",
                     max_streams=2)
    eng = StreamEngine(_int8(cfg), model, mode="fast", max_streams=2,
                       device="cpu")
    f32 = StreamEngine(cfg, model, mode="fast", max_streams=2, device="cpu")
    for e in (jeng, eng, f32):
        e.add_stream("a")
        e.add_stream("b")
    rng = np.random.default_rng(6)
    hop = cfg.dsp.hop_length
    outs_q, outs_f = [], []
    for t in range(10):
        chunks = {"a": (0.1 * rng.standard_normal(hop)).astype(np.float32)}
        if not 3 <= t <= 5:
            chunks["b"] = (0.1 * rng.standard_normal(hop)).astype(np.float32)
        before = eng.state.hx[eng.slots["b"]].clone()
        want, got, ref = (jeng.process(chunks), eng.process(chunks),
                          f32.process(chunks))
        for sid in chunks:
            np.testing.assert_allclose(got[sid], want[sid], atol=ENGINE_ATOL)
        if "b" not in chunks:
            assert torch.equal(eng.state.hx[eng.slots["b"]], before)
        outs_q.append(got["a"])
        outs_f.append(ref["a"])
    a, b = np.concatenate(outs_f)[2 * hop:], np.concatenate(outs_q)[2 * hop:]
    agree = 10 * np.log10(np.sum(a ** 2) / max(np.sum((a - b) ** 2), 1e-20))
    assert agree > 25.0, agree


def test_engine_fast_bfloat16_serves_fp32(good):
    """JAX's make_fast_step ignores serving.dtype 'bfloat16', so mode
    'fast' serves fp32 there: the port's bf16 engine equals its fp32
    engine bit for bit."""
    _, (cfg, model, _) = good
    b16 = dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, dtype="bfloat16"))
    engines = [StreamEngine(c, model, mode="fast", max_streams=2,
                            device="cpu") for c in (cfg, b16)]
    rng = np.random.default_rng(7)
    for e in engines:
        e.add_stream("a")
    for _ in range(3):
        chunk = {"a": (0.1 * rng.standard_normal(cfg.dsp.hop_length)
                       ).astype(np.float32)}
        f32, bf = (e.process(chunk)["a"] for e in engines)
        np.testing.assert_array_equal(bf, f32)


def test_engine_fast_int8_refuses_an_unquantized_plan_model(good):
    _, (cfg, model, _) = good
    with pytest.raises(ValueError, match="quantized plan"):
        StreamEngine(_int8(cfg), PlanModel(model, device="cpu"),
                     mode="fast", max_streams=2, device="cpu")
    eng = StreamEngine(_int8(cfg), PlanModel(model, device="cpu",
                                             quantized=True),
                       mode="fast", max_streams=2, device="cpu")
    assert eng.mode == "fast"

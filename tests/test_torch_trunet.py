"""The port's TRUNet against the JAX package on the CPU: ``GRU`` (against
the reference's golden and JAX's GRU, bidirectional and stacked), the
grouped ``conv1d`` of TRUNet's depthwise convs, inference BatchNorm,
``TRUNet`` (the golden; JAX's apply on the same weights, ``_pad_cat``'s
crop included) and ``TRUNetDenoiser`` on ``runs/trunet-realnoise.npz``
through both hubs: the image in, image out surface,
``offline_denoise_stateless``, ``offline_denoise_streamed`` and
``StreamEngine`` mode 'unet' at the class-default geometry (TRUNet is
not in SEGMENT_ARCHS, so nothing replaces it). The same numpy inputs, made
from a seed, go through both packages."""

import json
import os
from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu.config import (
    recommended_streaming_geometry as jax_recommended_geometry)
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.models.gru import GRU as JaxGRU
from audio_denoising_tpu.models.trunet import (
    TRUNet as JaxTRUNet, batch_norm_1d as jax_batch_norm)
from audio_denoising_tpu.ops import convs as jax_convs
from audio_denoising_tpu import pipeline as jax_pipeline
from audio_denoising_tpu.runtime.engine import StreamEngine as JaxEngine

from audio_denoising_torch.compat import params_from_jax
from audio_denoising_torch.config import (
    ModelConfig, recommended_streaming_geometry)
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.models import (
    GRU, TRUNet, TRUNetDenoiser, build_model)
from audio_denoising_torch.models.trunet import BatchNorm1d
from audio_denoising_torch.ops.convs import conv1d
from audio_denoising_torch.pipeline import (
    offline_denoise_stateless, offline_denoise_streamed)
from audio_denoising_torch.runtime.engine import StreamEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
TRUNET = os.path.join(REPO, "runs", "trunet-realnoise.npz")
GOLDEN_TOL = dict(atol=5e-5, rtol=1e-4)   # tests/test_models.py's bound
ATOL = 1e-5          # a layer or the network against JAX (measured <= 1e-6)
OUT_ATOL = 1e-5      # waveforms against JAX (measured <= 3e-7)


def _golden(name):
    g = np.load(os.path.join(GOLD, f"model_{name}-rand.npz"))
    return g, {k[3:]: g[k] for k in g.files if k.startswith("sd.")}


@pytest.fixture(scope="module")
def trunet():
    jcfg, jmodel, jparams = jax_load_pretrained(TRUNET)
    cfg, model = load_pretrained(TRUNET)
    return jcfg, jmodel, jparams, cfg, model


# -- the building blocks -------------------------------------------------------

def test_gru_matches_golden():
    g, sd = _golden("GRU")
    model = GRU(12, 20, num_layers=2)
    model.load_state_dict(params_from_jax(sd))
    with torch.no_grad():
        out, h = model.apply(torch.from_numpy(g["x"]))
    np.testing.assert_allclose(out.numpy(), g["out"], **GOLDEN_TOL)
    np.testing.assert_allclose(h.numpy(), g["h"], **GOLDEN_TOL)


@pytest.mark.parametrize("layers,bidirectional", [(1, True), (2, True),
                                                   (2, False)])
def test_gru_matches_jax(layers, bidirectional):
    """Random torch-layout weights and an initial state through both GRUs:
    outputs (both directions, in input order) and every final state."""
    rng = np.random.default_rng(20 + layers)
    model = GRU(6, 9, num_layers=layers, bidirectional=bidirectional)
    sd = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
          for k, v in model.state_dict().items()}
    model.load_state_dict(params_from_jax(sd))
    nd = 2 if bidirectional else 1
    x = rng.standard_normal((4, 7, 6)).astype(np.float32)
    h0 = rng.standard_normal((layers * nd, 4, 9)).astype(np.float32)
    with torch.no_grad():
        out, h = model.apply(torch.from_numpy(x), torch.from_numpy(h0))
    jout, jh = JaxGRU(6, 9, num_layers=layers,
                      bidirectional=bidirectional).apply(
        {k: jnp.asarray(v) for k, v in sd.items()}, jnp.asarray(x),
        jnp.asarray(h0))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)


@pytest.mark.parametrize("k,s", [(3, 1), (5, 2), (3, 2)])
def test_depthwise_conv_and_batch_norm_match_jax(k, s):
    """TRUNet's depthwise conv (groups = channels, padding k // 2) and
    inference BatchNorm against JAX's conv1d and batch_norm_1d."""
    rng = np.random.default_rng(k * 10 + s)
    x = rng.standard_normal((3, 8, 33)).astype(np.float32)
    w = rng.standard_normal((8, 1, k)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    got = conv1d(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(b), stride=s, padding=k // 2,
                 groups=8).numpy()
    want = np.asarray(jax_convs.conv1d(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), stride=s,
                                       padding=k // 2, groups=8))
    np.testing.assert_allclose(got, want, atol=ATOL)
    bn = BatchNorm1d(8)
    stats = {"weight": rng.standard_normal(8), "bias": rng.standard_normal(8),
             "running_mean": rng.standard_normal(8),
             "running_var": 0.5 + rng.random(8)}
    bn.load_state_dict(params_from_jax(stats))
    with torch.no_grad():
        got = bn(torch.from_numpy(x)).numpy()
    want = jax_batch_norm(jnp.asarray(x), {f"bn.{k}": jnp.asarray(
        v, jnp.float32) for k, v in stats.items()}, "bn")
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


# -- the network -----------------------------------------------------------------

def test_trunet_matches_golden_and_jax():
    """The reference's random-weight golden (its BatchNorm counters
    dropped), then JAX's TRUNet.apply on the same weights."""
    g, sd = _golden("TRUNet")
    model = TRUNet().load_params(params_from_jax(sd))
    assert not any(k.endswith("num_batches_tracked")
                   for k in model.state_dict())
    with torch.no_grad():
        got = model.apply(torch.from_numpy(g["x"])).numpy()
    assert got.shape == g["out"].shape == (2, 5, 257)
    np.testing.assert_allclose(got, g["out"], **GOLDEN_TOL)
    want = jax.jit(JaxTRUNet().apply)(
        {k: jnp.asarray(v) for k, v in sd.items()}, jnp.asarray(g["x"]))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("bins", [257, 250])
def test_trunet_pad_cat_crops_as_jax(bins):
    """The decoder overshoots its skips (up2 gives 67 frames against 65
    at 257 bins, 63 against 62 at 250) and F.pad with negative pads crops
    (trunet.py:95-98), an even and an odd crop: against JAX's."""
    _g, sd = _golden("TRUNet")
    model = TRUNet().load_params(params_from_jax(sd))
    x = np.random.default_rng(bins).standard_normal((3, 4, bins)).astype(
        np.float32)
    with torch.no_grad():
        got = model.apply(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(JaxTRUNet().apply)(
        {k: jnp.asarray(v) for k, v in sd.items()}, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_trunet_denoiser_matches_jax(trunet):
    """runs/trunet-realnoise.npz through both hubs: the same config, the
    registry's bin count, and a (B, F, T) log-magnitude image's residual
    within ATOL of JAX's (B * T frames through the network)."""
    jcfg, jmodel, jparams, cfg, model = trunet
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())
    assert isinstance(model, TRUNetDenoiser) and model.num_bins == 257
    assert build_model(ModelConfig(arch="TRUNetDenoiser")).num_bins == 257
    assert isinstance(build_model(ModelConfig(arch="TRUNet")), TRUNet)
    assert model.compatible_frames(37) == jmodel.compatible_frames(37) == 37
    rng = np.random.default_rng(30)
    img = np.log1p(np.abs(rng.standard_normal((2, 257, 11)))).astype(
        np.float32)
    with torch.no_grad():
        got = model.apply(torch.from_numpy(img)).numpy()
    want = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(img)))
    assert got.shape == want.shape == img.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


# -- the paths ---------------------------------------------------------------------

def test_trunet_offline_paths_match_jax(trunet):
    """offline_denoise_stateless over 0.5 s at 16 kHz and
    offline_denoise_streamed at the class-default geometry (16-hop
    segments, 960 samples of context on each side), against JAX."""
    jcfg, jmodel, jparams, cfg, model = trunet
    assert recommended_streaming_geometry(cfg) is cfg
    assert jax_recommended_geometry(jcfg) is jcfg
    rng = np.random.default_rng(31)
    audio = (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)
    got = offline_denoise_stateless(cfg, model, torch.from_numpy(audio))
    want = jax.jit(partial(jax_pipeline.offline_denoise_stateless, jcfg,
                           jmodel))(jparams, jnp.asarray(audio))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL)
    got = offline_denoise_streamed(cfg, model, torch.from_numpy(audio))
    want = jax.jit(partial(jax_pipeline.offline_denoise_streamed, jcfg,
                           jmodel))(jparams, jnp.asarray(audio))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL)


def test_trunet_engine_matches_jax(trunet):
    """Mode 'unet' on TRUNetDenoiser over 2 cycles (32 ticks): 'b' misses
    every fifth tick, the latency is seg + ctx, outputs within OUT_ATOL of
    JAX's engine."""
    jcfg, jmodel, jparams, cfg, model = trunet
    jeng = JaxEngine(jcfg, jmodel, jparams, mode="unet", max_streams=3)
    eng = StreamEngine(cfg, model, mode="unet", max_streams=3, device="cpu")
    assert eng.algorithmic_latency_samples == \
        jeng.algorithmic_latency_samples == 16 * 256 + 960
    rng = np.random.default_rng(32)
    for e in (jeng, eng):
        e.add_stream("a")
        e.add_stream("b")
    for t in range(32):
        chunks = {s: (0.1 * rng.standard_normal(256)).astype(np.float32)
                  for s in ("a", "b") if not (s == "b" and t % 5 == 2)}
        got, want = eng.process(chunks), jeng.process(chunks)
        for s in chunks:
            np.testing.assert_allclose(got[s], np.asarray(want[s]),
                                       atol=OUT_ATOL)

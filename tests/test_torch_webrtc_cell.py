"""The WebRTC hop's cell stage on the CPU (``csrc/webrtc_hop.cu``
``cell_stage_frames`` and the walk choice in ``ops/kernels/webrtc_hop.py``):
the batched walk's plain mirror (``cell_frames_math``: the encoder chain and
the decoder's skip products once over the three frames, then frame by frame
the reset gate, the GRU update and each decoder level's ``h @ up_w`` added
to its skip product) against JAX's ``plan_cell_math`` run three times with
hx carried and against the port's plain cell; the walk each configuration
gets (``cell_walk``); and the shared-memory count the engine reads, which
keeps every shipped checkpoint's serving mode. The kernel itself is held
against its plain version on the card by chip_smoke.py."""

import dataclasses
import glob
import os
import types
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu.config import ModelConfig as JaxModelConfig
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.models import build_model as jax_build_model
from audio_denoising_tpu.ops.pallas.common import (
    pack_plan_weights as jax_pack_plan_weights,
    plan_cell_math as jax_plan_cell_math)
from audio_denoising_tpu.runtime.plan import (
    build_cell_plan as jax_build_cell_plan)

from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.ops.kernels.common import (
    pack_plan_weights, plan_cell_math, plan_shape)
from audio_denoising_torch.ops.kernels.webrtc_hop import (
    FRAMES, cell_walk, webrtc_hop_smem_bytes)
from audio_denoising_torch.runtime import engine as engine_mod
from audio_denoising_torch.runtime.plan import (
    build_cell_plan, gru_update, plan_from_numpy)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.join(HERE, "..")
SMEM_LIMIT = 232448  # an H100 block's opt-in shared memory, bytes
REL = 1e-5           # each output against JAX's, relative to its largest |v|
FLAGSHIP = os.path.join(REPO, "runs", "gruunet2mel128w64-mrstft-50k.npz")


def cell_frames_math(w, skip_flags, n, x, hx):
    """The batched walk of csrc/webrtc_hop.cu's cell stage in plain
    PyTorch: the cell steps of the frames of ``x`` (B, T, feat), carrying
    ``hx`` (B, n), with the matmuls that read no state run once over all
    B T rows (the encoder chain and each decoder level's skip product),
    then frame by frame the reset gate, the GRU update and each decoder
    level's ``h @ up_w`` added to its skip product, then the bias. ``w``,
    ``skip_flags``: pack_plan_weights's. Returns (y (B, T, feat), hi (B,
    n) after the last frame): T steps of ``plan_cell_math``, with the
    decoder's sums in another order."""
    L = len(skip_flags)
    it = iter(w)
    B, T = x.shape[:2]
    h = x.reshape(B * T, -1)
    acts = [h]
    for _ in range(L):
        m, b = next(it), next(it)
        h = torch.relu(h @ m + b)
        acts.append(h)
    gate_x = h.reshape(B, T, -1)
    reset, reset_b = next(it), next(it)
    levels = []
    for i in range(L):
        m, b = next(it), next(it)
        skip = (acts[L - i] @ next(it)).reshape(B, T, -1) \
            if skip_flags[i] else None
        levels.append((m, b, skip))
    ys = []
    for t in range(T):
        hx = gru_update(n, gate_x[:, t], torch.relu(hx @ reset + reset_b), hx)
        h = hx
        for i, (m, b, skip) in enumerate(levels):
            out = h @ m if skip is None else skip[:, t] + h @ m
            out = out + b
            h = torch.relu(out) if i != L - 1 else out
        ys.append(h)
    return torch.stack(ys, dim=1), hx


def _small():
    """JAX's plan and the port's on the same random GRUUNet2 weights (16
    mels, hidden (5, 5), as the JAX webrtc tests)."""
    model = jax_build_model(JaxModelConfig(
        arch="GRUUNet2", num_compressed_bins=4, hidden_sizes=(5, 5),
        kernel_sizes=(3, 3), strides=(2, 2), paddings=(1, 1),
        num_gaussians=3), num_bins=16)
    jplan = jax_build_cell_plan(model, model.init(jax.random.PRNGKey(3)))
    return jplan, plan_from_numpy(jplan), 16


def _trained(spec):
    jcfg, jmodel, params = jax_load_pretrained(spec)
    _, model = load_pretrained(spec)
    return (jax_build_cell_plan(jmodel, params), build_cell_plan(model),
            jcfg.dsp.n_mels)


PLANS = {"small": _small, "gruunet2-dari_tult":
         lambda: _trained("gruunet2-dari_tult")}


@pytest.mark.parametrize("name", list(PLANS))
def test_batched_walk_matches_three_jax_steps(name):
    """Three frames of 3 streams (a ragged kernel tile) from numpy inputs:
    the batched walk's y at each frame and hx after the third against
    JAX's plan_cell_math stepped three times with hx carried, and against
    the port's plain cell stepped the same way, each within REL of the
    output's scale."""
    jplan, plan, feat = PLANS[name]()
    jw, jflags = jax_pack_plan_weights(jplan)
    w, flags = pack_plan_weights(plan)
    n = plan.hidden * plan.compressed
    rng = np.random.default_rng(24)
    x = rng.uniform(0.0, 3.0, (3, FRAMES, feat)).astype(np.float32)
    hx = (0.5 * rng.standard_normal((3, n))).astype(np.float32)
    ys, h = cell_frames_math(w, flags, n, torch.from_numpy(x),
                             torch.from_numpy(hx))
    jh, ph = jnp.asarray(hx), torch.from_numpy(hx)
    for t in range(FRAMES):
        jy, jh = jax_plan_cell_math(jw, jflags, n, feat, False,
                                    jnp.asarray(x[:, t]), jh)
        py, ph = plan_cell_math(w, flags, n, torch.from_numpy(x[:, t]), ph)
        for got, want in ((ys[:, t], np.asarray(jy)), (ys[:, t], py.numpy())):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=REL * np.abs(want).max())
    for want in (np.asarray(jh), ph.numpy()):
        np.testing.assert_allclose(h.numpy(), want, rtol=0,
                                   atol=REL * np.abs(want).max())


def _geometry(cfg, n_fft):
    return dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, n_fft=n_fft, hop_length=n_fft // 2,
        griffin_lim_warm_start=True))


@pytest.fixture(scope="module")
def served():
    return {spec: (cfg, build_cell_plan(model)) for spec, (cfg, model) in (
        (s, load_pretrained(s)) for s in (
            "gruunet2-good", "gruunet2-dari_tult", FLAGSHIP))}


BLOCK_FOR_ALL = 1 << 30   # a block every layout fits: the batched walk


@pytest.mark.parametrize("spec,n_fft,walk", [
    *((s, n, "batched") for s in ("gruunet2-good", "gruunet2-dari_tult")
      for n in (640, 882, 1536)),
    (FLAGSHIP, None, "per-frame")])
def test_cell_walk_at_the_served_geometries(served, spec, n_fft, walk):
    """gruunet2-good and gruunet2-dari_tult (64 mels) take the batched
    walk at n_fft 640, 882 (WebRTC's 10 ms frame at 44.1 kHz) and 1536 on
    an H100, in both entry points; the 128-mel flagship at its own n_fft
    1024 keeps the per-frame walk (its batched buffers would not fit a
    block). The walk is batched exactly where its count fits the limit in
    both entry points, the count the engine decides by (no limit) is the
    per-frame walk's, the least, and a hop's count is its walk's."""
    cfg, plan = served[spec]
    cfg = _geometry(cfg, n_fft or cfg.dsp.n_fft)
    assert cell_walk(cfg, plan, SMEM_LIMIT) == walk
    batched = [webrtc_hop_smem_bytes(cfg, plan, hops, limit=BLOCK_FOR_ALL)
               for hops in (1, 25)]
    assert cell_walk(cfg, plan, max(batched)) == "batched"
    assert cell_walk(cfg, plan, max(batched) - 1) == "per-frame"
    assert (max(batched) <= SMEM_LIMIT) == (walk == "batched")
    for hops, most in zip((1, 25), batched):
        least = webrtc_hop_smem_bytes(cfg, plan, hops)
        assert least == webrtc_hop_smem_bytes(cfg, plan, hops, limit=0)
        assert least <= most
        assert webrtc_hop_smem_bytes(cfg, plan, hops, limit=SMEM_LIMIT) == (
            most if walk == "batched" else least)


def _stand_in_plan(model):
    """A plan with the widths ``build_cell_plan`` gives ``model`` (a
    GRUUNet2: level i of the encoder maps channels x bins of level i to
    level i + 1's, the gates' 3 hidden channels at the compressed bins;
    the decoder mirrors it, a skip at every level but the first) and empty
    matrices: building the 128-mel plans takes seconds each."""
    c, cell = model.config, model.cell
    sizes, L = cell.bin_sizes, len(cell.bin_sizes) - 1
    chans = [1, *c.hidden_sizes[:-1], 3 * cell.hidden]
    rev = [1, *c.hidden_sizes][::-1]
    down = [chans[i] * sizes[i] for i in range(L + 1)]
    up = [rev[i] * sizes[L - i] for i in range(L + 1)]
    mat = lambda a, b: torch.empty((a, b), device="meta")
    return types.SimpleNamespace(
        down_mats=tuple(mat(down[i], down[i + 1]) for i in range(L)),
        up_h_mats=tuple(mat(up[i], up[i + 1]) for i in range(L)),
        up_s_mats=tuple(None if i == 0 else mat(down[L - i], up[i + 1])
                        for i in range(L)),
        hidden=cell.hidden, compressed=cell.compressed, delta=False)


def _shipped():
    """(label, cfg, plan) of every shipped checkpoint the WebRTC kernels
    could serve (the GRUUNet2 family, mel domain; the segment family and
    MOMO have no such plan), its plan a stand-in with its widths; the
    first two model shapes' stand-ins held against their built plans."""
    checked = set()
    for path in sorted(glob.glob(os.path.join(REPO, "checkpoints", "*.npz"))
                       + glob.glob(os.path.join(REPO, "runs", "*.npz"))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cfg, model = load_pretrained(path)
        if cfg.model.arch != "GRUUNet2" or cfg.dsp.domain != "mel":
            continue
        plan = _stand_in_plan(model)
        M = cfg.dsp.n_mels
        if len(checked) < 2 and plan_shape(plan, M) not in checked:
            assert plan_shape(plan, M) == plan_shape(build_cell_plan(model), M)
            checked.add(plan_shape(plan, M))
        yield os.path.basename(path), _geometry(cfg, cfg.dsp.n_fft), plan


# the shipped GRUUNet2 checkpoints whose per-frame hop does not fit an H100
# block, which the engine serves in mode webrtc, as before the batched walk
NOT_FUSED = {"gruunet2mel128w96-mrstft-50k.npz"}


def test_smem_keeps_the_fit_mode_of_every_shipped_checkpoint(monkeypatch):
    """The engine's capacity rule (``_fit``) serves every shipped
    checkpoint in mode fused-webrtc exactly where the per-frame walk fits
    an H100 block (the count without a limit), all but NOT_FUSED, and
    where it does, the walk the hop then takes fits the block in both
    entry points."""
    monkeypatch.setattr(engine_mod, "shared_memory_limit",
                        lambda device: SMEM_LIMIT)
    seen, refused = 0, set()
    for label, cfg, plan in _shipped():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mode = engine_mod._fit(cfg, plan, "fused-webrtc", "cuda")
        fits = webrtc_hop_smem_bytes(cfg, plan) <= SMEM_LIMIT
        assert mode == ("fused-webrtc" if fits else "webrtc"), label
        if mode == "fused-webrtc":
            assert webrtc_hop_smem_bytes(cfg, plan,
                                         limit=SMEM_LIMIT) <= SMEM_LIMIT
            if cell_walk(cfg, plan, SMEM_LIMIT) == "batched":
                assert webrtc_hop_smem_bytes(cfg, plan, 25,
                                             limit=SMEM_LIMIT) <= SMEM_LIMIT
        else:
            refused.add(label)
        seen += 1
    assert seen >= 20
    assert refused == NOT_FUSED

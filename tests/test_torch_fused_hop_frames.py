"""The fused hop's frame-group walk on the CPU (``csrc/fused_hop.cu``
``group_walk`` and the walk choice in ``ops/kernels/fused_hop.py``): the
walk's plain mirror (``hop_frames_math``: the stages that read no state
once over a group of hops; the recurrence, each decoder level over h and
that hop's skip input, the gate and the overlap-add hop by hop) against
JAX's interpret-mode K-hop kernel, in the mel domain and in the raw
domain with the delta carry (MOMO3), ungated and with estimator 'both',
with a last group shorter than the others; the group size the host rule
gives each served configuration; and the shared-memory count the engine
reads, which keeps every shipped checkpoint's serving mode. The kernels
themselves are held against the plain version and against single hops
on the card by chip_smoke.py."""

import dataclasses
import glob
import os
import types
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

from audio_denoising_torch.config import PRESETS
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.ops.kernels.common import plan_shape
from audio_denoising_torch.ops.kernels.fused_hop import (
    GROUP, fused_hop_init_state, fused_hop_smem_bytes, hop_group,
    make_fused_hop)
from audio_denoising_torch.runtime import engine as engine_mod
from audio_denoising_torch.runtime.plan import (
    build_cell_plan, gru_update, plan_from_numpy)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.join(HERE, "..")
SMEM_LIMIT = 232448  # an H100 block's opt-in shared memory, bytes
SPEC = "gruunet2-stream16k"
MOMO_SPEC = "momo3-4d4ea0"
FLAGSHIP = os.path.join(REPO, "runs", "gruunet2mel128w64-mrstft-50k.npz")
HIDDEN40 = os.path.join(REPO, "runs", "gruunet2s16kw40-mrstft-idp-50k.npz")
# tests/test_torch_fused_hop.py's bounds: the mel hop's output and state,
# MOMO3's (its kernel against the fast step), the gate's planes relative
OUT_ATOL, STATE_ATOL, MOMO_ATOL = 2e-4, 2e-5, 1e-5
PLANE_RTOL, PLANE_ATOL = 2e-4, 1e-9
K, PER_GROUP, B = 5, 2, 3   # groups of 2, 2 and 1 hops; a ragged tile


def _gated(cfg, gate_db, width_db):
    """``cfg`` (either package's Config) with the gate on, estimator
    'both'."""
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, snr_gate_db=gate_db, snr_gate_width_db=width_db,
        snr_gate_estimator="both"))


def hop_frames_math(hop, state, chunks, group):
    """csrc/fused_hop.cu's frame-group walk in plain PyTorch, on the CPU
    hop ``hop`` (float32 IO): ``chunks`` (K, B, hop) in groups of
    ``group`` hops, the last one shorter where ``group`` does not divide
    K. Returns (state', outs (K, B, hop)): K hops of ``hop.reference``,
    with the analysis, the encoder, the inverse mel and the inverse DFT
    each one product over the group's rows."""
    outs = []
    for k0 in range(0, chunks.shape[0], group):
        state, out = _frame_group(hop, state, chunks[k0:k0 + group])
        outs.append(out)
    return state, torch.cat(outs)


def _frame_group(hop, state, chunks):
    R, b, H = chunks.shape
    n_fft, L = hop.n_fft, len(hop.skip_flags)
    # frame t: the last n_fft samples of ring ++ chunks[0 .. t]; rows are
    # frame-major (row t b + s)
    seq = torch.cat([state.ring, chunks.permute(1, 0, 2).reshape(b, R * H)],
                    dim=-1)
    frames = torch.stack([seq[:, (t + 1) * H:(t + 1) * H + n_fft]
                          for t in range(R)])
    rows = (frames * hop.win).reshape(R * b, n_fft)
    re, im = rows @ hop.cf, rows @ hop.sf
    mag = torch.sqrt(re * re + im * im)
    x = torch.log(1.0 + (mag if hop.raw else mag @ hop.mel))
    h = x
    if hop.delta:   # prev: the previous frame's feature, the plane first
        xs = x.reshape(R, b, -1)
        h = torch.cat([x, torch.cat([state.prev[None], xs[:-1]]).reshape(
            R * b, -1)], dim=-1)
    # the encoder over the group's rows
    it = iter(hop.weights)
    acts = [h]
    for _ in range(L):
        m, bias = next(it), next(it)
        h = torch.relu(h @ m + bias)
        acts.append(h)
    gate_x = h.reshape(R, b, -1)
    reset, reset_b = next(it), next(it)
    levels = []
    for i in range(L):
        m, bias = next(it), next(it)
        skip = ((acts[L - i].reshape(R, b, -1), next(it))
                if hop.skip_flags[i] else None)
        levels.append((m, bias, skip))
    # hop by hop: the reset gate, the GRU, the decoder (level i over h and
    # that hop's rows of the encoder's level L - i), hx decayed, the
    # residual
    hx, feats = state.hx, []
    for t in range(R):
        hi = gru_update(hop.n, gate_x[t], torch.relu(hx @ reset + reset_b),
                        hx)
        y = hi
        for i, (m, bias, skip) in enumerate(levels):
            out = y @ m + bias
            if skip is not None:
                out = out + skip[0][t] @ skip[1]
            y = torch.relu(out) if i != L - 1 else out
        hx = hi * hop.state_decay
        rec = x.reshape(R, b, -1)[t] - y
        rec = torch.where(rec >= 0, rec, 0.2 * rec)
        feats.append(torch.clamp(torch.exp(rec) - 1.0, min=0.0))
    feat = torch.cat(feats)
    lin = (feat if hop.raw else torch.clamp(feat @ hop.imel, min=0.0)) \
        * hop.output_gain
    # hop by hop: the gate's estimators and the blend
    lins = lin.reshape(R, b, -1)
    mags = mag.reshape(R, b, -1)
    blended = []
    for t in range(R):
        lt = lins[t]
        if hop.gated:
            planes, lt = hop._gate(state, mags[t], lt)
            state = state._replace(**planes)
        blended.append(lt)
    lin = torch.cat(blended)
    safe = mag > 1e-8
    scale = lin / torch.where(safe, mag, torch.ones_like(mag))
    rec_re = torch.where(safe, re * scale, lin)
    rec_im = torch.where(safe, im * scale, torch.zeros_like(im))
    synth = ((rec_re @ hop.ic + rec_im @ hop.is_) * hop.win).reshape(
        R, b, n_fft)
    # hop by hop: overlap-add, the finished hop over the envelope
    ola, outs = state.ola, []
    for t in range(R):
        acc = ola + synth[t]
        outs.append(acc[:, :H] / hop.env)
        ola = torch.cat([acc[:, H:], torch.zeros_like(acc[:, :H])], dim=-1)
    extra = {"prev": x.reshape(R, b, -1)[-1]} if hop.delta else {}
    return state._replace(ring=frames[-1], ola=ola, hx=hx,
                          **extra), torch.stack(outs)


def _mel():
    jcfg, model, params = jax_load_pretrained(SPEC)
    jplan = jax_build_cell_plan(model, params)
    return jcfg, jplan, PRESETS[SPEC], plan_from_numpy(jplan), OUT_ATOL, \
        STATE_ATOL


def _momo():
    jcfg, model, params = jax_load_pretrained(MOMO_SPEC)
    jplan = jax_build_cell_plan_momo(model, params)
    cfg, _ = load_pretrained(MOMO_SPEC)
    return jcfg, jplan, cfg, plan_from_numpy(jplan), MOMO_ATOL, MOMO_ATOL


def _chunks(rng, hop_len, sr):
    """Voiced bursts over per-stream noise levels: the gate blends."""
    t_ax = np.arange(2 * K * hop_len).reshape(2 * K, 1, hop_len) / sr
    burst = (np.sin(2 * np.pi * 220 * t_ax) * 0.3
             * (np.arange(2 * K)[:, None, None] // 2 % 2))
    lv = np.array([0.001, 0.03, 0.3])[None, :B, None]
    return (burst + lv * rng.standard_normal((2 * K, B, hop_len))
            ).astype(np.float32)


@pytest.mark.parametrize("domain", ["mel", "raw-delta"])
@pytest.mark.parametrize("gate", [None, "both"])
def test_frame_groups_match_jax_k_hop_kernel(domain, gate):
    """K = 5 hops in groups of 2 (the last group of 1) at B = 3, two
    calls carrying the state: the walk's plain mirror against JAX's
    resident kernel (``hops_per_call=5``, interpret mode), every output
    and plane within the existing fused-hop tests' bounds (the gate's
    planes relative, its per-stream EMAs against JAX's column 0); and
    against the port's plain version (K hops of ``reference``)."""
    jcfg, jplan, cfg, plan, out_atol, state_atol = (
        _mel() if domain == "mel" else _momo())
    if gate:
        jcfg, cfg = (_gated(c, 1.0, 6.0) for c in (jcfg, cfg))
    hop = make_fused_hop(cfg, plan, device="cpu", hops_per_call=K)
    assert hop.raw == (domain != "mel") and hop.delta == (domain != "mel")
    jax_multi = jax_make_hop(jcfg, jplan, interpret=True, hops_per_call=K)
    data = _chunks(np.random.default_rng(25), cfg.dsp.hop_length,
                   cfg.dsp.sample_rate)
    js = jax_init_state(jcfg, jplan, B)
    s = p = fused_hop_init_state(cfg, plan, B)
    for call in range(2):
        chunks = data[call * K:(call + 1) * K]
        js, jouts = jax_multi(js, jnp.asarray(chunks))
        s, outs = hop_frames_math(hop, s, torch.from_numpy(chunks),
                                  PER_GROUP)
        p, pouts = hop.plain(p, torch.from_numpy(chunks))
        for want in (np.asarray(jouts), pouts.numpy()):
            np.testing.assert_allclose(outs.numpy(), want, rtol=0,
                                       atol=out_atol)
        for name, t in s._asdict().items():
            jt = getattr(js, name)
            assert (t is None) == (jt is None), name
            if t is None:
                continue
            got, want = t.numpy(), np.asarray(jt)
            if name in ("ring", "ola", "hx", "prev"):
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=state_atol, err_msg=name)
            elif got.shape[1] == 1:
                np.testing.assert_allclose(got[:, 0], want[:, 0],
                                           rtol=PLANE_RTOL, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=PLANE_RTOL,
                                           atol=PLANE_ATOL, err_msg=name)
    if gate:   # the gate took part: a stream is not fully denoised
        assert (hop.alpha(s) < 1).any()


@pytest.fixture(scope="module")
def served():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = {}
        for spec in (SPEC, "gruunet2-good", HIDDEN40, FLAGSHIP, MOMO_SPEC):
            cfg, model = load_pretrained(spec)
            out[spec] = (cfg, build_cell_plan(model))
        return out


# (spec, the K-hop kernel's group at K = 50 on an H100; 0: per frame)
SERVED_GROUPS = [(SPEC, 4), ("gruunet2-good", 4), (HIDDEN40, 4),
                 (FLAGSHIP, 0), (MOMO_SPEC, 4)]


@pytest.mark.parametrize("spec,group", SERVED_GROUPS,
                         ids=lambda v: os.path.basename(str(v)))
@pytest.mark.parametrize("gated", [False, True])
def test_hop_group_at_the_served_configurations(served, spec, group, gated):
    """On an H100 block the K-hop kernel takes groups of 4 hops at
    stream16k, gruunet2-good, the hidden-40 plan and MOMO3, and the
    128-mel flagship keeps the per-frame walk, with and without the tuned
    gate; the single hop walks per frame. The K-hop's walk is the
    frame-group walk exactly where its layout fits the limit, at any K
    above 1; the count with a limit is that walk's, and without one the
    per-frame walk's; bf16 and int8 walk per frame."""
    cfg, plan = served[spec]
    if gated:
        cfg = _gated(cfg, 1.0, 6.0)
    grouped = fused_hop_smem_bytes(cfg, plan, hops_per_call=2,
                                   limit=1 << 30)
    assert (grouped <= SMEM_LIMIT) == (group == GROUP)
    assert hop_group(cfg, plan, grouped, 50) == GROUP
    assert hop_group(cfg, plan, grouped - 1, 50) == 0
    for k in (1, 2, 3, 7, 50):
        got = hop_group(cfg, plan, SMEM_LIMIT, k)
        assert got == (group if k > 1 else 0)
        count = fused_hop_smem_bytes(cfg, plan, hops_per_call=k,
                                     limit=SMEM_LIMIT)
        per_frame = fused_hop_smem_bytes(cfg, plan, hops_per_call=k)
        assert count == (grouped if got else per_frame)
        assert count <= SMEM_LIMIT
    for dtype in (torch.bfloat16, torch.int8):
        assert hop_group(cfg, plan, SMEM_LIMIT, 50, dtype) == 0
        assert fused_hop_smem_bytes(cfg, plan, dtype, 50, SMEM_LIMIT) == \
            fused_hop_smem_bytes(cfg, plan, dtype)


def _stand_in_plan(model):
    """A plan with the widths ``build_cell_plan`` gives the GRUUNet2
    ``model`` (tests/test_torch_webrtc_cell.py's stand-in: level i of the
    encoder maps channels x bins of level i to level i + 1's, the gates' 3
    hidden channels at the compressed bins; the decoder mirrors it, a skip
    at every level but the first) and empty matrices: building the
    128-mel plans takes seconds each."""
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
    """(label, cfg, plan) of every shipped checkpoint the fused hop could
    serve (those with a cell plan: the GRUUNet2 family, each plan a
    stand-in with its widths, the first two shapes held against their
    built plans, and MOMO3)."""
    checked = set()
    for path in sorted(glob.glob(os.path.join(REPO, "checkpoints", "*.npz"))
                       + glob.glob(os.path.join(REPO, "runs", "*.npz"))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cfg, model = load_pretrained(path)
        feat = cfg.dsp.n_stft if cfg.dsp.domain == "raw" else cfg.dsp.n_mels
        if cfg.model.arch == "MOMO3":
            plan = build_cell_plan(model)
        elif cfg.model.arch == "GRUUNet2":
            plan = _stand_in_plan(model)
            if len(checked) < 2 and plan_shape(plan, feat) not in checked:
                assert plan_shape(plan, feat) == plan_shape(
                    build_cell_plan(model), feat)
                checked.add(plan_shape(plan, feat))
        else:
            continue
        yield os.path.basename(path), cfg, plan


# the shipped checkpoints whose fused hop does not fit an H100 block at
# their serving dtype, which the engine serves in mode fast
NOT_FUSED = {"gruunet2mel128w96-mrstft-50k.npz"}


def test_smem_keeps_the_fit_mode_of_every_shipped_checkpoint(monkeypatch):
    """The engine's capacity rule (``_fit``) serves every shipped
    checkpoint in mode fused exactly where the per-frame walk fits an
    H100 block (the count without a limit), all but NOT_FUSED; where it
    does, the walk its hops take fits the block in both entry points."""
    monkeypatch.setattr(engine_mod, "shared_memory_limit",
                        lambda device: SMEM_LIMIT)
    seen, refused = 0, set()
    for label, cfg, plan in _shipped():
        dtype = getattr(torch, cfg.serving.dtype)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mode = engine_mod._fit(cfg, plan, "fused", "cuda")
        fits = fused_hop_smem_bytes(cfg, plan, dtype) <= SMEM_LIMIT
        assert mode == ("fused" if fits else "fast"), label
        if mode == "fused":
            for k in (1, 50):
                assert fused_hop_smem_bytes(cfg, plan, dtype, k,
                                            SMEM_LIMIT) <= SMEM_LIMIT
        else:
            refused.add(label)
        seen += 1
    assert seen >= 20
    assert refused == NOT_FUSED

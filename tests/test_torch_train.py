"""The port's training (audio_denoising_torch/train/context.py,
runtime/plan.py's trainable build, apps/trainer.py) against the JAX
package's TrainingContext on the CPU.

One step of each family (GRUUNet2 on the residual and the reconstruction
objectives, with SI-SDR, with a lookahead of 2; MOMO3; UNet2d4 at
dropout 0; TRUNet) from the same parameters and batch: the loss, every
gradient (``jax.value_and_grad`` against autograd) and every parameter
after the AdamW step (JAX's own optax update). The LR staircase across
count 999 -> 1001, checkpoints written by either package and resumed by
the other, a resume mid-run against the uninterrupted run. Then the JAX
package's own training tests, case for case, on the port, and the
``train`` command with ``--device cpu``. The numpy inputs come from a
seed; JAX's parameters are carried across by state-dict key."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from audio_denoising_tpu.config import (
    Config as JConfig, DSPConfig as JDSP, ModelConfig as JModel,
    PRESETS as JAX_PRESETS, TrainConfig as JTrain)
from audio_denoising_tpu.models import build_model as jax_build_model
from audio_denoising_tpu.train.context import TrainingContext as JaxContext

from audio_denoising_torch.compat import load_params_npz
from audio_denoising_torch.config import (
    Config, DSPConfig, ModelConfig, PRESETS, TrainConfig)
from audio_denoising_torch.models import build_model
from audio_denoising_torch.runtime.plan import build_cell_plan
from audio_denoising_torch.train import MixtureSampler, TrainingContext


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small tensors: one intra-op thread each, so workers running side
    by side do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One step against JAX. The loss relative to its value. Each gradient
# relative to its largest magnitude, floored at GRAD_FLOOR of the model's
# largest gradient: some gradients are zero in exact arithmetic (a conv
# bias in front of an InstanceNorm) or sums that cancel (a PReLU slope),
# round-off in both packages. The reconstruction objective's
# log(|E| + 1e-5) multiplies float32 round-off in |E| by up to 1e5 where
# the estimate is near zero, as the trained U-Net's is on noise-only bins:
# its gradients are held at GRAD_RTOL_LOGMAG (measured 2.0e-2; the same
# U-Net on the residual objective agrees to 7e-6).
# The parameters after the step, in units of the step's LR: JAX's optax
# update applied to the port's gradients against the port's (the
# optimizer alone, OPT_LR_ATOL; measured <= 1.2e-4); then against JAX's
# own step, elementwise: an element whose gradient's sign both packages
# share to ten times their difference within PARAM_LR_ATOL (measured
# <= 0.022), any other within ROUNDOFF_STEP, since Adam's first step
# moves an element by lr * g / |g|, +-lr whatever g's size.
LOSS_RTOL = 1e-5
GRAD_RTOL = 5e-3
GRAD_RTOL_LOGMAG = 5e-2
GRAD_FLOOR = 1e-2
OPT_LR_ATOL = 1e-3
PARAM_LR_ATOL = 0.05
ROUNDOFF_STEP = 2.05

DSP = dict(sample_rate=8000, n_fft=256, hop_length=128, n_mels=32)
MODEL = dict(arch="GRUUNet2", num_compressed_bins=2, hidden_sizes=(8,) * 4,
             kernel_sizes=(3,) * 4, strides=(2,) * 4, paddings=(1,) * 4)
TRAIN = dict(batch_size=2, crop_samples=2048, learning_rate=3e-3)


def _cfgs(dsp=None, model=None, train=None):
    """The same small config in both packages."""
    d, m, t = dict(DSP, **(dsp or {})), dict(MODEL, **(model or {})), \
        dict(TRAIN, **(train or {}))
    return (JConfig(dsp=JDSP(**d), model=JModel(**m), train=JTrain(**t)),
            Config(dsp=DSPConfig(**d), model=ModelConfig(**m),
                   train=TrainConfig(**t)))


def _trained(name, crop, objective=None):
    """A preset's config, or a runs/ checkpoint's own, in both packages,
    cut to batch 2 and ``crop`` samples, dropout 0; and the trained
    weights (random weights of a U-Net blow its raw-domain expm1 up to
    losses in the thousands, where float32 round-off dominates)."""
    if name in PRESETS:
        path = os.path.join(REPO, "checkpoints", f"{name}.npz")
        pair = (JAX_PRESETS[name], PRESETS[name])
    else:
        path = os.path.join(REPO, "runs", name)
        text = json.dumps(load_params_npz(path)[1]["full_config"])
        pair = (JConfig.from_json(text), Config.from_json(text))
    tr = dict(batch_size=2, crop_samples=crop)
    if objective:
        tr["objective"] = objective
    cfgs = tuple(dataclasses.replace(
        c, model=dataclasses.replace(c.model, dropout=0.0),
        train=dataclasses.replace(c.train, **tr)) for c in pair)
    params = {k: v for k, v in load_params_npz(path)[0].items()
              if not k.startswith("__opt__") and not k.endswith("gs.offset")}
    return cfgs + (params,)


CASES = {
    "residual_mse": lambda: _cfgs(),
    "recon_mrstft": lambda: _cfgs(train=dict(objective="recon_mrstft")),
    "recon_si_sdr": lambda: _cfgs(train=dict(objective="recon_mrstft",
                                             si_sdr_weight=0.5)),
    "lookahead2": lambda: _cfgs(model=dict(lookahead_frames=2)),
    "lookahead2_recon": lambda: _cfgs(model=dict(lookahead_frames=2),
                                      train=dict(objective="recon_mrstft")),
    "momo3": lambda: _trained("momo3-4d4ea0", 2100),
    "unet2d4": lambda: _trained("unet4crop2s-mrstft-30k.npz", 4800,
                                "residual_mse"),
    "unet2d4_recon": lambda: _trained("unet4crop2s-mrstft-30k.npz", 4800),
    "trunet": lambda: _trained("trunet-realnoise.npz", 4096, "residual_mse"),
}


def _batch(cfg, seed=0, silent=False, identity=False):
    """(mixture, clean) (B, crop) float32: a voiced clean signal over a
    -60 dB noise floor, as a recording has (a pure harmonic signal has
    round-off magnitudes between its harmonics, where log(|.| + 1e-5)
    turns float32 round-off into percent), and noise; ``silent`` zeroes a stretch of both, ``identity`` makes the
    first example an exact copy (the identity examples of
    ``identity_prob``)."""
    rng = np.random.default_rng(seed)
    b, n = cfg.train.batch_size, cfg.train.crop_samples
    t = np.arange(n) / cfg.dsp.sample_rate
    f0 = rng.uniform(120, 220, (b, 1))
    clean = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5))
    clean = 0.2 * clean * (1 + np.sin(2 * np.pi * 3 * t))
    clean = (clean + 1e-3 * rng.standard_normal((b, n))).astype(np.float32)
    mix = np.clip(clean + 0.2 * rng.standard_normal((b, n)), -1, 1)
    mix = mix.astype(np.float32)
    if silent:
        clean[:, n // 4:n // 2] = 0.0
        mix[:, n // 4:n // 2] = 0.0
    if identity:
        mix[0] = clean[0]
    return mix, clean


def _contexts(jc, pc, seed=0, params=None):
    """JAX's context (``params``, or its initialization from ``seed``)
    and the port's on the same parameters."""
    jm = jax_build_model(jc.model, num_bins=jc.dsp.n_mels)
    jctx = JaxContext(jc, jm, seed=seed, params=None if params is None else
                      {k: jnp.asarray(v) for k, v in params.items()})
    params = {k: np.asarray(v) for k, v in jctx.state.params.items()}
    ctx = TrainingContext(pc, build_model(pc.model, num_bins=pc.dsp.n_mels),
                          params=params, device="cpu")
    return jctx, ctx


def _jax_step(jctx, mix, clean):
    """JAX's _train_step_impl split open: (loss, grads, params after)."""
    m, c = jnp.asarray(mix), jnp.asarray(clean)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jctx._loss(p, m, c, jctx.train_loss)))(jctx.state.params)
    updates, _ = jctx.optim.update(grads, jctx.state.opt_state,
                                   jctx.state.params)
    return loss, grads, optax.apply_updates(jctx.state.params, updates)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def check_grads(want, got, rtol=GRAD_RTOL):
    top = max(np.abs(_np(g)).max() for g in want.values())
    for k, g in want.items():
        g = _np(g)
        scale = max(np.abs(g).max(), GRAD_FLOOR * top)
        err = np.abs(g - _np(got[k])).max()
        assert err <= rtol * scale, (k, err, scale)


def check_params(want, got, lr, grads=None):
    """Parameters after a step, in LR units; with ``grads`` (JAX's, the
    port's), an element whose gradient's sign round-off decides is held
    to one step of either side."""
    for k, p in want.items():
        tol = np.full(np.shape(p), PARAM_LR_ATOL)
        if grads is not None:
            gj, gp = _np(grads[0][k]), _np(grads[1][k])
            tol[np.abs(gj) <= 10 * np.abs(gj - gp)] = ROUNDOFF_STEP
        err = np.abs(_np(p) - _np(got[k])) / lr
        assert (err <= tol).all(), (k, err.max())


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(case):
    jc, pc, *params = CASES[case]()
    jctx, ctx = _contexts(jc, pc, params=params[0] if params else None)
    mix, clean = _batch(pc)
    loss_j, grads_j, params_j = _jax_step(jctx, mix, clean)
    loss, grads = ctx.loss_and_grads(mix, clean)
    assert abs(float(loss) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    assert all(torch.isfinite(g).all() for g in grads.values())
    check_grads(grads_j, grads,
                GRAD_RTOL_LOGMAG if case == "unet2d4_recon" else GRAD_RTOL)
    updates, _ = jctx.optim.update(
        {k: jnp.asarray(_np(g)) for k, g in grads.items()},
        jctx.state.opt_state, jctx.state.params)
    on_port_grads = optax.apply_updates(jctx.state.params, updates)
    assert ctx.train_step(mix, clean) == float(loss)
    lr = pc.train.learning_rate
    for k, p in on_port_grads.items():
        err = np.abs(_np(p) - _np(ctx.state.params[k])).max()
        assert err <= OPT_LR_ATOL * lr, (k, err / lr)
    check_params(params_j, ctx.state.params, lr, (grads_j, grads))


def test_silence_and_identity_keep_gradients_finite():
    """The reconstruction objective meets |STFT| = 0 and log(|.| + eps)
    on a silent stretch and on an exact copy of the clean signal: the
    loss and every gradient stay finite in both packages. The two are
    not compared there: d log(|E| + 1e-5) / d|E| is up to 1e5 where the
    estimate is silent, so float32 round-off in |E| moves a gradient by
    about 1 %, and where the mixture's spectrum is round-off (between
    the harmonics of the copied clean signal) its phase is noise that
    the model's output magnitude rides on."""
    jc, pc = CASES["recon_mrstft"]()
    jctx, ctx = _contexts(jc, pc)
    mix, clean = _batch(pc, silent=True, identity=True)
    loss_j, grads_j, _ = _jax_step(jctx, mix, clean)
    loss, grads = ctx.loss_and_grads(mix, clean)
    assert np.isfinite(float(loss_j)) and torch.isfinite(loss)
    for k, g in grads.items():
        assert np.isfinite(np.asarray(grads_j[k])).all(), k
        assert torch.isfinite(g).all(), k


def test_trainable_plan_equals_serving_plan():
    """The training build (the model's own parameters, autograd on) holds
    the serving build's float64-probed values, and its graph reaches the
    conv weights."""
    _jc, pc = _cfgs()
    model = build_model(pc.model, num_bins=pc.dsp.n_mels)
    served = build_cell_plan(model)
    trained = build_cell_plan(model, trainable=True)
    for a, b in zip(served.down_mats + served.up_h_mats,
                    trained.down_mats + trained.up_h_mats):
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-6)
    assert trained.reset_mat.requires_grad and not served.reset_mat.requires_grad
    w = model.cell.input_gate.downs[0].conv.weight
    (g,) = torch.autograd.grad(trained.down_mats[0].sum(), [w])
    assert g.abs().max() > 0


def _jax_counts(jctx, count):
    """JAX's optimizer state with Adam's and the schedule's counts (the
    first and last leaves) set to ``count``."""
    leaves, tree = jax.tree.flatten(jctx.state.opt_state)
    leaves[0] = jnp.asarray(count, jnp.int32)
    leaves[-1] = jnp.asarray(count, jnp.int32)
    return jctx.state._replace(opt_state=jax.tree.unflatten(tree, leaves),
                               step=jnp.asarray(count, jnp.int32))


def test_schedule_across_the_staircase(tmp_path):
    """From a state at count 999 (moments from one real step), two steps:
    the second runs at count 1000, lr * gamma. JAX's checkpoint of that
    state resumes in the port, and both step alike."""
    jc, pc = _cfgs(train=dict(lr_gamma=0.5))
    jctx, _ = _contexts(jc, pc)
    mix, clean = _batch(pc)
    jctx.train_step(mix, clean)
    jctx.state = _jax_counts(jctx, 999)
    path = str(tmp_path / "c999.npz")
    jctx.save(path)
    ctx = TrainingContext.load(path, pc, build_model(
        pc.model, num_bins=pc.dsp.n_mels), device="cpu")
    assert ctx.state.step == ctx.state.lr_step == 999
    assert ctx.learning_rate(999) == pc.train.learning_rate
    assert ctx.learning_rate(1000) == 0.5 * pc.train.learning_rate
    for i in range(2):
        lj = jctx.train_step(mix, clean)
        lp = ctx.train_step(mix, clean)
        assert abs(lp - lj) <= LOSS_RTOL * abs(lj)
        check_params(jctx.state.params, ctx.state.params,
                     ctx.learning_rate(999 + i))
    leaves = ctx.opt_leaves()
    assert int(leaves[0]) == int(leaves[-1]) == 1001 == ctx.state.step


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A JAX run saved after two steps resumes in the port with its AdamW
    moments and LR step; the next step of each agrees."""
    jc, pc = _cfgs()
    jctx, _ = _contexts(jc, pc, seed=3)
    mix, clean = _batch(pc, seed=1)
    for _ in range(2):
        jctx.train_step(mix, clean)
    path = str(tmp_path / "jax.npz")
    jctx.save(path)
    ctx = TrainingContext.load(path, pc, build_model(
        pc.model, num_bins=pc.dsp.n_mels), device="cpu")
    for a, b in zip(jax.tree.leaves(jctx.state.opt_state), ctx.opt_leaves()):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert ctx.total_iters == 2 and ctx.train_loss_record == \
        jctx.train_loss_record
    lj, lp = jctx.train_step(mix, clean), ctx.train_step(mix, clean)
    assert abs(lp - lj) <= LOSS_RTOL * abs(lj)
    check_params(jctx.state.params, ctx.state.params,
                 pc.train.learning_rate)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The reverse: the port's checkpoint after two steps loads in JAX's
    TrainingContext (the same __opt__ layout and meta), and the next step
    of each agrees."""
    jc, pc = _cfgs()
    _jctx, ctx = _contexts(jc, pc, seed=4)
    mix, clean = _batch(pc, seed=2)
    for _ in range(2):
        ctx.train_step(mix, clean)
    path = str(tmp_path / "port.npz")
    ctx.save(path)
    jctx = JaxContext.load(path, jc, jax_build_model(
        jc.model, num_bins=jc.dsp.n_mels))
    assert int(jctx.state.step) == 2 and jctx.total_iters == 2
    for a, b in zip(jax.tree.leaves(jctx.state.opt_state), ctx.opt_leaves()):
        np.testing.assert_array_equal(np.asarray(a), b)
    lj, lp = jctx.train_step(mix, clean), ctx.train_step(mix, clean)
    assert abs(lp - lj) <= LOSS_RTOL * abs(lj)
    check_params(jctx.state.params, ctx.state.params,
                 pc.train.learning_rate)


def test_resume_mid_run_equals_uninterrupted(tmp_path):
    _jc, pc = _cfgs(train=dict(objective="recon_mrstft"))
    model = build_model(pc.model, num_bins=pc.dsp.n_mels)
    batches = [_batch(pc, seed=s) for s in range(4)]
    full = TrainingContext(pc, model, seed=5, device="cpu")
    half = TrainingContext(pc, model, seed=5, device="cpu")
    for m, c in batches:
        full.train_step(m, c)
    for m, c in batches[:2]:
        half.train_step(m, c)
    path = str(tmp_path / "half.npz")
    half.save(path)
    resumed = TrainingContext.load(path, pc, model, device="cpu")
    for m, c in batches[2:]:
        resumed.train_step(m, c)
    assert resumed.train_loss_record == full.train_loss_record
    for k, v in full.state.params.items():
        torch.testing.assert_close(resumed.state.params[k], v, rtol=0,
                                   atol=0)


# -- the JAX package's tests/test_train.py, case for case ------------------

def _sampler(tmp_path, batch=4, crop=2048):
    from audio_denoising_torch.io.wavio import write_wav
    paths = []
    for i in range(4):
        t = np.arange(8000) / 8000
        tone = 0.5 * np.sin(2 * np.pi * (200 + 100 * i) * t)
        p = str(tmp_path / f"tone{i}.wav")
        write_wav(p, tone.astype(np.float32), 8000)
        paths.append(p)
    return MixtureSampler(paths, crop_samples=crop, batch_size=batch)


class TestTraining:
    def test_loss_decreases(self, tmp_path):
        _jc, pc = _cfgs(train=dict(batch_size=4))
        ctx = TrainingContext(pc, build_model(pc.model, num_bins=32),
                              seed=0, device="cpu")
        losses = []
        for i, (m, c) in enumerate(_sampler(tmp_path)):
            if i >= 30:
                break
            losses.append(ctx.train_step(m, c))
        assert np.mean(losses[-5:]) < np.mean(losses[:5])
        assert ctx.total_iters == 30 and len(ctx.train_loss_record) == 30

    def test_eval_and_records(self, tmp_path):
        _jc, pc = _cfgs(train=dict(batch_size=4))
        ctx = TrainingContext(pc, build_model(pc.model, num_bins=32),
                              device="cpu")
        m, c = _sampler(tmp_path).sample()
        ctx.train_step(m, c)
        v = ctx.eval_step(m, c)
        assert ctx.best_eval_loss == v and ctx.test_loss_record == {1: v}

    def test_checkpoint_roundtrip(self, tmp_path):
        _jc, pc = _cfgs(train=dict(batch_size=4))
        model = build_model(pc.model, num_bins=32)
        ctx = TrainingContext(pc, model, device="cpu")
        m, c = _sampler(tmp_path).sample()
        for _ in range(3):
            ctx.train_step(m, c)
        ctx.eval_step(m, c)
        p = str(tmp_path / "ck.npz")
        ctx.save(p)
        ctx2 = TrainingContext.load(p, pc, model, device="cpu")
        assert ctx2.total_iters == 3
        assert ctx2.train_loss_record == ctx.train_loss_record
        assert ctx2.best_eval_loss == ctx.best_eval_loss
        for k, v in ctx.state.params.items():
            torch.testing.assert_close(ctx2.state.params[k], v, rtol=0,
                                       atol=0)
        assert np.isfinite(ctx2.train_step(m, c))

    def test_data_parallel_refuses_several_cards(self, tmp_path,
                                                 monkeypatch):
        """Several cards no longer refuse --data-parallel: with no group
        to join, the command starts one worker per card (stubbed here)
        with its own arguments, and trains nothing itself; --device-data
        is checked first and trains on one device, as in JAX."""
        from audio_denoising_torch.apps import trainer
        for k in ("ADT_COORDINATOR", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setattr(trainer, "device_count", lambda device: 2)
        started = []
        monkeypatch.setattr(trainer, "spawn_workers",
                            lambda argv, world: started.append(
                                (argv, world)) or 0)
        argv = ["--data", str(tmp_path), "--device", "cpu",
                "--data-parallel"]
        assert trainer.main(argv) == 0
        assert started == [(argv, 2)]
        with pytest.raises(SystemExit):   # trains here: no WAVs under data
            trainer.main(argv + ["--device-data"])
        assert len(started) == 1

    def test_same_seed_same_initialization(self):
        _jc, pc = _cfgs()
        model = build_model(pc.model, num_bins=32)
        a = TrainingContext(pc, model, seed=7, device="cpu")
        b = TrainingContext(pc, model, seed=7, device="cpu")
        c = TrainingContext(pc, model, seed=8, device="cpu")
        for k, v in a.state.params.items():
            torch.testing.assert_close(b.state.params[k], v, rtol=0, atol=0)
        assert any(not torch.equal(c.state.params[k], v)
                   for k, v in a.state.params.items())


class TestMixtureSampler:
    def test_shapes_and_clamp(self, tmp_path):
        m, c = _sampler(tmp_path).sample()
        assert m.shape == c.shape == (4, 2048)
        assert np.abs(m).max() <= 1.0
        assert not np.allclose(m, c)


class TestStatelessTraining:
    @pytest.mark.parametrize("preset", ["unet4-raw480", "unet4wide-raw480"])
    def test_unet4_training_step_works(self, preset):
        cfg = PRESETS[preset]
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=2, crop_samples=12000))
        model = build_model(cfg.model, num_bins=cfg.dsp.n_stft)
        ctx = TrainingContext(cfg, model, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        mix = (0.2 * rng.standard_normal((2, 12000))).astype(np.float32)
        clean = (0.1 * rng.standard_normal((2, 12000))).astype(np.float32)
        l1 = ctx.train_step(mix, clean)
        l2 = ctx.train_step(mix, clean)
        assert np.isfinite(l1) and np.isfinite(l2) and l2 < l1

    def test_lookahead_on_a_unet_is_refused(self):
        cfg = PRESETS["unet4-raw480"]
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, lookahead_frames=2))
        with pytest.raises(ValueError, match="recurrent family only"):
            TrainingContext(cfg, build_model(cfg.model, num_bins=241),
                            device="cpu")


class TestTrainerCLIFlags:
    def _corpus(self, tmp_path):
        from audio_denoising_torch.io.wavio import write_wav
        d = tmp_path / "corpus"
        d.mkdir()
        sr = 48000
        t = np.arange(sr) / sr
        write_wav(str(d / "c.wav"),
                  (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32), sr)
        return str(d)

    def test_objective_weight_flags_reach_the_checkpoint(self, tmp_path):
        from audio_denoising_torch.apps.trainer import main as train_main
        d = self._corpus(tmp_path)
        out = str(tmp_path / "run.npz")
        rc = train_main([
            "--preset", "momo3-4d4ea0", "--data", d, "--device", "cpu",
            "--objective", "recon_mrstft", "--mrstft-weight", "2.5",
            "--wave-l1-weight", "4.0", "--si-sdr-weight", "0.1",
            "--identity-prob", "0.07", "--iters", "1", "--batch-size", "2",
            "--crop-samples", "4200", "--save", out])
        assert rc == 0
        _params, meta = load_params_npz(out)
        tr = meta["full_config"]["train"]
        assert tr["mrstft_weight"] == 2.5 and tr["wave_l1_weight"] == 4.0
        assert tr["si_sdr_weight"] == 0.1 and tr["identity_prob"] == 0.07
        assert tr["objective"] == "recon_mrstft"

    def test_resume_uses_checkpoint_config_not_preset(self, tmp_path):
        from audio_denoising_torch.apps.trainer import main as train_main
        d = self._corpus(tmp_path)
        first = str(tmp_path / "first.npz")
        assert train_main([
            "--preset", "momo3-4d4ea0", "--data", d, "--device", "cpu",
            "--objective", "recon_mrstft", "--mrstft-weight", "2.5",
            "--iters", "1", "--batch-size", "2", "--crop-samples", "4200",
            "--save", first]) == 0
        second = str(tmp_path / "second.npz")
        assert train_main([
            "--preset", "momo3-4d4ea0", "--data", d, "--device", "cpu",
            "--iters", "1", "--save", second, "--resume", first]) == 0
        _params, meta = load_params_npz(second)
        tr = meta["full_config"]["train"]
        assert tr["objective"] == "recon_mrstft"
        assert tr["mrstft_weight"] == 2.5 and tr["batch_size"] == 2
        srv = meta["full_config"]["serving"]
        assert srv["output_gain"] == 1.0 and srv["state_decay"] == 1.0
        assert meta["total_training_iters"] == 2 and meta["opt_step"] == 2
        third = str(tmp_path / "third.npz")
        assert train_main([
            "--preset", "momo3-4d4ea0", "--data", d, "--device", "cpu",
            "--iters", "1", "--save", third, "--resume", first,
            "--mrstft-weight", "9.0"]) == 0
        _params, meta3 = load_params_npz(third)
        assert meta3["full_config"]["train"]["mrstft_weight"] == 9.0
        assert meta3["full_config"]["train"]["objective"] == "recon_mrstft"

    def test_train_command_in_a_subprocess(self, tmp_path):
        """``python -m audio_denoising_torch train --device cpu`` on the
        host sampler and then ``--device-data``; without a card and
        without ``--device cpu`` it exits 1 and writes nothing."""
        d = self._corpus(tmp_path)
        out = str(tmp_path / "cli.npz")
        base = [sys.executable, "-m", "audio_denoising_torch", "train",
                "--preset", "gruunet2-dari_tult", "--data", d, "--iters",
                "2", "--batch-size", "2", "--crop-samples", "4800",
                "--save", out]
        env = dict(os.environ, PYTHONPATH=REPO)
        r = subprocess.run(base + ["--device", "cpu"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        r = subprocess.run(base + ["--device", "cpu", "--device-data",
                                   "--resume", out], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        assert "resumed at iter 2" in r.stdout
        _params, meta = load_params_npz(out)
        assert meta["total_training_iters"] == 4 and meta["opt_step"] == 4
        if not torch.cuda.is_available():
            gone = str(tmp_path / "none.npz")
            r = subprocess.run(base[:-1] + [gone], cwd=REPO, env=env,
                               capture_output=True, text=True, timeout=300)
            assert r.returncode == 1 and not os.path.exists(gone)


class TestOrbaxBackend:
    def test_orbax_is_refused(self, tmp_path):
        _jc, pc = _cfgs()
        model = build_model(pc.model, num_bins=32)
        ctx = TrainingContext(pc, model, device="cpu")
        with pytest.raises(ValueError, match="orbax_store.py"):
            ctx.save(str(tmp_path / "ck"), backend="orbax")
        (tmp_path / "ckdir").mkdir()
        with pytest.raises(ValueError, match="orbax_store.py"):
            TrainingContext.load(str(tmp_path / "ckdir"), pc, model,
                                 device="cpu")


class TestOptimizerResume:
    def test_resume_restores_adamw_moments_and_lr_step(self, tmp_path):
        cfg = PRESETS["gruunet2-dari_tult"]
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=2, crop_samples=8192))
        model = build_model(cfg.model, num_bins=cfg.dsp.n_mels)
        ctx = TrainingContext(cfg, model, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        mix = (0.2 * rng.standard_normal((2, 8192))).astype(np.float32)
        clean = (0.1 * rng.standard_normal((2, 8192))).astype(np.float32)
        for _ in range(3):
            ctx.train_step(mix, clean)
        path = str(tmp_path / "resume.npz")
        ctx.save(path)
        ctx2 = TrainingContext.load(path, cfg, model, device="cpu")
        assert ctx2.state.step == 3
        for a, b in zip(ctx.opt_leaves(), ctx2.opt_leaves()):
            np.testing.assert_array_equal(a, b)
        assert any(np.abs(v).max() > 0 for v in ctx2.opt_leaves()[1:-1])
        assert abs(ctx.train_step(mix, clean)
                   - ctx2.train_step(mix, clean)) < 1e-6

    def test_shipped_run_resumes_with_its_moments(self, tmp_path):
        """A JAX run of runs/ resumes with its stored AdamW state (the
        flagship at step 50,000, LR 1e-3 * 0.97^50); the same weights
        without __opt__ leaves start with fresh moments at count 0."""
        from audio_denoising_torch.compat import save_params_npz
        path = os.path.join(REPO, "runs", "gruunet2mel128w64-mrstft-50k.npz")
        stored, meta = load_params_npz(path)
        cfg = Config.from_json(json.dumps(meta["full_config"]))
        model = build_model(cfg.model, num_bins=cfg.dsp.n_mels)
        ctx = TrainingContext.load(path, cfg, model, device="cpu")
        assert ctx.total_iters == meta["total_training_iters"] == 50000
        assert ctx.state.step == ctx.state.lr_step == meta["opt_step"]
        for i, v in enumerate(ctx.opt_leaves()):
            np.testing.assert_array_equal(v, stored[f"__opt__{i}"])
        assert ctx.learning_rate(ctx.state.lr_step) == pytest.approx(
            1e-3 * 0.97 ** 50)
        bare = str(tmp_path / "bare.npz")
        save_params_npz(bare, {k: v for k, v in stored.items()
                               if not k.startswith("__opt__")}, meta)
        fresh = TrainingContext.load(bare, cfg, model, device="cpu")
        assert fresh.state.step == 0
        leaves = fresh.opt_leaves()
        assert int(leaves[0]) == 0 and all(not v.any() for v in leaves)


class TestReconObjective:
    def test_recon_objective_loss_decreases(self, tmp_path):
        _jc, pc = _cfgs(train=dict(batch_size=4, objective="recon_mrstft"))
        ctx = TrainingContext(pc, build_model(pc.model, num_bins=32),
                              seed=0, device="cpu")
        losses = []
        for i, (m, c) in enumerate(_sampler(tmp_path)):
            if i >= 25:
                break
            losses.append(ctx.train_step(m, c))
        assert np.isfinite(losses).all()
        assert np.mean(losses[-5:]) < np.mean(losses[:5])

    def test_recon_objective_saved_in_checkpoint(self, tmp_path):
        _jc, pc = _cfgs(train=dict(batch_size=4, objective="recon_mrstft"))
        ctx = TrainingContext(pc, build_model(pc.model, num_bins=32),
                              device="cpu")
        m, c = _sampler(tmp_path).sample()
        ctx.train_step(m, c)
        path = str(tmp_path / "recon.npz")
        ctx.save(path)
        _params, meta = load_params_npz(path)
        assert meta["full_config"]["train"]["objective"] == "recon_mrstft"


class TestTRUNetTraining:
    def test_trunet_train_step_and_roundtrip(self, tmp_path):
        from audio_denoising_torch.apps.offline import denoise_array
        from audio_denoising_torch.hub import load_pretrained
        cfg = PRESETS["trunet16k"]
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=2, crop_samples=4096))
        model = build_model(cfg.model, num_bins=cfg.dsp.n_mels)
        ctx = TrainingContext(cfg, model, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        losses = []
        for i in range(4):
            clean = 0.3 * np.sin(np.arange(2 * 4096).reshape(2, 4096)
                                 / (4.0 + i)).astype(np.float32)
            mix = np.clip(clean + 0.3 * rng.standard_normal(
                (2, 4096)).astype(np.float32), -1, 1)
            losses.append(ctx.train_step(mix, clean))
        assert np.isfinite(losses).all()
        path = str(tmp_path / "trunet.npz")
        ctx.save(path)
        cfg2, model2 = load_pretrained(path)
        assert cfg2.model.arch == "TRUNetDenoiser" and cfg2.dsp.n_stft == 257
        out = denoise_array(cfg2, model2, np.zeros(4096, np.float32) + 0.01,
                            16000, device="cpu")
        assert out.shape == (4096,) and np.isfinite(out).all()

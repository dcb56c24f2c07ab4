"""TrainingContext: AdamW with a staircase exponential LR decay, the
residual-MSE and reconstruction objectives, per-iteration loss records
and native checkpoints (JAX counterpart train/context.py).

It mirrors the reference contract (TrainingContext, server.py:86-142:
AdamW, ExponentialLR, batch 64, loss records keyed by total_iters,
best-eval tracking). Features (STFT, mel, log1p) are computed inside the
step on the training device. The parameters are the model's state dict
(buffers such as TRUNet's BatchNorm statistics included, as the JAX
package trains its whole parameter dict), held as leaf tensors and run
through the model with ``torch.func.functional_call``; the optimizer is
``torch.optim.AdamW``, whose update is optax's ``adamw``:
``p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.

The recurrent families train through the matrixized plan built inside
the step (``build_cell_plan(..., trainable=True)``, the probes keeping
the graph back to the conv weights) with the encoder and decoder lifted
out of the recurrence (``plan_apply_parallel``), as JAX does. On the card
every step runs in full fp32 (``fp32_scope``: TF32 off in cuDNN and in
matmuls).
"""

import contextlib
import copy
import dataclasses
import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_denoising_torch import pipeline
from audio_denoising_torch.compat.npz_store import (
    load_params_npz, save_params_npz)
from audio_denoising_torch.config import Config
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.ops import istft, stft
from audio_denoising_torch.train.losses import LOSSES

ORBAX_REFUSAL = ("orbax checkpoints (directories, compat/orbax_store.py) "
                 "are not ported: the orbax package is not available; use "
                 "an .npz checkpoint")
LR_STAIRCASE = 1000    # optimizer steps per LR decay step


@dataclasses.dataclass
class TrainState:
    """The trainable state: parameters by state-dict key, the optimizer
    holding their AdamW moments, the step count (the dropout masks'
    seed), and the LR schedule's own count (optax keeps it apart from
    Adam's; both equal ``step`` unless a checkpoint says otherwise)."""
    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.AdamW
    step: int = 0
    lr_step: int = 0


@contextlib.contextmanager
def fp32_scope():
    """Full fp32 on the card: TF32 off in cuDNN's convolutions
    (``pipeline.fp32_convs``) and in matmuls, restored afterwards."""
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with pipeline.fp32_convs():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


def make_feature_fn(cfg: Config, device="cpu"
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """waveform (B, L) -> log1p frames (B, T, F) on ``device``: mel
    features in the mel domain, the log1p magnitude at n_stft bins in the
    raw domain (the 2-D U-Nets')."""
    dsp = cfg.dsp
    fb, _inv, win = pipeline._transforms(cfg, device)

    def features(wave: torch.Tensor) -> torch.Tensor:
        mag = torch.abs(stft(wave, dsp.n_fft, dsp.hop_length, dsp.win,
                             window=win))
        return pipeline._to_features(cfg, mag, fb).transpose(-1, -2)

    return features


def init_params(cfg: Config, model, seed: int) -> Dict[str, torch.Tensor]:
    """A fresh model's state dict, its initialization drawn from torch's
    generator seeded with ``seed`` (the caller's RNG state is kept)."""
    from audio_denoising_torch.models import build_model
    bins = getattr(model, "num_bins", getattr(model, "bins", None))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_model(cfg.model, num_bins=bins).state_dict()


class _Forward(nn.Module):
    """The model's training forward, as a module so that
    ``functional_call`` runs it on the trainable tensors: (B, T, F)
    features -> (residual prediction (B, T, F), hx' or None)."""

    def __init__(self, model: nn.Module, dropout: float):
        super().__init__()
        self.model = model
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None):
        from audio_denoising_torch.models import GRUUNet2, MOMO3, UNet2d
        from audio_denoising_torch.runtime.plan import (
            build_cell_plan, plan_apply_parallel)
        m = self.model
        if isinstance(m, (GRUUNet2, MOMO3)):
            plan = build_cell_plan(m, trainable=True)
            hx = x.new_zeros((x.shape[0], plan.hidden * plan.compressed))
            return plan_apply_parallel(plan, x, hx)
        if hasattr(m, "compatible_frames"):           # stateless family
            # (B, T, F) frames -> (B, F, T) image, padded to a frame count
            # the fixed-output-padding decoder takes, cropped back
            img = x.transpose(-1, -2)
            t = img.shape[-1]
            img = F.pad(img, (0, m.compatible_frames(t) - t))
            if isinstance(m, UNet2d):
                resid = m.apply(img, generator, self.dropout, rows)
            else:
                resid = m.apply(img)              # TRUNet has no dropout
            resid = resid[..., :x.shape[-1], :t]
            return resid.transpose(-1, -2), None
        return m.apply(x)


class TrainingContext:
    def __init__(self, cfg: Config, model, params: Optional[Dict] = None,
                 seed: int = 0, device=None):
        """``model``: an ``nn.Module`` of the zoo (copied to ``device``,
        the card unless ``"cpu"``); ``params``: its state dict (arrays or
        tensors), or None for a fresh initialization from ``seed``."""
        self.cfg = cfg
        self.device = resolve_device(device)
        tr = cfg.train
        if getattr(cfg.model, "lookahead_frames", 0) and hasattr(
                model, "compatible_frames"):
            raise ValueError(
                "lookahead_frames applies to the recurrent family only; "
                "stateless U-Nets already see their whole segment "
                "(their lookahead is the serving ctx/seg window)")
        if params is None:
            params = init_params(cfg, model, seed)
        # the reference's GaussianSmearing offsets are constants the
        # models compute (models/base.py), not parameters
        known = set(model.state_dict())
        params = {k: v for k, v in params.items()
                  if k in known or not k.endswith("gs.offset")}
        self.model = copy.deepcopy(model).to(self.device)
        self._fwd = _Forward(self.model, getattr(cfg.model, "dropout", 0.0))
        tensors = {k: v if isinstance(v, torch.Tensor)
                   else torch.from_numpy(np.array(v, np.float32))
                   for k, v in params.items()}
        self.keys = sorted(tensors)
        params = {k: tensors[k].detach().to(self.device, torch.float32)
                  .clone().requires_grad_(True) for k in self.keys}

        # teacher-student distillation (train/distill.py): the target is
        # the teacher's denoised output on each mixture
        self._teacher = None
        if getattr(tr, "distill_from", None):
            from audio_denoising_torch.train.distill import load_teacher
            self._teacher = load_teacher(tr.distill_from, cfg, self.device)

        optimizer = torch.optim.AdamW(
            [params[k] for k in self.keys], lr=tr.learning_rate,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=tr.weight_decay)
        self.state = TrainState(params=params, optimizer=optimizer)

        self.features = make_feature_fn(cfg, self.device)
        self.train_loss = LOSSES[tr.loss_metric_train]
        self.eval_loss = LOSSES[tr.loss_metric_eval]
        self.train_loss_record: Dict[int, float] = {}
        self.test_loss_record: Dict[int, float] = {}
        self.best_eval_loss: Optional[float] = None
        self.total_iters = 0

    # -- the schedule ---------------------------------------------------------
    def learning_rate(self, lr_step: int) -> float:
        """optax.exponential_decay(lr, 1000, gamma, staircase=True) at the
        schedule's count (read before its increment)."""
        tr = self.cfg.train
        return tr.learning_rate * tr.lr_gamma ** (lr_step // LR_STAIRCASE)

    def dropout_generator(self, step: int) -> Optional[torch.Generator]:
        """The step's dropout generator, seeded from (train seed, step):
        a resumed run draws the same masks at the same step. None where
        the model has no dropout."""
        from audio_denoising_torch.models import UNet2d
        if not isinstance(self.model, UNet2d) or not self._fwd.dropout:
            return None
        seed = np.random.SeedSequence(
            [self.cfg.train.seed, step]).generate_state(1)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    # -- the objective ----------------------------------------------------------
    def _forward(self, params, x, generator=None, rows=None):
        """``rows`` = (start, global batch): ``x`` is a shard of a larger
        batch, whose dropout masks it takes (``UNet2d.apply``)."""
        return torch.func.functional_call(
            self._fwd, {"model." + k: v for k, v in params.items()},
            (x, generator, rows))

    def _loss(self, params, mixture, clean, loss_fn, generator=None,
              rows=None):
        if self.cfg.train.objective == "recon_mrstft":
            return self._loss_recon(params, mixture, clean, generator, rows)
        la = getattr(self.cfg.model, "lookahead_frames", 0)
        if la:
            # bounded lookahead: la hops of silence past the crop, then
            # pred[t + la] against frame t's target, the flush-and-shift
            # the serving paths perform
            padded = F.pad(mixture, (0, la * self.cfg.dsp.hop_length))
            x_all = self.features(padded)             # (B, T + la, M)
            pred, _ = self._forward(params, x_all, generator, rows)
            x = x_all[:, :x_all.shape[1] - la]
            pred = pred[:, la:]
        else:
            x = self.features(mixture)                # (B, T, M)
            pred, _ = self._forward(params, x, generator, rows)
        target = x - self.features(clean)     # residual target (noisy - clean)
        return loss_fn(pred, target)

    def _loss_recon(self, params, mixture, clean, generator=None,
                    rows=None):
        """The reconstruction objective ('recon_mrstft'): the offline
        phase-reuse chain (STFT, features, the model's residual,
        leaky_relu(0.2) subtract, expm1, inverse mel, noisy-phase iSTFT)
        with autograd on, the denoised waveform scored against clean by
        the multi-resolution STFT loss and waveform L1, plus the residual
        MSE as a stabilizing auxiliary and optionally -SI-SDR / 10."""
        from audio_denoising_torch.train.losses import multi_res_stft

        tr, dsp = self.cfg.train, self.cfg.dsp
        fb, inv, win = pipeline._transforms(self.cfg, mixture.device)
        length = mixture.shape[-1]
        la = getattr(self.cfg.model, "lookahead_frames", 0)
        wave_in = F.pad(mixture, (0, la * dsp.hop_length)) if la else mixture
        spec = stft(wave_in, dsp.n_fft, dsp.hop_length, dsp.win, window=win)
        x = pipeline._to_features(self.cfg, spec.abs(), fb).transpose(-1, -2)
        pred, _ = self._forward(params, x, generator, rows)
        if la:
            # pred[t + la] targets frame t; the la flush frames go, so the
            # reconstruction aligns sample for sample with the mixture
            t_use = x.shape[1] - la
            pred = pred[:, la:]
            x = x[:, :t_use]
            spec = spec[..., :t_use]
        recon = F.leaky_relu(x - pred, 0.2)
        lin = pipeline._to_linear(self.cfg, recon.transpose(-1, -2), inv)
        est = istft(torch.polar(lin, torch.angle(spec)), dsp.n_fft,
                    dsp.hop_length, dsp.win, window=win, length=length)

        target = x - self.features(clean)
        loss = (tr.mrstft_weight * multi_res_stft(est, clean)
                + tr.wave_l1_weight * torch.mean(torch.abs(est - clean))
                + tr.residual_aux_weight * torch.mean((pred - target) ** 2))
        if tr.si_sdr_weight:
            from audio_denoising_torch.train.eval_metrics import si_sdr_db
            loss = loss - tr.si_sdr_weight * torch.mean(
                si_sdr_db(clean, est)) / 10.0
        return loss

    def loss_and_grads(self, mixture, clean):
        """(the training loss, {key: gradient}) at the current parameters
        and step, without an update."""
        p = self.state.params
        with fp32_scope():
            loss = self._loss(p, self._tensor(mixture), self._tensor(clean),
                              self.train_loss,
                              self.dropout_generator(self.state.step))
        grads = torch.autograd.grad(loss, [p[k] for k in self.keys])
        return loss.detach(), dict(zip(self.keys, grads))

    def _step(self, mixture: torch.Tensor, clean: torch.Tensor,
              rows: Optional[Tuple[int, int]] = None,
              reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> torch.Tensor:
        """One AdamW step on device tensors -> the loss (a device
        scalar, not synchronized). ``rows`` = (start, global batch): the
        batch is a shard of a larger one, whose dropout masks it takes.
        ``reduce`` maps the flattened gradients with the loss appended
        (one vector) to the ones the update uses: the data-parallel
        step's all_reduce (``make_sharded_train_step``)."""
        st = self.state
        with fp32_scope():
            loss = self._loss(st.params, mixture, clean, self.train_loss,
                              self.dropout_generator(st.step), rows)
            st.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            loss = loss.detach()
            if reduce is not None:
                params = [st.params[k] for k in self.keys]
                flat = reduce(torch.cat([p.grad.reshape(-1) for p in params]
                                        + [loss.reshape(1)]))
                for p, g in zip(params, torch.split(
                        flat[:-1], [p.numel() for p in params])):
                    p.grad = g.view_as(p)
                loss = flat[-1]
            for group in st.optimizer.param_groups:
                group["lr"] = self.learning_rate(st.lr_step)
            st.optimizer.step()
        st.step += 1
        st.lr_step += 1
        return loss

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # -- host loop ------------------------------------------------------------
    def train_step(self, mixture, clean) -> float:
        mixture = self._tensor(mixture)
        clean = (self._teacher(mixture) if self._teacher is not None
                 else self._tensor(clean))
        val = float(self._step(mixture, clean))
        self.total_iters += 1
        self.train_loss_record[self.total_iters] = val
        return val

    def eval_step(self, mixture, clean) -> float:
        with torch.no_grad(), fp32_scope():
            val = float(self._loss(self.state.params, self._tensor(mixture),
                                   self._tensor(clean), self.eval_loss))
        self.test_loss_record[self.total_iters] = val
        if self.best_eval_loss is None or val < self.best_eval_loss:
            self.best_eval_loss = val
        return val

    def fit(self, sampler, iters: int, eval_every: int = 0,
            log_every: int = 0) -> Dict[int, float]:
        for i, (mixture, clean) in enumerate(sampler):
            if i >= iters:
                break
            loss = self.train_step(mixture, clean)
            if log_every and (i + 1) % log_every == 0:
                print(f"iter {self.total_iters}: train "
                      f"{self.cfg.train.loss_metric_train}={loss:.5f}",
                      flush=True)
            if eval_every and (i + 1) % eval_every == 0:
                m, c = sampler.sample()
                self.eval_step(m, c)
        return self.train_loss_record

    def fit_on_device(self, corpus, iters: int, steps_per_dispatch: int = 10,
                      log_every: int = 0, seed: int = 0, noise_corpus=None,
                      noise_gain=(0.2, 1.0), snr_range_db=None):
        """Training with the batches made on the device
        (train/device_data.py): ``steps_per_dispatch`` steps of batch
        synthesis and update run back to back with no host round trip;
        their losses come to the host once per dispatch. The draws come
        from a generator on the corpus's device seeded with ``seed``."""
        from audio_denoising_torch.train.device_data import (
            make_device_sampler)

        if corpus.buffer.device.type != self.device.type:
            raise ValueError(f"the corpus is on {corpus.buffer.device}, "
                             f"the model trains on {self.device}")
        if snr_range_db is None:
            snr_range_db = self.cfg.train.snr_range_db
        sample = make_device_sampler(
            corpus, self.cfg.train.crop_samples, self.cfg.train.batch_size,
            noise_gain=tuple(noise_gain), noise_corpus=noise_corpus,
            snr_range_db=snr_range_db,
            identity_prob=self.cfg.train.identity_prob)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        done = 0
        while done < iters:
            losses = []
            for _ in range(min(steps_per_dispatch, iters - done)):
                mixture, clean = sample(gen)
                if self._teacher is not None:
                    clean = self._teacher(mixture)
                losses.append(self._step(mixture, clean))
            vals = torch.stack(losses).cpu().tolist()
            for v in vals:
                self.total_iters += 1
                self.train_loss_record[self.total_iters] = v
            done += len(vals)
            if log_every and (done % log_every == 0 or done >= iters):
                print(f"iter {self.total_iters}: train "
                      f"{self.cfg.train.loss_metric_train}={vals[-1]:.5f}",
                      flush=True)
        return self.train_loss_record

    # -- checkpointing ----------------------------------------------------------
    def opt_leaves(self) -> list:
        """The optimizer state as optax's ``adamw`` leaves, JAX's
        ``__opt__`` layout: Adam's count (int32), the first moments and
        then the second in sorted key order, the schedule's count."""
        st = self.state
        mus, nus, count = [], [], 0
        for k in self.keys:
            p = st.params[k]
            s = st.optimizer.state.get(p)
            if s:
                count = int(s["step"])
                mus.append(s["exp_avg"].detach().cpu().numpy())
                nus.append(s["exp_avg_sq"].detach().cpu().numpy())
            else:
                zeros = np.zeros(tuple(p.shape), np.float32)
                mus.append(zeros)
                nus.append(zeros)
        return ([np.asarray(count, np.int32)] + mus + nus
                + [np.asarray(st.lr_step, np.int32)])

    def set_opt_leaves(self, leaves, step: int) -> None:
        """Restore ``opt_leaves``' layout and the step count."""
        n = len(self.keys)
        if len(leaves) != 2 * n + 2:
            raise ValueError(f"{len(leaves)} optimizer leaves for {n} "
                             f"parameters; AdamW's layout has {2 * n + 2}")
        st = self.state
        count = int(leaves[0])
        for i, k in enumerate(self.keys):
            p = st.params[k]
            st.optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": torch.as_tensor(np.asarray(leaves[1 + i]),
                                           device=self.device).float(),
                "exp_avg_sq": torch.as_tensor(np.asarray(leaves[1 + n + i]),
                                              device=self.device).float()}
        st.lr_step = int(leaves[-1])
        st.step = int(step)

    def save(self, path: str, backend: str = "npz") -> None:
        """Native checkpoint: parameters, the optimizer state as
        ``__opt__{i}`` leaves, loss records, config and metadata: the
        fields of the reference's save_model (app.py:43-91) and of the JAX
        package's checkpoints, which resume in either package."""
        if backend != "npz":
            raise ValueError(ORBAX_REFUSAL)
        meta = {
            "arch": self.cfg.model.arch,
            "config": self.cfg.model.to_reference_dict(),
            "full_config": json.loads(self.cfg.to_json()),
            "total_training_iters": self.total_iters,
            "last_target_name": self.cfg.train.target_name,
            "last_batch_size": self.cfg.train.batch_size,
            "loss_metric": {"train": self.cfg.train.loss_metric_train,
                            "test": self.cfg.train.loss_metric_eval},
            "loss_record": {"train": {str(k): v for k, v in
                                      self.train_loss_record.items()},
                            "test": {str(k): v for k, v in
                                     self.test_loss_record.items()}},
        }
        store = {k: v.detach().cpu().numpy()
                 for k, v in self.state.params.items()}
        leaves = self.opt_leaves()
        store.update({f"__opt__{i}": v for i, v in enumerate(leaves)})
        meta["opt_n_leaves"] = len(leaves)
        meta["opt_step"] = self.state.step
        save_params_npz(path, store, meta)

    @classmethod
    def load(cls, path: str, cfg: Config, model,
             device=None) -> "TrainingContext":
        """Resume from an ``.npz`` checkpoint: parameters, the AdamW
        moments and LR step when the checkpoint has its ``__opt__``
        leaves (fresh moments otherwise, as for the shipped ``runs/``),
        the iteration count and loss records."""
        if os.path.isdir(path):
            raise ValueError(ORBAX_REFUSAL)
        stored, meta = load_params_npz(path)
        opt = {k: v for k, v in stored.items() if k.startswith("__opt__")}
        params = {k: v for k, v in stored.items()
                  if not k.startswith("__opt__")}
        self = cls(cfg, model, params=params, device=device)
        n = meta.get("opt_n_leaves")
        if n is not None and len(opt) == n:
            self.set_opt_leaves([opt[f"__opt__{i}"] for i in range(n)],
                                meta.get("opt_step", 0))
        self.total_iters = meta.get("total_training_iters") or 0
        rec = meta.get("loss_record") or {}
        self.train_loss_record = {int(k): v for k, v in
                                  (rec.get("train") or {}).items()}
        self.test_loss_record = {int(k): v for k, v in
                                 (rec.get("test") or {}).items()}
        if self.test_loss_record:
            self.best_eval_loss = min(self.test_loss_record.values())
        return self


def make_sharded_train_step(ctx: TrainingContext, mesh=None):
    """A data-parallel step over the process group that
    ``parallel.distributed.initialize`` joined (JAX counterpart
    context.py:393-408): ``step(mixture (B, L), clean (B, L)) -> loss``
    (a device scalar), updating ``ctx.state`` through
    ``TrainingContext._step`` on the rank's rows; ``mesh`` is ``parallel.distributed.global_mesh()``, or None for
    the whole group.

    Every rank passes the same global batch and holds the same
    parameters. Rank r of W takes the batch's contiguous rows r B/W ..
    (r+1) B/W and computes its loss and gradients in ``fp32_scope``; one
    ``all_reduce`` sums the flattened gradients and the loss over the
    ranks, divided by W; every rank then takes the same AdamW step at the
    LR staircase's rate. Every loss is a mean over examples of equal
    size, so the mean of the ranks' losses is the loss of the whole batch
    and the step is the single-device step on it, up to the order of the
    sums. Dropout masks are drawn at the whole batch's shape and each
    rank keeps its rows. As in JAX, the step takes the batch's clean
    targets (no teacher). The all_reduce is the step's only collective:
    gloo reduces CUDA tensors too, so two ranks may share a card, which
    NCCL refuses."""
    import torch.distributed as dist
    group = None if mesh is None else mesh.get_group()
    world, rank = dist.get_world_size(group), dist.get_rank(group)

    def reduce(flat: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(flat, group=group)
        return flat / world

    def step(mixture, clean) -> torch.Tensor:
        mixture, clean = ctx._tensor(mixture), ctx._tensor(clean)
        b = mixture.shape[0]
        if b % world:
            raise ValueError(f"a batch of {b} does not split over {world} "
                             f"ranks")
        lo, hi = rank * b // world, (rank + 1) * b // world
        return ctx._step(mixture[lo:hi], clean[lo:hi], (lo, b), reduce)

    return step

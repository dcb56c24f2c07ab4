"""Configuration tree of the PyTorch port: a copy of the reference
package's ``config.py`` (stdlib only), so the port imports nothing from
``audio_denoising_tpu``.

The DSP parameters travel with the model config, so a loaded checkpoint
fully determines the processing graph. Keep this file in step with
``audio_denoising_tpu/config.py``: ``tests/test_torch_dsp.py`` checks that
the presets agree.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


def _tup(x) -> Tuple[int, ...]:
    if x is None:
        return None
    if isinstance(x, (int, float)):
        return (int(x),)
    return tuple(int(v) for v in x)


@dataclass(frozen=True)
class DSPConfig:
    """Spectral front-end / back-end parameters.

    Defaults mirror the reference's WebRTC path (app2.py:28-32). The socket
    path (server.py:166-170) uses ``n_fft=1024, hop=512`` with phase reuse.
    """

    sample_rate: int = 48000
    n_fft: int = 1536
    win_length: Optional[int] = None  # None -> n_fft
    hop_length: int = 768
    n_mels: int = 64
    # 'mel'  -> mel log1p domain (app2.py / dari_tult checkpoints)
    # 'raw'  -> clamped raw-spectrogram domain (GRUUNet2-good / MOMO3)
    domain: str = "mel"
    # 'griffin_lim' (app2.py:220) or 'phase' = noisy-phase reuse (server.py:215-216)
    reconstruction: str = "phase"
    griffin_lim_iters: int = 32
    griffin_lim_momentum: float = 0.99
    # RTISI-style streaming warm start: carry converged GL phases across
    # hops and re-seed each window (shifted by one frame) — reaches cold-32
    # quality in ~4-8 iterations once the stream is warm.
    griffin_lim_warm_start: bool = False

    @property
    def win(self) -> int:
        return self.win_length or self.n_fft

    @property
    def n_stft(self) -> int:
        return self.n_fft // 2 + 1


@dataclass(frozen=True)
class ModelConfig:
    """Architecture + hyperparameters, matching the reference's checkpoint
    ``config`` dicts (verified from saves/*/checkpoint.pth)."""

    arch: str = "GRUUNet2"
    num_compressed_bins: int = 4
    in_size: int = 1
    hidden_sizes: Tuple[int, ...] = (17, 17, 17, 17)
    kernel_sizes: Tuple[int, ...] = (3, 3, 3, 3)
    strides: Tuple[int, ...] = (2, 2, 2, 2)
    paddings: Tuple[int, ...] = (1, 1, 1, 1)
    num_gaussians: int = 6
    # 2D U-Net family extras (unet.py / unet4.py)
    chnls_in: int = 1
    chnls_out: int = 1
    chnls_gs: int = 32
    dropout: float = 0.01
    # Bounded lookahead (round 5, VERDICT r4 #1 — the latency–quality
    # frontier): the model's output at step t is trained to target frame
    # t - lookahead_frames, so the recurrence sees `lookahead_frames` of
    # FUTURE context relative to every emitted frame. This is a property
    # of the trained weights (the shift is baked into the objective), so
    # it lives in ModelConfig and travels with the checkpoint; serving
    # surfaces (pipeline.offline_denoise, engine mode 'fast') read it and
    # delay reconstruction by the same k frames. Added serving latency =
    # lookahead_frames * hop_length samples on top of the causal path's.
    # 0 = strictly causal (every pre-round-5 checkpoint). Recurrent
    # (GRUUNet/MOMO) family only — the stateless U-Nets already see their
    # whole segment. No reference counterpart (the reference's latency is
    # fixed at one 32 ms frame, app2.py:185-233).
    lookahead_frames: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_reference_dict(cls, arch: str, cfg: Dict[str, Any]) -> "ModelConfig":
        """Build from a checkpoint's ``config`` field (app2.py:62-99 treats
        that field as the source of truth for reconstruction)."""
        known = {f.name for f in dataclasses.fields(cls)}
        kw: Dict[str, Any] = {"arch": arch}
        extra: Dict[str, Any] = {}
        for k, v in cfg.items():
            if k in ("hidden_sizes", "kernel_sizes", "strides", "paddings"):
                kw[k] = _tup(v)
            elif k in known:
                kw[k] = v
            else:
                extra[k] = v
        kw["extra"] = extra
        return cls(**kw)

    def to_reference_dict(self) -> Dict[str, Any]:
        """Round-trip back to the reference checkpoint ``config`` layout."""
        if self.arch.lower().startswith(("unet2d", "unet4")):
            return dict(
                chnls_in=self.chnls_in, chnls_out=self.chnls_out,
                chnls_gs=self.chnls_gs, dropout=self.dropout, **self.extra,
            )
        d = dict(
            num_compressed_bins=self.num_compressed_bins,
            in_size=self.in_size,
            hidden_sizes=tuple(self.hidden_sizes),
            kernel_sizes=tuple(self.kernel_sizes),
            strides=tuple(self.strides),
            paddings=tuple(self.paddings),
            num_gaussians=self.num_gaussians,
        )
        d.update(self.extra)
        return d


@dataclass(frozen=True)
class ServingConfig:
    """Batched multi-stream serving parameters."""

    max_streams: int = 256
    chunk_samples: int = 768          # samples consumed per stream per step
    # matmul compute dtype for the serving cell ('float32', 'bfloat16' or
    # 'int8'): bf16 doubles MXU rate / halves weight VMEM at a test-locked
    # parity bound (tests/test_fused_hop.py, tests/test_webrtc_hop.py);
    # int8 (engine mode 'fast': W8A8 matrixized plan, runtime/quant.py)
    # runs the MXU's native int8 path with dynamic activation scales at a
    # test-locked agreement bound (tests/test_quant.py). State always
    # stays fp32.
    dtype: str = "float32"
    mesh_axis: str = "streams"        # 1-D mesh axis the batch is sharded over
    state_decay: float = 1.0          # server.py:214 uses hx *= 0.9
    output_gain: float = 1.0          # server.py:213 uses x3
    passthrough_on_underrun: bool = True
    # Cadence-locked segment streaming for the stateless U-Nets (engine
    # mode 'unet'): the per-hop tick buffers ``unet_seg_hops`` hops, then
    # runs the full U-Net once over [ctx | seg | ctx] samples and emits the
    # middle seg over the next cycle (the reference never streams unet4 —
    # unet4.py:147-194 is offline-only — so these semantics are ours).
    # Latency = seg + ctx samples (ctx is the lookahead component; see
    # pipeline.make_unet_stream_step); ctx covers the iSTFT edge taper
    # and gives the conv stack real left/right context at segment joins.
    unet_seg_hops: int = 16
    unet_ctx_samples: int = 960
    # Segment-join crossfade (round 5): the previous cycle's window
    # already denoised the first `unet_xfade_samples` of the NEXT
    # segment (they lie in its right-ctx span); blending that estimate
    # with the new window's over a linear ramp removes the spectral
    # discontinuity at segment joins. Measured on the v2 manifest
    # through the streamed chain (docs/BENCHMARKS.md frontier section):
    # joins are a real LSD cost at every latency budget. Zero added
    # latency (the tail is already computed); must be <= both ctx and
    # seg. 0 = hard splice (the round-2..4 behavior).
    unet_xfade_samples: int = 0
    # Asymmetric window: PAST context is latency-free — only the right
    # ctx (lookahead) and the segment length cost latency. None =
    # symmetric (ctx_left = unet_ctx_samples, the round-2..4 geometry).
    # Setting this to ~1-2 s of samples lets a bounded-lookahead stream
    # hand the U-Net windows the LENGTH it was trained on (2-s crops):
    # the round-5 frontier measurement showed short windows, not segment
    # joins, carry most of the streamed-LSD cost (docs/BENCHMARKS.md).
    # Compute per emitted sample grows with window/seg — a throughput
    # (not latency) tradeoff.
    unet_ctx_left_samples: Optional[int] = None
    # SNR-gated output blend (round 4, VERDICT r3 #1 serving-side): when
    # set, a per-stream estimator (ops/noisefloor.py) reads the input
    # SNR per frame and the output magnitude blends toward PASSTHROUGH
    # on near-clean input. The blend is a clipped RAMP
    # (noisefloor.gate_alpha): alpha = clip((gate + width - snr_est) /
    # (2 * width), 0, 1) — full denoise at/below gate - width, full
    # passthrough at/above gate + width;
    # out = alpha * denoised + (1 - alpha) * input.
    # Counters the causal family's clean-input damage without retraining
    # (every causal checkpoint measured negative ΔSI-SDR at +10 dB input
    # on manifest v2). None = off (bit-identical to round-3 behavior).
    # Tuned operating point for the default 'both' estimator (frame-
    # exact grid search, tools/gate_grid.py on held-out seeds 400+):
    # gate 1 dB with the width/tau defaults — i.e. `--snr-gate 1` alone
    # is the tuned configuration. The single-estimator points: 'removed'
    # gate 1 / width 6, 'floor' gate 10 / width 4.
    snr_gate_db: Optional[float] = None
    snr_gate_width_db: float = 6.0
    # 'both' (default): the model-informed 'removed' estimator (SNR from
    # the EMA ratio of output power to the power the model removed; its
    # dB scale is compressed — tuned gates sit around 0..+3 dB) decides,
    # and the minimum-statistics 'floor' tracker VETOES its false-cleans
    # at fixed distribution-derived constants (noisefloor.FLOOR_VETO_*)
    # — the two estimators fail on DISJOINT streams (measured, round 4:
    # threshold accuracy 0.91/1.00 clean/noisy for the pair vs 0.91/0.97
    # removed-alone and 1.00/0.59 floor-alone on manifest v2). 'removed'
    # and 'floor' run a single estimator. Frame-exact grid search
    # (tools/gate_grid.py, held-out seeds 400+): gate 1 / width 6 /
    # tau 0.1 improves EVERY input-SNR bracket vs ungated.
    snr_gate_estimator: str = "both"
    # Time constant (seconds) of the stream-level power EMAs behind the
    # gate's SNR estimate. The tuning sweep is unambiguous: shorter
    # converges inside real utterances and rescues near-clean audio
    # sooner (tau 2.0 -> 0.1 moves the +10 dB bracket from -0.5 to +0.4
    # on the held-out set) while ~10-frame smoothing still rejects
    # per-frame burst noise.
    snr_gate_tau_s: float = 0.1


@dataclass(frozen=True)
class TrainConfig:
    """Reconstructed training contract (SURVEY §3.5; TrainingContext at
    reference server.py:86-142): AdamW + ExponentialLR(0.9), batch 64,
    MSE on residual target, eval MAE."""

    batch_size: int = 64
    learning_rate: float = 1e-3
    lr_gamma: float = 0.9             # per-epoch exponential decay
    weight_decay: float = 0.01
    seq_frames: int = 64              # frames per training sequence
    crop_samples: int = 48000
    loss_metric_train: str = "MSE"
    loss_metric_eval: str = "MAE"
    target_name: str = "clamped mel-spectrogram"
    seed: int = 0
    # Objective: 'residual_mse' is the reference contract (MSE on the
    # feature-domain residual). 'recon_mrstft' trains THROUGH the full
    # differentiable phase-reuse reconstruction (the same chain the
    # offline/eval path runs) against a multi-resolution STFT +
    # waveform-L1 + residual-MSE composite (train/losses.py) — the
    # round-3 attack on the residual-MSE quality ceiling.
    objective: str = "residual_mse"
    mrstft_weight: float = 1.0
    wave_l1_weight: float = 10.0      # waveforms live in [-1,1]
    residual_aux_weight: float = 0.05
    # negative SI-SDR (dB/10) term — directly optimizes the headline
    # eval metric (scale-invariant, so it composes with any level
    # convention). 0 disables. (Oracle analysis, docs/BENCHMARKS.md:
    # noisy-phase reuse allows +19.9 dB SI-SDR on the eval manifest and
    # the mel-64 bottleneck +11.6, so the metric is model-limited, not
    # phase-limited — worth optimizing directly.)
    si_sdr_weight: float = 0.0
    # Curriculum: when set, per-mixture noise gain targets a uniform SNR
    # in [lo, hi] dB (computed from crop energies on device) instead of
    # the uniform amplitude gain — evens difficulty across the batch.
    snr_range_db: Optional[Tuple[float, float]] = None
    # Easy-input preservation (round 4, VERDICT r3 #1): probability that
    # a training example is mixed with ZERO noise (mixture == clean), so
    # the model must learn identity on clean audio. Counters the causal
    # family's near-clean degradation (-3.2 dB SI-SDR at +10 dB input on
    # manifest v2): the SNR curriculum's gain floor (0.02) never shows
    # the model a truly clean input, so it learns to always suppress.
    identity_prob: float = 0.0
    # Teacher-student distillation (round 5, VERDICT r4 #5): path of a
    # teacher checkpoint. When set, the training target waveform is the
    # TEACHER's denoised output on each mixture (computed on device,
    # stop-gradient) instead of the ground-truth clean crop — the
    # hypothesis is that the teacher's achievable mapping is easier for
    # a causal student to match than the truth. Teacher runs through its
    # own serving chain (stateless segment path for the unet4 family)
    # with any SNR gate disabled. No reference counterpart (the
    # reference trains against clean targets only, SURVEY §3.5).
    distill_from: Optional[str] = None


@dataclass(frozen=True)
class Config:
    dsp: DSPConfig = field(default_factory=DSPConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        def default(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            raise TypeError(type(o))
        return json.dumps(dataclasses.asdict(self), default=default, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        return cls(
            dsp=DSPConfig(**d.get("dsp", {})),
            model=ModelConfig(**{
                k: (_tup(v) if k in ("hidden_sizes", "kernel_sizes", "strides", "paddings") else v)
                for k, v in d.get("model", {}).items()
            }),
            serving=ServingConfig(**d.get("serving", {})),
            train=TrainConfig(**{
                k: (tuple(v) if k == "snr_range_db" and v is not None
                    else v)
                for k, v in d.get("train", {}).items()
            }),
        )


# The causal-streaming (recurrent) family — the architectures the serving
# SNR gate was tuned on (round-4 grid search, tools/gate_grid.py). The
# stateless U-Nets/TRUNet see their whole segment and were not measured
# to benefit; Griffin-Lim reconstruction has no gated path.
CAUSAL_ARCHS = frozenset({"GRUUNet", "GRUUNet2", "MOMO", "MOMO2", "MOMO3"})


def recommended_serving(cfg: Config) -> Config:
    """The measured-best deployment profile (round 5, VERDICT r4 #4):
    enable the TUNED SNR gate (gate 1 dB / width 6 / estimator 'both' /
    tau 0.1 — +0.88 SIG SI-SDR and −0.10 SIG LSD overall vs ungated on
    manifest v2, with the +10 dB input bracket going −3.17 → −0.52) for
    checkpoints where it is applicable and was measured:

    - causal recurrent family (``CAUSAL_ARCHS``) — the stateless
      segment models were not measured to benefit;
    - phase-reuse reconstruction — the Griffin-Lim paths have no gated
      reconstruction;
    - unit ``output_gain`` — the blend mixes toward the RAW input level,
      so x3-gain (residual-objective) checkpoints would level-swing.

    No-op otherwise, and no-op when a gate is already configured. The
    engine daemon applies this in modes ``fast`` and ``fused``. The
    reference's analogue
    is its ad-hoc fixed x3 serving gain (server.py:213-214) — a static
    heuristic where this is a measured per-stream blend."""
    srv = cfg.serving
    if (cfg.model.arch in CAUSAL_ARCHS
            and cfg.dsp.reconstruction == "phase"
            and srv.output_gain == 1.0
            and srv.snr_gate_db is None):
        return dataclasses.replace(cfg, serving=dataclasses.replace(
            srv, snr_gate_db=1.0, snr_gate_width_db=6.0,
            snr_gate_estimator="both", snr_gate_tau_s=0.1))
    return cfg


def with_snr_gate(cfg: Config, gate_db: Optional[float],
                  width_db: Optional[float] = None,
                  estimator: Optional[str] = None) -> Config:
    """``cfg`` with the SNR-gated passthrough blend on (one helper, so
    every surface agrees: the tuning chose (gate, width) pairs). No-op
    when ``gate_db`` is None. Warns on a non-unit ``output_gain``: the
    blend mixes the gained denoised magnitude with the raw input, so the
    gate is meant for level-calibrated (gain 1.0) checkpoints."""
    if gate_db is None:
        return cfg
    if estimator is not None and estimator not in ("removed", "floor",
                                                   "both"):
        raise ValueError(
            f"snr_gate_estimator must be 'removed', 'floor' or 'both', "
            f"got {estimator!r}")
    if cfg.serving.output_gain != 1.0:
        import warnings
        warnings.warn(
            f"snr_gate_db set on a checkpoint with output_gain="
            f"{cfg.serving.output_gain} — the gate blends toward the "
            f"raw input level, so non-unit gains shift level with the "
            f"gate; intended for level-calibrated (gain 1.0) "
            f"checkpoints", stacklevel=2)
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, snr_gate_db=gate_db,
        snr_gate_width_db=(width_db if width_db is not None
                           else cfg.serving.snr_gate_width_db),
        snr_gate_estimator=(estimator if estimator is not None
                            else cfg.serving.snr_gate_estimator)))


PRESETS: Dict[str, Config] = {
    # WebRTC path: mel domain, Griffin-Lim reconstruction (app2.py).
    "gruunet2-dari_tult": Config(
        dsp=DSPConfig(n_fft=1536, hop_length=768, n_mels=64, domain="mel",
                      reconstruction="griffin_lim"),
        model=ModelConfig(arch="GRUUNet2"),
    ),
    "gruunet2-dari_tult2": Config(
        dsp=DSPConfig(n_fft=1536, hop_length=768, n_mels=64, domain="mel",
                      reconstruction="griffin_lim"),
        model=ModelConfig(arch="GRUUNet2"),
    ),
    # Socket path: mel-domain model at 1024/512 with noisy-phase reuse (server.py).
    "gruunet2-good": Config(
        dsp=DSPConfig(n_fft=1024, hop_length=512, n_mels=64, domain="mel",
                      reconstruction="phase"),
        model=ModelConfig(arch="GRUUNet2"),
        serving=ServingConfig(state_decay=0.9, output_gain=3.0, chunk_samples=512),
    ),
    # The BASELINE serving config: 16 kHz streams, 20 ms hops, phase reuse,
    # single-frame fast analysis (n_fft = 2 hops) — the bench.py setup.
    "gruunet2-stream16k": Config(
        dsp=DSPConfig(sample_rate=16000, n_fft=640, hop_length=320,
                      n_mels=64, domain="mel", reconstruction="phase"),
        model=ModelConfig(arch="GRUUNet2"),
        serving=ServingConfig(state_decay=0.9, output_gain=3.0,
                              chunk_samples=320),
    ),
    # Wider mel basis (round 3, ours — no reference counterpart): the
    # oracle ceiling analysis (docs/BENCHMARKS.md) shows clean magnitudes
    # pushed through the mel-64 basis cap SI-SDR improvement at +11.6 dB
    # on the frozen manifest, while mel-128 allows +17.7 — the feature
    # basis, not phase reuse or parameter count, binds quality at 64.
    # Same socket-path DSP as gruunet2-good otherwise; the encoder's four
    # stride-2 levels compress 128 -> 8 bins.
    "gruunet2-mel128": Config(
        dsp=DSPConfig(n_fft=1024, hop_length=512, n_mels=128, domain="mel",
                      reconstruction="phase"),
        model=ModelConfig(arch="GRUUNet2", num_compressed_bins=8),
        serving=ServingConfig(state_decay=0.9, output_gain=3.0,
                              chunk_samples=512),
    ),
    # Five-level variant (round 3, ours): the GRUUNet2 architecture is
    # config-driven in level count, so depth is a searchable axis —
    # 128 -> 64 -> 32 -> 16 -> 8 -> 4 compressed bins, one more
    # stride-2 encoder/decoder pair and GRU gate than the reference's
    # fixed four (gruunet2.py:228-244). Width experiments saturate at
    # hidden 64 on the mel-128 basis (docs/BENCHMARKS.md); this probes
    # the orthogonal capacity direction.
    "gruunet2-mel128d5": Config(
        dsp=DSPConfig(n_fft=1024, hop_length=512, n_mels=128, domain="mel",
                      reconstruction="phase"),
        model=ModelConfig(arch="GRUUNet2", num_compressed_bins=4,
                          hidden_sizes=(17,) * 5, kernel_sizes=(3,) * 5,
                          strides=(2,) * 5, paddings=(1,) * 5),
        serving=ServingConfig(state_decay=0.9, output_gain=3.0,
                              chunk_samples=512),
    ),
    # Stateless magnitude U-Net (unet4) on the raw-spectrogram front-end:
    # BINS=241 = 480/2+1, win 10 ms, hop 384 (utils.py:32-37, unet4.py:32).
    # The reference ships no UNet checkpoint — train via the training CLI.
    "unet4-raw480": Config(
        dsp=DSPConfig(n_fft=480, hop_length=384, n_mels=241, domain="raw",
                      reconstruction="phase"),
        model=ModelConfig(arch="UNet2d4"),
    ),
    # Capacity axis for the stateless family: unet2.py's channel ladder
    # (64/64/128/128/256/256) on the unet4 front-end/head. The reference
    # defines the wide spec (unet2.py:24-60) but never trains it; round 4
    # probes whether the crop2s champion is capacity-limited the way the
    # recurrent family was (mel128 w40 -> w64 gained +1.5 dB SI-SDR).
    "unet4wide-raw480": Config(
        dsp=DSPConfig(n_fft=480, hop_length=384, n_mels=241, domain="raw",
                      reconstruction="phase"),
        model=ModelConfig(arch="UNet2d4Wide"),
    ),
    # TRUNet live (round 3): the vendored model's 257-bin per-frame
    # contract (reference trunet.py:122-158) fixes n_fft = 512
    # (n_stft = 257); 16 kHz is the TRU-Net paper's rate. Raw domain,
    # noisy-phase reconstruction; streams via engine mode 'unet'
    # (stateless cadence-locked segments). The reference ships no TRUNet
    # weights and never wires the model to audio — featurization is ours
    # (models/trunet.py TRUNetDenoiser).
    "trunet16k": Config(
        dsp=DSPConfig(sample_rate=16000, n_fft=512, hop_length=256,
                      n_mels=257, domain="raw", reconstruction="phase"),
        model=ModelConfig(arch="TRUNetDenoiser"),
        train=TrainConfig(batch_size=16, crop_samples=16000,
                          target_name="clamped raw-spectrogram"),
    ),
    # The MOMO3 checkpoint's own metadata says last_target_name =
    # 'clamped raw-spectrogram' (saves/MOMO3-4d4ea0/checkpoint.pth) and its
    # conv geometry fixes the input at 22 bins (22->11->5->3 with strides
    # (2,2,2), paddings (1,0,1)) — so the front-end is the signed-log clamp
    # on a RAW 22-bin spectrum (utils.py:82-95), which forces n_fft = 42
    # (n_stft = n_fft/2+1 = 22). The reference never serves MOMO3 (its
    # serving notebook is a missing blob), so hop is our choice: 21 (50%
    # overlap, hop | n_fft as the fast/fused WOLA paths require).
    "momo3-4d4ea0": Config(
        dsp=DSPConfig(n_fft=42, hop_length=21, n_mels=22, domain="raw",
                      reconstruction="phase"),
        model=ModelConfig(arch="MOMO3", num_compressed_bins=3,
                          hidden_sizes=(16, 16, 16), kernel_sizes=(3, 3, 3),
                          strides=(2, 2, 2), paddings=(1, 0, 1)),
        serving=ServingConfig(chunk_samples=21),
    ),
}


def with_unet_geometry(cfg: Config,
                       seg_hops: Optional[int] = None,
                       ctx: Optional[int] = None,
                       xfade: Optional[int] = None,
                       ctx_left: Optional[int] = None) -> Config:
    """``cfg`` with the segment family's streaming geometry overridden
    (one helper, so the engine daemon, the WebSocket daemon and
    ``denoise --streamed`` agree). Each argument is in its ServingConfig
    field's units (``seg_hops`` in hops, the rest in samples at the
    model's rate); None keeps the checkpoint's value. The algorithmic
    latency is ``seg_hops * hop + ctx`` samples: ``xfade`` (the crossfade
    at a segment join) and ``ctx_left`` (past context) add none."""
    over = {}
    if seg_hops is not None:
        over["unet_seg_hops"] = seg_hops
    if ctx is not None:
        over["unet_ctx_samples"] = ctx
    if xfade is not None:
        over["unet_xfade_samples"] = xfade
    if ctx_left is not None:
        over["unet_ctx_left_samples"] = ctx_left
    if not over:
        return cfg
    return dataclasses.replace(
        cfg, serving=dataclasses.replace(cfg.serving, **over))


# The stateless segment family the streamed-geometry frontier was measured
# on (TRUNetDenoiser also streams through mode 'unet', but its 16 kHz
# window was not swept: it keeps the class defaults).
SEGMENT_ARCHS = frozenset({"UNet2d", "UNet2d3", "UNet2d4", "UNet2d4Wide"})

# The measured-best bounded-latency window of the JAX package's frontier
# (its docs/BENCHMARKS.md), at the 48 kHz / hop-384 basis seg_hops 8, ctx
# 960, ctx_left 44544, xfade 384: 84 ms of algorithmic latency. Kept in
# seconds, so the rule scales to any DSP basis: a ~64 ms segment, 20 ms
# of future context, an 8 ms crossfade, and past context that makes the
# whole window ~1 s (what the 2-s-crop training recipe saw).
_STREAM_SEG_S = 3072 / 48000
_STREAM_CTX_S = 960 / 48000
_STREAM_XFADE_S = 384 / 48000
_STREAM_WINDOW_S = 48576 / 48000


def recommended_streaming_geometry(cfg: Config) -> Config:
    """The measured-best bounded-latency window for ``SEGMENT_ARCHS``,
    applied only where every geometry field still holds its class default
    (an explicit override wins). The daemons in mode ``unet`` and
    ``denoise --streamed`` serve it when no geometry flag is given."""
    srv = cfg.serving
    d = ServingConfig()
    if (cfg.model.arch not in SEGMENT_ARCHS
            or srv.unet_seg_hops != d.unet_seg_hops
            or srv.unet_ctx_samples != d.unet_ctx_samples
            or srv.unet_xfade_samples != d.unet_xfade_samples
            or srv.unet_ctx_left_samples != d.unet_ctx_left_samples):
        return cfg
    sr, hop = cfg.dsp.sample_rate, cfg.dsp.hop_length
    seg_hops = max(1, round(_STREAM_SEG_S * sr / hop))
    seg = seg_hops * hop
    ctx = int(round(_STREAM_CTX_S * sr))
    xfade = min(int(round(_STREAM_XFADE_S * sr)), ctx, seg)
    ctx_left = max(0, int(round(_STREAM_WINDOW_S * sr)) - seg - ctx)
    ctx_left = (ctx_left // hop) * hop     # whole hops (44544 = 116 x 384)
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        srv, unet_seg_hops=seg_hops, unet_ctx_samples=ctx,
        unet_xfade_samples=xfade, unet_ctx_left_samples=ctx_left))

"""Batched multi-stream serving engine (JAX counterpart runtime/engine.py,
``StreamEngine`` at :231).

Modes of the port:

- ``fast``         — the phase-reuse hop op by op (``make_fast_step``):
                     one windowed rfft, mel log1p (raw log1p in the raw
                     domain), one model cell, inverse mel, noisy-phase
                     resynthesis, WOLA;
- ``fused``        — the phase-reuse hop as one kernel launch per tick
                     (ops/kernels/fused_hop.py);
- ``webrtc``       — the reference's Griffin-Lim WebRTC hop op by op
                     (pipeline.make_webrtc_step), cold or warm GL, with
                     the SNR gate where the config sets one;
- ``fused-webrtc`` — the same hop with warm-start GL in the hand-written
                     kernels of ops/kernels/webrtc_hop.py.

Every tick advances all slots and commits state only for the slots that
received a chunk. Per-stream state lives at a slot index of batched
device tensors; slots are admitted and evicted by index, and inactive
slots compute on zeros. Where the JAX engine downgrades a mode that
cannot serve a config, the port raises. Modes ``fast`` and ``fused``
serve the GRUUNet and MOMO families (MOMO v1 in mode ``fast`` only, as
it has no plan); the webrtc modes GRUUNet2.
"""

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from audio_denoising_torch.config import Config
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.ops import (
    hann_window, inverse_mel_matrix, inverse_mel_scale, mel_filterbank,
    mel_scale)
from audio_denoising_torch.ops.kernels.fused_hop import (
    fused_hop_init_state, make_fused_hop)
from audio_denoising_torch.ops.kernels.webrtc_hop import (
    make_webrtc_hop, webrtc_hop_init_state)
from audio_denoising_torch.ops.noisefloor import (
    gate_state, make_gate_estimator)
from audio_denoising_torch.ops.windows import wola_envelope
from audio_denoising_torch.pipeline import (
    fp32_convs, make_webrtc_step, serving_model, webrtc_init_state)
from audio_denoising_torch.runtime.plan import PlanModel, build_cell_plan


class FastState(NamedTuple):
    """JAX counterpart engine.py:34, without the lookahead planes (not
    ported). JAX keeps a MOMO3 carry (hx, prev) as a tuple in ``hx``; here
    prev is a plane of its own, so slot resets and masked commits walk
    named tensors. The SNR-gate planes are present only when
    ``serving.snr_gate_db`` is set: estimator 'floor' carries the nf_*
    planes, 'removed' the em_* EMAs, 'both' all five."""
    ring: torch.Tensor   # (B, n_fft) analysis window
    ola: torch.Tensor    # (B, n_fft) synthesis accumulator
    hx: torch.Tensor     # the model's state: (B, hidden, comp) for the zoo
                         # model, (B, hidden*comp) for a PlanModel
    prev: Optional[torch.Tensor] = None        # (B, F) MOMO3's prev frame
    nf_smooth: Optional[torch.Tensor] = None   # (B, F)
    nf_floor: Optional[torch.Tensor] = None    # (B, F)
    nf_total: Optional[torch.Tensor] = None    # (B,) long power EMA
    em_out: Optional[torch.Tensor] = None      # (B,) output-power EMA
    em_rem: Optional[torch.Tensor] = None      # (B,) removed-power EMA


def _check_fast_supported(cfg: Config) -> None:
    """What the JAX fast step serves and the port's does not yet."""
    if getattr(cfg.model, "lookahead_frames", 0):
        raise NotImplementedError(
            "the fast step's lookahead delay rings "
            "(ModelConfig.lookahead_frames > 0) are not ported yet "
            "(ROADMAP A10)")
    if cfg.dsp.domain == "raw" and cfg.dsp.n_mels != cfg.dsp.n_stft:
        raise ValueError("raw domain: n_mels must equal n_stft (feature "
                         "width)")
    if cfg.dsp.n_fft % cfg.dsp.hop_length:
        raise ValueError("fast mode expects hop | n_fft (WOLA)")


def fast_init_state(cfg: Config, model, batch: int,
                    device: Union[str, torch.device] = "cpu") -> FastState:
    _check_fast_supported(cfg)
    n_fft = cfg.dsp.n_fft
    init = getattr(model, "init_carry", None) or model.init_state
    hx, prev = _split_carry(init(batch, device=device))
    return FastState(
        ring=torch.zeros((batch, n_fft), device=device),
        ola=torch.zeros((batch, n_fft), device=device),
        hx=hx, prev=prev,
        **gate_state(cfg.serving, batch, cfg.dsp.n_stft, device))


def _split_carry(carry):
    """A model's carry as (hx, prev): prev None unless it carries one."""
    return carry if isinstance(carry, tuple) else (carry, None)


def make_snr_gate(cfg: Config):
    """``gate(state, mag, lin) -> (planes, lin')`` for ``cfg``'s SNR gate
    (JAX engine.py:178-216), or None without one: the estimators step on
    this hop's input power ``mag**2`` and the output power ``lin**2``
    (``noisefloor.make_gate_estimator``), then each stream's output
    magnitude blends toward its input by its alpha. ``planes`` holds the
    state fields the gate updated."""
    estimate = make_gate_estimator(cfg.serving, cfg.dsp.hop_length,
                                   cfg.dsp.sample_rate)
    if estimate is None:
        return None

    def gate(state, mag, lin):
        planes, alpha = estimate(state, mag * mag, lin * lin)
        alpha = alpha[:, None]
        return planes, alpha * lin + (1.0 - alpha) * mag

    return gate


def make_fast_step(cfg: Config, model,
                   device: Optional[Union[str, torch.device]] = None):
    """Build ``step(state, chunk (B, hop)) -> (state', out (B, hop))`` on
    ``device`` (the card unless ``"cpu"``; JAX counterpart
    engine.py:95-228, no lookahead).

    Per hop: one windowed rfft (no center padding), mel log1p (in the raw
    domain log1p of the magnitude at n_stft bins, no mel pair), one model
    cell on the carried state (MOMO3's full carry (hx, prev): ``apply``
    would restart the delta every hop), leaky-ReLU 0.2 of the residual,
    expm1, inverse mel (none in the raw domain), the output gain, the
    state decay (the model's ``decay_carry`` where it has one: hx only),
    noisy-phase resynthesis and WOLA
    divided by the window envelope; with ``serving.snr_gate_db`` set,
    the SNR gate (``make_snr_gate``) blends the output magnitude toward
    the input's before resynthesis. ``model`` is a zoo model or a
    PlanModel (``fused=True`` runs its cell as the hand-written kernel)."""
    _check_fast_supported(cfg)
    dsp, srv = cfg.dsp, cfg.serving
    device = resolve_device(device)
    model = serving_model(model, device)
    n_fft, hop = dsp.n_fft, dsp.hop_length
    raw = dsp.domain == "raw"
    if not raw:
        fb = mel_filterbank(dsp.n_stft, dsp.n_mels,
                            dsp.sample_rate).to(device)
        inv = inverse_mel_matrix(dsp.n_stft, dsp.n_mels,
                                 dsp.sample_rate).to(device)
    win = hann_window(n_fft).to(device)
    env_hop = torch.from_numpy(wola_envelope(
        hann_window(n_fft, dtype=torch.float64).numpy(), n_fft, hop)
    ).to(device)
    decay = getattr(model, "decay_carry", None) or (lambda h, f: h * f)
    gate = make_snr_gate(cfg)

    def step(state: FastState, chunk: torch.Tensor
             ) -> Tuple[FastState, torch.Tensor]:
        ring = torch.cat([state.ring[:, hop:], chunk], dim=-1)
        spec = torch.fft.rfft(ring * win, n=n_fft, dim=-1)    # (B, F)
        mag = spec.abs()
        if raw:
            x_t = torch.log1p(mag)
        else:
            x_t = torch.log1p(mel_scale(mag[..., None], fb))[..., 0]
        carry = state.hx if state.prev is None else (state.hx, state.prev)
        with torch.no_grad(), fp32_convs():
            resid, carry = model.cell(x_t, carry)
        rec = torch.nn.functional.leaky_relu(x_t - resid, 0.2)
        feat_mag = torch.clamp(torch.expm1(rec), min=0.0)
        if raw:
            lin = feat_mag * srv.output_gain
        else:
            lin = inverse_mel_scale(feat_mag[..., None], inv)[..., 0] * \
                srv.output_gain
        hx, prev = _split_carry(decay(carry, srv.state_decay))
        planes = {}
        if gate is not None:
            planes, lin = gate(state, mag, lin)
        # angle(0) is 0, so a silent bin is rebuilt as lin + 0j
        synth = torch.fft.irfft(torch.polar(lin, torch.angle(spec)),
                                n=n_fft, dim=-1) * win
        acc = state.ola + synth
        out = acc[:, :hop] / env_hop
        ola = torch.cat([acc[:, hop:], torch.zeros_like(acc[:, :hop])],
                        dim=-1)
        return state._replace(ring=ring, ola=ola, hx=hx, prev=prev,
                              **planes), out

    return step


MODES = ("fast", "fused", "webrtc", "fused-webrtc")


def _quantized_model(model, device):
    """Mode ``fast`` at ``serving.dtype="int8"`` serves the W8A8 plan in
    place of the zoo model (JAX engine.py:344-350), with the same cell
    interface; a PlanModel passed in must already be quantized."""
    if isinstance(model, torch.nn.Module):
        return PlanModel(model, device=device, quantized=True)
    if not getattr(model, "quantized", False):
        raise ValueError("serving dtype 'int8' in mode 'fast' serves the "
                         "quantized plan: pass the zoo model or "
                         "PlanModel(..., quantized=True)")
    return model


def _fields(state: NamedTuple) -> Dict[str, torch.Tensor]:
    """The state's tensors by name; absent (None) fields left out."""
    return {k: v for k, v in state._asdict().items() if v is not None}


class StreamEngine:
    """Admission-controlled batched serving over a fixed slot table.

    A stream's lifecycle is add -> process xN -> remove (slot state reset
    to the mode's initial state on add). ``device`` is the card unless
    ``"cpu"`` is passed, which runs the kernels' plain PyTorch versions.
    In mode ``fast`` ``model`` may be a zoo model or a PlanModel; the other
    modes take a zoo model: GRUUNet2, MOMO2 or MOMO3 in mode ``fused``
    (``build_cell_plan`` compiles either family), GRUUNet2 in the webrtc
    modes. ``serving.dtype`` picks the compute: mode ``fused`` runs the
    fused hop in it (float32, bfloat16 or int8); mode ``fast`` serves the
    quantized plan at int8 and float32 otherwise, as JAX's fast step
    ignores bfloat16."""

    def __init__(self, cfg: Config, model, mode: str = "fused",
                 max_streams: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if mode not in MODES:
            raise ValueError(f"engine mode {mode!r} is not ported yet; the "
                             f"port has {MODES}")
        if getattr(cfg.model, "lookahead_frames", 0):
            if mode in ("fast", "fused"):
                # the JAX engine serves them in mode 'fast' (and downgrades
                # 'fused' to it); the port's fast step has no delay rings
                raise NotImplementedError(
                    "bounded-lookahead checkpoints need the fast step's "
                    "delay rings, which are not ported yet (ROADMAP A10)")
            raise ValueError(
                f"engine mode {mode!r} does not support lookahead "
                f"checkpoints (ModelConfig.lookahead_frames > 0)")
        if cfg.serving.snr_gate_db is not None and mode == "fused-webrtc":
            # the JAX engine downgrades to mode 'webrtc', whose op-by-op
            # step carries the gate; the port serves only the mode asked
            raise ValueError(
                "the fused webrtc kernel has no SNR gate "
                "(serving.snr_gate_db is set); engine mode 'webrtc' serves "
                "the gate on the op-by-op Griffin-Lim step")
        if cfg.serving.dtype == "int8" and mode not in ("fast", "fused"):
            # the JAX engine warns and serves mode 'fast' (ROADMAP A7)
            raise ValueError(
                f"serving dtype 'int8' is implemented in engine modes "
                f"'fast' (the quantized plan) and 'fused' (the int8 fused "
                f"hop), not in mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.n = max_streams or cfg.serving.max_streams
        self.hop = cfg.dsp.hop_length
        self.plan = None
        # each maker raises for what its hop lacks before it resolves the
        # device; on the card the kernel hops then check what the card can
        # take (a block's shared memory)
        if mode == "fast":
            if cfg.serving.dtype == "int8":
                model = _quantized_model(model, device)
            self.hop_step = make_fast_step(cfg, model, device)
            self.device = resolve_device(device)
            init = lambda b: fast_init_state(cfg, model, b, self.device)
        elif mode == "webrtc":
            self.hop_step = make_webrtc_step(cfg, model, device)
            self.device = resolve_device(device)
            init = lambda b: webrtc_init_state(cfg, model, b, self.device)
        else:
            self.plan = build_cell_plan(model)
            make, init_state = (
                (make_fused_hop, fused_hop_init_state) if mode == "fused"
                else (make_webrtc_hop, webrtc_hop_init_state))
            self.hop_step = make(cfg, self.plan, device,
                                 compute_dtype=getattr(torch,
                                                       cfg.serving.dtype))
            self.device = self.hop_step.device
            init = lambda b: init_state(cfg, self.plan, b, self.device)
        self.state = init(self.n)
        self._zero_one = init(1)      # what add_stream resets a slot to
        self.slots: Dict[str, int] = {}
        self._free = list(range(self.n - 1, -1, -1))

    # -- lifecycle ---------------------------------------------------------
    def add_stream(self, stream_id: str) -> int:
        if stream_id in self.slots:
            raise KeyError(f"stream {stream_id!r} already active")
        if not self._free:
            raise RuntimeError("engine full: no free stream slots")
        slot = self._free.pop()
        for name, t in _fields(self.state).items():
            t[slot] = getattr(self._zero_one, name)[0]
        self.slots[stream_id] = slot
        return slot

    def remove_stream(self, stream_id: str) -> None:
        slot = self.slots.pop(stream_id)
        self._free.append(slot)

    @property
    def active_streams(self) -> int:
        return len(self.slots)

    @property
    def algorithmic_latency_samples(self) -> int:
        """What the serving mode itself delays the audio by (JAX
        engine.py:513-541): in modes ``fast`` and ``fused`` the
        hop-synchronous overlap-add holds ``n_fft - hop`` samples (the
        lookahead term is 0: lookahead checkpoints are refused); in the
        webrtc modes the segment leaves before the newest frame enters the
        OLA buffer (app2.py:226-231), the same window tail."""
        return self.cfg.dsp.n_fft - self.cfg.dsp.hop_length

    @property
    def algorithmic_latency_ms(self) -> float:
        return (self.algorithmic_latency_samples
                / self.cfg.dsp.sample_rate * 1e3)

    # -- data path -----------------------------------------------------------
    def _step(self, batch: torch.Tensor) -> Tuple[NamedTuple, torch.Tensor]:
        # ingress sanitization: a NaN/Inf sample would poison the slot's
        # recurrent state for good (the carry never forgets it, and masked
        # commit cannot help: the poisoned tick is a real chunk)
        batch = torch.where(torch.isfinite(batch), batch,
                            torch.zeros_like(batch))
        return self.hop_step(self.state, batch)

    def _gather(self, chunks: Dict[str, np.ndarray]):
        batch = np.zeros((self.n, self.hop), np.float32)
        mask = np.zeros((self.n,), np.bool_)
        slot_map = {}
        for sid, chunk in chunks.items():
            slot = self.slots[sid]
            batch[slot] = chunk
            mask[slot] = True
            slot_map[sid] = slot
        return batch, mask, slot_map

    def process_async(self, chunks: Dict[str, np.ndarray]
                      ) -> Tuple[torch.Tensor, Dict[str, int]]:
        """Advance every slot with a chunk this tick and return
        ``(out (N, hop) on the device, slot_map)`` without waiting for the
        device. Only those slots commit their new state: a stream's
        recurrence must not advance on the zero inputs of ticks it missed."""
        batch, mask, slot_map = self._gather(chunks)
        batch = torch.from_numpy(batch).to(self.device)
        keep = torch.from_numpy(mask).to(self.device)[:, None]
        new, out = self._step(batch)
        self.state = self.state._replace(**{
            k: torch.where(keep.reshape((-1,) + (1,) * (v.dim() - 1)),
                           getattr(new, k), v)
            for k, v in _fields(self.state).items()})
        return out, slot_map

    def process(self, chunks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """chunks: {stream_id: (hop,) float32} -> same keyed outputs."""
        out, slot_map = self.process_async(chunks)
        out = out.cpu().numpy()
        return {sid: out[slot] for sid, slot in slot_map.items()}

    def process_batch(self, batch: torch.Tensor) -> torch.Tensor:
        """Raw fixed-shape path: (N, hop) in -> (N, hop) out, every slot
        advances."""
        self.state, out = self._step(batch.to(self.device))
        return out

    # -- failure recovery: snapshot/restore of stream state ------------------
    def snapshot(self) -> Dict:
        """Host-side copy of all per-stream state and the slot table."""
        return {
            "state": {k: v.cpu().numpy()
                      for k, v in _fields(self.state).items()},
            "slots": dict(self.slots),
            "free": list(self._free),
            "mode": self.mode,
        }

    def restore(self, snap: Dict) -> None:
        if snap["mode"] != self.mode:
            raise ValueError(f"snapshot mode {snap['mode']!r} != engine "
                             f"mode {self.mode!r}")
        current = _fields(self.state)
        if set(snap["state"]) != set(current):
            raise ValueError("snapshot state layout mismatch")
        state = self.state._replace(**{
            k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
            for k, v in snap["state"].items()})
        mismatched = [(tuple(v.shape), tuple(current[k].shape))
                      for k, v in _fields(state).items()
                      if v.shape != current[k].shape]
        if mismatched:
            raise ValueError(
                f"snapshot shapes {mismatched} do not match this engine "
                f"(different max_streams or DSP config?)")
        self.state = state
        self.slots = dict(snap["slots"])
        self._free = list(snap["free"])

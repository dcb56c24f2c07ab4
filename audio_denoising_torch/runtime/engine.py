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
                     kernels of ops/kernels/webrtc_hop.py;
- ``unet``         — cadence-locked segment streaming for the stateless
                     U-Nets and TRUNetDenoiser
                     (pipeline.make_unet_stream_step): every tick shifts
                     a hop into each slot's window and drains its
                     segment, and every ``unet_seg_hops``-th tick runs
                     the model over every window at once. No hand-written
                     kernel: JAX's segment path reaches no Pallas kernel.

Every tick advances all slots and, but in mode ``unet``, commits state
only for the slots that received a chunk. Per-stream state lives at a
slot index of batched device tensors; slots are admitted and evicted by
index, and inactive slots compute on zeros. Where a mode cannot serve a
config, the engine warns and serves another, as the JAX engine does (``_downgrade``,
``_fit``; ``engine.mode`` names the mode served): a bounded-lookahead
checkpoint is served in mode ``fast`` (its delay rings; ``fused`` is
downgraded to it, the webrtc modes refuse it), and the gated int8
flagship stays in ``fused``. Modes ``fast`` and ``fused`` serve the
GRUUNet and MOMO families (MOMO v1 in mode ``fast`` only, as it has no
plan); the webrtc modes GRUUNet2, ``fused-webrtc`` in fp32 or with its
Griffin-Lim loop in bf16 (``serving.dtype="bfloat16"``); mode ``unet``
the segment family, in fp32 (as in JAX, bfloat16 is ignored there and
int8 is downgraded to mode ``fast``).
"""

import warnings
from functools import partial
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from audio_denoising_torch.config import Config
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.ops import (
    hann_window, inverse_mel_matrix, inverse_mel_scale, mel_filterbank,
    mel_scale, spec_phase)
from audio_denoising_torch.ops.kernels.fused_hop import (
    fused_hop_init_state, fused_hop_smem_bytes, make_fused_hop)
from audio_denoising_torch.ops.kernels.webrtc_hop import (
    make_webrtc_hop, webrtc_hop_init_state, webrtc_hop_smem_bytes)
from audio_denoising_torch.ops.noisefloor import (
    gate_state, make_gate_estimator)
from audio_denoising_torch.ops.windows import wola_envelope
from audio_denoising_torch.parallel.mesh import gather, shard_engine_step
from audio_denoising_torch.pipeline import (
    fp32_convs, make_unet_stream_step, make_webrtc_step, serving_model,
    unet_stream_init_state, webrtc_init_state)
from audio_denoising_torch.runtime.plan import PlanModel, build_cell_plan


class FastState(NamedTuple):
    """JAX counterpart engine.py:34. JAX keeps a MOMO3 carry (hx, prev)
    as a tuple in ``hx``; here prev is a plane of its own, so slot resets
    and masked commits walk named tensors. The SNR-gate planes are
    present only when ``serving.snr_gate_db`` is set: estimator 'floor'
    carries the nf_* planes, 'removed' the em_* EMAs, 'both' all five."""
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
    la_mag: Optional[torch.Tensor] = None      # (B, k, F)
    la_phase: Optional[torch.Tensor] = None    # (B, k, F)


def _check_fast_supported(cfg: Config) -> None:
    """What the fast step refuses, as the JAX one asserts."""
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
    la = cfg.model.lookahead_frames
    rings = {}
    if la:
        rings = {k: torch.zeros((batch, la, cfg.dsp.n_stft), device=device)
                 for k in ("la_mag", "la_phase")}
    return FastState(
        ring=torch.zeros((batch, n_fft), device=device),
        ola=torch.zeros((batch, n_fft), device=device),
        hx=hx, prev=prev,
        **gate_state(cfg.serving, batch, cfg.dsp.n_stft, device), **rings)


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
    engine.py:95-228).

    Per hop: one windowed rfft (no center padding), mel log1p (in the raw
    domain log1p of the magnitude at n_stft bins, no mel pair), one model
    cell on the carried state (MOMO3's full carry (hx, prev): ``apply``
    would restart the delta every hop), leaky-ReLU 0.2 of the residual,
    expm1, inverse mel (none in the raw domain), the output gain, the
    state decay (the model's ``decay_carry`` where it has one: hx only),
    noisy-phase resynthesis and WOLA
    divided by the window envelope; with ``serving.snr_gate_db`` set,
    the SNR gate (``make_snr_gate``) blends the output magnitude toward
    the input's before resynthesis. With ``model.lookahead_frames`` = k
    > 0 the cell still consumes the newest frame, but its residual
    applies to frame t - k: the step pops that frame's magnitude and
    phase from the delay rings and pushes the new frame's, and the
    residual, the gate and the phase reuse all take the delayed frame.
    ``model`` is a zoo model or a PlanModel (``fused=True`` runs its cell
    as the hand-written kernel)."""
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
    la = cfg.model.lookahead_frames

    def features(mag):
        if raw:
            return torch.log1p(mag)
        return torch.log1p(mel_scale(mag[..., None], fb))[..., 0]

    def step(state: FastState, chunk: torch.Tensor
             ) -> Tuple[FastState, torch.Tensor]:
        ring = torch.cat([state.ring[:, hop:], chunk], dim=-1)
        spec = torch.fft.rfft(ring * win, n=n_fft, dim=-1)    # (B, F)
        mag, phase = spec.abs(), spec_phase(spec)
        x_t = features(mag)
        carry = state.hx if state.prev is None else (state.hx, state.prev)
        with torch.no_grad(), fp32_convs():
            resid, carry = model.cell(x_t, carry)
        rings = {}
        if la:
            # the residual targets frame t - la: pop it, push frame t
            rings = dict(
                la_mag=torch.cat([state.la_mag[:, 1:], mag[:, None]], 1),
                la_phase=torch.cat([state.la_phase[:, 1:], phase[:, None]],
                                   1))
            mag, phase = state.la_mag[:, 0], state.la_phase[:, 0]
            x_t = features(mag)
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
        synth = torch.fft.irfft(torch.polar(lin, phase),
                                n=n_fft, dim=-1) * win
        acc = state.ola + synth
        out = acc[:, :hop] / env_hop
        ola = torch.cat([acc[:, hop:], torch.zeros_like(acc[:, :hop])],
                        dim=-1)
        return state._replace(ring=ring, ola=ola, hx=hx, prev=prev,
                              **planes, **rings), out

    return step


MODES = ("fast", "fused", "webrtc", "fused-webrtc", "unet")


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


def hop_smem_bytes(cfg: Config, plan, mode: str) -> int:
    """The shared memory a block of mode ``mode``'s kernel takes for
    ``cfg`` and ``plan`` (fused_hop_smem_bytes at ``serving.dtype``, or
    webrtc_hop_smem_bytes: -1 where the WebRTC kernels do not take the
    geometry)."""
    if mode == "fused":
        return fused_hop_smem_bytes(cfg, plan,
                                    getattr(torch, cfg.serving.dtype))
    return webrtc_hop_smem_bytes(cfg, plan)


def shared_memory_limit(device: Optional[Union[str, torch.device]]
                        ) -> Optional[int]:
    """The shared memory a block may take on ``device`` (the card unless
    ``"cpu"``): the card's opt-in limit; None on the CPU, which runs the
    kernels' plain versions, and where there is no card (the hop's maker
    then raises, after its own checks)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def _downgrade(cfg: Config, mode: str) -> str:
    """The mode that serves ``cfg`` when ``mode`` cannot, with a warning
    naming both, as the JAX engine does (engine.py:260-308): a
    bounded-lookahead checkpoint in ``fused`` is served by ``fast`` (only
    the op-by-op step has the delay rings) and refused by the webrtc
    modes; a gated ``fused-webrtc`` is served by ``webrtc`` (the kernel
    has no gate; the op-by-op step carries it); int8 outside
    ``fast``/``fused`` by ``fast`` (on the quantized plan; in mode
    ``unet`` too, where no model of the segment family has a plan, so
    the engine then refuses it, as JAX's fails in its plan)."""
    if cfg.model.lookahead_frames and mode != "fast":
        if mode != "fused":
            raise ValueError(
                f"engine mode {mode!r} does not support lookahead "
                f"checkpoints (ModelConfig.lookahead_frames > 0); use "
                f"mode 'fast'")
        warnings.warn("lookahead checkpoints are served by the op-by-op "
                      "fast step (the fused kernel has no delay rings); "
                      "engine mode 'fused' downgraded to 'fast'",
                      stacklevel=3)
        mode = "fast"
    if cfg.serving.snr_gate_db is not None and mode == "fused-webrtc":
        warnings.warn("snr_gate_db is set but the fused webrtc kernel does "
                      "not implement the gate; engine mode 'fused-webrtc' "
                      "downgraded to 'webrtc'", stacklevel=3)
        mode = "webrtc"
    if cfg.serving.dtype == "int8" and mode not in ("fast", "fused"):
        warnings.warn(f"serving dtype 'int8' is implemented for engine "
                      f"modes 'fast' and 'fused' only; engine mode {mode!r} "
                      f"downgraded to 'fast'", stacklevel=3)
        mode = "fast"
    return mode


def _fit(cfg: Config, plan, mode: str, device) -> str:
    """Mode ``mode`` (``fused`` or ``fused-webrtc``), or its op-by-op mode
    with a warning where its kernel needs more shared memory per block
    than the card has (``hop_smem_bytes`` against
    ``shared_memory_limit``; the JAX engine counts VMEM, engine.py:310-
    342). A geometry the WebRTC kernels do not take (-1: n_fft / 2 with
    a prime factor above 5) is not a capacity case: the kernel's wrapper
    raises."""
    limit = shared_memory_limit(device)
    if limit is None:
        return mode
    need = hop_smem_bytes(cfg, plan, mode)
    if need <= limit:
        return mode
    fallback = "fast" if mode == "fused" else "webrtc"
    warnings.warn(f"the {mode} kernel needs {need} B of shared memory per "
                  f"block at serving dtype {cfg.serving.dtype}, over the "
                  f"card's {limit} B; engine mode {mode!r} downgraded to "
                  f"{fallback!r}", stacklevel=3)
    return fallback


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
    modes, a model with ``compatible_frames`` (the U-Nets,
    TRUNetDenoiser) in mode ``unet``. ``serving.dtype`` picks the
    compute: mode ``fused`` runs the fused hop in it (float32, bfloat16
    or int8); mode ``fast`` serves the quantized plan at int8 and float32
    otherwise, as JAX's fast step ignores bfloat16.

    Mode ``unet`` is cadence-locked (JAX engine.py:417-440): segment
    boundaries belong to the engine's tick, not to a stream, so every
    slot advances every tick, with no mask; an active stream that misses
    a tick gets zeros spliced into its segment. The cycle's phase is a
    host int, advanced only after a step succeeded, and carried by
    ``snapshot``/``restore``.

    ``mesh`` (``parallel.make_mesh``; JAX engine.py:240-256) shards the
    slots over the mesh's entries in contiguous blocks, which
    ``max_streams`` must divide: each entry holds its block's state
    (``shards``) on its device, and each tick runs every entry's hop on
    its block through a step of its own (``shard_engine_step``; in mode
    ``fused`` one ``FusedHop`` per entry, as ``make_fused_hop_sharded``
    builds them; the phase of mode ``unet`` is shared). The outputs meet on the first entry's device,
    ``device``. With a mesh, ``device`` must be None; ``state`` reads
    the whole batch gathered there (a copy) and writing it splits a
    whole batch over the shards. A PlanModel, built for one device, is
    served on a mesh of that device only."""

    def __init__(self, cfg: Config, model, mode: str = "fused",
                 max_streams: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        if mode not in MODES:
            raise ValueError(f"unknown engine mode {mode!r}; the port has "
                             f"{MODES}")
        self.n = max_streams or cfg.serving.max_streams
        if mesh is not None:
            if device is not None:
                raise ValueError("a mesh names its devices; pass device="
                                 "None with mesh")
            if self.n % mesh.size:
                raise ValueError(f"max_streams ({self.n}) must divide "
                                 f"evenly over the mesh's {mesh.size} "
                                 f"entries")
        entries = mesh.devices if mesh is not None else (device,)
        mode = _downgrade(cfg, mode)
        if mode != "unet" and hasattr(model, "compatible_frames"):
            # JAX fails deeper here (an AttributeError in the step or the
            # plan); int8 in mode unet lands here through _downgrade
            raise ValueError(
                f"engine mode {mode!r} streams the recurrent families; "
                f"{type(model).__name__} is a stateless segment model, "
                f"served in mode 'unet' at float32 (serving dtype "
                f"{cfg.serving.dtype!r})")
        plan = None
        if mode in ("fused", "fused-webrtc"):
            plan = build_cell_plan(model)
            # the card with the least shared memory per block decides
            mode = _fit(cfg, plan, mode, min(
                entries, key=lambda d: shared_memory_limit(d) or 0))
        if mode == "unet" and not hasattr(model, "compatible_frames"):
            raise ValueError(
                f"mode='unet' needs a stateless U-Net (model "
                f"{type(model).__name__} has no compatible_frames); "
                f"recurrent models stream via 'fast'/'webrtc'/'fused'")
        self.plan = plan if mode in ("fused", "fused-webrtc") else None
        self.cfg = cfg
        self.mode = mode
        self.mesh = mesh
        self.hop = cfg.dsp.hop_length
        compute = getattr(torch, cfg.serving.dtype)

        def build(d):
            """(this mode's step on device ``d``, its initial state of a
            batch) -- each maker raises for what its hop lacks, before it
            looks for the device; on the card the kernel hops check again
            what _fit checked (a block's shared memory)."""
            if mode == "fast":
                m = (_quantized_model(model, d)
                     if cfg.serving.dtype == "int8" else model)
                step, init = make_fast_step(cfg, m, d), partial(
                    fast_init_state, cfg, m)
            elif mode == "webrtc":
                step, init = make_webrtc_step(cfg, model, d), partial(
                    webrtc_init_state, cfg, model)
            elif mode == "unet":
                step, init = make_unet_stream_step(cfg, model, d), partial(
                    unet_stream_init_state, cfg, model)
            else:
                make, init_state = ((make_fused_hop, fused_hop_init_state)
                                    if mode == "fused" else
                                    (make_webrtc_hop, webrtc_hop_init_state))
                step = make(cfg, self.plan, d, compute_dtype=compute)
                init = partial(init_state, cfg, self.plan)
            d = resolve_device(d)
            return step, lambda b: init(b, d)

        inits = []

        def make_step(d):
            step, init = build(d)
            inits.append(init)
            return step

        if mesh is None:
            self.hop_step = make_step(device)
            self.devices = (resolve_device(device),)
        else:
            # one step per entry, also where the mesh repeats a device
            self.hop_step = shard_engine_step(make_step, mesh)
            self.devices = mesh.devices
        self.device = self.devices[0]
        self._per = self.n // len(self.devices)   # slots per shard
        self.shards = [init(self._per) for init in inits]
        self._zero_ones = [init(1) for init in inits]   # add_stream's reset
        self._cadence_locked = mode == "unet"
        self._seg_hops = cfg.serving.unet_seg_hops if self._cadence_locked \
            else 1
        self._phase = 0
        self.slots: Dict[str, int] = {}
        self._free = list(range(self.n - 1, -1, -1))

    @property
    def state(self) -> NamedTuple:
        """Every slot's state: the one shard's, or with a mesh the shards
        gathered on ``device`` (a copy)."""
        if len(self.shards) == 1:
            return self.shards[0]
        return gather(self.shards, self.device)

    @state.setter
    def state(self, state: NamedTuple) -> None:
        """A whole batch's state, split over the shards' devices."""
        self.shards = [
            type(state)(*(None if t is None else
                          t[i * self._per:(i + 1) * self._per].to(d)
                          for t in state))
            for i, d in enumerate(self.devices)]

    # -- lifecycle ---------------------------------------------------------
    def add_stream(self, stream_id: str) -> int:
        if stream_id in self.slots:
            raise KeyError(f"stream {stream_id!r} already active")
        if not self._free:
            raise RuntimeError("engine full: no free stream slots")
        slot = self._free.pop()
        shard, row = divmod(slot, self._per)
        zero = self._zero_ones[shard]
        for name, t in _fields(self.shards[shard]).items():
            t[row] = getattr(zero, name)[0]
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
        hop-synchronous overlap-add holds ``n_fft - hop`` samples, plus
        ``lookahead_frames * hop`` on a bounded-lookahead checkpoint (the
        delay rings hold k frames before reconstruction); in the webrtc
        modes the segment leaves before the newest frame enters the OLA
        buffer (app2.py:226-231), the same window tail; in mode ``unet``
        ``seg + ctx``: a segment leaves only once its right context has
        arrived."""
        dsp = self.cfg.dsp
        if self._cadence_locked:
            srv = self.cfg.serving
            return srv.unet_seg_hops * dsp.hop_length + srv.unet_ctx_samples
        base = dsp.n_fft - dsp.hop_length
        if self.mode in ("fast", "fused"):
            base += self.cfg.model.lookahead_frames * dsp.hop_length
        return base

    @property
    def algorithmic_latency_ms(self) -> float:
        return (self.algorithmic_latency_samples
                / self.cfg.dsp.sample_rate * 1e3)

    # -- data path -----------------------------------------------------------
    def _step(self, batches: List[torch.Tensor]
              ) -> Tuple[List[NamedTuple], List[torch.Tensor]]:
        """Every shard's hop on its block of the batch -> (the shards' new
        states, their outputs)."""
        # ingress sanitization: a NaN/Inf sample would poison the slot's
        # recurrent state for good (the carry never forgets it, and masked
        # commit cannot help: the poisoned tick is a real chunk)
        batches = [torch.where(torch.isfinite(b), b, torch.zeros_like(b))
                   for b in batches]
        phase = (self._phase,) if self._cadence_locked else ()
        if self.mesh is None:
            new, out = self.hop_step(self.shards[0], batches[0], *phase)
            return [new], [out]
        return self.hop_step(self.shards, batches, *phase)

    def _split(self, batch) -> List[torch.Tensor]:
        """A whole (N, ...) batch (numpy or a tensor) as each shard's block
        on its device."""
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        p = self._per
        return [batch[i * p:(i + 1) * p].to(d)
                for i, d in enumerate(self.devices)]

    def _join(self, outs: List[torch.Tensor]) -> torch.Tensor:
        """The shards' outputs in slot order on ``device``: a copy from
        another card is ordered after that card's hop, so work recorded
        on ``device``'s stream afterwards follows every shard's."""
        return outs[0] if len(outs) == 1 else gather(outs, self.device)

    def _advance_phase(self) -> None:
        """Advance the segment cycle's phase; called only after a step
        succeeded, so a step that raises leaves phase and ring in step."""
        self._phase = (self._phase + 1) % self._seg_hops

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
        recurrence must not advance on the zero inputs of ticks it missed.
        In mode ``unet`` every slot advances and commits (zeros where no
        chunk came)."""
        batch, mask, slot_map = self._gather(chunks)
        news, outs = self._step(self._split(batch))
        if self._cadence_locked:
            self.shards = news
            self._advance_phase()
            return self._join(outs), slot_map
        self.shards = [
            old._replace(**{
                k: torch.where(keep.reshape((-1,) + (1,) * (v.dim() - 1)),
                               getattr(new, k), v)
                for k, v in _fields(old).items()})
            for old, new, keep in zip(self.shards, news, self._split(mask))]
        return self._join(outs), slot_map

    def process(self, chunks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """chunks: {stream_id: (hop,) float32} -> same keyed outputs."""
        out, slot_map = self.process_async(chunks)
        out = out.cpu().numpy()
        return {sid: out[slot] for sid, slot in slot_map.items()}

    def process_batch(self, batch: torch.Tensor) -> torch.Tensor:
        """Raw fixed-shape path: (N, hop) in -> (N, hop) out, every slot
        advances."""
        self.shards, outs = self._step(self._split(batch))
        if self._cadence_locked:
            self._advance_phase()
        return self._join(outs)

    # -- failure recovery: snapshot/restore of stream state ------------------
    def snapshot(self) -> Dict:
        """Host-side copy of all per-stream state and the slot table (the
        whole batch, with or without a mesh)."""
        return {
            "state": {k: np.concatenate([getattr(sh, k).cpu().numpy()
                                         for sh in self.shards])
                      for k in _fields(self.shards[0])},
            "slots": dict(self.slots),
            "free": list(self._free),
            "mode": self.mode,
            "phase": self._phase,
        }

    def restore(self, snap: Dict) -> None:
        if snap["mode"] != self.mode:
            raise ValueError(f"snapshot mode {snap['mode']!r} != engine "
                             f"mode {self.mode!r}")
        current = _fields(self.state)
        if set(snap["state"]) != set(current):
            raise ValueError("snapshot state layout mismatch")
        state = self.state._replace(**{
            k: torch.as_tensor(np.asarray(v, np.float32))
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
        self._phase = int(snap.get("phase", 0)) % self._seg_hops

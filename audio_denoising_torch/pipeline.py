"""The offline full-clip denoise and the op-by-op streaming steps (JAX
counterpart pipeline.py: ``_transforms`` :37, ``_to_features`` :51,
``_to_linear`` :57, ``_apply_snr_gate`` :66, ``offline_denoise`` :115,
``jit_offline_denoiser`` :454; the segment family's
``offline_denoise_stateless`` :163, ``UNetStreamState`` :200,
``unet_stream_init_state`` :245, ``make_unet_stream_step`` :269 and
``offline_denoise_streamed`` :412; the webrtc part, ``WebRTCState`` :464,
``webrtc_init_state`` :490, ``make_webrtc_step`` :520; and
``make_server_step`` :653).

``offline_denoise``: a whole clip at once, STFT, features (log1p of the
mel-scaled or raw magnitude), the model over all frames, residual
subtract, leaky_relu(0.2), expm1, inverse mel, the optional SNR gate over
the whole clip, then phase reuse or full-clip Griffin-Lim. A
bounded-lookahead checkpoint gets ``la`` hops of silence to flush its
tail and its output re-aligned. ``offline_denoiser`` binds it to a
device. It runs no hand-written kernel, as the JAX graph reaches no
Pallas kernel.

``offline_denoise_stateless``: a stateless segment model (the 2-D
U-Nets, TRUNetDenoiser) over a whole (freq, time) log-magnitude image,
padded to a frame count the model takes, with noisy-phase resynthesis.
``make_unet_stream_step``: engine mode ``unet``'s cadence-locked step,
which runs that graph once a cycle over each slot's sample window;
``offline_denoise_streamed`` runs a clip through it. None of them runs a
hand-written kernel: JAX's segment path reaches no Pallas kernel.

``make_webrtc_step``: one hop of the reference's app2.py recv loop
(app2.py:174-233), op by op: ring buffer, per-window peak normalization,
Hann pre-window, 3-frame centered STFT, mel log1p, the model over the
three frames with carried hx, residual subtract, leaky_relu(0.2), expm1,
inverse mel, Griffin-Lim, peak de-normalization and overlap-add. With
``dsp.griffin_lim_warm_start`` the converged GL phases are carried from
hop to hop and re-seeded one frame later (RTISI-style streaming GL).
This is engine mode ``webrtc`` and the oracle of the fused WebRTC hop
(ops/kernels/webrtc_hop.py). With ``serving.snr_gate_db`` set, the SNR
gate (ops/noisefloor.py) steps its estimators on the un-normalized newest
frame of each hop and blends the Griffin-Lim target magnitudes toward the
input's, carrying its planes in the state.

``make_server_step``: one server.py recv message (server.py:200-216), a
centered STFT over the whole chunk, the model, ReLU on its residual, the
output gain, the state decay, the inverse mel and the ISTFT with the
noisy phase. ``profile --mode server`` runs it.

Each step takes a zoo model (an ``nn.Module``, copied to the device) or
a ``runtime.plan.PlanModel`` built for that device.
"""

import copy
import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from audio_denoising_torch.config import Config
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.ops import (
    griffin_lim, hann_window, inverse_mel_matrix, inverse_mel_scale,
    istft, mel_filterbank, mel_scale, num_frames, spec_phase, stft)
from audio_denoising_torch.ops.noisefloor import (
    FLOOR_VETO_GATE_DB, FLOOR_VETO_WIDTH_DB, FloorState, RemovedState,
    floor_rise_per_frame, gate_alpha, gate_planes, gate_state,
    make_gate_estimator, noise_floor_scan, removed_powers, removed_snr_db,
    removed_snr_scan, removed_step, smooth_beta_per_frame, snr_db_from_floor,
    total_beta_per_frame)


def serving_model(model, device: torch.device):
    """The model a step runs on ``device``: a zoo model (``nn.Module``) is
    copied there in eval mode; a PlanModel is built for one device and
    must be on this one."""
    if isinstance(model, torch.nn.Module):
        return copy.deepcopy(model).to(device).eval()
    if model.device.type != device.type:
        raise ValueError(f"this model was built for {model.device}, the "
                         f"step runs on {device}")
    return model


def fp32_convs():
    """Scope the model's convolutions to full fp32: cuDNN takes TF32 for
    fp32 convolutions by default on the card."""
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled,
        benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic,
        allow_tf32=False)


def _transforms(cfg: Config, device: Union[str, torch.device] = "cpu"):
    """(mel filterbank, its inverse, analysis window) on ``device``; the
    mel pair is None in the raw domain."""
    dsp = cfg.dsp
    win = hann_window(dsp.win).to(device)
    if dsp.domain == "raw":
        if dsp.n_mels != dsp.n_stft:
            raise ValueError("raw domain: n_mels must equal n_stft "
                             "(feature width)")
        return None, None, win
    fb = mel_filterbank(dsp.n_stft, dsp.n_mels, dsp.sample_rate).to(device)
    inv = inverse_mel_matrix(dsp.n_stft, dsp.n_mels,
                             dsp.sample_rate).to(device)
    return fb, inv, win


def _to_features(cfg: Config, mag: torch.Tensor, fb) -> torch.Tensor:
    """(B, F, T) magnitude -> (B, M, T) model features per cfg.dsp.domain."""
    if cfg.dsp.domain == "raw":
        return torch.log1p(mag)   # signed-log clamp == log1p on magnitudes
    return torch.log1p(mel_scale(mag, fb))


def _to_linear(cfg: Config, feat_out: torch.Tensor, inv) -> torch.Tensor:
    """(B, M, T) reconstructed features -> (B, F, T) linear magnitude."""
    lin = torch.clamp(torch.expm1(feat_out), min=0.0)
    if cfg.dsp.domain == "raw":
        return lin
    return inverse_mel_scale(lin, inv)


def offline_gate_alpha(cfg: Config, mag: torch.Tensor,
                       lin_mag: torch.Tensor) -> Optional[torch.Tensor]:
    """(B, T) per-frame denoise weight in [0, 1] of the SNR gate over a
    whole clip (ops/noisefloor.py: the causal estimators scanned over all
    frames), or None without a gate. mag/lin_mag: (B, F, T) linear
    input/output magnitudes."""
    srv = cfg.serving
    if srv.snr_gate_db is None:
        return None
    power = mag * mag
    hop, sr = cfg.dsp.hop_length, cfg.dsp.sample_rate
    beta_tot = total_beta_per_frame(hop, sr, srv.snr_gate_tau_s)

    def removed_alpha():
        p_out, p_rem = removed_powers(power, lin_mag * lin_mag, axis=-2)
        snr, _ = removed_snr_scan(p_out, p_rem, beta_tot)      # (B, T)
        return gate_alpha(snr, srv.snr_gate_db, srv.snr_gate_width_db)

    def floor_alpha(gate_db, width_db):
        floors, totals, _ = noise_floor_scan(
            power, floor_rise_per_frame(hop, sr),
            smooth_beta_per_frame(hop, sr), beta_tot)
        snr = snr_db_from_floor(totals, floors.mean(dim=-2))
        return gate_alpha(snr, gate_db, width_db)

    est = srv.snr_gate_estimator
    if est == "removed":
        alpha = removed_alpha()
    elif est == "floor":
        alpha = floor_alpha(srv.snr_gate_db, srv.snr_gate_width_db)
    else:  # 'both': the floor tracker vetoes the removed decision
        alpha = torch.maximum(
            removed_alpha(),
            floor_alpha(FLOOR_VETO_GATE_DB, FLOOR_VETO_WIDTH_DB))
    return alpha


def _apply_snr_gate(cfg: Config, mag: torch.Tensor,
                    lin_mag: torch.Tensor) -> torch.Tensor:
    """The gated output blend: frames read as near-clean lean toward the
    input magnitude (with the reused noisy phase, passthrough-exact).
    No-op without a gate."""
    alpha = offline_gate_alpha(cfg, mag, lin_mag)
    if alpha is None:
        return lin_mag
    alpha = alpha[:, None, :]
    return alpha * lin_mag + (1.0 - alpha) * mag


def offline_denoise(cfg: Config, model, audio: torch.Tensor,
                    hx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """audio: (B, L) or (L,) -> denoised audio of the same shape, on the
    device and in the dtype of ``audio`` (where ``model`` must be too).
    The DSP constants follow the audio's dtype, so a float64 clip with a
    float64 model runs the whole chain in float64."""
    dsp = cfg.dsp
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    length = audio.shape[-1]
    fb, inv, win = (None if t is None else t.to(audio.dtype)
                    for t in _transforms(cfg, audio.device))

    la = getattr(cfg.model, "lookahead_frames", 0)
    if la:
        # the model's output at step t targets frame t - la: feed la hops
        # of silence to flush the tail, as the stream does when the input
        # ends, and re-align below
        audio = torch.nn.functional.pad(audio, (0, la * dsp.hop_length))
    spec = stft(audio, dsp.n_fft, dsp.hop_length, dsp.win, window=win)
    mag = spec.abs()
    x = _to_features(cfg, mag, fb).transpose(-1, -2)          # (B, T, M)
    with torch.no_grad(), fp32_convs():
        resid, _ = model.apply(x, hx)
    if la:
        t_use = x.shape[1] - la            # frame count of the raw input
        resid = resid[:, la:]              # pred[t + la] targets frame t
        x = x[:, :t_use]
        spec = spec[..., :t_use]
        mag = mag[..., :t_use]
    recon = torch.nn.functional.leaky_relu(x - resid, 0.2)
    lin_mag = _to_linear(cfg, recon.transpose(-1, -2), inv)   # (B, F, T)
    lin_mag = _apply_snr_gate(cfg, mag, lin_mag)

    if dsp.reconstruction == "phase":
        out = istft(torch.polar(lin_mag, spec_phase(spec)), dsp.n_fft,
                    dsp.hop_length, dsp.win, window=win, length=length)
    else:
        out = griffin_lim(lin_mag, dsp.n_fft, dsp.hop_length, dsp.win,
                          window=win, n_iter=dsp.griffin_lim_iters,
                          momentum=dsp.griffin_lim_momentum, length=length)
    return out[0] if squeeze else out


def offline_denoiser(cfg: Config, model,
                     device: Optional[Union[str, torch.device]] = None):
    """``fn(audio) -> audio``: ``offline_denoise`` with the model copied
    to ``device`` (the card unless ``"cpu"``) once; ``audio`` (B, L) or
    (L,), a tensor or an array, is taken to that device as float32."""
    device = resolve_device(device)
    model = serving_model(model, device)

    def fn(audio) -> torch.Tensor:
        return offline_denoise(cfg, model, torch.as_tensor(
            audio, dtype=torch.float32, device=device))

    return fn


def offline_denoise_stateless(cfg: Config, model,
                              audio: torch.Tensor) -> torch.Tensor:
    """Offline denoise through a stateless segment model, a 2-D U-Net or
    TRUNetDenoiser (JAX pipeline.py:163-197): STFT, log1p magnitude, the
    model's residual over the whole (freq, time) image, subtract, ReLU,
    expm1, the optional SNR gate over the clip, noisy-phase iSTFT. The
    U-Nets take only some frame counts (fixed output paddings,
    unet4.py:211-230), so the spectrogram pads to
    ``model.compatible_frames`` and the output crops back. ``audio`` (B,
    L) or (L,), on the device and in the dtype of ``model``."""
    dsp = cfg.dsp
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    length = audio.shape[-1]
    win = hann_window(dsp.win).to(audio.device, audio.dtype)
    spec = stft(audio, dsp.n_fft, dsp.hop_length, dsp.win, window=win)
    mag = spec.abs()
    logmag = torch.log1p(mag)                               # (B, F, T)
    t = logmag.shape[-1]
    x = torch.nn.functional.pad(logmag, (0, model.compatible_frames(t) - t))
    with torch.no_grad(), fp32_convs():
        resid = model.apply(x)[..., :dsp.n_stft, :t]
    lin = torch.expm1(torch.clamp(logmag - resid, min=0.0))
    lin = _apply_snr_gate(cfg, mag, lin)
    out = istft(torch.polar(lin, spec_phase(spec)), dsp.n_fft,
                dsp.hop_length, dsp.win, window=win, length=length)
    return out[0] if squeeze else out


class UNetStreamState(NamedTuple):
    """A slot's state in cadence-locked segment streaming (JAX
    pipeline.py:200-226)."""
    ring: torch.Tensor   # (B, ctx_left + seg + ctx) input sample history
    out: torch.Tensor    # (B, seg) the segment being drained
    # the previous window's estimate of the next segment's first xf
    # samples (in its denoised right context), blended at the join; None
    # without a crossfade
    tail: Optional[torch.Tensor] = None        # (B, xf)
    # the SNR gate's planes, carried across windows (a window is too short
    # for the estimators to settle): 'floor' the nf_* planes, 'removed'
    # the em_* EMAs, 'both' all five; present only with a gate
    nf_smooth: Optional[torch.Tensor] = None   # (B, F)
    nf_floor: Optional[torch.Tensor] = None    # (B, F)
    nf_total: Optional[torch.Tensor] = None    # (B,)
    em_out: Optional[torch.Tensor] = None      # (B,)
    em_rem: Optional[torch.Tensor] = None      # (B,)


def _unet_stream_geometry(cfg: Config) -> Tuple[int, int, int, int, int]:
    """(hop, seg_hops, seg, ctx_right, ctx_left). The latency is ``seg +
    ctx_right``; ctx_left is past samples, which only grow a window's
    compute (``serving.unet_ctx_left_samples``, None for symmetric)."""
    hop = cfg.dsp.hop_length
    seg_hops = cfg.serving.unet_seg_hops
    ctx = cfg.serving.unet_ctx_samples
    ctx_l = cfg.serving.unet_ctx_left_samples
    return (hop, seg_hops, seg_hops * hop, ctx,
            ctx if ctx_l is None else ctx_l)


def _unet_xfade(cfg: Config) -> int:
    xf = cfg.serving.unet_xfade_samples
    if xf:
        _h, _p, seg, ctx, _cl = _unet_stream_geometry(cfg)
        if xf > min(seg, ctx):
            raise ValueError(
                f"unet_xfade_samples={xf} exceeds min(seg={seg}, "
                f"ctx={ctx}) — the crossfade tail must lie inside the "
                f"previous window's denoised right context")
    return xf


def unet_stream_init_state(cfg: Config, model, batch: int,
                           device: Union[str, torch.device] = "cpu"
                           ) -> UNetStreamState:
    _h, _p, seg, ctx, ctx_l = _unet_stream_geometry(cfg)
    xf = _unet_xfade(cfg)
    return UNetStreamState(
        ring=torch.zeros((batch, ctx_l + seg + ctx), device=device),
        out=torch.zeros((batch, seg), device=device),
        tail=torch.zeros((batch, xf), device=device) if xf else None,
        **gate_state(cfg.serving, batch, cfg.dsp.n_stft, device))


def _unet_window_denoiser(cfg: Config, model, device: torch.device):
    """``denoise(ring, state) -> (segment, planes)``: one window through
    ``offline_denoise_stateless`` (ungated), its middle segment with the
    crossfade at the join, then the SNR gate with its estimators carried
    across windows; ``planes`` holds the state fields it updated."""
    _hop, _p, seg, ctx, ctx_l = _unet_stream_geometry(cfg)
    srv, dsp = cfg.serving, cfg.dsp
    removed, floor = gate_planes(srv)
    inner = dataclasses.replace(cfg, serving=dataclasses.replace(
        srv, snr_gate_db=None))
    xf = _unet_xfade(cfg)
    if xf:
        # the new window's weight rises 0 -> 1 over the join; the previous
        # window's estimate (its own side's context) has the complement
        ramp = (torch.arange(1, xf + 1, dtype=torch.float32, device=device)
                / (xf + 1))
    if removed:
        # one EMA update per emitted segment: its retention takes the
        # segment as the hop
        beta_seg = total_beta_per_frame(seg, dsp.sample_rate,
                                        srv.snr_gate_tau_s)
    if floor:
        win = hann_window(dsp.win).to(device)
        rise = floor_rise_per_frame(dsp.hop_length, dsp.sample_rate)
        beta = smooth_beta_per_frame(dsp.hop_length, dsp.sample_rate)
        beta_t = total_beta_per_frame(dsp.hop_length, dsp.sample_rate,
                                      srv.snr_gate_tau_s)
        both = srv.snr_gate_estimator == "both"
        f_gate = FLOOR_VETO_GATE_DB if both else srv.snr_gate_db
        f_width = FLOOR_VETO_WIDTH_DB if both else srv.snr_gate_width_db

    def denoise(ring: torch.Tensor, state: UNetStreamState):
        den = offline_denoise_stateless(inner, model, ring)
        mid = den[:, ctx_l:ctx_l + seg]
        planes = {}
        if xf:
            mid = torch.cat([ramp * mid[:, :xf] + (1.0 - ramp) * state.tail,
                             mid[:, xf:]], dim=1)
            # the next segment's first xf samples, as this window sees them
            planes["tail"] = den[:, ctx_l + seg:ctx_l + seg + xf]
        if not (removed or floor):
            return mid, planes
        # the estimators read the emitted span only: contiguous and
        # disjoint across cycles, each sample seen once
        mid_in = ring[:, ctx_l:ctx_l + seg]
        alpha = None
        if removed:
            # time-domain segment powers (by Parseval the bin means the
            # spectral paths use, less the per-bin clip)
            p_in = (mid_in * mid_in).mean(dim=1)
            p_out = (mid * mid).mean(dim=1)
            rs = removed_step(RemovedState(state.em_out, state.em_rem),
                              p_out, torch.clamp(p_in - p_out, min=0.0),
                              beta_seg)
            alpha = gate_alpha(removed_snr_db(rs), srv.snr_gate_db,
                               srv.snr_gate_width_db)
            planes.update(em_out=rs.out, em_rem=rs.rem)
        if floor:
            power = stft(mid_in, dsp.n_fft, dsp.hop_length, dsp.win,
                         window=win).abs() ** 2
            _f, _t, last = noise_floor_scan(
                power, rise, beta, beta_t, init=FloorState(
                    state.nf_smooth, state.nf_floor, state.nf_total))
            alpha_f = gate_alpha(
                snr_db_from_floor(last.total, last.floor.mean(dim=-1)),
                f_gate, f_width)
            alpha = alpha_f if alpha is None else torch.maximum(alpha,
                                                                alpha_f)
            planes.update(nf_smooth=last.smooth, nf_floor=last.floor,
                          nf_total=last.total)
        alpha = alpha[:, None]
        return alpha * mid + (1.0 - alpha) * mid_in, planes

    return denoise


def _unet_step(cfg: Config, model, device: torch.device):
    hop, seg_hops, _s, _c, _cl = _unet_stream_geometry(cfg)
    denoise = _unet_window_denoiser(cfg, model, device)

    def step(state: UNetStreamState, chunk: torch.Tensor, phase: int
             ) -> Tuple[UNetStreamState, torch.Tensor]:
        ring = torch.cat([state.ring[:, hop:], chunk], dim=-1)
        # emit from the previous cycle's segment before (maybe) refilling
        out = state.out[:, phase * hop:(phase + 1) * hop].clone()
        if phase != seg_hops - 1:
            return state._replace(ring=ring), out
        with torch.no_grad():
            seg, planes = denoise(ring, state)
        return state._replace(ring=ring, out=seg, **planes), out

    return step


def make_unet_stream_step(cfg: Config, model,
                          device: Optional[Union[str, torch.device]] = None):
    """Build ``step(state, chunk (B, hop), phase) -> (state', out (B,
    hop))`` on ``device`` (the card unless ``"cpu"``) for a stateless
    segment model (JAX pipeline.py:269-409; engine mode ``unet``).

    Cadence-locked block processing, the JAX package's own semantics (the
    reference only runs these models offline, unet4.py:147-194): every
    tick shifts one hop into a ``[ctx_left | seg | ctx]`` sample ring and
    emits one hop of the segment being drained; on the tick that closes a
    cycle (``phase == seg_hops - 1``) the offline graph runs once over
    the ring and its middle ``seg`` samples, crossfaded at the join and
    gated, become the next cycle's segment. The emitted stream is the
    input delayed by ``seg + ctx`` samples. ``phase`` is a host int: the
    boundary is a Python branch, read nowhere from the device, so the
    other ticks cost only the ring shift."""
    device = resolve_device(device)
    return _unet_step(cfg, serving_model(model, device), device)


def offline_denoise_streamed(cfg: Config, model,
                             audio: torch.Tensor) -> torch.Tensor:
    """Denoise a clip exactly as engine mode ``unet`` serves it (JAX
    pipeline.py:412-451): the cadence-locked window chain of
    ``make_unet_stream_step`` hop by hop, with the ``seg + ctx`` delay
    removed so the output aligns with the input sample for sample. The
    model sees the future context a live stream would, where
    ``offline_denoise_stateless`` hands it the whole clip. ``audio`` (B,
    L) or (L,), on the device of ``model``."""
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    hop, seg_hops, seg, ctx, _cl = _unet_stream_geometry(cfg)
    b, length = audio.shape
    delay = seg + ctx
    n_ticks = -(-(length + delay) // hop)          # whole hops
    x = torch.nn.functional.pad(audio, (0, n_ticks * hop - length))
    step = _unet_step(cfg, model, audio.device)
    state = unet_stream_init_state(cfg, model, b, audio.device)
    outs = []
    for t in range(n_ticks):
        state, out = step(state, x[:, t * hop:(t + 1) * hop], t % seg_hops)
        outs.append(out)
    y = torch.cat(outs, dim=1)[:, delay:delay + length]
    return y[0] if squeeze else y


class WebRTCState(NamedTuple):
    ring: torch.Tensor   # (B, n_fft) input window
    ola: torch.Tensor    # (B, n_fft) overlap-add accumulator
    hx: torch.Tensor     # (B, hidden, compressed) model state
    # carried GL phases as real (B, F, T, 2) [..., (re, im)] planes, the
    # JAX package's layout; None unless dsp.griffin_lim_warm_start
    gl_angles: Optional[torch.Tensor] = None
    # the SNR gate's planes, present only when serving.snr_gate_db is set:
    # estimator 'floor' the nf_* planes, 'removed' the em_* EMAs, 'both'
    # all five; tracked on the un-normalized newest frame of each hop
    nf_smooth: Optional[torch.Tensor] = None   # (B, F)
    nf_floor: Optional[torch.Tensor] = None    # (B, F)
    nf_total: Optional[torch.Tensor] = None    # (B,) long power EMA
    em_out: Optional[torch.Tensor] = None      # (B,) output-power EMA
    em_rem: Optional[torch.Tensor] = None      # (B,) removed-power EMA


def _webrtc_frames(cfg: Config) -> int:
    """Frames in one centered n_fft window's STFT."""
    return num_frames(cfg.dsp.n_fft, cfg.dsp.n_fft, cfg.dsp.hop_length)


def webrtc_init_state(cfg: Config, model, batch: int,
                      device: Union[str, torch.device] = "cpu"
                      ) -> WebRTCState:
    n_fft = cfg.dsp.n_fft
    angles = None
    if cfg.dsp.griffin_lim_warm_start:
        # warm seed 1+0j
        angles = torch.zeros((batch, cfg.dsp.n_stft, _webrtc_frames(cfg), 2),
                             device=device)
        angles[..., 0] = 1.0
    return WebRTCState(
        ring=torch.zeros((batch, n_fft), device=device),
        ola=torch.zeros((batch, n_fft), device=device),
        hx=model.init_state(batch, device=device),
        gl_angles=angles,
        **gate_state(cfg.serving, batch, cfg.dsp.n_stft, device))


def make_webrtc_step(cfg: Config, model,
                     device: Optional[Union[str, torch.device]] = None):
    """Build ``step(state, chunk (B, hop)) -> (state', out (B, hop))`` on
    ``device`` (the card unless ``"cpu"``). The output segment is emitted
    before the new frame enters the OLA buffer (app2.py:226-231). With the
    SNR gate, ``state`` carries its planes (``webrtc_init_state``)."""
    dsp = cfg.dsp
    if getattr(cfg.model, "lookahead_frames", 0):
        raise ValueError(
            "lookahead checkpoints (ModelConfig.lookahead_frames > 0) "
            "stream via the delayed phase-reuse path; the Griffin-Lim "
            "webrtc path has no delayed magnitude ring")
    gate = make_gate_estimator(cfg.serving, dsp.hop_length, dsp.sample_rate)
    device = resolve_device(device)
    model = serving_model(model, device)
    n_fft, hop = dsp.n_fft, dsp.hop_length
    fb, inv, win = _transforms(cfg, device)
    # per-bin phase advance of one hop for the extrapolated newest frame:
    # advancing time by `hop` multiplies bin k by e^{+2 pi i k hop / n_fft}
    # under rfft's e^{-2 pi i k n / N} convention (pipeline.py:164-175)
    gl_rot = torch.from_numpy(np.exp(
        2j * np.pi * np.arange(dsp.n_stft) * hop / n_fft
    )[None, :, None].astype(np.complex64)).to(device)

    def step(state: WebRTCState, chunk: torch.Tensor
             ) -> Tuple[WebRTCState, torch.Tensor]:
        ring = torch.cat([state.ring[:, hop:], chunk], dim=-1)
        peak = ring.abs().amax(dim=-1, keepdim=True)
        ok = peak > 1e-6
        normed = torch.where(ok, ring / torch.where(ok, peak, 1.0), ring)
        peak = torch.where(ok, peak, 1.0)

        windowed = normed * win                            # Hann pre-window
        spec = stft(windowed, n_fft, hop, dsp.win, window=win)
        mag = spec.abs()
        logmel = torch.log1p(mel_scale(mag, fb))            # (B, M, T=3)
        x = logmel.transpose(-1, -2)
        with torch.no_grad(), fp32_convs():
            resid, hx = model.apply(x, state.hx)
        recon = torch.nn.functional.leaky_relu(x - resid, 0.2)
        mel_mag = torch.clamp(torch.expm1(recon.transpose(-1, -2)), min=0.0)
        lin_mag = inverse_mel_scale(mel_mag, inv)
        planes = {}
        if gate is not None:
            # the estimators read the newest frame at the input's scale;
            # the blend moves the GL targets of all three frames toward
            # the input's magnitudes
            planes, alpha = gate(state, (mag[..., -1] * peak) ** 2,
                                 (lin_mag[..., -1] * peak) ** 2)
            alpha = alpha[:, None, None]
            lin_mag = alpha * lin_mag + (1.0 - alpha) * mag
        if dsp.griffin_lim_warm_start:
            # re-seed from the carried phases shifted one frame; the new
            # frame reuses the last one's, advanced by one hop
            carried = torch.complex(state.gl_angles[..., 0],
                                    state.gl_angles[..., 1])
            seed = torch.cat([carried[..., 1:], carried[..., -1:] * gl_rot],
                             dim=-1)
            frame, angles_c = griffin_lim(
                lin_mag, n_fft, hop, dsp.win, window=win,
                n_iter=dsp.griffin_lim_iters,
                momentum=dsp.griffin_lim_momentum,
                init_angles=seed, return_angles=True)
            angles = torch.stack([angles_c.real, angles_c.imag], dim=-1)
        else:
            angles = state.gl_angles
            frame = griffin_lim(lin_mag, n_fft, hop, dsp.win, window=win,
                                n_iter=dsp.griffin_lim_iters,
                                momentum=dsp.griffin_lim_momentum)
        frame = frame * peak

        out = state.ola[:, :hop]
        ola = torch.cat([state.ola[:, hop:],
                         torch.zeros_like(state.ola[:, :hop])], dim=-1)
        ola = ola + frame
        return state._replace(ring=ring, ola=ola, hx=hx, gl_angles=angles,
                              **planes), out

    return step


def make_server_step(cfg: Config, model,
                     device: Optional[Union[str, torch.device]] = None):
    """Build ``step(hx, chunk (B, L)) -> (hx', out (B, L))`` on ``device``
    (the card unless ``"cpu"``): the chunk is processed as one centered
    STFT exactly like a server.py recv message, with the output gain and
    state decay of the serving config. ReLU on the residual, no clamp
    before the inverse mel: not the fast step's nonlinearity."""
    dsp, srv = cfg.dsp, cfg.serving
    if getattr(cfg.model, "lookahead_frames", 0):
        raise ValueError(
            "lookahead checkpoints (ModelConfig.lookahead_frames > 0) "
            "stream via engine mode 'fast'; the per-message server step "
            "cannot carry the cross-chunk delay ring")
    device = resolve_device(device)
    model = serving_model(model, device)
    fb, inv, win = _transforms(cfg, device)

    def step(hx: torch.Tensor, chunk: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        length = chunk.shape[-1]
        spec = stft(chunk, dsp.n_fft, dsp.hop_length, dsp.win, window=win)
        logmel = torch.log1p(mel_scale(spec.abs(), fb))
        with torch.no_grad(), fp32_convs():
            out, hx = model.apply(logmel.transpose(-1, -2), hx)
        out = torch.relu(out.transpose(-1, -2)) * srv.output_gain
        hx = hx * srv.state_decay
        lin = inverse_mel_scale(torch.exp(logmel - out) - 1.0, inv)
        # angle(0) is 0, so a silent bin is rebuilt as lin + 0j
        rec = torch.polar(lin, spec_phase(spec))
        y = istft(rec, dsp.n_fft, dsp.hop_length, dsp.win, window=win,
                  length=length)
        return hx, y

    return step

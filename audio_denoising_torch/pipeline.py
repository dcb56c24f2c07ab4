"""The offline full-clip denoise and the op-by-op streaming steps (JAX
counterpart pipeline.py: ``_transforms`` :37, ``_to_features`` :51,
``_to_linear`` :57, ``_apply_snr_gate`` :66, ``offline_denoise`` :115,
``jit_offline_denoiser`` :454; the webrtc part, ``WebRTCState`` :464,
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
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from audio_denoising_torch.config import Config
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.ops import (
    griffin_lim, hann_window, inverse_mel_matrix, inverse_mel_scale,
    istft, mel_filterbank, mel_scale, num_frames, stft)
from audio_denoising_torch.ops.noisefloor import (
    FLOOR_VETO_GATE_DB, FLOOR_VETO_WIDTH_DB, floor_rise_per_frame,
    gate_alpha, gate_state, make_gate_estimator, noise_floor_scan,
    removed_powers, removed_snr_scan, smooth_beta_per_frame,
    snr_db_from_floor, total_beta_per_frame)


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
        out = istft(torch.polar(lin_mag, torch.angle(spec)), dsp.n_fft,
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
        rec = torch.polar(lin, torch.angle(spec))
        y = istft(rec, dsp.n_fft, dsp.hop_length, dsp.win, window=win,
                  length=length)
        return hx, y

    return step

"""The op-by-op streaming steps (JAX counterpart pipeline.py: the webrtc
part, ``_transforms`` :37, ``WebRTCState`` :464, ``webrtc_init_state``
:490, ``make_webrtc_step`` :520; and ``make_server_step`` :653).

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
    gate_state, make_gate_estimator)


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

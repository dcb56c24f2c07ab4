"""Input-SNR estimation for the serving-side SNR gate (JAX counterpart
ops/noisefloor.py, on tensors).

Two estimators (``ServingConfig.snr_gate_estimator``):

``floor``: model-independent per-bin noise-floor tracking. Per-bin
spectral power is EMA-smoothed, then the floor follows the smoothed power
down at once and up only at a bounded exponential rate, so sparse speech
rides above the floor while steady noise defines it. The residual bias of
the smoothed minimum (about 1.2x) is compensated in the SNR estimate.

``removed``: model-informed. Per frame, the bin-mean of the power the
model removed (clipped at 0) estimates the noise and the bin-mean output
power the signal; both run through long EMAs and their ratio is the
stream's SNR.

``both`` (the default): ``removed`` decides and ``floor`` vetoes its
false cleans at the fixed ``FLOOR_VETO_GATE_DB``/``FLOOR_VETO_WIDTH_DB``.

The gate blends each stream's output magnitude toward its input
magnitude with ``gate_alpha`` (1 denoises fully, 0 passes through);
``make_gate_estimator`` is the per-hop decision that the fast step and the
webrtc step share. Every carry that is all zero (a freshly admitted
engine slot) latches to the current frame instead of staying pinned at 0.
"""

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

# time constants (seconds) of the power smoothing, the floor's doubling
# and the long stream-level EMA; the bias of the smoothed minimum
SMOOTH_TAU_SECONDS = 0.1
FLOOR_DOUBLE_SECONDS = 0.4
TOTAL_TAU_SECONDS = 2.0
FLOOR_BIAS = 1.2
_EPS = 1e-12

# 'both': the floor tracker's veto, at fixed constants
FLOOR_VETO_GATE_DB = 4.5
FLOOR_VETO_WIDTH_DB = 2.5


class FloorState(NamedTuple):
    smooth: torch.Tensor   # (B, F) EMA of per-bin power
    floor: torch.Tensor    # (B, F) tracked noise floor
    total: torch.Tensor    # (B,) long EMA of the mean frame power


def floor_rise_per_frame(hop_length: int, sample_rate: int,
                         double_seconds: float = FLOOR_DOUBLE_SECONDS
                         ) -> float:
    """Multiplicative per-frame rise bound: the floor doubles in
    ``double_seconds`` of persistently louder input."""
    frames_per_double = double_seconds * sample_rate / hop_length
    return float(2.0 ** (1.0 / max(frames_per_double, 1.0)))


def smooth_beta_per_frame(hop_length: int, sample_rate: int,
                          tau_seconds: float = SMOOTH_TAU_SECONDS) -> float:
    """EMA retention per frame for a ``tau_seconds`` time constant."""
    return float(math.exp(-hop_length / (sample_rate * tau_seconds)))


def total_beta_per_frame(hop_length: int, sample_rate: int,
                         tau_seconds: float = TOTAL_TAU_SECONDS) -> float:
    """EMA retention of the stream-level total-power average."""
    return smooth_beta_per_frame(hop_length, sample_rate, tau_seconds)


def floor_init(power0: torch.Tensor) -> FloorState:
    """Seed from the first frame's power (B, F)."""
    return FloorState(smooth=power0, floor=power0,
                      total=power0.mean(dim=-1))


def floor_step(state: FloorState, power_t: torch.Tensor, beta: float,
               rise: float, beta_tot: float) -> FloorState:
    """One causal frame update; ``power_t`` (B, F) linear power. A zero
    floor bin or a zero total latches to the current value."""
    smooth = beta * state.smooth + (1.0 - beta) * power_t
    floor = torch.where(state.floor <= 0.0, smooth,
                        torch.minimum(smooth, state.floor * rise))
    p_mean = power_t.mean(dim=-1)
    total = torch.where(state.total <= 0.0, p_mean,
                        beta_tot * state.total + (1.0 - beta_tot) * p_mean)
    return FloorState(smooth=smooth, floor=floor, total=total)


def noise_floor_scan(power: torch.Tensor, rise: float, beta: float,
                     beta_tot: float, init: Optional[FloorState] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, FloorState]:
    """power (B, F, T) -> (floors (B, F, T), totals (B, T), the last
    FloorState); ``init`` seeds the carry (else the first frame)."""
    state = floor_init(power[..., 0]) if init is None else init
    floors, totals = [], []
    for t in range(power.shape[-1]):
        state = floor_step(state, power[..., t], beta, rise, beta_tot)
        floors.append(state.floor)
        totals.append(state.total)
    return torch.stack(floors, dim=-1), torch.stack(totals, dim=-1), state


def snr_db_from_floor(total: torch.Tensor, floor_mean: torch.Tensor,
                      bias: float = FLOOR_BIAS) -> torch.Tensor:
    """Stream-level SNR in dB from the long total-power EMA and the
    bin-mean of the tracked floor."""
    nf = bias * floor_mean
    sig = torch.clamp(total - nf, min=0.0)
    return 10.0 * torch.log10((sig + _EPS) / (nf + _EPS))


def estimator_planes(estimator: str) -> Tuple[bool, bool]:
    """(uses_removed, uses_floor) for a gate estimator; every serving
    path's state and step agree on it."""
    if estimator not in ("removed", "floor", "both"):
        raise ValueError(f"unknown snr_gate_estimator {estimator!r}")
    return (estimator in ("removed", "both"),
            estimator in ("floor", "both"))


def gate_planes(serving) -> Tuple[bool, bool]:
    """(uses_removed, uses_floor) for a ``ServingConfig``: both False
    when its gate is off."""
    if serving.snr_gate_db is None:
        return False, False
    return estimator_planes(serving.snr_gate_estimator)


def gate_alpha(snr_db: torch.Tensor, gate_db: float,
               width_db: float) -> torch.Tensor:
    """Denoise weight in [0, 1]: a clipped ramp, 1 at or below
    gate - width, 0 at or above gate + width."""
    w = max(width_db, 1e-3)
    return torch.clamp((gate_db + w - snr_db) / (2.0 * w), 0.0, 1.0)


class RemovedState(NamedTuple):
    """Long EMAs of the output power and the removed power, both (B,)."""
    out: torch.Tensor
    rem: torch.Tensor


def removed_init(batch: int, dtype=torch.float32,
                 device="cpu") -> RemovedState:
    return RemovedState(out=torch.zeros((batch,), dtype=dtype, device=device),
                        rem=torch.zeros((batch,), dtype=dtype, device=device))


def removed_powers(power_in: torch.Tensor, power_out: torch.Tensor,
                   axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame (signal, noise) proxies: the bin-mean output power and
    the bin-mean of what the model removed, clipped at 0 per bin."""
    p_out = power_out.mean(dim=axis)
    p_rem = torch.clamp(power_in - power_out, min=0.0).mean(dim=axis)
    return p_out, p_rem


def removed_step(state: RemovedState, p_out_t: torch.Tensor,
                 p_rem_t: torch.Tensor, beta_tot: float) -> RemovedState:
    """One causal update of both EMAs; an all-zero carry latches."""
    fresh = (state.out + state.rem) <= 0.0
    out = torch.where(fresh, p_out_t,
                      beta_tot * state.out + (1.0 - beta_tot) * p_out_t)
    rem = torch.where(fresh, p_rem_t,
                      beta_tot * state.rem + (1.0 - beta_tot) * p_rem_t)
    return RemovedState(out=out, rem=rem)


def removed_snr_db(state: RemovedState) -> torch.Tensor:
    return 10.0 * torch.log10((state.out + _EPS) / (state.rem + _EPS))


def removed_snr_scan(p_out: torch.Tensor, p_rem: torch.Tensor,
                     beta_tot: float, init: Optional[RemovedState] = None
                     ) -> Tuple[torch.Tensor, RemovedState]:
    """p_out, p_rem (B, T) -> (snr_db (B, T), the last RemovedState)."""
    state = (removed_init(p_out.shape[0], p_out.dtype, p_out.device)
             if init is None else init)
    snrs = []
    for t in range(p_out.shape[1]):
        state = removed_step(state, p_out[:, t], p_rem[:, t], beta_tot)
        snrs.append(removed_snr_db(state))
    return torch.stack(snrs, dim=1), state


def gate_state(serving, batch: int, n_bins: int,
               device="cpu") -> Dict[str, torch.Tensor]:
    """The gate's planes of a fresh (B-stream) state for ``serving``, by
    name: zeros, which latch to the first frame; {} without a gate."""
    removed, floor = gate_planes(serving)
    z = lambda *shape: torch.zeros(shape, device=device)
    planes = {}
    if floor:
        planes.update(nf_smooth=z(batch, n_bins), nf_floor=z(batch, n_bins),
                      nf_total=z(batch))
    if removed:
        planes.update(em_out=z(batch), em_rem=z(batch))
    return planes


def gate_weight(serving, state) -> torch.Tensor:
    """(B,) each stream's denoise weight from the gate planes ``state``
    carries (of nf_smooth, nf_floor, nf_total, em_out, em_rem, by name),
    read after the estimators stepped: 'removed' decides, 'floor' decides,
    or under 'both' the floor tracker vetoes the removed-power decision's
    false cleans (JAX pipeline.py:598-614)."""
    removed, floor = gate_planes(serving)
    gate_db, width_db = serving.snr_gate_db, serving.snr_gate_width_db
    alpha = None
    if removed:
        alpha = gate_alpha(removed_snr_db(RemovedState(state.em_out,
                                                       state.em_rem)),
                           gate_db, width_db)
    if floor:
        snr_f = snr_db_from_floor(state.nf_total,
                                  state.nf_floor.mean(dim=-1))
        if alpha is None:
            alpha = gate_alpha(snr_f, gate_db, width_db)
        else:
            alpha = torch.maximum(alpha, gate_alpha(
                snr_f, FLOOR_VETO_GATE_DB, FLOOR_VETO_WIDTH_DB))
    return alpha


def make_gate_estimator(serving, hop_length: int, sample_rate: int):
    """The SNR gate's per-hop decision for ``serving`` (JAX engine.py:178-216
    and pipeline.py:583-614), or None without a gate: ``step(state,
    power_in (B, F), power_out (B, F)) -> (planes, alpha (B,))`` steps the
    estimators on one frame's input and output power and returns the
    state fields it updated (``state`` is a NamedTuple that carries the
    gate planes by name) and each stream's ``gate_weight``."""
    if serving.snr_gate_db is None:
        return None
    removed, floor = gate_planes(serving)
    beta_t = total_beta_per_frame(hop_length, sample_rate,
                                  serving.snr_gate_tau_s)
    beta = smooth_beta_per_frame(hop_length, sample_rate)
    rise = floor_rise_per_frame(hop_length, sample_rate)

    def step(state, power_in: torch.Tensor, power_out: torch.Tensor):
        planes = {}
        if removed:
            rs = removed_step(RemovedState(state.em_out, state.em_rem),
                              *removed_powers(power_in, power_out), beta_t)
            planes.update(em_out=rs.out, em_rem=rs.rem)
        if floor:
            fs = floor_step(FloorState(state.nf_smooth, state.nf_floor,
                                       state.nf_total), power_in, beta,
                            rise, beta_t)
            planes.update(nf_smooth=fs.smooth, nf_floor=fs.floor,
                          nf_total=fs.total)
        return planes, gate_weight(serving, state._replace(**planes))

    return step

"""The port's ops/noisefloor.py against the JAX package's on the same
seeded numpy inputs (rtol 1e-6: both compute in float32), including the
latching of a zero carry and estimator_planes' error."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import audio_denoising_tpu.ops.noisefloor as jnf
import audio_denoising_torch.ops.noisefloor as tnf

RTOL = 1e-6
B, F, T = 3, 17, 9


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=0)


def _power(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.exponential(1.0, shape) * 10.0 ** rng.uniform(-3, 1, shape)
            ).astype(np.float32)


def _floor_carry(seed):
    """A carry with zero bins and one zero total (fresh slots latch)."""
    smooth, floor = _power(seed, (B, F)), _power(seed + 1, (B, F))
    floor[0, :5] = 0.0
    floor[2] = 0.0
    total = _power(seed + 2, (B,))
    total[1] = 0.0
    return smooth, floor, total


@pytest.mark.parametrize("name", [
    "SMOOTH_TAU_SECONDS", "FLOOR_DOUBLE_SECONDS", "TOTAL_TAU_SECONDS",
    "FLOOR_BIAS", "_EPS", "FLOOR_VETO_GATE_DB", "FLOOR_VETO_WIDTH_DB"])
def test_constants_match(name):
    assert getattr(tnf, name) == getattr(jnf, name)


@pytest.mark.parametrize("hop, sr", [(320, 16000), (512, 48000),
                                     (768, 48000), (10, 16)])
def test_per_frame_rates_match(hop, sr):
    assert tnf.floor_rise_per_frame(hop, sr) == pytest.approx(
        jnf.floor_rise_per_frame(hop, sr), rel=1e-12)
    assert tnf.smooth_beta_per_frame(hop, sr) == pytest.approx(
        jnf.smooth_beta_per_frame(hop, sr), rel=1e-12)
    assert tnf.total_beta_per_frame(hop, sr, 0.1) == pytest.approx(
        jnf.total_beta_per_frame(hop, sr, 0.1), rel=1e-12)
    assert tnf.total_beta_per_frame(hop, sr) == pytest.approx(
        jnf.total_beta_per_frame(hop, sr), rel=1e-12)


def test_floor_init_matches():
    p = _power(0, (B, F))
    want, got = jnf.floor_init(jnp.asarray(p)), tnf.floor_init(
        torch.from_numpy(p))
    for w, g in zip(want, got):
        _close(g, w)


def test_floor_step_matches_and_latches():
    smooth, floor, total = _floor_carry(1)
    p = _power(5, (B, F))
    args = (0.8, 1.01, 0.95)
    want = jnf.floor_step(jnf.FloorState(*map(jnp.asarray,
                                              (smooth, floor, total))),
                          jnp.asarray(p), *args)
    got = tnf.floor_step(tnf.FloorState(*map(torch.from_numpy,
                                             (smooth, floor, total))),
                         torch.from_numpy(p), *args)
    for w, g in zip(want, got):
        _close(g, w)
    # the zero bins and the zero total took the current value
    np.testing.assert_array_equal(got.floor[2].numpy(), got.smooth[2].numpy())
    assert float(got.total[1]) == pytest.approx(float(p[1].mean()), rel=RTOL)
    assert bool((got.floor > 0).all())


@pytest.mark.parametrize("seeded", [False, True])
def test_noise_floor_scan_matches(seeded):
    p = _power(7, (B, F, T))
    args = (1.02, 0.7, 0.9)
    init = _floor_carry(8) if seeded else None
    want = jnf.noise_floor_scan(
        jnp.asarray(p), *args,
        init=None if init is None else jnf.FloorState(*map(jnp.asarray,
                                                           init)))
    got = tnf.noise_floor_scan(
        torch.from_numpy(p), *args,
        init=None if init is None else tnf.FloorState(*map(torch.from_numpy,
                                                           init)))
    _close(got[0], want[0])
    _close(got[1], want[1])
    for w, g in zip(want[2], got[2]):
        _close(g, w)


def test_snr_db_from_floor_matches():
    total = _power(9, (B, T)) * 3.0
    fmean = _power(10, (B, T))
    _close(tnf.snr_db_from_floor(torch.from_numpy(total),
                                 torch.from_numpy(fmean)),
           jnf.snr_db_from_floor(jnp.asarray(total), jnp.asarray(fmean)))
    _close(tnf.snr_db_from_floor(torch.from_numpy(total),
                                 torch.from_numpy(fmean), bias=1.5),
           jnf.snr_db_from_floor(jnp.asarray(total), jnp.asarray(fmean),
                                 bias=1.5))


@pytest.mark.parametrize("estimator", ["removed", "floor", "both"])
def test_estimator_planes_match(estimator):
    assert tnf.estimator_planes(estimator) == jnf.estimator_planes(estimator)


def test_estimator_planes_refuses_an_unknown_estimator():
    with pytest.raises(ValueError, match="unknown snr_gate_estimator"):
        tnf.estimator_planes("median")
    with pytest.raises(ValueError, match="unknown snr_gate_estimator"):
        jnf.estimator_planes("median")


@pytest.mark.parametrize("gate, width", [(1.0, 6.0), (10.0, 4.0),
                                         (2.0, 0.0)])
def test_gate_alpha_matches(gate, width):
    snr = np.linspace(-20, 30, 41, dtype=np.float32)
    got = tnf.gate_alpha(torch.from_numpy(snr), gate, width)
    _close(got, jnf.gate_alpha(jnp.asarray(snr), gate, width))
    assert float(got.min()) == 0.0 and float(got.max()) == 1.0


def test_removed_init_matches():
    want, got = jnf.removed_init(B), tnf.removed_init(B)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_removed_powers_matches():
    p_in, p_out = _power(11, (B, F)), _power(12, (B, F))
    want = jnf.removed_powers(jnp.asarray(p_in), jnp.asarray(p_out))
    got = tnf.removed_powers(torch.from_numpy(p_in), torch.from_numpy(p_out))
    for w, g in zip(want, got):
        _close(g, w)
    want = jnf.removed_powers(jnp.asarray(p_in.T), jnp.asarray(p_out.T),
                              axis=0)
    got = tnf.removed_powers(torch.from_numpy(p_in.T.copy()),
                             torch.from_numpy(p_out.T.copy()), axis=0)
    for w, g in zip(want, got):
        _close(g, w)


def test_removed_step_matches_and_latches():
    out, rem = _power(13, (B,)), _power(14, (B,))
    out[1] = rem[1] = 0.0                     # a fresh slot
    p_out, p_rem = _power(15, (B,)), _power(16, (B,))
    want = jnf.removed_step(jnf.RemovedState(jnp.asarray(out),
                                             jnp.asarray(rem)),
                            jnp.asarray(p_out), jnp.asarray(p_rem), 0.9)
    got = tnf.removed_step(tnf.RemovedState(torch.from_numpy(out),
                                            torch.from_numpy(rem)),
                           torch.from_numpy(p_out), torch.from_numpy(p_rem),
                           0.9)
    for w, g in zip(want, got):
        _close(g, w)
    assert float(got.out[1]) == float(p_out[1])
    assert float(got.rem[1]) == float(p_rem[1])
    _close(tnf.removed_snr_db(got), jnf.removed_snr_db(want))


@pytest.mark.parametrize("seeded", [False, True])
def test_removed_snr_scan_matches(seeded):
    p_out, p_rem = _power(17, (B, T)), _power(18, (B, T))
    init = (_power(19, (B,)), _power(20, (B,))) if seeded else None
    want = jnf.removed_snr_scan(
        jnp.asarray(p_out), jnp.asarray(p_rem), 0.85,
        init=None if init is None else jnf.RemovedState(*map(jnp.asarray,
                                                             init)))
    got = tnf.removed_snr_scan(
        torch.from_numpy(p_out), torch.from_numpy(p_rem), 0.85,
        init=None if init is None else tnf.RemovedState(*map(
            torch.from_numpy, init)))
    _close(got[0], want[0])
    for w, g in zip(want[1], got[1]):
        _close(g, w)


@pytest.mark.parametrize("gate, estimator, want", [
    (None, "both", (False, False)), (1.0, "both", (True, True)),
    (1.0, "removed", (True, False)), (1.0, "floor", (False, True))])
def test_gate_planes_follow_the_serving_config(gate, estimator, want):
    from audio_denoising_torch.config import ServingConfig
    srv = ServingConfig(snr_gate_db=gate, snr_gate_estimator=estimator)
    assert tnf.gate_planes(srv) == want

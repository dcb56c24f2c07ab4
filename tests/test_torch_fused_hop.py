"""The port's fused hop: its plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) fed the identical plan, and the
wrapper's checks. The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.ops.pallas.fused_hop import (
    fused_hop_init_state as jax_init_state, make_fused_hop as jax_make_hop)
from audio_denoising_tpu.runtime.plan import (
    build_cell_plan as jax_build_cell_plan)

from audio_denoising_torch.config import PRESETS
from audio_denoising_torch.ops.kernels.fused_hop import (
    FusedHopState, fused_hop_init_state, make_fused_hop)
from audio_denoising_torch.runtime.plan import plan_from_numpy

SPEC = "gruunet2-stream16k"
OUT_ATOL = 2e-4      # tests/test_fused_hop.py's bounds for the fused hop
STATE_ATOL = 2e-5


@pytest.fixture(scope="module")
def plans():
    cfg, model, params = jax_load_pretrained(SPEC)
    jplan = jax_build_cell_plan(model, params)
    return cfg, jplan, PRESETS[SPEC], plan_from_numpy(jplan)


@pytest.mark.parametrize("batch", [4, 3])
def test_plain_hop_matches_jax_kernel(plans, batch):
    """B=3 is not a multiple of the JAX kernel's tile: its padding path."""
    jcfg, jplan, cfg, plan = plans
    jax_hop = jax_make_hop(jcfg, jplan, interpret=True)
    hop = make_fused_hop(cfg, plan, device="cpu")
    js = jax_init_state(jcfg, jplan, batch)
    s = fused_hop_init_state(cfg, plan, batch)
    rng = np.random.default_rng(batch)
    for _ in range(8):
        chunk = (0.1 * rng.standard_normal((batch, 320))).astype(np.float32)
        js, jout = jax_hop(js, jnp.asarray(chunk))
        s, out = hop(s, torch.from_numpy(chunk))
        assert out.shape == (batch, 320) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=OUT_ATOL)
        for name in ("ring", "ola", "hx"):
            np.testing.assert_allclose(getattr(s, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       atol=STATE_ATOL)
    assert hop.launches == 0      # the plain version is not a launch


def _bad_inputs(hop, cfg, plan):
    s = fused_hop_init_state(cfg, plan, 2)
    c = torch.zeros(2, cfg.dsp.hop_length)
    return {
        "chunk dtype": (s, c.double(), TypeError),
        "chunk width": (s, torch.zeros(2, cfg.dsp.hop_length + 1),
                        ValueError),
        "chunk rank": (s, torch.zeros(cfg.dsp.hop_length), ValueError),
        "state batch": (fused_hop_init_state(cfg, plan, 3), c, ValueError),
        "hx dtype": (s._replace(hx=s.hx.half()), c, TypeError),
        "ring width": (s._replace(ring=torch.zeros(2, 7)), c, ValueError),
    }


@pytest.mark.parametrize("case", ["chunk dtype", "chunk width", "chunk rank",
                                  "state batch", "hx dtype", "ring width"])
def test_wrapper_rejects_bad_inputs(plans, case):
    _, _, cfg, plan = plans
    hop = make_fused_hop(cfg, plan, device="cpu")
    state, chunk, err = _bad_inputs(hop, cfg, plan)[case]
    with pytest.raises(err):
        hop(state, chunk)


def _with(cfg, **serving):
    return dataclasses.replace(
        cfg, serving=dataclasses.replace(cfg.serving, **serving))


@pytest.mark.parametrize("case", ["gate", "raw", "bf16", "int8", "multi",
                                  "int16", "delta"])
def test_later_slices_raise(plans, case):
    _, _, cfg, plan = plans
    kw = {}
    if case == "gate":
        cfg = _with(cfg, snr_gate_db=1.0)
    elif case == "raw":
        cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
            cfg.dsp, domain="raw"))
    elif case in ("bf16", "int8"):
        kw["compute_dtype"] = {"bf16": torch.bfloat16,
                               "int8": torch.int8}[case]
    elif case == "multi":
        kw["hops_per_call"] = 50
    elif case == "int16":
        kw["io_dtype"] = torch.int16
    else:
        plan = plan._replace(delta=True)
    with pytest.raises(NotImplementedError, match="does not implement"):
        make_fused_hop(cfg, plan, device="cpu", **kw)


def test_hop_needs_a_card_unless_cpu_is_asked(plans, monkeypatch):
    _, _, cfg, plan = plans
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fused_hop(cfg, plan)


def test_cpu_hop_refuses_cuda_tensors_it_was_not_built_for(plans):
    _, _, cfg, plan = plans
    hop = make_fused_hop(cfg, plan, device="cpu")
    state = FusedHopState(*(torch.empty(2, w, device="meta")
                            for w in (640, 640, 68)))
    with pytest.raises(ValueError, match="built for cpu"):
        hop(state, torch.empty(2, 320, device="meta"))

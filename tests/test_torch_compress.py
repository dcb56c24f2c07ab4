"""The port's ``ops/compress.py`` against JAX's ``ops/compress.py`` on the
CPU: the eight functions on the same seeded numpy inputs, float32, as
cases of one test. Elementwise log1p, expm1 and divisions by the same
float32 table: within 4 ulp of float32 (XLA's and PyTorch's expm1 read
up to 3.01e-7 apart, relative, on these inputs; the rest within 2 ulp)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_denoising_tpu.ops import compress as jax_compress

from audio_denoising_torch import ops
from audio_denoising_torch.ops import compress

RTOL = 4.8e-7    # 4 ulp of float32


def _real(rng, shape, scale=3.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _inputs(name, rng):
    if name == "log1p_compress":
        return [np.abs(_real(rng, (2, 241, 7)))]
    if name == "wrap_complex":
        return [_real(rng, (2, 2, 241, 7))]
    if name == "unwrap_complex":
        return [(_real(rng, (2, 241, 7)) + 1j * _real(rng, (2, 241, 7))
                 ).astype(np.complex64)]
    return [_real(rng, (2, 241, 7))]


@pytest.mark.parametrize("name", [
    "signed_log_clamp", "signed_log_unclamp", "log1p_compress",
    "expm1_expand", "unwrap_complex", "wrap_complex", "normalize_stds",
    "denormalize_stds"])
def test_compress_matches_jax(name):
    """Each function against JAX's on the same inputs; the stds pair also
    on a (B, 2, F, T) input and a table of one's own, and each inverse
    pair undoes its forward."""
    rng = np.random.default_rng(sum(map(ord, name)))
    args = _inputs(name, rng)
    fn, jfn = getattr(compress, name), getattr(jax_compress, name)
    assert getattr(ops, name) is fn
    cases = [(args, {})]
    if name.endswith("normalize_stds"):
        stds = (0.5 + rng.random(241)).astype(np.float32)
        cases += [([_real(rng, (2, 2, 241, 7))], {}),
                  ([_real(rng, (2, 241, 7))], {"stds": stds})]
    for a, kw in cases:
        got = fn(*(torch.from_numpy(x) for x in a), **kw).numpy()
        want = np.asarray(jfn(*(jnp.asarray(x) for x in a),
                              **{k: jnp.asarray(v) for k, v in kw.items()}))
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    inverse = {"signed_log_clamp": "signed_log_unclamp",
               "log1p_compress": "expm1_expand",
               "unwrap_complex": "wrap_complex",
               "normalize_stds": "denormalize_stds"}.get(name)
    if inverse:
        x = torch.from_numpy(args[0])
        back = getattr(compress, inverse)(fn(x))
        np.testing.assert_allclose(back.numpy(), args[0], rtol=1e-5,
                                   atol=1e-6)

"""The port's config copy and host-side DSP constants against the JAX
package, on the CPU."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_denoising_tpu import config as jax_config
from audio_denoising_tpu.ops import convs as jax_convs
from audio_denoising_tpu.ops.mel import (
    inverse_mel_matrix as jax_inverse_mel, mel_filterbank as jax_mel)
from audio_denoising_tpu.ops.pallas.fused_hop import (
    _dft_matrices as jax_dft_matrices)
from audio_denoising_tpu.ops.windows import hann_window as jax_hann

from audio_denoising_torch import config
from audio_denoising_torch.ops import convs
from audio_denoising_torch.ops.kernels.fused_hop import _dft_matrices
from audio_denoising_torch.ops.mel import inverse_mel_matrix, mel_filterbank
from audio_denoising_torch.ops.windows import hann_window

ATOL = 1e-6
# (n_stft, n_mels, sample_rate) of the presets' mel bases
MEL_BASES = [(321, 64, 16000), (513, 64, 48000), (769, 64, 48000),
             (513, 128, 48000)]


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_presets_match_the_reference_config(name):
    assert config.PRESETS[name].to_json() == \
        jax_config.PRESETS[name].to_json()
    assert config.recommended_serving(config.PRESETS[name]).to_json() == \
        jax_config.recommended_serving(jax_config.PRESETS[name]).to_json()


@pytest.mark.parametrize("n", [1, 42, 640, 1024, 1536])
@pytest.mark.parametrize("periodic", [True, False])
def test_hann_window(n, periodic):
    np.testing.assert_allclose(hann_window(n, periodic).numpy(),
                               np.asarray(jax_hann(n, periodic)), atol=ATOL)


@pytest.mark.parametrize("n_stft,n_mels,sr", MEL_BASES)
def test_mel_filterbank(n_stft, n_mels, sr):
    got = mel_filterbank(n_stft, n_mels, sr)
    assert got.dtype == torch.float32 and got.shape == (n_stft, n_mels)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_mel(n_stft, n_mels, sr)),
                               atol=ATOL)


@pytest.mark.parametrize("n_stft,n_mels,sr", MEL_BASES)
def test_inverse_mel_matrix(n_stft, n_mels, sr):
    np.testing.assert_allclose(
        inverse_mel_matrix(n_stft, n_mels, sr).numpy(),
        np.asarray(jax_inverse_mel(n_stft, n_mels, sr)), atol=ATOL)


@pytest.mark.parametrize("n_fft", [42, 640, 1024])
def test_dft_matrices(n_fft):
    for got, want in zip(_dft_matrices(n_fft), jax_dft_matrices(n_fft)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (2, 0)])
def test_conv1d(rng, stride, padding):
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w = rng.standard_normal((4, 5, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    got = convs.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), stride=stride, padding=padding)
    want = jax_convs.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            stride=stride, padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("in_size,out_size", [(4, 8), (8, 16), (5, 9)])
def test_conv_transpose1d(rng, in_size, out_size):
    op = convs.transpose_output_padding(in_size, out_size, 3, 2, 1)
    assert op == jax_convs.transpose_output_padding(in_size, out_size, 3,
                                                    2, 1)
    x = rng.standard_normal((2, 6, in_size)).astype(np.float32)
    w = rng.standard_normal((6, 3, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    got = convs.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), stride=2, padding=1,
                                 output_padding=op)
    want = jax_convs.conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), stride=2, padding=1,
                                      output_padding=op)
    assert got.shape[-1] == out_size
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_unreachable_output_padding_raises():
    with pytest.raises(ValueError, match="unreachable"):
        convs.transpose_output_padding(4, 12, 3, 2, 1)

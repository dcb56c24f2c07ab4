"""WAV codec and PCM<->float conversion.

PCM normalization constants match the reference's int->float rules
(utils.py:109-116: int8/128, int16/32768, int32/2^31, int64/2^63).
A C++ fast path for bulk conversion is used when the native extension is
built (native/); the numpy path is always available.
"""

import wave
from typing import Tuple

import numpy as np

_PCM_SCALE = {1: 128.0, 2: 32768.0, 4: 2147483648.0, 8: 9223372036854775808.0}
_PCM_DTYPE = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def pcm_to_float32(samples: np.ndarray) -> np.ndarray:
    """Integer PCM -> float32 in [-1, 1) (reference scaling rules)."""
    if samples.dtype == np.float32:
        return samples
    if samples.dtype == np.float64:
        return samples.astype(np.float32)
    if samples.dtype == np.int16:
        from audio_denoising_torch.io import native
        out = native.pcm16_to_f32(samples)
        if out is not None:
            return out
    scale = _PCM_SCALE[samples.dtype.itemsize]
    return samples.astype(np.float32) / scale


def float32_to_pcm16(samples: np.ndarray) -> np.ndarray:
    """float in [-1, 1] -> int16, with clipping (app2.py:246-247)."""
    from audio_denoising_torch.io import native
    out = native.f32_to_pcm16(samples)
    if out is not None:
        return out
    clipped = np.clip(samples, -1.0, 1.0)
    return (clipped * 32767.0).astype(np.int16)


def read_wav(path: str, mono: bool = False) -> Tuple[np.ndarray, int]:
    """-> (samples (channels, n) float32, sample_rate)."""
    with wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
    if width == 3:  # 24-bit
        from audio_denoising_torch.io import native
        fast = native.pcm24_to_f32(np.frombuffer(raw, dtype=np.uint8))
        if fast is not None:
            samples = fast
        else:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            ints = (b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints) << 8
            samples = ints.astype(np.float32) / _PCM_SCALE[4]
    elif width == 1:
        # WAV stores 8-bit PCM UNSIGNED with a 128 offset (unlike the
        # signed widths) — int8 decode would invert/wrap every sample
        u = np.frombuffer(raw, dtype=np.uint8)
        samples = (u.astype(np.float32) - 128.0) / 128.0
    else:
        data = np.frombuffer(raw, dtype=_PCM_DTYPE[width])
        samples = pcm_to_float32(data)
    samples = samples.reshape(-1, n_ch).T  # (channels, n)
    if mono and n_ch > 1:
        samples = samples[:1]
    return np.ascontiguousarray(samples), sr


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """samples: (channels, n) or (n,) float32 in [-1, 1] -> 16-bit WAV."""
    if samples.ndim == 1:
        samples = samples[None]
    pcm = float32_to_pcm16(samples.T)  # (n, channels) interleaved
    with wave.open(path, "wb") as w:
        w.setnchannels(samples.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(np.ascontiguousarray(pcm).tobytes())

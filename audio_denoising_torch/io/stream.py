"""Stream utilities: fixed-size re-chunking with residue carry, stream
limiting, and additive mixture synthesis — the reference's
``buffer_stream``/``limit_stream``/``combine_audio`` contracts
(utils.py:221-269, 355-398)."""

from typing import Iterable, Iterator, Tuple

import numpy as np

from audio_denoising_torch.io.wavio import read_wav

AudioChunk = Tuple[np.ndarray, int]


def buffer_stream(chunks: Iterable[AudioChunk], buffer_size: int,
                  limit_samples: int = 10 ** 20,
                  skip_samples: int = 0) -> Iterator[AudioChunk]:
    """Re-chunk arbitrary (C, n) pieces into exact (C, buffer_size) windows
    with residue carry; trailing partial windows are dropped, sample rate
    must be uniform (utils.py:221-269)."""
    residue = None
    sr0 = None
    total = 0
    skipped = 0
    for samples, sr in chunks:
        if sr0 is None:
            sr0 = sr
        assert sr == sr0, "sample rate must be consistent"
        if skipped < skip_samples:
            skipped += samples.shape[-1]
            continue
        total += samples.shape[-1]
        residue = samples if residue is None else np.concatenate(
            [residue, samples], axis=-1)
        while residue.shape[-1] >= buffer_size:
            yield residue[..., :buffer_size], sr0
            residue = residue[..., buffer_size:]
        if total > limit_samples:
            return


def stream_audio(path: str, buffer_size: int = 48000,
                 chunk: int = 48000) -> Iterator[AudioChunk]:
    """Stream a WAV file as fixed-size windows."""
    samples, sr = read_wav(path)

    def pieces():
        for i in range(0, samples.shape[-1], chunk):
            yield samples[..., i:i + chunk], sr

    return buffer_stream(pieces(), buffer_size)


def limit_stream(stream: Iterable[AudioChunk],
                 max_samples: int) -> Iterator[AudioChunk]:
    total = 0
    for samples, sr in stream:
        total += samples.shape[-1]
        yield samples, sr
        if total >= max_samples:
            break


def combine_audio(a1: AudioChunk, a2: AudioChunk) -> AudioChunk:
    """Additive mixing with clamp to [-1, 1] — the noisy-mixture synthesizer
    for training (utils.py:363-372). Uses the native C++ path when built."""
    s1, sr1 = a1
    s2, sr2 = a2
    assert sr1 == sr2, "sample rates must be the same"
    if s1.shape == s2.shape:
        from audio_denoising_torch.io import native
        fast = native.combine(s1, s2)
        if fast is not None:
            return fast.reshape(s1.shape), sr1
    return np.clip(s1 + s2, -1.0, 1.0), sr1


def clip_audio_to_same_size(a1: AudioChunk, a2: AudioChunk):
    """Trim the longer signal to the shorter's length (utils.py:374-398)."""
    s1, sr1 = a1
    s2, sr2 = a2
    assert sr1 == sr2, "sample rates must be the same"
    n = min(s1.shape[-1], s2.shape[-1])
    return (s1[..., :n], sr1), (s2[..., :n], sr1)

"""Mixture synthesis on the host (JAX counterpart train/data.py).

Training data is synthesized on the fly: random clean crops plus random
noise crops, added and clipped to [-1, 1] (reference combine_audio,
utils.py:368; random crops through the cache, utils.py:98-171). The
sampler moves only raw waveforms; features are computed inside the train
step on the training device.

Noise files decode through ``io.codec`` (mp3, webm/opus) or ffmpeg where
present; without any decodable noise the sampler draws synthetic noise (a
white and brown mixture). Every draw comes from numpy generators seeded
by ``seed``, in the JAX sampler's order, so both packages synthesize the
same batches bit for bit from the same corpus.
"""

from typing import Sequence, Tuple

import numpy as np

from audio_denoising_torch.io.cache import AudioCache
from audio_denoising_torch.io.codec import codec_available
from audio_denoising_torch.io.ffmpeg import ffmpeg_available


class MixtureSampler:
    def __init__(self, clean_paths: Sequence[str],
                 noise_paths: Sequence[str] = (),
                 crop_samples: int = 48000, batch_size: int = 64,
                 noise_gain: Tuple[float, float] = (0.2, 1.0),
                 seed: int = 0, sample_rate: int = None):
        """``sample_rate``: the clean corpus's rate; noise crops are
        resampled to it (mixing a 48 kHz noise corpus into an 8 kHz clean
        one unresampled would pitch-shift the noise)."""
        if not clean_paths:
            raise ValueError("need at least one clean audio file")
        self.clean_paths = list(clean_paths)
        self.noise_paths = [p for p in noise_paths
                            if p.lower().endswith(".wav")
                            or codec_available(p) or ffmpeg_available()]
        self.crop = crop_samples
        self.batch = batch_size
        self.noise_gain = noise_gain
        self.sample_rate = sample_rate
        self.cache = AudioCache(seed=seed)
        self.rng = np.random.default_rng(seed)

    def _synth_noise(self, n: int) -> np.ndarray:
        """White plus integrated (brown) noise, peak-normalized."""
        white = self.rng.standard_normal(n).astype(np.float32)
        brown = np.cumsum(white).astype(np.float32)
        brown /= max(1e-6, np.abs(brown).max())
        mix = 0.7 * white / max(1e-6, np.abs(white).max()) + 0.3 * brown
        return mix / max(1e-6, np.abs(mix).max())

    def _noise_crop(self) -> np.ndarray:
        if self.noise_paths:
            crop, _ = self.cache.random_crop_from(
                self.noise_paths, self.crop, resample_to=self.sample_rate)
            return crop[0]
        return self._synth_noise(self.crop)

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> (mixture, clean), each (batch, crop_samples) float32."""
        clean = np.empty((self.batch, self.crop), np.float32)
        mixture = np.empty((self.batch, self.crop), np.float32)
        lo, hi = self.noise_gain
        for i in range(self.batch):
            c, _ = self.cache.random_crop_from(self.clean_paths, self.crop)
            c = c[0]
            g = self.rng.uniform(lo, hi)
            n = self._noise_crop() * g
            clean[i] = c
            mixture[i] = np.clip(c + n, -1.0, 1.0)
        return mixture, clean

    def __iter__(self):
        while True:
            yield self.sample()

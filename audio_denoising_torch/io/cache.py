"""Whole-file audio cache with random-crop sampling.

Replaces the reference's process-global ``AUDIO_CACHE`` dict and its crop
helpers (utils.py:25, 98-171) with an explicit object (no global mutable
state); entries are decoded once and crops are served from memory — the
training data path.
"""

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from audio_denoising_torch.io.wavio import read_wav
from audio_denoising_torch.io.codec import (codec_available, probe_mp3_rate,
                                          read_audio_codec)
from audio_denoising_torch.io.ffmpeg import ffmpeg_available, read_audio_ffmpeg


class AudioCache:
    def __init__(self, seed: int = 0):
        self._entries: Dict[str, Tuple[np.ndarray, int]] = {}
        self._rng = np.random.default_rng(seed)

    @staticmethod
    def _canonical(path: str) -> str:
        return os.path.realpath(os.path.normcase(os.path.abspath(path)))

    def load(self, path: str) -> Tuple[np.ndarray, int]:
        """-> (samples (C, N) float32, sample_rate), decoded once."""
        key = self._canonical(path)
        if key not in self._entries:
            if path.lower().endswith(".wav"):
                self._entries[key] = read_wav(path)
            elif codec_available(path):
                # system codec libs (io/codec.py): mp3 via libmpg123,
                # webm/opus via the pure-Python demux + libopus
                self._entries[key] = read_audio_codec(path)
            elif ffmpeg_available():
                self._entries[key] = read_audio_ffmpeg(path)
            else:
                raise RuntimeError(
                    f"cannot decode {path!r}: no codec library for this "
                    "container and no ffmpeg binary (WAV always works)")
        return self._entries[key]

    def load_at(self, path: str, sample_rate: int) -> Tuple[np.ndarray, int]:
        """Decode + resample to ``sample_rate`` once, then serve from
        memory (host-side polyphase — the corpus prep happens off-device,
        crops stay a pure memory slice)."""
        raw_key = self._canonical(path)
        key = (raw_key, int(sample_rate))
        if key not in self._entries:
            had_raw = raw_key in self._entries
            samples, sr = self.load(path)
            if sr != sample_rate:
                from fractions import Fraction
                from scipy.signal import resample_poly
                frac = Fraction(int(sample_rate), int(sr)).limit_denominator(
                    1 << 16)
                samples = resample_poly(
                    samples, frac.numerator, frac.denominator,
                    axis=-1).astype(np.float32)
                if not had_raw:
                    # don't hold the source-rate decode alive too — only
                    # the resampled entry is read again (a 48 kHz noise
                    # file resampled to 8 kHz would otherwise pin 7x its
                    # useful size for the process lifetime)
                    del self._entries[raw_key]
            self._entries[key] = (samples, int(sample_rate))
        return self._entries[key]

    def random_crop(self, path: str, crop_samples: int,
                    resample_to: Optional[int] = None) -> Tuple[np.ndarray, int]:
        """Random fixed-size crop (utils.py:98-119); short files wrap by
        tiling (the reference concatenates more files instead,
        utils.py:121-164 — tiling keeps the sampler single-file and pure)."""
        if resample_to is not None:
            samples, sr = self.load_at(path, resample_to)
        else:
            samples, sr = self.load(path)
        n = samples.shape[-1]
        if n < crop_samples:
            reps = int(np.ceil(crop_samples / n))
            samples = np.tile(samples, (1, reps))
            n = samples.shape[-1]
        if n == crop_samples:
            return samples.copy(), sr
        start = int(self._rng.integers(0, n - crop_samples))
        return samples[..., start:start + crop_samples].copy(), sr

    @staticmethod
    def probe_rate(path: str) -> int:
        """Sample rate without decoding (header-only)."""
        low = path.lower()
        if low.endswith(".wav"):
            import wave
            with wave.open(path, "rb") as w:
                return w.getframerate()
        if low.endswith((".mp3", ".mp2", ".mpga")):
            return probe_mp3_rate(path)
        if low.endswith((".webm", ".mkv", ".weba")):
            return 48000       # Opus always reconstructs at 48 kHz
        if low.endswith(".flac"):
            # STREAMINFO is the mandatory first metadata block: rate is
            # the top 20 bits at byte 10 of its body (io/flac.py)
            # absolute offset: 4 (fLaC) + 4 (block header) + 10 (body
            # prefix: min/max block 2+2, min/max frame 3+3)
            with open(path, "rb") as f:
                head = f.read(26)
            if head[:4] == b"fLaC":
                return int.from_bytes(head[18:21], "big") >> 4
        if low.endswith((".ogg", ".oga")):
            # Vorbis identification header rides in the first page:
            # "\x01vorbis" + version(4) + channels(1) + rate(4, LE)
            with open(path, "rb") as f:
                head = f.read(512)
            i = head.find(b"\x01vorbis")
            if i >= 0 and len(head) >= i + 16:
                return int.from_bytes(head[i + 12:i + 16], "little")
        return AudioCache().load(path)[1]

    def random_crop_from(self, paths: List[str], crop_samples: int,
                         sample_rate: Optional[int] = None,
                         resample_to: Optional[int] = None):
        """Crop from a random file (optionally filtered by sample rate —
        rates are probed from headers, not by decoding the corpus — or
        resampled to ``resample_to`` so mixed-rate corpora stay usable)."""
        candidates = paths
        if sample_rate is not None:
            candidates = [p for p in paths
                          if self.probe_rate(p) == sample_rate]
            if not candidates:
                raise ValueError(
                    f"no corpus file at {sample_rate} Hz among "
                    f"{len(paths)} paths")
        path = candidates[int(self._rng.integers(0, len(candidates)))]
        return self.random_crop(path, crop_samples, resample_to=resample_to)

    def __len__(self):
        return len(self._entries)

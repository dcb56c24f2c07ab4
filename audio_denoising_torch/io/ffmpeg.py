"""Optional FFmpeg-subprocess decoder for non-WAV containers (mp3/webm).

The reference decodes through PyAV (FFmpeg C bindings, utils.py:179-188);
neither PyAV nor an ffmpeg binary ships in this environment, so this path
is capability-gated: ``ffmpeg_available()`` is False -> callers fall back
to WAV-only corpora or raise with a clear message.
"""

import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def read_audio_ffmpeg(path: str, sample_rate: Optional[int] = None,
                      mono: bool = True) -> Tuple[np.ndarray, int]:
    """Decode any container via the ffmpeg binary -> (samples (C, N), sr)."""
    if not ffmpeg_available():
        raise RuntimeError(
            "ffmpeg binary not found; only WAV decode is available "
            "(install ffmpeg for mp3/webm corpora)")
    sr = sample_rate or 48000
    ch = 1 if mono else 2
    cmd = ["ffmpeg", "-v", "error", "-i", path, "-f", "f32le",
           "-acodec", "pcm_f32le", "-ac", str(ch), "-ar", str(sr), "-"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    data = np.frombuffer(raw, dtype=np.float32).reshape(-1, ch).T
    return np.ascontiguousarray(data), sr

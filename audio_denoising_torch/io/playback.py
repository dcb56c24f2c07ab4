"""Host audio playback (reference play_audio, utils.py:201-219).

sounddevice-gated: absent hardware/package degrades to a clear error, and
``play_audio(..., blocking=False)`` returns immediately like the reference.
"""

from typing import Optional

import numpy as np


def playback_available() -> bool:
    try:
        import sounddevice  # noqa: F401
        return True
    except Exception:
        return False


def play_audio(samples: np.ndarray, sample_rate: int,
               blocking: bool = True, device: Optional[str] = None) -> None:
    """samples: (n,) or (channels, n) float32 in [-1, 1]."""
    if not playback_available():
        raise RuntimeError(
            "sounddevice is not installed / no audio hardware available")
    import sounddevice as sd
    data = np.asarray(samples, np.float32)
    if data.ndim == 2:
        data = data.T                      # sounddevice wants (n, channels)
    sd.play(data, samplerate=sample_rate, blocking=blocking, device=device)


def stop_playback() -> None:
    if playback_available():
        import sounddevice as sd
        sd.stop()

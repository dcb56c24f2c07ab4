"""Any-container audio decode via linked FFmpeg libraries.

ctypes binding for native/adt_codec.cpp (libavformat + libavcodec,
LINKED — no ffmpeg binary, no subprocess): covers the container long
tail (m4a/aac, mp4, wma, aiff) the primary codec stack (io/codec.py:
libmpg123 / libopus / libvorbisfile / pure-Python FLAC) doesn't,
completing the reference's any-container PyAV ingest capability
(reference utils.py:179-198) fully natively. Auto-builds with g++ on
first use when the FFmpeg dev headers are present, into the package's
``build/`` directory (never into ``native/``); callers degrade through
codec_available() when they aren't.

The module also exposes the test-fixture m4a ENCODER from the same TU
(mirrors tests/helpers_flacenc.py: tests synthesize their own compressed
fixtures instead of shipping binary assets).
"""

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from audio_denoising_torch.io.native import (
    BUILD_DIR, NATIVE_DIR, build_library)

_LIB_PATH = os.path.join(BUILD_DIR, "libadt_codec.so")
_SRC_PATH = os.path.join(NATIVE_DIR, "adt_codec.cpp")

_lib = None
_lock = threading.Lock()
_tried = False

_F32P = ctypes.POINTER(ctypes.c_float)


def _build() -> bool:
    return build_library(_SRC_PATH, _LIB_PATH,
                         ("-lavformat", "-lavcodec", "-lavutil"))


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and os.path.exists(_SRC_PATH):
            _build()
        if not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            # built on a machine with the libs, loaded on one without
            return None
        lib.adt_av_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(_F32P),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
        lib.adt_av_decode.restype = ctypes.c_int
        lib.adt_av_free.argtypes = [_F32P]
        lib.adt_av_encode_m4a.argtypes = [
            ctypes.c_char_p, _F32P, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.adt_av_encode_m4a.restype = ctypes.c_int
        _lib = lib
        return _lib


def av_available() -> bool:
    return _load() is not None


def read_audio_av(path: str) -> Tuple[np.ndarray, int]:
    """Decode any libavformat/libavcodec container -> ((C, N) f32, rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "libadt_codec unavailable (FFmpeg dev libraries not present "
            "at build time)")
    buf = _F32P()
    n = ctypes.c_int64()
    ch = ctypes.c_int()
    rate = ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    rc = lib.adt_av_decode(os.fsencode(path), ctypes.byref(buf),
                           ctypes.byref(n), ctypes.byref(ch),
                           ctypes.byref(rate), err, len(err))
    if rc != 0:
        raise RuntimeError(
            f"av decode failed on {path!r}: "
            f"{err.value.decode(errors='replace')}")
    try:
        if n.value == 0:
            return np.zeros((max(1, ch.value), 0), np.float32), rate.value
        out = np.ctypeslib.as_array(buf, shape=(ch.value, n.value)).copy()
    finally:
        lib.adt_av_free(buf)
    return out, rate.value


def encode_m4a(path: str, pcm: np.ndarray, sample_rate: int) -> None:
    """TEST HELPER: (C, N) float32 -> .m4a via libavcodec's AAC coder."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libadt_codec unavailable")
    pcm = np.ascontiguousarray(pcm, np.float32)
    if pcm.ndim == 1:
        pcm = pcm[None]
    ch, n = pcm.shape
    err = ctypes.create_string_buffer(256)
    rc = lib.adt_av_encode_m4a(os.fsencode(path),
                               pcm.ctypes.data_as(_F32P), n, ch,
                               sample_rate, err, len(err))
    if rc != 0:
        raise RuntimeError(
            f"m4a encode failed: {err.value.decode(errors='replace')}")

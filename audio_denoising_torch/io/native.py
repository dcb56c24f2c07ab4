"""ctypes bindings for the native host runtime (native/adt_native.cpp).

Loaded lazily; auto-builds with g++ on first use if the shared library is
missing (build is a single TU, <1 s). The library is built from the
repo's ``native/`` source into the package's ``build/`` directory (listed
in ``.gitignore``) and loaded from there; nothing is written into
``native/``. Every function has a numpy fallback in its caller, so the
package works without a toolchain.
"""

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")   # the sources
BUILD_DIR = os.path.join(_PKG, "build")
_LIB_PATH = os.path.join(BUILD_DIR, "libadt_native.so")
_SRC_PATH = os.path.join(NATIVE_DIR, "adt_native.cpp")

_lib = None
_lock = threading.Lock()
_tried = False


def build_library(src: str, out: str, libs=()) -> bool:
    """g++ ``src`` into ``out`` through a temporary file renamed into
    place, so a concurrent process never loads a half-written library."""
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", src,
             "-o", tmp, *libs],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _build() -> bool:
    return build_library(_SRC_PATH, _LIB_PATH)


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
            return None
        c_f32p = ctypes.POINTER(ctypes.c_float)
        c_i16p = ctypes.POINTER(ctypes.c_int16)
        c_i64 = ctypes.c_int64
        lib.adt_pcm16_to_f32.argtypes = [c_i16p, c_f32p, c_i64]
        lib.adt_f32_to_pcm16.argtypes = [c_f32p, c_i16p, c_i64]
        lib.adt_pcm24_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), c_f32p, c_i64]
        lib.adt_deinterleave_f32.argtypes = [c_f32p, c_f32p, c_i64, c_i64]
        lib.adt_interleave_f32.argtypes = [c_f32p, c_f32p, c_i64, c_i64]
        lib.adt_peak_f32.argtypes = [c_f32p, c_i64]
        lib.adt_peak_f32.restype = ctypes.c_float
        lib.adt_combine_f32.argtypes = [c_f32p, c_f32p, c_f32p, c_i64]
        lib.adt_chunker_new.argtypes = [c_i64, c_i64]
        lib.adt_chunker_new.restype = ctypes.c_void_p
        lib.adt_chunker_free.argtypes = [ctypes.c_void_p]
        lib.adt_chunker_push.argtypes = [ctypes.c_void_p, c_f32p, c_i64]
        lib.adt_chunker_push.restype = c_i64
        lib.adt_chunker_pop.argtypes = [ctypes.c_void_p, c_f32p]
        lib.adt_chunker_pop.restype = ctypes.c_int32
        lib.adt_chunker_size.argtypes = [ctypes.c_void_p]
        lib.adt_chunker_size.restype = c_i64
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pcm16_to_f32(samples: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, np.int16)
    out = np.empty(samples.shape, np.float32)
    lib.adt_pcm16_to_f32(_ptr(samples, ctypes.c_int16),
                         _ptr(out, ctypes.c_float), samples.size)
    return out


def f32_to_pcm16(samples: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, np.float32)
    out = np.empty(samples.shape, np.int16)
    lib.adt_f32_to_pcm16(_ptr(samples, ctypes.c_float),
                         _ptr(out, ctypes.c_int16), samples.size)
    return out


def pcm24_to_f32(raw: np.ndarray) -> Optional[np.ndarray]:
    """raw: (n*3,) uint8 packed 24-bit LE -> (n,) float32."""
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, np.uint8)
    n = raw.size // 3
    out = np.empty(n, np.float32)
    lib.adt_pcm24_to_f32(_ptr(raw, ctypes.c_uint8),
                         _ptr(out, ctypes.c_float), n)
    return out


def deinterleave(samples: np.ndarray, channels: int) -> Optional[np.ndarray]:
    """(n*ch,) interleaved f32 -> (ch, n)."""
    lib = _load()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, np.float32)
    n = samples.size // channels
    out = np.empty((channels, n), np.float32)
    lib.adt_deinterleave_f32(_ptr(samples, ctypes.c_float),
                             _ptr(out, ctypes.c_float), n, channels)
    return out


def interleave(samples: np.ndarray) -> Optional[np.ndarray]:
    """(ch, n) planar f32 -> (n*ch,) interleaved."""
    lib = _load()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, np.float32)
    ch, n = samples.shape
    out = np.empty(ch * n, np.float32)
    lib.adt_interleave_f32(_ptr(samples, ctypes.c_float),
                           _ptr(out, ctypes.c_float), n, ch)
    return out


def peak(samples: np.ndarray) -> Optional[float]:
    lib = _load()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, np.float32)
    return float(lib.adt_peak_f32(_ptr(samples, ctypes.c_float),
                                  samples.size))


def combine(a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    out = np.empty(a.shape, np.float32)
    lib.adt_combine_f32(_ptr(a, ctypes.c_float), _ptr(b, ctypes.c_float),
                        _ptr(out, ctypes.c_float), a.size)
    return out


class NativeChunker:
    """Residue-carry re-chunker (buffer_stream contract, utils.py:221-269)
    backed by the C++ ring buffer; falls back to a numpy deque upstream if
    the native lib is unavailable (callers check native_available())."""

    def __init__(self, chunk_size: int, capacity: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.chunk_size = chunk_size
        self._h = lib.adt_chunker_new(chunk_size, capacity or chunk_size * 4)

    def push(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, np.float32)
        return int(self._lib.adt_chunker_push(
            self._h, _ptr(samples, ctypes.c_float), samples.size))

    def pop(self) -> Optional[np.ndarray]:
        out = np.empty(self.chunk_size, np.float32)
        if self._lib.adt_chunker_pop(self._h, _ptr(out, ctypes.c_float)):
            return out
        return None

    @property
    def pending(self) -> int:
        return int(self._lib.adt_chunker_size(self._h))

    def __del__(self):
        try:
            self._lib.adt_chunker_free(self._h)
        except Exception:
            pass

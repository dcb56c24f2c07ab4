"""Build the port's CUDA sources with ``nvcc`` and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface, so it compiles in
seconds without PyTorch's headers. The shared library goes into the
package's ``build/`` directory (listed in ``.gitignore``) at first use,
named by a hash of the source and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. Nothing here runs at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple

_PKG = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: str
    log: str          # nvcc's output (the -Xptxas -v lines); "" if cached
    seconds: float    # build time; 0.0 if the library was already built


_lock = threading.Lock()
_loaded: Dict[str, KernelLibrary] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from source at first use")
    return found


def load_kernel_library(name: str) -> KernelLibrary:
    """Build ``csrc/<name>.cu`` for sm_90a unless already built, load it,
    and return it with the build log. Raises if nvcc fails."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        src = SOURCE_DIR / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        log, seconds = "", 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            os.replace(tmp, out)     # atomic: other processes see all or none
        built = KernelLibrary(ctypes.CDLL(str(out)), str(out), log, seconds)
        _loaded[name] = built
        return built

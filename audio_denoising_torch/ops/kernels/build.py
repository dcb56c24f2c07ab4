"""Build the port's CUDA sources with ``nvcc`` and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface, so it compiles in
seconds without PyTorch's headers; the ``csrc/*.cuh`` headers hold device
code that several kernels share. The shared library goes into the
package's ``build/`` directory (listed in ``.gitignore``) at first use,
named by a hash of the source, the headers and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing here
runs at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence

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


def _library_path(name: str) -> Path:
    src = SOURCE_DIR / f"{name}.cu"
    # the headers beside the sources are part of every build's input
    headers = b"".join(h.read_bytes()
                       for h in sorted(SOURCE_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_kernel_libraries(names: Sequence[str]) -> List[KernelLibrary]:
    """Build each ``csrc/<name>.cu`` for sm_90a unless already built (one
    nvcc process per source, all started together), load them, and return
    them with their build logs. Raises if nvcc fails."""
    with _lock:
        todo, built = {}, {}
        try:
            for name in dict.fromkeys(names):
                out = _library_path(name) if name not in _loaded else None
                if out is None or out.exists():
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                src = SOURCE_DIR / f"{name}.cu"
                proc = subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                todo[name] = (proc, tmp, out, time.perf_counter())
            for name, (proc, tmp, out, t0) in todo.items():
                log = proc.communicate(timeout=NVCC_TIMEOUT_S)[0]
                built[name] = (log, time.perf_counter() - t0)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {SOURCE_DIR / (name + '.cu')}:\n{log}")
                os.replace(tmp, out)  # atomic: other processes see all or none
        finally:
            for proc, tmp, _, _ in todo.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                tmp.unlink(missing_ok=True)
        for name in names:
            if name not in _loaded:
                out = _library_path(name)
                log, seconds = built.get(name, ("", 0.0))
                _loaded[name] = KernelLibrary(ctypes.CDLL(str(out)), str(out),
                                              log, seconds)
        return [_loaded[name] for name in names]


def load_kernel_library(name: str) -> KernelLibrary:
    """Build ``csrc/<name>.cu`` for sm_90a unless already built, load it,
    and return it with the build log. Raises if nvcc fails."""
    return load_kernel_libraries((name,))[0]

"""Build the port's CUDA sources with ``nvcc`` and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface, so it compiles in
seconds without PyTorch's headers; the ``csrc/*.cuh`` headers hold device
code that several kernels share. The shared library goes into the
package's ``build/`` directory (listed in ``.gitignore``) at first use,
named by a hash of the source, the headers and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. A source
listed in ``PARTS`` is compiled as several objects at once, each with its
part's macro set (``csrc/fused_hop.cu``: one object per compute mode), and
linked into its one library. Nothing here runs at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600
# sources built in parts: (the macro each object is compiled with, the
# parts 0 .. n - 1); csrc/fused_hop.cu's modes fp32, bf16 and int8
PARTS = {"fused_hop": ("ADT_FUSED_HOP_PART", 3)}


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


def _start(cmd: List[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _compiles(name: str, tmp: Path) -> List[Tuple[List[str], Path]]:
    """The nvcc commands that build ``name``'s library into ``tmp``, each
    with what it writes: one, or one object per part (``PARTS``)."""
    src = str(SOURCE_DIR / f"{name}.cu")
    if name not in PARTS:
        return [([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), src], tmp)]
    macro, n = PARTS[name]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [tmp.with_name(f"{tmp.name}.{p}.o") for p in range(n)]
    return [([nvcc_path(), *flags, "-c", f"-D{macro}={p}", "-o", str(o),
              src], o) for p, o in enumerate(objs)]


def load_kernel_libraries(names: Sequence[str]) -> List[KernelLibrary]:
    """Build each ``csrc/<name>.cu`` for sm_90a unless already built (one
    nvcc process per source or per part of one, all started together),
    load them, and return them with their build logs. Raises if nvcc
    fails."""
    with _lock:
        todo, built = {}, {}
        try:
            for name in dict.fromkeys(names):
                out = _library_path(name) if name not in _loaded else None
                if out is None or out.exists():
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                jobs = [(_start(cmd), made)
                        for cmd, made in _compiles(name, tmp)]
                todo[name] = (jobs, tmp, out, time.perf_counter())
            for name, (jobs, tmp, out, t0) in todo.items():
                logs = []
                for proc, _ in jobs:
                    logs.append(proc.communicate(timeout=NVCC_TIMEOUT_S)[0])
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed on {SOURCE_DIR / (name + '.cu')}:"
                            f"\n{logs[-1]}")
                if name in PARTS:   # the parts' objects into one library
                    link = _start([nvcc_path(), *NVCC_FLAGS[:4], "-shared",
                                   "-Xcompiler", "-fPIC", "-o", str(tmp),
                                   *(str(made) for _, made in jobs)])
                    jobs.append((link, tmp))
                    logs.append(link.communicate(timeout=NVCC_TIMEOUT_S)[0])
                    if link.returncode != 0:
                        raise RuntimeError(f"linking {name} failed:\n"
                                           f"{logs[-1]}")
                built[name] = ("".join(logs), time.perf_counter() - t0)
                os.replace(tmp, out)  # atomic: other processes see all or none
        finally:
            for jobs, tmp, _, _ in todo.values():
                for proc, made in jobs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                    if made != tmp:
                        made.unlink(missing_ok=True)
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

"""Profiling of the serving steps (JAX counterpart runtime/profiler.py).

- ``device_trace``: a context manager around ``torch.profiler`` that
  writes a Chrome trace (``trace.json``, for chrome://tracing or
  Perfetto) of what ran inside it, the card's kernels included.
- ``StageProfile``: host-clock latency of a step, per hop with the card
  synchronized after every hop (``measure_dispatch``), or amortized over
  a chain of dependent hops with one synchronize at the end
  (``measure_amortized``). PyTorch runs eagerly and has no ``lax.scan``,
  so unlike the JAX figure the amortized one still holds the host's
  launch cost of every op of every hop: it is a rate the host and the
  card reach together, not the card's alone.
"""

import contextlib
import os
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from audio_denoising_torch.runtime.metrics import ServingMetrics


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the CPU ops and, where there is a card, its kernels into
    ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageProfile:
    """Time a step function hop by hop on ``device`` (see the module
    docstring); {p50_ms, p90_ms, p99_ms, n} per stage."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self.device = torch.device(device or "cpu")
        self.metrics = ServingMetrics(window=4096)

    def wait(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def measure_dispatch(self, fn: Callable, *args, iters: int = 50,
                         stage: str = "step") -> Dict[str, float]:
        fn(*args)
        self.wait()
        for _ in range(iters):
            with self.metrics.timer(stage):
                fn(*args)
                self.wait()
        return self.metrics.summary()[stage]

    def measure_amortized(self, make_chain: Callable, iters: int = 10,
                          chain: int = 50) -> float:
        """make_chain(chain) -> zero-arg callable running ``chain``
        dependent hops; returns the median milliseconds per hop."""
        fn = make_chain(chain)
        fn()
        self.wait()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            self.wait()
            ts.append((time.perf_counter() - t0) / chain * 1e3)
        return float(np.median(ts))

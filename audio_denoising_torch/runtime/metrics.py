"""Serving observability: per-stage timers, deadline tracking, counters
(a copy of the JAX package's runtime/metrics.py, which is pure Python).

The reference's observability is print statements and UI panels (SURVEY §5);
here metrics are structured and cheap (host-side monotonic clocks around
device steps, percentile summaries on demand).

Thread-safe: the tick thread records while connection handlers read
``summary()`` — an unguarded ``sorted(deque)`` mid-append raises
RuntimeError and would kill the reading handler (and with it every stream
that connection owns).
"""

import threading
import time
from collections import defaultdict, deque
from typing import Dict


class ServingMetrics:
    def __init__(self, window: int = 1024):
        self._lat = defaultdict(lambda: deque(maxlen=window))
        self._counters = defaultdict(int)
        self._lock = threading.Lock()

    def observe(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._lat[stage].append(seconds)

    def count(self, name: str, inc: int = 1) -> None:
        with self._lock:
            self._counters[name] += inc

    def timer(self, stage: str):
        metrics = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                metrics.observe(stage, time.perf_counter() - self.t0)

        return _Timer()

    @staticmethod
    def _pct(xs, q: float) -> float:
        if not xs:
            return float("nan")
        idx = min(len(xs) - 1, int(q / 100.0 * len(xs)))
        return xs[idx]

    def percentile(self, stage: str, q: float) -> float:
        with self._lock:
            xs = sorted(self._lat[stage])
        return self._pct(xs, q)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            lat = {stage: sorted(d) for stage, d in self._lat.items()}
            counters = dict(self._counters)
        out = {}
        for stage, xs in lat.items():
            out[stage] = {
                "p50_ms": 1e3 * self._pct(xs, 50),
                "p90_ms": 1e3 * self._pct(xs, 90),
                "p99_ms": 1e3 * self._pct(xs, 99),
                "n": float(len(xs)),
            }
        out["counters"] = counters
        return out

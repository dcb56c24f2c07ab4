"""Batching tick for the serving daemon (JAX counterpart runtime/tick.py).

One queue of (stream_id, chunk, sink) requests; each tick gathers a window
of requests, groups them into rounds of one chunk per stream, and advances
every round's streams in a single engine launch. A round's output is
copied to the host asynchronously and delivered on a later tick, so host
batching overlaps the device's work; rounds are launched, and delivered,
in the order they were formed.

A cadence-locked engine (mode ``unet``) advances every slot on each of
its ticks, so running a window's duplicate-sid rounds back to back would
splice zero hops into the streams whose chunks wait one round later: it
runs one round per wall tick and carries the rest into the next tick's
batch (JAX runtime/tick.py:86-184).

The engine call is guarded: one malformed chunk must fail only its own
requests (sinks get the exception via err_sink), never the tick thread —
a dead tick thread would silently wedge every stream on the daemon.
"""

import queue
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


class BatchingTick:
    def __init__(self, engine, metrics, tick_s: float = 1e-3,
                 lock: Optional[threading.Lock] = None, depth: int = 2):
        self.engine = engine
        self.metrics = metrics
        self.tick_s = tick_s
        # rounds kept in flight before delivery blocks on the oldest
        self.depth = max(1, depth)
        self.lock = lock or threading.Lock()
        self.requests: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._inflight = []

    # -- client side -------------------------------------------------------
    def submit(self, sid: str, chunk: np.ndarray,
               sink: Callable[[np.ndarray], None],
               err_sink: Optional[Callable[[str], None]] = None) -> None:
        self.requests.put((sid, chunk, sink, err_sink))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "BatchingTick":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the tick thread and wait up to ``timeout`` seconds for it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    # -- delivery of in-flight device results ---------------------------------
    def _deliver(self, entry) -> None:
        out, ready, slot_map, sinks, errs = entry
        try:
            # waiting is where asynchronous device errors surface: they
            # must fail only this round's requests, never the tick thread
            if ready is not None:
                ready.synchronize()
            out = out.numpy()
        except Exception as e:
            for sid in sinks:
                if errs[sid]:
                    errs[sid](f"engine error: {e!r}")
            return
        # count before replying, so a client that has its outputs sees
        # them in the next stats reply
        self.metrics.count("hops", len(slot_map))
        for sid, sink in sinks.items():
            if sid in slot_map:
                sink(out[slot_map[sid]])
            elif errs[sid]:
                errs[sid]("unknown stream")

    def _drain(self) -> None:
        while self._inflight:
            self._deliver(self._inflight.pop(0))

    def _flush_ready(self) -> None:
        """Deliver whatever the device has already finished, without
        blocking on rounds still in flight."""
        while self._inflight:
            ready = self._inflight[0][1]
            if ready is not None and not ready.query():
                break
            self._deliver(self._inflight.pop(0))

    def _dispatch(self, live: Dict[str, np.ndarray]):
        """Launch one round; start its device-to-host copy and mark its
        completion with an event on the stream of the card that holds the
        round's output. An engine sharded over several cards gathers the
        output on its first card, each shard's copy ordered after that
        shard's hop, so one event there marks every shard's end."""
        out, slot_map = self.engine.process_async(live)
        ready = None
        if out.is_cuda:
            stream = torch.cuda.current_stream(out.device)
            with torch.cuda.device(out.device):
                out = out.to("cpu", non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready, slot_map

    # -- the tick -------------------------------------------------------------
    def _loop(self) -> None:
        hop = self.engine.hop
        cadence = getattr(self.engine, "_cadence_locked", False)
        carry = []
        while not self._stop.is_set():
            try:
                # with a carried round pending, wait only about one tick
                # for fresh arrivals: blocking longer would throttle
                # clients that send one chunk per reply
                first = self.requests.get(
                    timeout=self.tick_s if carry
                    else (0.02 if self._inflight else 0.1))
            except queue.Empty:
                if not carry:
                    self._drain()  # idle: flush outstanding device results
                    continue
                first = None
            pending = carry + ([first] if first is not None else [])
            carry = []
            deadline = time.perf_counter() + self.tick_s
            while time.perf_counter() < deadline:
                try:
                    pending.append(self.requests.get_nowait())
                except queue.Empty:
                    time.sleep(self.tick_s / 10)

            while pending:
                batch: Dict[str, np.ndarray] = {}
                sinks, errs, rest = {}, {}, []
                for sid, chunk, sink, err_sink in pending:
                    if sid in batch:
                        rest.append((sid, chunk, sink, err_sink))
                        continue
                    chunk = np.asarray(chunk)
                    if chunk.shape != (hop,) or not np.issubdtype(
                            chunk.dtype, np.floating):
                        if err_sink:
                            err_sink(f"bad chunk: expected float ({hop},), "
                                     f"got {chunk.dtype} {chunk.shape}")
                        continue
                    batch[sid] = chunk.astype(np.float32, copy=False)
                    sinks[sid] = sink
                    errs[sid] = err_sink

                if batch:
                    try:
                        with self.metrics.timer("tick"):
                            with self.lock:
                                live = {s: c for s, c in batch.items()
                                        if s in self.engine.slots}
                                launched = (self._dispatch(live) if live
                                            else None)
                        if launched is not None:
                            self._inflight.append((*launched, sinks, errs))
                            while len(self._inflight) >= self.depth:
                                self._deliver(self._inflight.pop(0))
                        else:
                            for sid in batch:
                                if errs[sid]:
                                    errs[sid]("unknown stream")
                    except Exception as e:   # guard the tick thread
                        for sid in batch:
                            if errs[sid]:
                                errs[sid](f"engine error: {e!r}")
                if cadence and rest:
                    carry = rest           # the next wall tick's round
                    break
                pending = rest
            if not carry and self.requests.empty():
                self._flush_ready()
        self._drain()

"""Batched multi-stream serving daemon (JAX counterpart
apps/engine_serve.py, same wire protocol).

N concurrent client streams multiplex onto one fixed-slot StreamEngine;
every tick advances all streams that sent a chunk in a single launch of
the fused-hop kernel (runtime/tick.BatchingTick).

Protocol (multiprocessing.connection, length-prefixed pickle):

    ("open",  stream_id)             -> ("ok", stream_id, slot)
                                        | ("err", stream_id, reason)
    ("chunk", stream_id, float32[hop]) -> ("out", stream_id, float32[hop])
                                        | ("err", stream_id, reason)
    ("close", stream_id)             -> ("ok", stream_id, -1)
    ("stats",)                       -> ("stats", metrics_summary_dict)

A connection may only chunk/close streams it opened (stream ids are
client-chosen, so without the ownership check any client could close or
corrupt another's stream). Pickle runs arbitrary code on load: serve on a
trusted network only, as the reference package's daemon does.
"""

import argparse
import queue
import socket
import threading
from multiprocessing.connection import Listener
from typing import Optional, Tuple, Union

import torch

from audio_denoising_torch.config import recommended_serving
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.runtime.engine import MODES, StreamEngine
from audio_denoising_torch.runtime.metrics import ServingMetrics
from audio_denoising_torch.runtime.tick import BatchingTick

POLL_S = 0.25   # how often blocked loops look at the stop flag


class EngineDaemon:
    def __init__(self, spec: str = "gruunet2-stream16k",
                 max_streams: int = 256,
                 address: Tuple[str, int] = ("localhost", 6102),
                 mode: str = "fused", tick_ms: float = 1.0,
                 pipeline_depth: int = 2,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg, self.model = load_pretrained(spec)
        # the measured-best profile; a checkpoint it would gate is refused
        # by the fused hop (no gate yet), never served ungated
        self.cfg = recommended_serving(self.cfg)
        self.engine = StreamEngine(self.cfg, self.model, mode=mode,
                                   max_streams=max_streams, device=device)
        self.address = address
        self.metrics = ServingMetrics()
        self._lock = threading.Lock()   # engine lifecycle ops
        self.tick = BatchingTick(self.engine, self.metrics,
                                 tick_s=tick_ms / 1e3, lock=self._lock,
                                 depth=pipeline_depth)
        self._stop = threading.Event()
        self.listening = threading.Event()

    # -- connections ---------------------------------------------------------
    def _handle(self, conn) -> None:
        owned = set()
        closed = threading.Event()
        # Replies are queued and drained by a per-connection sender thread:
        # conn.send() blocks when the client's TCP buffer fills, and the
        # tick thread (shared by every stream) calls the sinks — one client
        # that stops reading must not wedge the whole daemon. Bounded with
        # drop-oldest.
        out_q: "queue.Queue" = queue.Queue(maxsize=64)

        def reply(msg):
            while True:
                try:
                    out_q.put_nowait(msg)
                    return
                except queue.Full:
                    try:
                        out_q.get_nowait()   # drop oldest
                    except queue.Empty:
                        pass

        def sender():
            while not (self._stop.is_set() or closed.is_set()):
                try:
                    msg = out_q.get(timeout=POLL_S)
                except queue.Empty:
                    continue
                try:
                    conn.send(msg)
                except (OSError, ValueError):
                    return

        threading.Thread(target=sender, daemon=True).start()
        try:
            while not self._stop.is_set():
                try:
                    if not conn.poll(POLL_S):
                        continue
                    msg = conn.recv()
                except (EOFError, OSError):
                    break
                op = msg[0]
                if op == "open":
                    sid = msg[1]
                    try:
                        with self._lock:
                            slot = self.engine.add_stream(sid)
                    except (RuntimeError, KeyError) as e:
                        reply(("err", sid, str(e)))
                        continue
                    owned.add(sid)
                    reply(("ok", sid, slot))
                elif op == "chunk":
                    sid = msg[1]
                    if sid not in owned:
                        reply(("err", sid, "not your stream"))
                        continue
                    self.tick.submit(
                        sid, msg[2],
                        sink=lambda out, sid=sid: reply(("out", sid, out)),
                        err_sink=lambda reason, sid=sid: reply(
                            ("err", sid, reason)))
                elif op == "close":
                    sid = msg[1]
                    if sid not in owned:
                        reply(("err", sid, "not your stream"))
                        continue
                    with self._lock:
                        if sid in self.engine.slots:
                            self.engine.remove_stream(sid)
                    owned.discard(sid)
                    reply(("ok", sid, -1))
                elif op == "stats":
                    reply(("stats", {
                        "active_streams": self.engine.active_streams,
                        "algorithmic_latency_ms": round(
                            self.engine.algorithmic_latency_ms, 3),
                        **self.metrics.summary()}))
                else:
                    reply(("err", None, f"unknown op {op!r}"))
        finally:
            closed.set()             # terminate the sender thread
            with self._lock:
                for sid in owned:    # eviction on disconnect
                    if sid in self.engine.slots:
                        self.engine.remove_stream(sid)
            conn.close()

    def serve_forever(self) -> None:
        """Accept connections until ``stop()``; returns within POLL_S of it."""
        self.tick.start()
        try:
            with Listener(self.address) as listener:
                # accept() has no timeout parameter; set it on the
                # underlying socket so stop() can take effect
                listener._listener._socket.settimeout(POLL_S)
                self.address = listener.address
                self.listening.set()
                print(f"engine listening on {self.address} (max "
                      f"{self.engine.n} streams, hop {self.engine.hop}, "
                      f"{self.engine.device})", flush=True)
                while not self._stop.is_set():
                    try:
                        conn = listener.accept()
                    except socket.timeout:
                        continue
                    threading.Thread(target=self._handle, args=(conn,),
                                     daemon=True).start()
        finally:
            self.tick.stop()

    def stop(self) -> None:
        self._stop.set()
        self.tick.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="audio_denoising_torch engine",
        description="Batched multi-stream denoising daemon (PyTorch/CUDA)")
    p.add_argument("--model", default="gruunet2-stream16k")
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=6102)
    p.add_argument("--max-streams", type=int, default=256)
    p.add_argument("--mode", choices=list(MODES), default="fused")
    p.add_argument("--tick-ms", type=float, default=1.0)
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="rounds kept in flight before delivery blocks")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cpu' runs the kernel's plain PyTorch version")
    args = p.parse_args(argv)
    daemon = EngineDaemon(args.model, args.max_streams,
                          (args.host, args.port), args.mode, args.tick_ms,
                          pipeline_depth=args.pipeline_depth,
                          device=args.device)
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        daemon.stop()
    return 0

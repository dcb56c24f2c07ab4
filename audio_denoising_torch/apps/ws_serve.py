"""WebSocket real-time denoising daemon, the browser-mic entry point (JAX
counterpart apps/ws_serve.py; the reference's streamlit-webrtc UI,
app2.py:479-492).

Protocol per connection (one connection is one stream):

- the client sends BINARY frames of int16 little-endian mono PCM at the
  model's sample rate, of any size (a host-side re-chunker carries the
  residue to the engine's hop);
- the server replies with BINARY int16 frames of denoised audio, one per
  hop, the same total length (hop-quantized; the residue goes with the
  next frame);
- the TEXT frame "stats" returns a JSON stats message; a close frame ends
  the connection.

A plain HTTP ``GET /`` on the same port serves the browser mic client,
the port's own copy of the page (``apps/static/index.html``:
getUserMedia -> AudioWorklet -> int16 PCM frames -> denoised playback).

All connections multiplex onto one batched StreamEngine on the card
(``device="cpu"`` runs the kernels' plain versions): every tick advances
every active stream in one engine step (runtime/tick.BatchingTick), one
launch of the fused-hop kernel in mode ``fused``, of the WebRTC-hop
kernels in mode ``fused-webrtc``. The JAX daemon's defaults hold:
``gruunet2-good`` in mode ``fast`` with 256 streams on port 8765, the
tuned SNR gate in modes ``fast`` and ``fused`` unless ``--snr-gate`` or
``--no-snr-gate`` is given, and ``--dtype`` applied after the gate
profile. Mode ``unet`` serves the U-Nets and TRUNet cadence-locked, at
the measured-best geometry unless a ``--unet-*`` flag or
``--no-snr-gate`` is given.
"""

import argparse
import dataclasses
import json
import os
import queue
import socket
import threading
import uuid
from typing import Optional, Union

import numpy as np
import torch

from audio_denoising_torch.apps.engine_serve import add_unet_flags
from audio_denoising_torch.config import (
    recommended_serving, recommended_streaming_geometry, with_snr_gate,
    with_unet_geometry)
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.io import websocket as ws
from audio_denoising_torch.io.wavio import float32_to_pcm16, pcm_to_float32
from audio_denoising_torch.runtime.engine import MODES, StreamEngine
from audio_denoising_torch.runtime.metrics import ServingMetrics
from audio_denoising_torch.runtime.tick import BatchingTick

POLL_S = 0.25      # how often blocked loops look at the stop flag
REPLY_QUEUE = 64   # replies a connection holds before the oldest is dropped
_STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "static")


class _PyChunker:
    """Residue-carry re-chunker where the native ring is unavailable."""

    def __init__(self, chunk_size: int):
        self.chunk_size = chunk_size
        self._buf = np.zeros(0, np.float32)

    def push(self, samples: np.ndarray) -> int:
        self._buf = np.concatenate([self._buf, samples])
        return len(self._buf) // self.chunk_size

    def pop(self) -> Optional[np.ndarray]:
        if len(self._buf) < self.chunk_size:
            return None
        out, self._buf = (self._buf[:self.chunk_size],
                          self._buf[self.chunk_size:])
        return out


def _make_chunker(hop: int):
    from audio_denoising_torch.io.native import (
        NativeChunker, native_available)
    if native_available():
        return NativeChunker(hop)
    return _PyChunker(hop)


class WSDaemon:
    """One batched engine behind a WebSocket port; see the module
    docstring. ``port=0`` binds a free port, which ``address`` gives once
    ``listening`` is set."""

    def __init__(self, spec: str = "gruunet2-good", host: str = "localhost",
                 port: int = 8765, max_streams: int = 256,
                 mode: str = "fast", tick_ms: float = 1.0,
                 pipeline_depth: int = 2,
                 snr_gate_db: Optional[float] = None,
                 snr_gate_width_db: Optional[float] = None,
                 snr_gate_estimator: Optional[str] = None,
                 dtype: Optional[str] = None, auto_gate: bool = True,
                 device: Optional[Union[str, torch.device]] = None,
                 unet_seg_hops: Optional[int] = None,
                 unet_ctx: Optional[int] = None,
                 unet_xfade: Optional[int] = None,
                 unet_ctx_left: Optional[int] = None):
        self.spec = spec
        self.cfg, self.model = load_pretrained(spec)
        self.cfg = with_unet_geometry(self.cfg, unet_seg_hops, unet_ctx,
                                      unet_xfade, unet_ctx_left)
        if snr_gate_db is not None:
            self.cfg = with_snr_gate(self.cfg, snr_gate_db,
                                     snr_gate_width_db, snr_gate_estimator)
        elif auto_gate and mode in ("fast", "fused"):
            # the measured-best profile of the phase-reuse hops, as the
            # JAX daemon serves it; the webrtc modes are gated on request
            self.cfg = recommended_serving(self.cfg)
        if auto_gate and mode == "unet" and all(v is None for v in (
                unet_seg_hops, unet_ctx, unet_xfade, unet_ctx_left)):
            # no geometry flag: the measured-best window, as the engine
            # daemon serves it
            self.cfg = recommended_streaming_geometry(self.cfg)
        if dtype is not None:
            self.cfg = dataclasses.replace(
                self.cfg,
                serving=dataclasses.replace(self.cfg.serving, dtype=dtype))
        self.engine = StreamEngine(self.cfg, self.model, mode=mode,
                                   max_streams=max_streams, device=device)
        self.address = (host, port)
        self.hop = self.cfg.dsp.hop_length
        self.metrics = ServingMetrics()
        self._lock = threading.Lock()   # engine lifecycle ops
        self.tick = BatchingTick(self.engine, self.metrics,
                                 tick_s=tick_ms / 1e3, lock=self._lock,
                                 depth=pipeline_depth)
        self._stop = threading.Event()
        self.listening = threading.Event()

    # -- the browser client page ---------------------------------------------
    def client_page(self) -> bytes:
        """The mic client's HTML with this daemon's DSP substituted."""
        with open(os.path.join(_STATIC_DIR, "index.html"), "rb") as f:
            page = f.read()
        return (page
                .replace(b"__SAMPLE_RATE__",
                         str(self.cfg.dsp.sample_rate).encode())
                .replace(b"__HOP__", str(self.hop).encode())
                .replace(b"__MODEL__", self.spec.encode()))

    def _serve_http(self, method, path, _headers, sock) -> None:
        """Plain HTTP on the WebSocket port: GET / gives the mic client."""
        if method != "GET":
            sock.sendall(b"HTTP/1.1 405 Method Not Allowed\r\n"
                         b"Allow: GET\r\nContent-Length: 0\r\n\r\n")
            return
        if path.split("?")[0] not in ("/", "/index.html"):
            sock.sendall(b"HTTP/1.1 404 Not Found\r\n"
                         b"Content-Length: 0\r\n\r\n")
            return
        body = self.client_page()
        sock.sendall(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/html; charset=utf-8\r\n"
                     b"Cache-Control: no-store\r\n"
                     b"Content-Length: " + str(len(body)).encode()
                     + b"\r\nConnection: close\r\n\r\n" + body)

    def _stats(self) -> bytes:
        return json.dumps({
            "active_streams": self.engine.active_streams,
            "algorithmic_latency_ms": round(
                self.engine.algorithmic_latency_ms, 3),
            **self.metrics.summary()}).encode()

    # -- one connection --------------------------------------------------------
    def _handle(self, raw_conn: socket.socket) -> None:
        sid = uuid.uuid4().hex
        conn = raw_conn
        closed = threading.Event()   # ends the sender thread
        try:
            hs = ws.handshake(raw_conn, http_handler=self._serve_http)
            if hs is None:
                return
            conn = ws.Buffered(raw_conn, hs[1])
            try:
                with self._lock:
                    self.engine.add_stream(sid)
            except RuntimeError as e:          # engine full
                ws.send_frame(conn, json.dumps({"error": str(e)}).encode(),
                              ws.OP_TEXT)
                # close code 1013, "try again later"
                ws.send_frame(conn, b"\x03\xf5busy", ws.OP_CLOSE)
                return
            # bounded: a client that sends but stops reading would grow the
            # queue without limit (TCP backpressure blocks the sender);
            # dropping the oldest degrades to a gap, as the reference does
            out_q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=REPLY_QUEUE)

            def sink(hop_out: np.ndarray) -> None:
                while True:
                    try:
                        out_q.put_nowait(hop_out)
                        return
                    except queue.Full:
                        try:
                            out_q.get_nowait()   # drop the oldest
                        except queue.Empty:
                            pass

            def sender() -> None:
                while not (self._stop.is_set() or closed.is_set()):
                    try:
                        out = out_q.get(timeout=POLL_S)
                    except queue.Empty:
                        continue
                    try:
                        ws.send_frame(conn, float32_to_pcm16(out).tobytes())
                    except OSError:
                        return

            threading.Thread(target=sender, daemon=True).start()
            chunker = _make_chunker(self.hop)
            while not self._stop.is_set():
                op, payload = ws.recv_message(conn)
                if op == ws.OP_CLOSE:
                    break
                if op == ws.OP_TEXT:
                    if payload.strip() == b"stats":
                        ws.send_frame(conn, self._stats(), ws.OP_TEXT)
                    continue
                # an odd-length frame ends in half a sample: drop it
                payload = payload[:len(payload) & ~1]
                if not payload:
                    continue
                chunker.push(pcm_to_float32(np.frombuffer(payload, np.int16)))
                while (chunk := chunker.pop()) is not None:
                    self.tick.submit(sid, chunk, sink)
        except (ConnectionError, OSError):
            pass
        finally:
            closed.set()
            with self._lock:
                if sid in self.engine.slots:
                    self.engine.remove_stream(sid)
            try:
                conn.close()
            except OSError:
                pass

    def serve_forever(self) -> None:
        """Accept connections until ``stop()``; returns within POLL_S of
        it."""
        self.tick.start()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(self.address)
            srv.listen(64)
            srv.settimeout(POLL_S)
            self.address = srv.getsockname()[:2]
            self.listening.set()
            print(f"websocket denoiser on ws://{self.address[0]}:"
                  f"{self.address[1]} (hop {self.hop} @ "
                  f"{self.cfg.dsp.sample_rate} Hz, max {self.engine.n} "
                  f"streams, mode {self.engine.mode}, {self.engine.device})",
                  flush=True)
            while not self._stop.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True).start()
        finally:
            srv.close()
            self.tick.stop()

    def stop(self) -> None:
        self._stop.set()
        self.tick.stop()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audio_denoising_torch ws",
        description="WebSocket browser-mic denoising daemon (PyTorch/CUDA)")
    p.add_argument("--model", default="gruunet2-good",
                   help="a preset name, an .npz or a reference .pth "
                   "checkpoint; mode fused-webrtc needs an .npz whose "
                   "full_config turns on dsp.griffin_lim_warm_start")
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=8765,
                   help="0 binds a free port")
    p.add_argument("--max-streams", type=int, default=256)
    p.add_argument("--mode", choices=list(MODES), default="fast")
    p.add_argument("--tick-ms", type=float, default=1.0)
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="rounds kept in flight before delivery blocks")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cpu' runs the kernels' plain PyTorch versions")
    p.add_argument("--snr-gate", type=float, default=None,
                   help="SNR-gated passthrough blend (dB): protects "
                   "near-clean streams. Without it, unit-gain causal "
                   "checkpoints serve the tuned gate in modes fast and "
                   "fused (config.recommended_serving)")
    p.add_argument("--no-snr-gate", action="store_true",
                   help="serve the raw profile: no recommended gate on "
                   "causal checkpoints, no recommended geometry in mode "
                   "unet")
    p.add_argument("--snr-gate-width", type=float, default=None,
                   help="the gate's transition width in dB (tuned default "
                   "6)")
    p.add_argument("--snr-gate-estimator", default=None,
                   choices=("removed", "floor", "both"),
                   help="the gate's SNR estimator (ops/noisefloor.py)")
    p.add_argument("--dtype", choices=["float32", "bfloat16", "int8"],
                   default=None,
                   help="serving compute dtype (default: the checkpoint's "
                   "own), applied after the gate profile: mode fused runs "
                   "the fused hop in it, mode fast serves the quantized "
                   "plan at int8; the webrtc modes serve int8 in mode fast")
    add_unet_flags(p)
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        p.exit(1, f"{p.prog}: {e}\n")
    daemon = WSDaemon(args.model, args.host, args.port, args.max_streams,
                      args.mode, args.tick_ms, args.pipeline_depth,
                      snr_gate_db=args.snr_gate,
                      snr_gate_width_db=args.snr_gate_width,
                      snr_gate_estimator=args.snr_gate_estimator,
                      dtype=args.dtype, auto_gate=not args.no_snr_gate,
                      device=device, unet_seg_hops=args.unet_seg_hops,
                      unet_ctx=args.unet_ctx, unet_xfade=args.unet_xfade,
                      unet_ctx_left=args.unet_ctx_left)
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        daemon.stop()
    return 0

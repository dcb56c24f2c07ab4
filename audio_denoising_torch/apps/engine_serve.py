"""Batched multi-stream serving daemon (JAX counterpart
apps/engine_serve.py, same wire protocol).

N concurrent client streams multiplex onto one fixed-slot StreamEngine;
every tick advances all streams that sent a chunk in one engine step
(runtime/tick.BatchingTick): the op-by-op phase-reuse hop in mode
``fast``, one launch of the fused-hop kernel in mode ``fused``, of the
WebRTC-hop kernels in mode ``fused-webrtc``, the op-by-op Griffin-Lim
hop in mode ``webrtc``, or the cadence-locked segment step of the
U-Nets and TRUNet in mode ``unet`` (one round per wall tick; the model
runs every ``unet_seg_hops`` ticks, at the measured-best geometry
unless a ``--unet-*`` flag or ``--no-snr-gate`` is given). As in the
JAX package, a bare daemon serves
``gruunet2-good`` in mode ``fast``, and in modes ``fast`` and ``fused`` a
unit-gain causal checkpoint gets the tuned SNR gate unless the caller
sets one (``--snr-gate``) or turns it off (``--no-snr-gate``); mode
``webrtc`` serves the gate that ``--snr-gate`` sets. ``--dtype`` sets the
serving compute: the fused hop in bfloat16 or int8 (W8A8) in mode
``fused``, the quantized plan at int8 in mode ``fast``. ``--multichip``
shards the slots over every local card when there are several (JAX
engine_serve.py:77-85): each card holds its contiguous block of slots and
runs the mode's hop on it (``StreamEngine(mesh=...)``); with one card the
daemon serves unsharded and its startup line says so.

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
import dataclasses
import queue
import socket
import threading
from multiprocessing.connection import Listener
from typing import Optional, Tuple, Union

import torch

from audio_denoising_torch.config import (
    recommended_serving, recommended_streaming_geometry, with_snr_gate,
    with_unet_geometry)
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.parallel.mesh import make_mesh
from audio_denoising_torch.runtime.engine import MODES, StreamEngine
from audio_denoising_torch.runtime.metrics import ServingMetrics
from audio_denoising_torch.runtime.tick import BatchingTick

POLL_S = 0.25   # how often blocked loops look at the stop flag


class EngineDaemon:
    """The JAX daemon's defaults: ``gruunet2-good`` in mode ``fast``. An
    explicit ``snr_gate_db`` turns the SNR gate on (``with_snr_gate``);
    without one, modes ``fast`` and ``fused`` serve the recommended
    profile (the tuned gate on unit-gain causal checkpoints) unless
    ``auto_gate`` is False. ``dtype`` ("float32", "bfloat16" or "int8";
    None keeps the checkpoint's own) replaces ``serving.dtype`` after the
    gate profile, as in the JAX daemon (engine_serve.py:73-76). The
    ``unet_*`` arguments set mode ``unet``'s geometry
    (``with_unet_geometry``); with none of them and ``auto_gate``, mode
    ``unet`` serves ``recommended_streaming_geometry``. ``multichip``
    shards the slots over every local card when there are several.
    ``mesh`` (``parallel.make_mesh``) shards them over its entries
    instead; it is for verification on one card (a card listed twice
    runs the sharded path there), users shard with ``multichip``."""

    def __init__(self, spec: str = "gruunet2-good",
                 max_streams: int = 256,
                 address: Tuple[str, int] = ("localhost", 6102),
                 mode: str = "fast", tick_ms: float = 1.0,
                 pipeline_depth: int = 2,
                 device: Optional[Union[str, torch.device]] = None,
                 snr_gate_db: Optional[float] = None,
                 snr_gate_width_db: Optional[float] = None,
                 snr_gate_estimator: Optional[str] = None,
                 auto_gate: bool = True, dtype: Optional[str] = None,
                 unet_seg_hops: Optional[int] = None,
                 unet_ctx: Optional[int] = None,
                 unet_xfade: Optional[int] = None,
                 unet_ctx_left: Optional[int] = None,
                 multichip: bool = False, mesh=None):
        self.cfg, self.model = load_pretrained(spec)
        self.cfg = with_unet_geometry(self.cfg, unet_seg_hops, unet_ctx,
                                      unet_xfade, unet_ctx_left)
        if snr_gate_db is not None:
            self.cfg = with_snr_gate(self.cfg, snr_gate_db,
                                     snr_gate_width_db, snr_gate_estimator)
        elif auto_gate and mode in ("fast", "fused"):
            # the measured-best profile of the phase-reuse hops, as the
            # JAX daemon serves it; mode webrtc is gated only on request
            self.cfg = recommended_serving(self.cfg)
        if auto_gate and mode == "unet" and all(v is None for v in (
                unet_seg_hops, unet_ctx, unet_xfade, unet_ctx_left)):
            # no geometry flag: the measured-best window; any flag, or
            # --no-snr-gate (the raw profile), opts out
            self.cfg = recommended_streaming_geometry(self.cfg)
        if dtype is not None:
            self.cfg = dataclasses.replace(
                self.cfg,
                serving=dataclasses.replace(self.cfg.serving, dtype=dtype))
        self.placement = None
        if multichip and mesh is None:
            cards = (torch.cuda.device_count()
                     if resolve_device(device).type == "cuda" else 1)
            if cards > 1:
                mesh = make_mesh()
            else:
                self.placement = "--multichip on one device: unsharded"
        if mesh is not None:
            device = None
            self.placement = (f"sharded over {mesh.size} entries "
                              f"({', '.join(map(str, mesh.devices))}), "
                              f"{max_streams // mesh.size} slots each")
        self.engine = StreamEngine(self.cfg, self.model, mode=mode,
                                   max_streams=max_streams, device=device,
                                   mesh=mesh)
        self.placement = self.placement or str(self.engine.device)
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
                print(f"engine listening on {self.address} (mode "
                      f"{self.engine.mode}, max {self.engine.n} streams, "
                      f"hop {self.engine.hop}, {self.placement})",
                      flush=True)
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


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audio_denoising_torch engine",
        description="Batched multi-stream denoising daemon (PyTorch/CUDA)")
    p.add_argument("--model", default="gruunet2-good",
                   help="a preset name or an .npz checkpoint; mode "
                   "fused-webrtc needs one whose embedded full_config "
                   "turns on dsp.griffin_lim_warm_start")
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=6102)
    p.add_argument("--max-streams", type=int, default=256)
    p.add_argument("--mode", choices=list(MODES), default="fast")
    p.add_argument("--tick-ms", type=float, default=1.0)
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="rounds kept in flight before delivery blocks")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cpu' runs the kernels' plain PyTorch versions")
    p.add_argument("--snr-gate", type=float, default=None,
                   help="SNR-gated passthrough blend: the output leans "
                   "toward the raw input above this estimated input SNR "
                   "(dB), protecting near-clean streams (ops/noisefloor.py)."
                   " Without it, unit-gain causal checkpoints serve the "
                   "tuned gate in modes fast and fused "
                   "(config.recommended_serving)")
    p.add_argument("--no-snr-gate", action="store_true",
                   help="serve the raw profile: no recommended gate on "
                   "causal checkpoints, no recommended geometry in mode "
                   "unet")
    p.add_argument("--snr-gate-width", type=float, default=None,
                   help="the gate's transition width in dB (tuned default "
                   "6)")
    p.add_argument("--snr-gate-estimator", default=None,
                   choices=("removed", "floor", "both"),
                   help="the gate's SNR estimator (default 'both': the "
                   "model-informed decision with the floor tracker's veto)")
    p.add_argument("--dtype", choices=["float32", "bfloat16", "int8"],
                   default=None,
                   help="serving compute dtype (default: the checkpoint's "
                   "own): mode fused runs the fused hop in bfloat16 (bf16 "
                   "matrices, fp32 sums) or int8 (W8A8 plan, bf16 DSP); "
                   "mode fast serves the quantized plan at int8 and "
                   "float32 otherwise")
    add_unet_flags(p)
    p.add_argument("--multichip", action="store_true",
                   help="shard the stream slots over every local card "
                   "(a 1-D mesh); one card serves unsharded")
    return p


def add_unet_flags(p: argparse.ArgumentParser) -> None:
    """Mode unet's geometry flags, shared with the WebSocket daemon."""
    p.add_argument("--unet-seg-hops", type=int, default=None,
                   help="mode unet: segment length in hops (latency = "
                   "seg_hops * hop + ctx samples)")
    p.add_argument("--unet-ctx", type=int, default=None,
                   help="mode unet: future window context in samples")
    p.add_argument("--unet-xfade", type=int, default=None,
                   help="mode unet: segment-join crossfade in samples "
                   "(adds no latency)")
    p.add_argument("--unet-ctx-left", type=int, default=None,
                   help="mode unet: past window context in samples (adds "
                   "no latency)")


def daemon_from_args(args: argparse.Namespace) -> EngineDaemon:
    return EngineDaemon(args.model, args.max_streams, (args.host, args.port),
                        args.mode, args.tick_ms,
                        pipeline_depth=args.pipeline_depth,
                        device=args.device, snr_gate_db=args.snr_gate,
                        snr_gate_width_db=args.snr_gate_width,
                        snr_gate_estimator=args.snr_gate_estimator,
                        auto_gate=not args.no_snr_gate, dtype=args.dtype,
                        unet_seg_hops=args.unet_seg_hops,
                        unet_ctx=args.unet_ctx, unet_xfade=args.unet_xfade,
                        unet_ctx_left=args.unet_ctx_left,
                        multichip=args.multichip)


def main(argv=None) -> int:
    daemon = daemon_from_args(parser().parse_args(argv))
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        daemon.stop()
    return 0

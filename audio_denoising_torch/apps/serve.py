"""Wire-compatible socket denoising daemon (JAX counterpart
apps/serve.py).

Speaks the reference's protocol (server.py:178-227): a
``multiprocessing.connection.Listener`` on ``('localhost', 6101)``, each
message a pickled float array of shape ``(n_samples, n_channels)``,
answered with the denoised array of the same shape (the first channel
denoised, repeated over the channels); the string ``'close'`` ends a
connection. Each message runs ``pipeline.make_server_step`` on the card
(``device="cpu"`` runs it on the CPU), one centered STFT per message, as
the reference's server does; it launches no hand-written kernel, as the
JAX daemon runs ``model.apply``.

As in the JAX daemon, behind the same wire format:

- each connection carries its own hidden state (the reference shares one
  ``hx`` across all connections, server.py:177,212); ``--shared-state``
  restores that;
- connections are served concurrently, and a malformed payload gets an
  error reply and closes only its own connection;
- the listener restarts after an error (server.py:221-227).

Pickle runs arbitrary code on load: serve on a trusted network only, as
the reference does.
"""

import argparse
import socket
import threading
import time
from multiprocessing.connection import Listener
from typing import Optional, Tuple, Union

import numpy as np
import torch

from audio_denoising_torch.config import recommended_serving, with_snr_gate
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.pipeline import make_server_step
from audio_denoising_torch.runtime.metrics import ServingMetrics

POLL_S = 0.5   # how often the accept loop looks at the stop flag


class SocketDaemon:
    """The JAX daemon's defaults: ``gruunet2-good`` on port 6101, the
    recommended gate profile unless ``snr_gate_db`` sets one or
    ``auto_gate`` is False (a no-op on gruunet2-good, whose output gain
    is 3). ``address`` with port 0 binds a free port, which ``address``
    gives once ``listening`` is set."""

    def __init__(self, spec: str = "gruunet2-good",
                 address: Tuple[str, int] = ("localhost", 6101),
                 shared_state: bool = False,
                 snr_gate_db: Optional[float] = None,
                 snr_gate_width_db: Optional[float] = None,
                 snr_gate_estimator: Optional[str] = None,
                 auto_gate: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.cfg, self.model = load_pretrained(spec)
        if snr_gate_db is not None:
            self.cfg = with_snr_gate(self.cfg, snr_gate_db,
                                     snr_gate_width_db, snr_gate_estimator)
        elif auto_gate:
            self.cfg = recommended_serving(self.cfg)
        self.address = address
        self.shared_state = shared_state
        self._step = make_server_step(self.cfg, self.model, self.device)
        self._shared_hx = None
        self._lock = threading.Lock()
        self.metrics = ServingMetrics()
        self._stop = threading.Event()
        self.listening = threading.Event()

    # -- processing ------------------------------------------------------------
    def process(self, x: np.ndarray, hx: torch.Tensor
                ) -> Tuple[np.ndarray, torch.Tensor]:
        """x: (n_samples, n_channels) -> (denoised, same shape; hx')."""
        x = np.asarray(x, np.float32).T          # (C, n)
        n_channels = x.shape[0] if x.ndim == 2 else 1
        mono = x[0] if x.ndim == 2 else x        # server.py:205
        with self.metrics.timer("step"):
            hx, y = self._step(hx, torch.from_numpy(
                np.ascontiguousarray(mono[None])).to(self.device))
            y = y[0].cpu().numpy()
        return np.repeat(y[None], n_channels, axis=0).T, hx

    # -- connections -------------------------------------------------------------
    def _handle(self, conn) -> None:
        hx = self.model.init_state(1, device=self.device)
        try:
            while not self._stop.is_set():
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    break
                if isinstance(msg, str) and msg == "close":
                    break
                # a malformed payload closes this connection with an error
                # reply; the other connections go on
                try:
                    arr = np.asarray(msg, np.float32)
                    if arr.ndim not in (1, 2) or arr.size == 0:
                        raise ValueError(
                            f"expected a non-empty (n_samples, n_channels) "
                            f"float array, got shape {arr.shape}")
                except (TypeError, ValueError) as e:
                    self.metrics.count("malformed")
                    try:
                        conn.send(f"error: malformed payload ({e})")
                    except OSError:
                        pass
                    break
                if self.shared_state:
                    with self._lock:
                        out, self._shared_hx = self.process(
                            arr, hx if self._shared_hx is None
                            else self._shared_hx)
                else:
                    out, hx = self.process(arr, hx)
                conn.send(out)
                self.metrics.count("messages")
        finally:
            conn.close()

    def serve_forever(self) -> None:
        """Accept connections until ``stop()``; the listener restarts
        after an error (server.py:221-227)."""
        while not self._stop.is_set():
            try:
                with Listener(self.address) as listener:
                    # accept() has no timeout parameter; set it on the
                    # underlying socket so stop() can take effect
                    listener._listener._socket.settimeout(POLL_S)
                    self.address = listener.address
                    self.listening.set()
                    print(f"listening on {self.address} ({self.device})",
                          flush=True)
                    while not self._stop.is_set():
                        try:
                            conn = listener.accept()
                        except socket.timeout:
                            continue
                        threading.Thread(target=self._handle, args=(conn,),
                                         daemon=True).start()
            except KeyboardInterrupt:
                break
            except Exception as e:
                print(f"listener error: {e}; restarting...", flush=True)
                time.sleep(0.1)

    def stop(self) -> None:
        self._stop.set()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audio_denoising_torch serve",
        description="Reference-protocol socket denoising daemon "
        "(PyTorch/CUDA)")
    p.add_argument("--model", default="gruunet2-good",
                   help="a preset name, an .npz or a reference .pth "
                   "checkpoint")
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=6101,
                   help="0 binds a free port")
    p.add_argument("--shared-state", action="store_true",
                   help="the reference's behaviour: one hx shared across "
                   "connections")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cpu' runs the server step on the CPU")
    p.add_argument("--snr-gate", type=float, default=None,
                   help="SNR-gated passthrough blend (dB); without it, "
                   "eligible causal checkpoints serve the tuned gate "
                   "(config.recommended_serving)")
    p.add_argument("--no-snr-gate", action="store_true",
                   help="serve the raw model: no recommended gate")
    p.add_argument("--snr-gate-width", type=float, default=None)
    p.add_argument("--snr-gate-estimator", default=None,
                   choices=("removed", "floor", "both"))
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        p.exit(1, f"{p.prog}: {e}\n")
    daemon = SocketDaemon(args.model, (args.host, args.port),
                          shared_state=args.shared_state,
                          snr_gate_db=args.snr_gate,
                          snr_gate_width_db=args.snr_gate_width,
                          snr_gate_estimator=args.snr_gate_estimator,
                          auto_gate=not args.no_snr_gate, device=device)
    try:
        daemon.serve_forever()
    finally:
        daemon.stop()
    return 0

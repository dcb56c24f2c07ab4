"""Batched multi-stream serving engine (JAX counterpart runtime/engine.py,
``StreamEngine`` at :231).

This slice has mode ``fused`` only: every tick advances all slots in one
launch of the fused-hop kernel (ops/kernels/fused_hop.py), and commits
state only for the slots that received a chunk. Per-stream state lives
at a slot index of batched device tensors; slots are admitted and
evicted by index, and inactive slots compute on zeros.
"""

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from audio_denoising_torch.config import Config
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.ops.kernels.fused_hop import (
    FusedHopState, fused_hop_init_state, make_fused_hop)
from audio_denoising_torch.runtime.plan import build_cell_plan

MODES = ("fused",)


class StreamEngine:
    """Admission-controlled batched serving over a fixed slot table.

    A stream's lifecycle is add -> process xN -> remove (slot state zeroed
    on add). ``device`` is the card unless ``"cpu"`` is passed, which runs
    the kernel's plain PyTorch version."""

    def __init__(self, cfg: Config, model, mode: str = "fused",
                 max_streams: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if mode not in MODES:
            raise ValueError(f"engine mode {mode!r} is not ported yet; the "
                             f"port has {MODES}")
        if getattr(cfg.model, "lookahead_frames", 0):
            raise NotImplementedError(
                "bounded-lookahead checkpoints need the op-by-op fast step, "
                "which is not ported yet")
        self.cfg = cfg
        self.mode = mode
        self.device = resolve_device(device)
        self.n = max_streams or cfg.serving.max_streams
        self.hop = cfg.dsp.hop_length
        self.plan = build_cell_plan(model)
        # raises for what the kernel lacks, and on the card checks that a
        # block's activations fit in shared memory
        self.hop_step = make_fused_hop(
            cfg, self.plan, self.device,
            compute_dtype=getattr(torch, cfg.serving.dtype))
        self.state = fused_hop_init_state(cfg, self.plan, self.n, self.device)
        self.slots: Dict[str, int] = {}
        self._free = list(range(self.n - 1, -1, -1))

    # -- lifecycle ---------------------------------------------------------
    def add_stream(self, stream_id: str) -> int:
        if stream_id in self.slots:
            raise KeyError(f"stream {stream_id!r} already active")
        if not self._free:
            raise RuntimeError("engine full: no free stream slots")
        slot = self._free.pop()
        for t in self.state:
            t[slot].zero_()
        self.slots[stream_id] = slot
        return slot

    def remove_stream(self, stream_id: str) -> None:
        slot = self.slots.pop(stream_id)
        self._free.append(slot)

    @property
    def active_streams(self) -> int:
        return len(self.slots)

    @property
    def algorithmic_latency_samples(self) -> int:
        """What the serving mode itself delays the audio by: the
        hop-synchronous overlap-add holds ``n_fft - hop`` samples."""
        return self.cfg.dsp.n_fft - self.cfg.dsp.hop_length

    @property
    def algorithmic_latency_ms(self) -> float:
        return (self.algorithmic_latency_samples
                / self.cfg.dsp.sample_rate * 1e3)

    # -- data path -----------------------------------------------------------
    def _step(self, batch: torch.Tensor) -> Tuple[FusedHopState,
                                                  torch.Tensor]:
        # ingress sanitization: a NaN/Inf sample would poison the slot's
        # recurrent state for good (the carry never forgets it, and masked
        # commit cannot help: the poisoned tick is a real chunk)
        batch = torch.where(torch.isfinite(batch), batch,
                            torch.zeros_like(batch))
        return self.hop_step(self.state, batch)

    def _gather(self, chunks: Dict[str, np.ndarray]):
        batch = np.zeros((self.n, self.hop), np.float32)
        mask = np.zeros((self.n,), np.bool_)
        slot_map = {}
        for sid, chunk in chunks.items():
            slot = self.slots[sid]
            batch[slot] = chunk
            mask[slot] = True
            slot_map[sid] = slot
        return batch, mask, slot_map

    def process_async(self, chunks: Dict[str, np.ndarray]
                      ) -> Tuple[torch.Tensor, Dict[str, int]]:
        """Advance every slot with a chunk this tick and return
        ``(out (N, hop) on the device, slot_map)`` without waiting for the
        device. Only those slots commit their new state: a stream's
        recurrence must not advance on the zero inputs of ticks it missed."""
        batch, mask, slot_map = self._gather(chunks)
        batch = torch.from_numpy(batch).to(self.device)
        keep = torch.from_numpy(mask).to(self.device)[:, None]
        new, out = self._step(batch)
        self.state = FusedHopState(*(torch.where(keep, a, b)
                                     for a, b in zip(new, self.state)))
        return out, slot_map

    def process(self, chunks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """chunks: {stream_id: (hop,) float32} -> same keyed outputs."""
        out, slot_map = self.process_async(chunks)
        out = out.cpu().numpy()
        return {sid: out[slot] for sid, slot in slot_map.items()}

    def process_batch(self, batch: torch.Tensor) -> torch.Tensor:
        """Raw fixed-shape path: (N, hop) in -> (N, hop) out, every slot
        advances."""
        self.state, out = self._step(batch.to(self.device))
        return out

    # -- failure recovery: snapshot/restore of stream state ------------------
    def snapshot(self) -> Dict:
        """Host-side copy of all per-stream state and the slot table."""
        return {
            "state": {k: v.cpu().numpy()
                      for k, v in self.state._asdict().items()},
            "slots": dict(self.slots),
            "free": list(self._free),
            "mode": self.mode,
        }

    def restore(self, snap: Dict) -> None:
        if snap["mode"] != self.mode:
            raise ValueError(f"snapshot mode {snap['mode']!r} != engine "
                             f"mode {self.mode!r}")
        if set(snap["state"]) != set(FusedHopState._fields):
            raise ValueError("snapshot state layout mismatch")
        state = FusedHopState(**{
            k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
            for k, v in snap["state"].items()})
        mismatched = [(tuple(a.shape), tuple(b.shape))
                      for a, b in zip(state, self.state)
                      if a.shape != b.shape]
        if mismatched:
            raise ValueError(
                f"snapshot shapes {mismatched} do not match this engine "
                f"(different max_streams or DSP config?)")
        self.state = state
        self.slots = dict(snap["slots"])
        self._free = list(snap["free"])

"""The whole serving hop as one kernel (JAX counterpart
ops/pallas/fused_hop.py, single-hop ``kernel`` at :242).

``make_fused_hop(cfg, plan, device)`` returns a ``FusedHop``: calling it
runs one hop for a batch of streams, ``step(state, chunk (B, hop)) ->
(state', out (B, hop))``. For CPU tensors it runs ``reference``, the plain
PyTorch version that follows ``_hop_math`` (fused_hop.py:256-371); for
CUDA tensors it launches the hand-written kernel in
``csrc/fused_hop.cu`` or raises. ``launches`` counts kernel launches.

This slice ports the fp32, mel-domain hop with no SNR gate and no delta
(MOMO3) carry; those, bf16/int8 compute, int16 IO and the resident
multi-hop form raise NotImplementedError.
"""

import ctypes
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from audio_denoising_torch.config import Config
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.ops.kernels.common import (
    pack_plan_weights, plan_cell_math)
from audio_denoising_torch.ops.mel import inverse_mel_matrix, mel_filterbank
from audio_denoising_torch.ops.windows import hann_window

MAX_LEVELS = 8          # ADT_MAX_LEVELS in csrc/fused_hop.cu


class FusedHopState(NamedTuple):
    ring: torch.Tensor   # (B, n_fft) analysis window
    ola: torch.Tensor    # (B, n_fft) synthesis accumulator
    hx: torch.Tensor     # (B, hidden*compressed) cell state


def fused_hop_init_state(cfg: Config, plan, batch: int,
                         device: Union[str, torch.device] = "cpu"
                         ) -> FusedHopState:
    n_fft = cfg.dsp.n_fft
    z = lambda w: torch.zeros((batch, w), dtype=torch.float32, device=device)
    return FusedHopState(ring=z(n_fft), ola=z(n_fft),
                         hx=z(plan.hidden * plan.compressed))


def _dft_matrices(n_fft: int):
    """(CF, SF) forward (n_fft, F) and (IC, IS) inverse (F, n_fft) real
    DFT matrices, float32, such that rfft(x) = x@CF + i x@SF and
    irfft(R + iI) = R@IC + I@IS. Built in float64."""
    F = n_fft // 2 + 1
    ang = 2 * np.pi * np.outer(np.arange(F), np.arange(n_fft)) / n_fft
    CF = np.cos(ang).T.astype(np.float32)
    SF = (-np.sin(ang)).T.astype(np.float32)
    w = np.ones(F, np.float64)
    w[1:-1] = 2.0
    IC = (w[:, None] * np.cos(ang) / n_fft).astype(np.float32)
    IS = (-w[:, None] * np.sin(ang) / n_fft).astype(np.float32)
    return CF, SF, IC, IS


def _ola_envelope(win: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Sum of the squared window over the overlapping hops, first hop only;
    1 where it vanishes."""
    env = np.zeros(n_fft, np.float64)
    for k in range(n_fft // hop):
        env += np.roll(win * win, k * hop)
    return np.where(env[:hop] > 1e-8, env[:hop], 1.0).astype(np.float32)


class _Args(ctypes.Structure):
    """Field-for-field mirror of AdtFusedHopArgs in csrc/fused_hop.cu."""
    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "ring", "ola", "hx", "chunk", "ring_out", "ola_out", "hx_out",
            "out", "cf", "sf", "ic", "is_", "mel", "imel", "win", "env")]
        + [("down_w", ctypes.c_void_p * MAX_LEVELS),
           ("down_b", ctypes.c_void_p * MAX_LEVELS),
           ("reset_w", ctypes.c_void_p), ("reset_b", ctypes.c_void_p),
           ("up_w", ctypes.c_void_p * MAX_LEVELS),
           ("up_s", ctypes.c_void_p * MAX_LEVELS),
           ("up_b", ctypes.c_void_p * MAX_LEVELS),
           ("down_n", ctypes.c_int * (MAX_LEVELS + 1)),
           ("up_n", ctypes.c_int * (MAX_LEVELS + 1))]
        + [(f, ctypes.c_int) for f in (
            "levels", "batch", "n_fft", "hop", "n_bins", "n_mels",
            "n_hidden")]
        + [("output_gain", ctypes.c_float), ("state_decay", ctypes.c_float)])


def _check_supported(cfg: Config, plan, hops_per_call: int, io_dtype,
                     compute_dtype) -> None:
    dsp, srv = cfg.dsp, cfg.serving
    later = []
    if srv.snr_gate_db is not None:
        later.append("the SNR gate (serving.snr_gate_db)")
    if plan.delta:
        later.append("delta (MOMO3) plans")
    if compute_dtype != torch.float32:
        later.append(f"compute dtype {compute_dtype}")
    if dsp.domain == "raw":
        later.append("the raw-spectrogram domain")
    if io_dtype != torch.float32:
        later.append(f"{io_dtype} IO")
    if hops_per_call != 1:
        later.append("hops_per_call > 1 (the resident multi-hop kernel)")
    if later:
        raise NotImplementedError(
            "the port's fused hop does not implement " + ", ".join(later)
            + " yet")
    if dsp.n_fft % dsp.hop_length or dsp.n_fft % 2:
        raise ValueError("the fused hop needs an even n_fft that the hop "
                         "divides (WOLA)")
    if len(plan.down_mats) > MAX_LEVELS:
        raise ValueError(f"the kernel takes at most {MAX_LEVELS} levels")


class FusedHop:
    """One serving hop for a batch of streams on ``device``; see the
    module docstring."""

    def __init__(self, cfg: Config, plan, device: torch.device):
        dsp, srv = cfg.dsp, cfg.serving
        self.device = device
        self.n_fft, self.hop = dsp.n_fft, dsp.hop_length
        self.F, self.M = dsp.n_stft, dsp.n_mels
        self.n = plan.hidden * plan.compressed
        self.output_gain = float(srv.output_gain)
        self.state_decay = float(srv.state_decay)
        self.launches = 0

        win = hann_window(self.n_fft, dtype=torch.float64).numpy()
        CF, SF, IC, IS = _dft_matrices(self.n_fft)
        f32 = lambda a: torch.as_tensor(
            np.ascontiguousarray(a), dtype=torch.float32).to(device)
        self.cf, self.sf, self.ic, self.is_ = map(f32, (CF, SF, IC, IS))
        self.mel = mel_filterbank(self.F, self.M, dsp.sample_rate).to(device)
        self.imel = inverse_mel_matrix(
            self.F, self.M, dsp.sample_rate).T.contiguous().to(device)
        self.win = f32(win)
        self.env = f32(_ola_envelope(win, self.n_fft, self.hop))
        plan = plan.to(device=device, dtype=torch.float32)
        weights, self.skip_flags = pack_plan_weights(plan)
        self.weights: List[torch.Tensor] = [w.contiguous() for w in weights]
        self.levels = len(self.skip_flags)
        self.down_n = [self.M] + [m.shape[1] for m in plan.down_mats]
        self.up_n = [self.n] + [m.shape[1] for m in plan.up_h_mats]

        self._lib = None
        if device.type == "cuda":
            from audio_denoising_torch.ops.kernels.build import (
                load_kernel_library)
            self._lib = load_kernel_library("fused_hop").lib
            self._lib.adt_fused_hop_args_size.restype = ctypes.c_int
            self._lib.adt_fused_hop_smem_bytes.argtypes = [ctypes.c_void_p]
            self._lib.adt_fused_hop_smem_bytes.restype = ctypes.c_longlong
            self._lib.adt_fused_hop.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p]
            self._lib.adt_fused_hop.restype = ctypes.c_int
            if self._lib.adt_fused_hop_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError("csrc/fused_hop.cu and _Args disagree on "
                                   "the argument layout")
            self._base_args = self._args()
            self._check_shared_memory()

    # -- the plain PyTorch version ------------------------------------------
    def reference(self, state: FusedHopState, chunk: torch.Tensor
                  ) -> Tuple[FusedHopState, torch.Tensor]:
        hop = self.hop
        ring = torch.cat([state.ring[:, hop:], chunk], dim=-1)
        frame = ring * self.win
        re = frame @ self.cf
        im = frame @ self.sf
        mag = torch.sqrt(re * re + im * im)
        x = torch.log(1.0 + mag @ self.mel)
        h, hi = plan_cell_math(self.weights, self.skip_flags, self.n, x,
                               state.hx)
        rec = x - h
        rec = torch.where(rec >= 0, rec, 0.2 * rec)
        feat_mag = torch.clamp(torch.exp(rec) - 1.0, min=0.0)
        # the mel pseudo-inverse projects some bins negative: clamp, as
        # inverse_mel_scale does, or they resynthesize with inverted phase
        lin = torch.clamp(feat_mag @ self.imel, min=0.0) * self.output_gain
        # phase reuse as complex scaling; at mag ~ 0 the bin is lin + 0j
        safe = mag > 1e-8
        scale = lin / torch.where(safe, mag, torch.ones_like(mag))
        rec_re = torch.where(safe, re * scale, lin)
        rec_im = torch.where(safe, im * scale, torch.zeros_like(im))
        synth = (rec_re @ self.ic + rec_im @ self.is_) * self.win
        acc = state.ola + synth
        out = acc[:, :hop] / self.env
        ola = torch.cat([acc[:, hop:], torch.zeros_like(acc[:, :hop])],
                        dim=-1)
        return FusedHopState(ring, ola, hi * self.state_decay), out

    # -- the wrapper -----------------------------------------------------------
    def __call__(self, state: FusedHopState, chunk: torch.Tensor
                 ) -> Tuple[FusedHopState, torch.Tensor]:
        self._check(state, chunk)
        if chunk.device.type == "cpu":
            return self.reference(state, chunk)
        return self._launch(state, chunk)

    def _check(self, state: FusedHopState, chunk: torch.Tensor) -> None:
        if chunk.dim() != 2 or chunk.shape[1] != self.hop:
            raise ValueError(f"chunk must be (B, {self.hop}), got "
                             f"{tuple(chunk.shape)}")
        b = chunk.shape[0]
        want = {"chunk": (b, self.hop), "ring": (b, self.n_fft),
                "ola": (b, self.n_fft), "hx": (b, self.n)}
        got = {"chunk": chunk, "ring": state.ring, "ola": state.ola,
               "hx": state.hx}
        for name, t in got.items():
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if tuple(t.shape) != want[name]:
                raise ValueError(f"{name} must be {want[name]}, got "
                                 f"{tuple(t.shape)}")
            if t.device != chunk.device:
                raise ValueError(f"{name} is on {t.device}, chunk on "
                                 f"{chunk.device}")
        if chunk.device.type != self.device.type:
            raise ValueError(f"this hop was built for {self.device}; got "
                             f"tensors on {chunk.device}")

    def _args(self) -> _Args:
        """The launch arguments that do not change from hop to hop. The
        kernel reads each weight row as float4s, so matrices get their
        columns zero-padded to a multiple of 4; the padded copies are kept
        alive on the hop."""
        def ptr(t):
            if t.dim() == 2 and t.shape[1] % 4:
                t = torch.nn.functional.pad(t, (0, 4 - t.shape[1] % 4))
            self._kernel_tensors.append(t)
            if t.data_ptr() % 16:
                raise ValueError("kernel operands must be 16-byte aligned")
            return t.data_ptr()

        self._kernel_tensors: List[torch.Tensor] = []
        a = _Args()
        for name in ("cf", "sf", "ic", "is_", "mel", "imel", "win", "env"):
            setattr(a, name, ptr(getattr(self, name)))
        it = iter(self.weights)
        for i in range(self.levels):
            a.down_w[i] = ptr(next(it))
            a.down_b[i] = ptr(next(it))
        a.reset_w = ptr(next(it))
        a.reset_b = ptr(next(it))
        for i in range(self.levels):
            a.up_w[i] = ptr(next(it))
            a.up_b[i] = ptr(next(it))
            a.up_s[i] = ptr(next(it)) if self.skip_flags[i] else None
        for i, v in enumerate(self.down_n):
            a.down_n[i] = v
        for i, v in enumerate(self.up_n):
            a.up_n[i] = v
        a.levels = self.levels
        a.n_fft, a.hop, a.n_bins, a.n_mels = self.n_fft, self.hop, self.F, \
            self.M
        a.n_hidden = self.n
        a.output_gain, a.state_decay = self.output_gain, self.state_decay
        return a

    def _check_shared_memory(self) -> None:
        """What this kernel can take: the activations of one block's tile
        of streams in its shared memory."""
        limit = torch.cuda.get_device_properties(
            self.device).shared_memory_per_block_optin
        need = int(self._lib.adt_fused_hop_smem_bytes(
            ctypes.byref(self._base_args)))
        if need > limit:
            raise RuntimeError(
                f"the fused hop needs {need} B of shared memory per block; "
                f"this card allows {limit} B")

    def _launch(self, state: FusedHopState, chunk: torch.Tensor
                ) -> Tuple[FusedHopState, torch.Tensor]:
        ins = [t.contiguous() for t in (state.ring, state.ola, state.hx,
                                        chunk)]
        new = FusedHopState(*(torch.empty_like(t) for t in ins[:3]))
        out = torch.empty_like(ins[3])
        a = _Args.from_buffer_copy(self._base_args)
        a.batch = chunk.shape[0]
        a.ring, a.ola, a.hx, a.chunk = (t.data_ptr() for t in ins)
        a.ring_out, a.ola_out, a.hx_out = (t.data_ptr() for t in new)
        a.out = out.data_ptr()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._lib.adt_fused_hop(ctypes.byref(a), stream)
        if err != 0:
            raise RuntimeError(f"fused hop launch failed: cudaError {err}")
        self.launches += 1
        return new, out


def make_fused_hop(cfg: Config, plan,
                   device: Optional[Union[str, torch.device]] = None,
                   hops_per_call: int = 1, io_dtype=torch.float32,
                   compute_dtype=torch.float32) -> FusedHop:
    """One-kernel serving hop on ``device`` (the card unless ``"cpu"``)."""
    _check_supported(cfg, plan, hops_per_call, io_dtype, compute_dtype)
    return FusedHop(cfg, plan, resolve_device(device))

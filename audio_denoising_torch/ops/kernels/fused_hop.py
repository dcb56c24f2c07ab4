"""The whole serving hop as one kernel (JAX counterpart
ops/pallas/fused_hop.py: the single-hop ``kernel`` at :242 and the
resident multi-hop ``kernel_multi`` at :384).

``make_fused_hop(cfg, plan, device)`` returns a ``FusedHop``: calling it
runs one hop for a batch of streams, ``step(state, chunk (B, hop)) ->
(state', out (B, hop))``. With ``hops_per_call=K > 1`` a call runs K hops,
``step(state, chunks (K, B, hop)) -> (state', outs (K, B, hop))``, as one
launch whose state stays in the card's shared memory across the K hops.
``io_dtype=torch.int16`` takes and gives int16 PCM (s16 x 1/32768 in,
clip to [-1, 1] x 32767 truncated out): in the multi-hop kernel, or
around the single hop in the wrapper, as JAX's ``step`` does. For CPU
tensors a call runs ``plain`` (K hops of ``reference``, the plain PyTorch
version that follows ``_hop_math``, fused_hop.py:256-371, with the same
int16 conversion); for CUDA tensors it launches the hand-written kernels
in ``csrc/fused_hop.cu`` or raises. ``launches`` counts kernel launches.

The model's feature is log(1 + mag @ mel) in the mel domain and log(1 +
mag) in the raw-spectrogram domain (MOMO3's, no mel pair; JAX
fused_hop.py:164-168). A delta (MOMO3) plan carries the previous hop's
feature as the state plane ``prev`` (B, feat): the cell's level 0 reads
cat(x, prev), and prev' = x.

The hop carries the SNR gate (``serving.snr_gate_db``; ops/noisefloor.py)
on extra state planes: estimator 'removed' two per-stream EMAs, 'floor'
the per-bin smoothed power and floor and a per-stream EMA, 'both' all
five. The per-stream EMAs are (B, 1) here; the Pallas kernel keeps them
as (B, 128) broadcasts of the TPU's lane width.

``compute_dtype`` picks one of JAX's three compute modes (fused_hop.py:
138-153, :205-223, common.py:56-160): float32; ``torch.bfloat16``, where
every matrix operand (the DFT pair, the mel pair, the plan's matrices) is
stored in bf16 and each matmul's activation is rounded to bf16, with the
products summed in fp32; ``torch.int8`` (W8A8), where the plan's
matrices are int8 with one fp32 scale per column, each dot's activation
is quantized per row from its live max, the integer products are summed
exactly and dequantized rank-1, and the DSP matmuls run as in bf16. The
window and envelope rows, the biases, the scale rows and every state
plane stay fp32.

The port does not take JAX's ``hops_per_step`` (hops unrolled per grid
step: its outputs are bit-identical, and the Hopper kernel has no grid
step along K) or ``block_b`` (the kernel's tile of 2 streams is fixed and
its ragged last tile masked, so B is not padded).
"""

import ctypes
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from audio_denoising_torch.config import Config
from audio_denoising_torch.device import resolve_device
from audio_denoising_torch.ops.kernels.common import (
    KTILE, PlanArgs, PlanScaleArgs, cell_layout_floats, check_plan,
    kernel_operand, pack_plan_weights, plan_args, plan_args_q,
    plan_cell_math, plan_shape, round4)
from audio_denoising_torch.ops.mel import inverse_mel_matrix, mel_filterbank
from audio_denoising_torch.ops.noisefloor import (
    _EPS, FLOOR_BIAS, FLOOR_VETO_GATE_DB, FLOOR_VETO_WIDTH_DB,
    floor_rise_per_frame, gate_planes, smooth_beta_per_frame,
    total_beta_per_frame)
from audio_denoising_torch.ops.windows import hann_window, wola_envelope

DB_PER_NEPER = 10.0 / np.log(10.0)
# compute_dtype -> the kernel's AdtFusedHopArgs.compute
COMPUTE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# per-stream scalars and the gate's reduction lanes (kScalars, kMeans and
# kLanes in csrc/fused_hop.cu)
SCALARS, MEANS, LANES = 4, 4, 32


class FusedHopState(NamedTuple):
    ring: torch.Tensor   # (B, n_fft) analysis window
    ola: torch.Tensor    # (B, n_fft) synthesis accumulator
    hx: torch.Tensor     # (B, hidden*compressed) cell state
    prev: Optional[torch.Tensor] = None        # (B, feat) delta plans
    # the SNR gate's planes, present only when serving.snr_gate_db is set
    nf_smooth: Optional[torch.Tensor] = None   # (B, F) estimator 'floor'
    nf_floor: Optional[torch.Tensor] = None    # (B, F) estimator 'floor'
    nf_total: Optional[torch.Tensor] = None    # (B, 1) estimator 'floor'
    em_out: Optional[torch.Tensor] = None      # (B, 1) estimator 'removed'
    em_rem: Optional[torch.Tensor] = None      # (B, 1) estimator 'removed'


def _feat_width(cfg: Config) -> int:
    """The model's feature width: mel bins, or raw bins (n_stft)."""
    return cfg.dsp.n_stft if cfg.dsp.domain == "raw" else cfg.dsp.n_mels


def _plane_widths(cfg: Config, plan) -> dict:
    """Width of each state plane ``cfg`` carries, in FusedHopState order."""
    removed, floor = gate_planes(cfg.serving)
    n_fft, F = cfg.dsp.n_fft, cfg.dsp.n_stft
    widths = {"ring": n_fft, "ola": n_fft,
              "hx": plan.hidden * plan.compressed}
    if plan.delta:
        widths["prev"] = _feat_width(cfg)
    if floor:
        widths.update(nf_smooth=F, nf_floor=F, nf_total=1)
    if removed:
        widths.update(em_out=1, em_rem=1)
    return widths


def fused_hop_init_state(cfg: Config, plan, batch: int,
                         device: Union[str, torch.device] = "cpu"
                         ) -> FusedHopState:
    """Zeros: a zero gate plane latches to the first hop's value, and a
    delta plan's prev starts at zeros, as the analysis ring does."""
    return FusedHopState(**{
        name: torch.zeros((batch, w), dtype=torch.float32, device=device)
        for name, w in _plane_widths(cfg, plan).items()})


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


class _StatePtrs(ctypes.Structure):
    """Field-for-field mirror of AdtHopState in csrc/fused_hop.cu."""
    _fields_ = [(f, ctypes.c_void_p) for f in FusedHopState._fields]


class _GateArgs(ctypes.Structure):
    """Field-for-field mirror of AdtGate in csrc/fused_hop.cu."""
    _fields_ = ([("removed", ctypes.c_int), ("floor", ctypes.c_int)]
                + [(f, ctypes.c_float) for f in (
                    "gate_db", "width_db", "floor_gate_db", "floor_width_db",
                    "beta", "rise", "beta_tot", "floor_bias", "eps")])


class _Args(ctypes.Structure):
    """Field-for-field mirror of AdtFusedHopArgs in csrc/fused_hop.cu."""
    _fields_ = (
        [("state_in", _StatePtrs), ("state_out", _StatePtrs)]
        + [(f, ctypes.c_void_p) for f in (
            "chunk", "out", "cf", "sf", "ic", "is_", "mel", "imel", "win",
            "env")]
        + [("plan", PlanArgs), ("gate", _GateArgs)]
        + [(f, ctypes.c_int) for f in (
            "batch", "n_fft", "hop", "n_bins", "n_mels", "raw", "hops",
            "pcm16")]
        + [("output_gain", ctypes.c_float), ("state_decay", ctypes.c_float),
           ("scales", PlanScaleArgs), ("compute", ctypes.c_int)])


def _check_supported(cfg: Config, plan, hops_per_call: int, io_dtype,
                     compute_dtype) -> None:
    dsp = cfg.dsp
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be float32, bfloat16 or int8, "
                         f"got {compute_dtype}")
    if dsp.domain == "raw" and dsp.n_mels != dsp.n_stft:
        raise ValueError("raw domain: n_mels must equal n_stft (feature "
                         "width)")
    if io_dtype not in (torch.float32, torch.int16):
        raise ValueError(f"io_dtype must be float32 or int16, got {io_dtype}")
    if hops_per_call < 1:
        raise ValueError(f"hops_per_call must be >= 1, got {hops_per_call}")
    if dsp.n_fft % dsp.hop_length or dsp.n_fft % 2:
        raise ValueError("the fused hop needs an even n_fft that the hop "
                         "divides (WOLA)")
    check_plan(plan, _feat_width(cfg))
    gate_planes(cfg.serving)   # raises on an unknown estimator


def fused_hop_smem_bytes(cfg: Config, plan,
                         compute_dtype=torch.float32) -> int:
    """The dynamic shared memory one block of either fused-hop kernel
    takes for ``cfg``, ``plan`` and ``compute_dtype``: a plain mirror of
    ``make_layout`` in csrc/fused_hop.cu, so that what a card can take is
    known before the library is built (the wrapper holds it equal to the
    library's ``adt_fused_hop_smem_bytes`` on the card). kTile rows of:
    the frame, the spectrum (re, im, mag, lin), ring and ola, a delta
    plan's prev, the gate's two floor planes, the scalars and the gate's
    reduction lanes; then the plan cell's layout (with the int8 plan's
    staging buffers)."""
    _, floor = gate_planes(cfg.serving)
    M = _feat_width(cfg)
    ld_t, ld_f, ld_m = (round4(n) for n in (cfg.dsp.n_fft, cfg.dsp.n_stft,
                                            M))
    floats = KTILE * (3 * ld_t + 4 * ld_f + (ld_m if plan.delta else 0)
                      + (2 * ld_f if floor else 0) + SCALARS + MEANS * LANES)
    floats += cell_layout_floats(plan_shape(plan, M),
                                 quant=compute_dtype == torch.int8)
    return 4 * floats


class FusedHop:
    """One serving hop (or ``hops_per_call`` hops) for a batch of streams
    on ``device``; see the module docstring."""

    def __init__(self, cfg: Config, plan, device: torch.device,
                 hops_per_call: int = 1, io_dtype=torch.float32,
                 compute_dtype=torch.float32):
        dsp, srv = cfg.dsp, cfg.serving
        self.device = device
        self.hops_per_call = hops_per_call
        self.io_dtype = io_dtype
        self.compute_dtype = compute_dtype
        # the DSP matmuls run in bf16 in both reduced modes
        self.dsp_bf16 = compute_dtype != torch.float32
        self.n_fft, self.hop = dsp.n_fft, dsp.hop_length
        self.raw = dsp.domain == "raw"
        self.F, self.M = dsp.n_stft, _feat_width(cfg)
        self.delta = plan.delta
        self.n = plan.hidden * plan.compressed
        self.output_gain = float(srv.output_gain)
        self.state_decay = float(srv.state_decay)
        self.widths = _plane_widths(cfg, plan)
        self.smem_bytes = fused_hop_smem_bytes(cfg, plan, compute_dtype)
        self.launches = 0
        self._gate_constants(cfg)

        win = hann_window(self.n_fft, dtype=torch.float64).numpy()
        CF, SF, IC, IS = _dft_matrices(self.n_fft)
        # the DSP matrices in float32, holding bf16 values in the reduced
        # modes; the kernel's bf16 operands are the same values
        dsp_round = ((lambda t: t.bfloat16().float()) if self.dsp_bf16
                     else (lambda t: t))
        f32 = lambda a: torch.as_tensor(
            np.ascontiguousarray(a), dtype=torch.float32).to(device)
        self.cf, self.sf, self.ic, self.is_ = (
            dsp_round(f32(m)) for m in (CF, SF, IC, IS))
        self.mel = self.imel = None    # the raw domain has no mel pair
        if not self.raw:
            self.mel = dsp_round(mel_filterbank(self.F, self.M,
                                                dsp.sample_rate).to(device))
            self.imel = dsp_round(inverse_mel_matrix(
                self.F, self.M, dsp.sample_rate).T.contiguous().to(device))
        self.win = f32(win)
        self.env = f32(wola_envelope(win, self.n_fft, self.hop))
        plan = plan.to(device=device, dtype=torch.float32)
        weights, self.skip_flags = pack_plan_weights(
            plan, quantize=compute_dtype == torch.int8)
        if compute_dtype == torch.bfloat16:   # matrices bf16, biases fp32
            weights = [w.bfloat16() if w.dim() == 2 else w for w in weights]
        self.weights: List[torch.Tensor] = [w.contiguous() for w in weights]

        self._lib = None
        if device.type == "cuda":
            from audio_denoising_torch.ops.kernels.build import (
                load_kernel_library)
            self._bind(load_kernel_library("fused_hop").lib)

    def _gate_constants(self, cfg: Config) -> None:
        """The gate's constants, as fused_hop.py:169-193 derives them."""
        srv, dsp = cfg.serving, cfg.dsp
        self.removed, self.floor = gate_planes(srv)
        self.gated = self.removed or self.floor
        if not self.gated:
            return
        hop, sr = dsp.hop_length, dsp.sample_rate
        self.beta = smooth_beta_per_frame(hop, sr)
        self.rise = floor_rise_per_frame(hop, sr)
        self.beta_t = total_beta_per_frame(hop, sr, srv.snr_gate_tau_s)
        self.gate_db = float(srv.snr_gate_db)
        self.width = max(srv.snr_gate_width_db, 1e-3)
        # the floor part's ramp: its own where it is the decision, the
        # fixed veto under 'both'
        both = self.removed and self.floor
        self.floor_gate_db = FLOOR_VETO_GATE_DB if both else self.gate_db
        self.floor_width = FLOOR_VETO_WIDTH_DB if both else self.width

    def _bind(self, lib) -> None:
        """Binds the built library's C functions and fills the launch
        arguments that do not change from call to call."""
        self._lib = lib
        lib.adt_fused_hop_args_size.restype = ctypes.c_int
        lib.adt_fused_hop_smem_bytes.argtypes = [ctypes.c_void_p]
        lib.adt_fused_hop_smem_bytes.restype = ctypes.c_longlong
        for fn in (lib.adt_fused_hop, lib.adt_fused_hop_multi):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        if lib.adt_fused_hop_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("csrc/fused_hop.cu and _Args disagree on "
                               "the argument layout")
        self._base_args = self._args()
        self._check_shared_memory()

    # -- the plain PyTorch version ------------------------------------------
    def _dsp(self, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """A DSP matmul: in the reduced modes the activation rounded to
        bf16 against the bf16-valued matrix, summed in fp32."""
        return (a.bfloat16().float() if self.dsp_bf16 else a) @ m

    def reference(self, state: FusedHopState, chunk: torch.Tensor
                  ) -> Tuple[FusedHopState, torch.Tensor]:
        """One hop in the hop's compute dtype (float32 IO and state)."""
        hop = self.hop
        ring = torch.cat([state.ring[:, hop:], chunk], dim=-1)
        frame = ring * self.win
        re = self._dsp(frame, self.cf)
        im = self._dsp(frame, self.sf)
        mag = torch.sqrt(re * re + im * im)
        x = torch.log(1.0 + (mag if self.raw else self._dsp(mag, self.mel)))
        h, hi = plan_cell_math(self.weights, self.skip_flags, self.n, x,
                               state.hx, prev=state.prev,
                               compute_dtype=self.compute_dtype)
        rec = x - h
        rec = torch.where(rec >= 0, rec, 0.2 * rec)
        feat_mag = torch.clamp(torch.exp(rec) - 1.0, min=0.0)
        if self.raw:
            lin = feat_mag * self.output_gain
        else:
            # the mel pseudo-inverse projects some bins negative: clamp, as
            # inverse_mel_scale does, or they resynthesize with inverted
            # phase
            lin = torch.clamp(self._dsp(feat_mag, self.imel), min=0.0) * \
                self.output_gain
        planes = {"prev": x} if self.delta else {}
        if self.gated:
            estimated, lin = self._gate(state, mag, lin)
            planes.update(estimated)
        # phase reuse as complex scaling; at mag ~ 0 the bin is lin + 0j
        safe = mag > 1e-8
        scale = lin / torch.where(safe, mag, torch.ones_like(mag))
        rec_re = torch.where(safe, re * scale, lin)
        rec_im = torch.where(safe, im * scale, torch.zeros_like(im))
        synth = (self._dsp(rec_re, self.ic)
                 + self._dsp(rec_im, self.is_)) * self.win
        acc = state.ola + synth
        out = acc[:, :hop] / self.env
        ola = torch.cat([acc[:, hop:], torch.zeros_like(acc[:, :hop])],
                        dim=-1)
        return state._replace(ring=ring, ola=ola, hx=hi * self.state_decay,
                              **planes), out

    def _gate(self, state: FusedHopState, mag: torch.Tensor,
              lin: torch.Tensor) -> Tuple[dict, torch.Tensor]:
        """The SNR gate in the kernel's form (fused_hop.py:302-350): the
        estimators' new planes and the blended output magnitude."""
        power = mag * mag
        bt = self.beta_t
        planes = {}
        if self.removed:
            p_lin = lin * lin
            p_out = p_lin.mean(dim=-1, keepdim=True)               # (B, 1)
            p_rem = torch.clamp(power - p_lin, min=0.0).mean(
                dim=-1, keepdim=True)
            # a zero pair (a fresh slot) latches
            fresh = (state.em_out + state.em_rem) <= 0.0
            planes["em_out"] = torch.where(
                fresh, p_out, bt * state.em_out + (1.0 - bt) * p_out)
            planes["em_rem"] = torch.where(
                fresh, p_rem, bt * state.em_rem + (1.0 - bt) * p_rem)
        if self.floor:
            smooth = self.beta * state.nf_smooth + (1.0 - self.beta) * power
            planes["nf_smooth"] = smooth
            planes["nf_floor"] = torch.where(
                state.nf_floor <= 0.0, smooth,
                torch.minimum(smooth, state.nf_floor * self.rise))
            p_mean = power.mean(dim=-1, keepdim=True)
            tot = state.nf_total
            planes["nf_total"] = torch.where(tot <= 0.0, p_mean,
                                             bt * tot + (1.0 - bt) * p_mean)
        alpha = self.alpha(state._replace(**planes))
        return planes, alpha * lin + (1.0 - alpha) * mag

    def alpha(self, state: FusedHopState) -> torch.Tensor:
        """(B, 1): each stream's denoise weight in the hop that left
        ``state`` (1 denoises fully, 0 passes the input through)."""
        ramp = lambda snr, gate, width: torch.clamp(
            (gate + width - snr) / (2.0 * width), 0.0, 1.0)
        alpha = None
        if self.removed:
            snr = DB_PER_NEPER * (torch.log(state.em_out + _EPS)
                                  - torch.log(state.em_rem + _EPS))
            alpha = ramp(snr, self.gate_db, self.width)
        if self.floor:   # the floor part; the veto under 'both'
            nfm = FLOOR_BIAS * state.nf_floor.mean(dim=-1, keepdim=True)
            sig = torch.clamp(state.nf_total - nfm, min=0.0)
            snr = DB_PER_NEPER * (torch.log(sig + _EPS)
                                  - torch.log(nfm + _EPS))
            alpha_f = ramp(snr, self.floor_gate_db, self.floor_width)
            alpha = alpha_f if alpha is None else torch.maximum(alpha, alpha_f)
        return alpha

    def plain(self, state: FusedHopState, chunks: torch.Tensor
              ) -> Tuple[FusedHopState, torch.Tensor]:
        """What one call computes, on the plain version: the int16
        conversion at the boundary and ``hops_per_call`` hops of
        ``reference``."""
        multi = self.hops_per_call > 1
        outs = []
        for chunk in (chunks if multi else (chunks,)):
            state, out = self.reference(state, _from_pcm(chunk))
            outs.append(_to_pcm(out, self.io_dtype))
        return state, torch.stack(outs) if multi else outs[0]

    # -- the wrapper -----------------------------------------------------------
    def __call__(self, state: FusedHopState, chunks: torch.Tensor
                 ) -> Tuple[FusedHopState, torch.Tensor]:
        self._check(state, chunks)
        if chunks.device.type == "cpu":
            return self.plain(state, chunks)
        return self._launch(state, chunks)

    def _check(self, state: FusedHopState, chunks: torch.Tensor) -> None:
        K = self.hops_per_call
        lead = (K,) if K > 1 else ()
        if chunks.dim() != len(lead) + 2 or chunks.shape[-1] != self.hop \
                or tuple(chunks.shape[:len(lead)]) != lead:
            want = f"({K}, B, {self.hop})" if K > 1 else f"(B, {self.hop})"
            raise ValueError(f"chunks must be {want}, got "
                             f"{tuple(chunks.shape)}")
        if chunks.dtype != self.io_dtype:
            raise TypeError(f"chunks must be {self.io_dtype}, got "
                            f"{chunks.dtype}")
        b = chunks.shape[-2]
        if chunks.device.type != self.device.type:
            raise ValueError(f"this hop was built for {self.device}; got "
                             f"tensors on {chunks.device}")
        for name in FusedHopState._fields:
            t = getattr(state, name)
            if (t is None) != (name not in self.widths):
                raise ValueError(
                    f"state plane {name} is "
                    f"{'missing' if t is None else 'not carried by this hop'}"
                    f" (the plan's delta carry and the SNR gate's "
                    f"configuration decide the planes)")
            if t is None:
                continue
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if tuple(t.shape) != (b, self.widths[name]):
                raise ValueError(f"{name} must be {(b, self.widths[name])}, "
                                 f"got {tuple(t.shape)}")
            if t.device != chunks.device:
                raise ValueError(f"{name} is on {t.device}, chunks on "
                                 f"{chunks.device}")

    def _args(self) -> _Args:
        """The launch arguments that do not change from call to call; the
        padded operand copies (kernel_operand) are kept alive on the
        hop."""
        self._kernel_tensors: List[torch.Tensor] = []
        keep = self._kernel_tensors
        a = _Args()
        dsp = torch.bfloat16 if self.dsp_bf16 else torch.float32
        for name in ("cf", "sf", "ic", "is_", "mel", "imel"):
            t = getattr(self, name)
            if t is not None:
                setattr(a, name, kernel_operand(t.to(dsp), keep))
        a.win, a.env = (kernel_operand(t, keep) for t in (self.win, self.env))
        if self.compute_dtype == torch.int8:
            a.plan, a.scales = plan_args_q(self.weights, self.skip_flags,
                                           self.M, self.n, keep, self.delta)
        else:
            a.plan = plan_args(self.weights, self.skip_flags, self.M, self.n,
                               keep, self.delta)
        a.compute = COMPUTE_DTYPES[self.compute_dtype]
        a.n_fft, a.hop, a.n_bins, a.n_mels = self.n_fft, self.hop, self.F, \
            self.M
        a.raw = int(self.raw)
        a.hops = self.hops_per_call
        a.pcm16 = int(self.hops_per_call > 1
                      and self.io_dtype == torch.int16)
        a.output_gain, a.state_decay = self.output_gain, self.state_decay
        g = a.gate
        g.removed, g.floor = int(self.removed), int(self.floor)
        if self.gated:
            g.gate_db, g.width_db = self.gate_db, self.width
            g.floor_gate_db, g.floor_width_db = (self.floor_gate_db,
                                                 self.floor_width)
            g.beta, g.rise, g.beta_tot = self.beta, self.rise, self.beta_t
            g.floor_bias, g.eps = FLOOR_BIAS, _EPS
        return a

    def _check_shared_memory(self) -> None:
        """What this kernel can take: the activations and the state of
        one block's tile of streams in its shared memory, as the library
        counts it and as ``fused_hop_smem_bytes`` does."""
        limit = torch.cuda.get_device_properties(
            self.device).shared_memory_per_block_optin
        need = int(self._lib.adt_fused_hop_smem_bytes(
            ctypes.byref(self._base_args)))
        if need != self.smem_bytes:
            raise RuntimeError(
                f"csrc/fused_hop.cu counts {need} B of shared memory per "
                f"block, fused_hop_smem_bytes {self.smem_bytes} B")
        if need > limit:
            raise RuntimeError(
                f"the fused hop needs {need} B of shared memory per block; "
                f"this card allows {limit} B")

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def _launch(self, state: FusedHopState, chunks: torch.Tensor
                ) -> Tuple[FusedHopState, torch.Tensor]:
        multi = self.hops_per_call > 1
        if not multi:
            chunks = _from_pcm(chunks)
        chunks = chunks.contiguous()
        ins = {k: v.contiguous() for k, v in state._asdict().items()
               if v is not None}
        new = {k: torch.empty_like(v) for k, v in ins.items()}
        out = torch.empty_like(chunks)
        a = _Args.from_buffer_copy(self._base_args)
        a.batch = chunks.shape[-2]
        for name in ins:
            setattr(a.state_in, name, ins[name].data_ptr())
            setattr(a.state_out, name, new[name].data_ptr())
        a.chunk, a.out = chunks.data_ptr(), out.data_ptr()
        fn = self._lib.adt_fused_hop_multi if multi else self._lib.adt_fused_hop
        err = fn(ctypes.byref(a), self._stream())
        if err != 0:
            raise RuntimeError(f"fused hop launch failed: cudaError {err}")
        self.launches += 1
        if not multi:
            out = _to_pcm(out, self.io_dtype)
        return FusedHopState(**new), out


def _from_pcm(chunk: torch.Tensor) -> torch.Tensor:
    """s16 -> float32 x 1/32768 (app2.py:177's scale); float32 as it is."""
    if chunk.dtype == torch.int16:
        return chunk.to(torch.float32) * (1.0 / 32768.0)
    return chunk


def _to_pcm(out: torch.Tensor, io_dtype) -> torch.Tensor:
    """float32 -> s16: clip to [-1, 1], x 32767, truncated toward zero
    (app2.py:246-247)."""
    if io_dtype == torch.int16:
        return (torch.clamp(out, -1.0, 1.0) * 32767.0).to(torch.int16)
    return out


def make_fused_hop(cfg: Config, plan,
                   device: Optional[Union[str, torch.device]] = None,
                   hops_per_call: int = 1, io_dtype=torch.float32,
                   compute_dtype=torch.float32) -> FusedHop:
    """One-kernel serving hop(s) on ``device`` (the card unless
    ``"cpu"``); see the module docstring."""
    _check_supported(cfg, plan, hops_per_call, io_dtype, compute_dtype)
    return FusedHop(cfg, plan, resolve_device(device), hops_per_call,
                    io_dtype, compute_dtype)

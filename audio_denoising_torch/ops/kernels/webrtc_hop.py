"""The whole WebRTC hop, warm-start Griffin-Lim included (JAX counterpart
ops/pallas/webrtc_hop.py: the single-hop ``kernel`` at :331 and the
resident multi-hop ``kernel_multi`` at :344).

``make_webrtc_hop(cfg, plan, device)`` returns a ``WebRTCHop``: calling it
runs one hop for a batch of streams, ``step(state, chunk (B, hop)) ->
(state', out (B, hop))``, with the semantics of
``pipeline.make_webrtc_step`` under ``dsp.griffin_lim_warm_start`` and the
model run through the matrixized plan. With ``hops_per_call=K > 1`` a call
runs K hops, ``step(state, chunks (K, B, hop)) -> (state', outs (K, B,
hop))``, as one launch whose state stays in the card's shared memory
across the K hops; its hops equal K single hops bit for bit. For CPU
tensors a call runs ``plain`` (K hops of ``reference``, the plain PyTorch
version that follows ``_hop_math``, webrtc_hop.py:190-327); for CUDA
tensors it launches the hand-written kernels of ``csrc/webrtc_hop.cu`` or
raises. ``launches`` counts the kernels launched on the card: three per
single hop (analysis, plan cell, Griffin-Lim and synthesis), one per
K-hop call.

The carried phases are ``(B, 3 * n_bins)`` planes with frame t at
``[t * n_bins, (t + 1) * n_bins)``; the JAX kernel pads each frame to 128
lanes, which the port does not need. The port does not take JAX's
``block_b``: the K-hop kernel's tile of 2 streams is fixed and its ragged
last tile masked, so B is not padded.

The kernels take every geometry JAX's kernel takes: any even n_fft with
hop = n_fft / 2, any mel count. Their transforms are ``csrc/fft.cuh``'s
FFTs of n_fft / 2 points in a few wide passes (``fft_radices``: radices
12, 8, 5, 4, 3 and 2 in registers, and 9 and 7 where M = n_fft / 2 is
compiled in; any other prime factor a pass of its own; their twiddles
``twiddle_table`` and ``pass_twiddle_table``, which the wrapper hands
over); ``fft_passes``, ``real_bins`` and ``inverse_input`` (all in
``ops/kernels/fft.py``) mirror the passes and the real-input formulas in
plain PyTorch for the tests, and ``fft_instance`` names the
instantiation a bound hop runs (M compiled in, ``fft.FFT_INSTANCES``:
768, 512, 441 and 32; or 0, the geometry read at run time).

``compute_dtype=torch.bfloat16`` is JAX's bf16 Griffin-Lim mode
(webrtc_hop.py:123-124, :144, :305-318): inside the GL loop only, each
transform takes its input rounded to bf16, where JAX's single bf16 pass
rounds it: the inverse STFT's bins ``lin * angle`` times the irfft bin
weight ``wN`` (2 / n_fft, 1 / n_fft at DC and Nyquist; JAX folds it into
the activation), the forward STFT's time signal. The port keeps its FFTs
with fp32 twiddles and fp32 sums, where JAX also rounds its window-folded
DFT matrices to bf16; the analysis, the plan cell and the final synthesis
stay fp32 in both. It buys no speed on the card: the rounding is extra
work on the same FFTs.

The cell stage walks the plan in one of two ways (``CELL_WALKS``), the
same in both entry points of a configuration: ``batched`` runs the
matmuls that read no state (the encoder chain, the decoder's skip
products) once over the three frames of a tile, then the rest frame by
frame; ``per-frame`` runs the plan cell three times. ``cell_walk`` picks batched where its larger
buffers fit a block of the card in both entry points, and
``webrtc_hop_smem_bytes`` counts the walk a limit gives; a bound hop
names its walk in ``cell_walk``.
"""

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from audio_denoising_torch.config import Config
from audio_denoising_torch.device import indexed, resolve_device
from audio_denoising_torch.ops.griffinlim import griffin_lim
from audio_denoising_torch.ops.kernels.common import (
    KTHREADS, KTILE, MAX_LEVELS, PlanArgs, PlanShape, cell_layout_floats,
    kernel_operand, pack_plan_weights, plan_args, plan_cell_math, plan_shape,
    round4)
# the FFT schedule's mirror, also imported from here by the tests
from audio_denoising_torch.ops.kernels.fft import (  # noqa: F401
    MAX_PASSES, fft_passes, fft_radices, inverse_input, pass_twiddle_table,
    real_bins, twiddle_table)
from audio_denoising_torch.ops.mel import inverse_mel_matrix, mel_filterbank
from audio_denoising_torch.ops.stft import istft, stft
from audio_denoising_torch.ops.windows import hann_window

FRAMES = 3   # centered STFT frames of one window at hop = n_fft / 2
KERNELS_PER_HOP = 3   # csrc/webrtc_hop.cu: analysis, cell, gl
# kRed: the analysis's partial results, one per lane of a stream's FFT
# stages, as many as the most lanes (288; 256 at M = 441, fft_threads)
RED = 288
# the cell stage's walks (cell_batched in csrc/webrtc_hop.cu: 1, 0)
CELL_WALKS = ("batched", "per-frame")


class WebRTCHopState(NamedTuple):
    ring: torch.Tensor     # (B, n_fft) input window
    ola: torch.Tensor      # (B, n_fft) synthesis accumulator
    hx: torch.Tensor       # (B, hidden*compressed) cell state
    ang_re: torch.Tensor   # (B, 3*n_bins) carried GL phases, real part
    ang_im: torch.Tensor   # (B, 3*n_bins) imaginary part


def webrtc_hop_init_state(cfg: Config, plan, batch: int,
                          device: Union[str, torch.device] = "cpu"
                          ) -> WebRTCHopState:
    n_fft, F = cfg.dsp.n_fft, cfg.dsp.n_stft
    z = lambda w: torch.zeros((batch, w), dtype=torch.float32, device=device)
    # warm seed 1+0j, matching pipeline.webrtc_init_state
    return WebRTCHopState(ring=z(n_fft), ola=z(n_fft),
                          hx=z(plan.hidden * plan.compressed),
                          ang_re=torch.ones((batch, FRAMES * F),
                                            dtype=torch.float32,
                                            device=device),
                          ang_im=z(FRAMES * F))


def _istft_envelope(win: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """The window-square envelope of the three frames' overlap-add over
    the trim region [hop, hop + n_fft); 1 where it vanishes."""
    env = np.zeros(n_fft + 2 * hop)
    for t in range(FRAMES):
        env[t * hop:t * hop + n_fft] += win * win
    env = env[hop:hop + n_fft]
    return np.where(np.abs(env) > 1e-11, env, 1.0).astype(np.float32)


class _Args(ctypes.Structure):
    """Field-for-field mirror of AdtWebRTCHopArgs in csrc/webrtc_hop.cu."""
    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "ring", "ola", "hx", "ang_re", "ang_im", "chunk", "ring_out",
            "ola_out", "hx_out", "ang_re_out", "ang_im_out", "out", "feat",
            "mel_mag", "peak", "win", "env", "mel", "imel", "twiddle")]
        + [("plan", PlanArgs)]
        + [(f, ctypes.c_int) for f in (
            "batch", "n_fft", "hop", "n_bins", "n_mels", "n_iter", "hops")]
        + [(f, ctypes.c_float) for f in (
            "momentum", "output_gain", "state_decay")]
        + [(f, ctypes.c_int) for f in ("gl_bf16", "cell_batched", "cell_d",
                                       "cell_s", "cell_x")])


def _spec_floats(n_fft: int, F: int, gl: bool) -> Tuple[int, int]:
    """(floats, offset of the GL planes) of ``make_spec_layout`` in
    csrc/webrtc_hop.cu: two buffers of FRAMES complex transforms, a
    window, the partial results, the frames' magnitudes, and for
    Griffin-Lim the carried and target phases."""
    are = 4 * FRAMES * (n_fft // 2) + round4(n_fft) + RED \
        + round4(FRAMES * F)
    return are + (4 * round4(FRAMES * F) if gl else 0), are


def _frames_floats(shape: PlanShape) -> Tuple[int, int, int]:
    """The floats of the batched walk's three parts (``frames_sizes`` in
    csrc/webrtc_hop.cu): the encoder's activations of the 3 KTILE rows;
    the decoder's skip products of those rows and hx; the split-K scratch
    of those rows' matmuls, over which the per-frame matmuls' scratch, the
    reset gate's output, the updated state and the decoder's two buffers
    lie."""
    rows, L = FRAMES * KTILE, shape.levels
    d = rows * sum(round4(w) for w in shape.down_n[:L + 1])
    skip = (rows * sum(round4(shape.up_n[i + 1]) for i in range(L)
                       if shape.skips[i])
            + KTILE * round4(shape.n_hidden))
    per_frame = KTILE * (4 * KTHREADS + round4(3 * shape.n_hidden)
                         + round4(shape.n_hidden)
                         + 2 * round4(max(shape.up_n[1:L + 1])))
    return d, skip, max(per_frame, rows * 4 * KTHREADS)


def _smem_floats(n_fft: int, F: int, M: int, shape: PlanShape,
                 hops_per_call: int, walk: str) -> int:
    spec, are = _spec_floats(n_fft, F, True)
    parts = (_frames_floats(shape) if walk == CELL_WALKS[0]
             else (cell_layout_floats(shape),))
    if hops_per_call == 1:
        return max(spec, sum(parts))
    # make_multi_layout: each stream's spectra, the tile's ring and ola,
    # hx, the features and mel magnitudes of the frames, the peaks; the
    # cell's parts, largest first, each in the first stream's transform
    # buffers below its GL planes that still have room, else after
    floats = (KTILE * spec + 2 * KTILE * round4(n_fft)
              + round4(KTILE * shape.n_hidden)
              + 2 * round4(KTILE * FRAMES * M) + round4(KTILE))
    used = [0] * KTILE
    for p in sorted(parts, reverse=True):
        s = next((s for s in range(KTILE) if used[s] + p <= are), None)
        if s is None:
            floats += p
        else:
            used[s] += p
    return floats


def _walk(n_fft: int, F: int, M: int, shape: PlanShape, limit: int) -> str:
    fits = all(4 * _smem_floats(n_fft, F, M, shape, hops, CELL_WALKS[0])
               <= limit for hops in (1, 2))
    return CELL_WALKS[0] if fits else CELL_WALKS[1]


def _takes(cfg: Config) -> bool:
    """Whether the kernels take ``cfg``'s geometry (hop n_fft / 2)."""
    return cfg.dsp.n_fft >= 2 and cfg.dsp.n_fft == 2 * cfg.dsp.hop_length


def cell_walk(cfg: Config, plan, limit: int) -> str:
    """The cell stage's walk for ``cfg`` and ``plan`` on a card whose
    block may take ``limit`` bytes of shared memory: ``"batched"`` where
    its buffers fit a block in both entry points (the three single-hop
    kernels and the K-hop kernel), else ``"per-frame"`` (the 128-mel
    plans on an H100). Both entry points run the walk it names, so K hops
    equal K single hops bit for bit. A geometry the kernels refuse is
    ``"per-frame"``."""
    if not _takes(cfg):
        return CELL_WALKS[1]
    dsp = cfg.dsp
    return _walk(dsp.n_fft, dsp.n_stft, dsp.n_mels,
                 plan_shape(plan, dsp.n_mels), limit)


def webrtc_hop_smem_bytes(cfg: Config, plan, hops_per_call: int = 1,
                          limit: Optional[int] = None) -> int:
    """The most dynamic shared memory one block of the WebRTC hop's
    kernels takes for ``cfg`` and ``plan`` (the three single-hop kernels,
    or the K-hop kernel where ``hops_per_call > 1``) in the walk
    ``cell_walk`` gives at ``limit``; without a limit, in the per-frame
    walk, the least any walk takes (what decides whether the kernels fit
    a card at all: ``runtime.engine._fit``). -1 where the kernels do not
    take the arguments (hop other than n_fft / 2). A plain mirror of
    ``adt_webrtc_hop_smem_bytes`` in csrc/webrtc_hop.cu, which the
    wrapper holds it equal to on the card."""
    if not _takes(cfg):
        return -1
    dsp = cfg.dsp
    shape = plan_shape(plan, dsp.n_mels)
    walk = CELL_WALKS[1] if limit is None else _walk(
        dsp.n_fft, dsp.n_stft, dsp.n_mels, shape, limit)
    return 4 * _smem_floats(dsp.n_fft, dsp.n_stft, dsp.n_mels, shape,
                            hops_per_call, walk)


def _check_supported(cfg: Config, plan, hops_per_call: int,
                     compute_dtype) -> None:
    dsp = cfg.dsp
    if dsp.n_fft != 2 * dsp.hop_length:
        raise ValueError("the fused webrtc hop expects hop == n_fft / 2")
    if not dsp.griffin_lim_warm_start:
        raise ValueError("the fused webrtc hop carries GL phases (warm "
                         "start); enable dsp.griffin_lim_warm_start")
    if dsp.domain == "raw":
        raise ValueError("the webrtc path is mel-domain (app2.py:199-202)")
    if plan.delta:
        raise ValueError("the webrtc hop serves the GRUUNet family, not "
                         "delta (MOMO3) plans")
    if len(plan.down_mats) > MAX_LEVELS:
        raise ValueError(f"the kernel takes at most {MAX_LEVELS} levels")
    if hops_per_call < 1:
        raise ValueError(f"hops_per_call must be >= 1, got {hops_per_call}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"the webrtc hop computes in float32 or with its Griffin-Lim "
            f"loop in bfloat16, not {compute_dtype}")


class WebRTCHop:
    """One WebRTC hop (or ``hops_per_call`` hops) for a batch of streams on
    ``device``; see the module docstring."""

    def __init__(self, cfg: Config, plan, device: torch.device,
                 hops_per_call: int = 1, compute_dtype=torch.float32):
        dsp, srv = cfg.dsp, cfg.serving
        self.device = device = indexed(device)
        self.hops_per_call = hops_per_call
        self.compute_dtype = compute_dtype
        self.gl_bf16 = compute_dtype == torch.bfloat16
        self.n_fft, self.hop = dsp.n_fft, dsp.hop_length
        self.F, self.M = dsp.n_stft, dsp.n_mels
        self.n = plan.hidden * plan.compressed
        self.n_iter = int(dsp.griffin_lim_iters)
        self.momentum = float(dsp.griffin_lim_momentum)
        self.output_gain = float(srv.output_gain)
        self.state_decay = float(srv.state_decay)
        self.smem_bytes = webrtc_hop_smem_bytes(cfg, plan, hops_per_call)
        self.shape = plan_shape(plan, self.M)
        self.launches = 0

        win = hann_window(self.n_fft, dtype=torch.float64).numpy()
        f32 = lambda a: torch.as_tensor(
            np.ascontiguousarray(a), dtype=torch.float32).to(device)
        self.win = f32(win)
        self.env = f32(_istft_envelope(win, self.n_fft, self.hop))
        self.mel = mel_filterbank(self.F, self.M, dsp.sample_rate).to(device)
        self.imel = inverse_mel_matrix(
            self.F, self.M, dsp.sample_rate).T.contiguous().to(device)
        # one-hop phase advance of the newest frame (pipeline.py:164-175)
        rot = np.exp(2j * np.pi * np.arange(self.F) * self.hop / self.n_fft)
        self.rot = torch.complex(f32(rot.real), f32(rot.imag))
        # the irfft's bin weights, as JAX's float32 wN row, and the exact
        # factors that undo them after the bf16 rounding
        w = np.full(self.F, 2.0 / self.n_fft)
        w[0] = w[-1] = 1.0 / self.n_fft
        self.bin_weight = f32(w)[:, None]                     # (F, 1)
        self.bin_unweight = f32(1.0 / w)[:, None]
        plan = plan.to(device=device, dtype=torch.float32)
        weights, self.skip_flags = pack_plan_weights(plan)
        self.weights: List[torch.Tensor] = [w.contiguous() for w in weights]

        self._lib = None
        # set when a kernel library is bound: the FFT instantiation and the
        # cell stage's walk ("batched" or "per-frame") at the card's limit
        self.fft_instance = None
        self.cell_walk = None
        if device.type == "cuda":
            from audio_denoising_torch.ops.kernels.build import (
                load_kernel_library)
            with torch.cuda.device(device):   # the card's queries
                self._bind(load_kernel_library("webrtc_hop").lib)

    def _bind(self, lib) -> None:
        """Binds the built library's C functions and fills the launch
        arguments that do not change from call to call."""
        self._lib = lib
        lib.adt_webrtc_hop_args_size.restype = ctypes.c_int
        lib.adt_webrtc_hop_smem_bytes.argtypes = [ctypes.c_void_p]
        lib.adt_webrtc_hop_smem_bytes.restype = ctypes.c_longlong
        lib.adt_webrtc_hop_fft_instance.argtypes = [ctypes.c_void_p]
        lib.adt_webrtc_hop_fft_instance.restype = ctypes.c_int
        lib.adt_webrtc_hop_fft_radices.argtypes = [ctypes.c_int,
                                                   ctypes.c_void_p]
        lib.adt_webrtc_hop_fft_radices.restype = ctypes.c_int
        for fn in (lib.adt_webrtc_hop, lib.adt_webrtc_hop_multi):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        if lib.adt_webrtc_hop_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("csrc/webrtc_hop.cu and _Args disagree on "
                               "the argument layout")
        if self.smem_bytes < 0:
            raise ValueError(
                f"the webrtc hop kernels take hop = n_fft / 2, not n_fft "
                f"{self.n_fft} and hop {self.hop}")
        limit = torch.cuda.get_device_properties(
            self.device).shared_memory_per_block_optin
        self.cell_walk = _walk(self.n_fft, self.F, self.M, self.shape, limit)
        self.smem_bytes = 4 * _smem_floats(self.n_fft, self.F, self.M,
                                           self.shape, self.hops_per_call,
                                           self.cell_walk)
        self._base_args = self._args()
        self._check_shared_memory(limit)
        # the M = n_fft / 2 of the kernels' FFT instantiation, 0 for the
        # one that reads the geometry at run time
        self.fft_instance = int(lib.adt_webrtc_hop_fft_instance(
            ctypes.byref(self._base_args)))

    # -- the plain PyTorch version ------------------------------------------
    def targets(self, state: WebRTCHopState, chunk: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
        """The hop up to Griffin-Lim, in plain PyTorch: ``(ring (B, n_fft),
        peak (B, 1), hx (B, n) before the decay, lin (B, 3, n_bins))``,
        where ``lin`` holds the magnitudes GL rebuilds phases for. No
        carried phase reaches any of them."""
        hop, n_fft = self.hop, self.n_fft
        ring = torch.cat([state.ring[:, hop:], chunk], dim=-1)
        peak = ring.abs().amax(dim=-1, keepdim=True)
        ok = peak > 1e-6
        normed = torch.where(ok, ring / torch.where(ok, peak, 1.0), ring)
        peak = torch.where(ok, peak, 1.0)
        spec = stft(normed * self.win, n_fft, hop, window=self.win)
        mag = spec.abs().transpose(1, 2)                      # (B, 3, F)
        x = torch.log(1.0 + mag @ self.mel)                   # (B, 3, M)

        hx = state.hx
        recs = []
        for t in range(FRAMES):
            y, hx = plan_cell_math(self.weights, self.skip_flags, self.n,
                                   x[:, t], hx)
            rec = x[:, t] - y
            recs.append(torch.where(rec >= 0, rec, 0.2 * rec))
        mel_mag = torch.clamp(torch.exp(torch.stack(recs, dim=1)) - 1.0,
                              min=0.0)
        lin = torch.clamp(mel_mag @ self.imel, min=0.0) * self.output_gain
        return ring, peak, hx, lin

    def reference(self, state: WebRTCHopState, chunk: torch.Tensor
                  ) -> Tuple[WebRTCHopState, torch.Tensor]:
        hop, n_fft, F = self.hop, self.n_fft, self.F
        b = chunk.shape[0]
        ring, peak, hx, lin = self.targets(state, chunk)

        # warm seed: shift one frame, advance the newest by one hop
        a = torch.complex(state.ang_re, state.ang_im).reshape(b, FRAMES, F)
        seed = torch.cat([a[:, 1:], (a[:, -1] * self.rot)[:, None]], dim=1)
        gl = self._griffin_lim_bf16 if self.gl_bf16 else functools.partial(
            griffin_lim, n_fft=n_fft, hop_length=hop, window=self.win,
            n_iter=self.n_iter, momentum=self.momentum, return_angles=True)
        frame, angles = gl(lin.transpose(1, 2),
                           init_angles=seed.transpose(1, 2))
        angles = angles.transpose(1, 2).reshape(b, FRAMES * F)

        out = state.ola[:, :hop]
        ola = torch.cat([state.ola[:, hop:],
                         torch.zeros_like(state.ola[:, :hop])], dim=-1)
        ola = ola + frame * peak
        return WebRTCHopState(ring, ola, hx * self.state_decay,
                              angles.real.contiguous(),
                              angles.imag.contiguous()), out

    def _griffin_lim_bf16(self, mag: torch.Tensor,
                          init_angles: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``griffin_lim`` (warm, ``return_angles``) in the bf16 GL mode:
        the loop's inverse STFT takes each bin's ``mag * angle`` times its
        irfft weight rounded to bf16 (then unweighted, exactly), its
        forward STFT the time signal rounded to bf16; the final synthesis
        is fp32. ``mag`` (B, F, 3), ``init_angles`` complex (B, F, 3)."""
        n_fft, hop = self.n_fft, self.hop
        mom = self.momentum / (1 + self.momentum)
        bf16 = lambda x: x.to(torch.bfloat16).to(x.dtype)

        def rounded(angles):
            re, im = (bf16(mag * part * self.bin_weight) * self.bin_unweight
                      for part in (angles.real, angles.imag))
            return torch.complex(re, im)

        angles = init_angles
        tprev = torch.zeros_like(angles)
        for _ in range(self.n_iter):
            inverse = istft(rounded(angles), n_fft, hop, window=self.win)
            rebuilt = stft(bf16(inverse), n_fft, hop, window=self.win)
            upd = rebuilt - mom * tprev
            angles = upd / (upd.abs() + 1e-16)
            tprev = rebuilt
        return istft(mag * angles, n_fft, hop, window=self.win), angles

    def plain(self, state: WebRTCHopState, chunks: torch.Tensor
              ) -> Tuple[WebRTCHopState, torch.Tensor]:
        """What one call computes, on the plain version: ``hops_per_call``
        hops of ``reference``, the state carried from hop to hop."""
        if self.hops_per_call == 1:
            return self.reference(state, chunks)
        outs = []
        for chunk in chunks:
            state, out = self.reference(state, chunk)
            outs.append(out)
        return state, torch.stack(outs)

    # -- the wrapper -----------------------------------------------------------
    def __call__(self, state: WebRTCHopState, chunks: torch.Tensor
                 ) -> Tuple[WebRTCHopState, torch.Tensor]:
        self._check(state, chunks)
        if chunks.device.type == "cpu":
            return self.plain(state, chunks)
        return self._launch(state, chunks)

    def _check(self, state: WebRTCHopState, chunks: torch.Tensor) -> None:
        K = self.hops_per_call
        lead = (K,) if K > 1 else ()
        if chunks.dim() != len(lead) + 2 or chunks.shape[-1] != self.hop \
                or tuple(chunks.shape[:len(lead)]) != lead:
            want = f"({K}, B, {self.hop})" if K > 1 else f"(B, {self.hop})"
            raise ValueError(f"chunks must be {want}, got "
                             f"{tuple(chunks.shape)}")
        b = chunks.shape[-2]
        nb = FRAMES * self.F
        want = {"chunks": lead + (b, self.hop), "ring": (b, self.n_fft),
                "ola": (b, self.n_fft), "hx": (b, self.n),
                "ang_re": (b, nb), "ang_im": (b, nb)}
        got = {"chunks": chunks, **state._asdict()}
        for name, t in got.items():
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if tuple(t.shape) != want[name]:
                raise ValueError(f"{name} must be {want[name]}, got "
                                 f"{tuple(t.shape)}")
            if t.device != chunks.device:
                raise ValueError(f"{name} is on {t.device}, chunks on "
                                 f"{chunks.device}")
        if chunks.device.type != self.device.type or (
                chunks.is_cuda and chunks.device != self.device):
            raise ValueError(f"this hop was built for {self.device}; got "
                             f"tensors on {chunks.device}")

    def _args(self) -> _Args:
        """The launch arguments that do not change from hop to hop; the
        operands (and the twiddle tables, ``twiddle_table`` and
        ``pass_twiddle_table``, built in float64) are kept alive on the
        hop."""
        self._kernel_tensors: List[torch.Tensor] = []
        keep = self._kernel_tensors
        # the n_fft-point table, then the passes' table
        twiddle = torch.as_tensor(
            np.concatenate([twiddle_table(self.n_fft),
                            pass_twiddle_table(self.hop)]),
            dtype=torch.float32).to(self.device)
        a = _Args()
        # read element by element, at their own widths: not padded
        for name, t in (("win", self.win), ("env", self.env),
                        ("mel", self.mel), ("imel", self.imel),
                        ("twiddle", twiddle)):
            setattr(a, name, kernel_operand(t, keep, pad_columns=False))
        a.plan = plan_args(self.weights, self.skip_flags, self.M, self.n,
                           keep)
        a.n_fft, a.hop, a.n_bins, a.n_mels = self.n_fft, self.hop, self.F, \
            self.M
        a.n_iter = self.n_iter
        a.hops = self.hops_per_call
        a.gl_bf16 = int(self.gl_bf16)
        a.cell_batched = int(self.cell_walk == CELL_WALKS[0])
        a.momentum = self.momentum / (1.0 + self.momentum)
        a.output_gain, a.state_decay = self.output_gain, self.state_decay
        return a

    def kernel_radices(self, m: int) -> List[int]:
        """The radices of the passes the bound kernels run for a complex
        FFT of m points (``fft_radices`` mirrors them)."""
        out = (ctypes.c_int * MAX_PASSES)()
        n = self._lib.adt_webrtc_hop_fft_radices(m, out)
        if n < 0:
            raise ValueError(f"the kernels take no FFT of {m} points")
        return list(out[:n])

    def _check_shared_memory(self, limit: int) -> None:
        """What these kernels can take on this card (``limit`` bytes a
        block): a block's working set in its shared memory, in the walk
        bound, as the library counts it and as ``webrtc_hop_smem_bytes``
        does."""
        need = int(self._lib.adt_webrtc_hop_smem_bytes(
            ctypes.byref(self._base_args)))
        if need != self.smem_bytes:
            raise RuntimeError(
                f"csrc/webrtc_hop.cu counts {need} B of shared memory per "
                f"block, webrtc_hop_smem_bytes {self.smem_bytes} B")
        if need > limit:
            raise RuntimeError(
                f"the webrtc hop needs {need} B of shared memory per block; "
                f"this card allows {limit} B")

    def _launch(self, state: WebRTCHopState, chunks: torch.Tensor
                ) -> Tuple[WebRTCHopState, torch.Tensor]:
        multi = self.hops_per_call > 1
        ins = [t.contiguous() for t in (*state, chunks)]
        new = WebRTCHopState(*(torch.empty_like(t) for t in ins[:5]))
        out = torch.empty_like(ins[5])
        a = _Args.from_buffer_copy(self._base_args)
        a.batch = b = chunks.shape[-2]
        (a.ring, a.ola, a.hx, a.ang_re, a.ang_im,
         a.chunk) = (t.data_ptr() for t in ins)
        (a.ring_out, a.ola_out, a.hx_out, a.ang_re_out,
         a.ang_im_out) = (t.data_ptr() for t in new)
        a.out = out.data_ptr()
        if not multi:   # the hand-offs between the three launches
            feat = torch.empty((b, FRAMES, self.M), device=chunks.device)
            mel_mag = torch.empty_like(feat)
            peak = torch.empty((b,), device=chunks.device)
            a.feat, a.mel_mag, a.peak = (
                t.data_ptr() for t in (feat, mel_mag, peak))
        stream = torch.cuda.current_stream(self.device).cuda_stream
        fn = self._lib.adt_webrtc_hop_multi if multi else \
            self._lib.adt_webrtc_hop
        # the library sets its attributes and launches on the current card
        with torch.cuda.device(self.device):
            err = fn(ctypes.byref(a), stream)
        if err != 0:
            raise RuntimeError(f"webrtc hop launch failed: cudaError {err}")
        self.launches += 1 if multi else KERNELS_PER_HOP
        return new, out


def make_webrtc_hop(cfg: Config, plan,
                    device: Optional[Union[str, torch.device]] = None,
                    compute_dtype=torch.float32,
                    hops_per_call: int = 1) -> WebRTCHop:
    """The WebRTC hop (or ``hops_per_call`` hops per call) on ``device``
    (the card unless ``"cpu"``); see the module docstring."""
    _check_supported(cfg, plan, hops_per_call, compute_dtype)
    return WebRTCHop(cfg, plan, resolve_device(device), hops_per_call,
                     compute_dtype)

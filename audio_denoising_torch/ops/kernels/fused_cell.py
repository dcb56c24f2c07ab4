"""One matrixized GRUUNet cell step as one kernel (JAX counterpart
ops/pallas/gruunet_cell.py, ``make_fused_cell.kernel`` at :58).

``make_fused_cell(plan, device)`` returns a ``FusedCell``: calling it runs
one cell step for a batch of streams, ``cell(x (B, F), hx (B, H)[, prev
(B, F)]) -> (y (B, F), hx' (B, H))``, with hx' before the state decay
(the caller applies it, as ``PlanModel.decay_carry`` does). A delta
(MOMO3) plan takes the previous frame ``prev`` (JAX ``gruunet_cell.py``
:60-83): the kernel stages it beside x in shared memory and runs level 0
as one matmul over cat(x, prev). For CPU tensors it runs
``reference``, the plain PyTorch version (``plan_cell_math``); for CUDA
tensors it launches the hand-written kernel in ``csrc/fused_cell.cu`` or
raises. The kernel takes the plan's matrices through a weight ring in
shared memory, fed by bulk copies multicast over a cluster of blocks; the
wrapper computes its slab schedule once (``ops/kernels/weight_ring.py``).
``launches`` counts kernel launches.

The JAX wrapper pads B to a multiple of its 128-row tile; the kernel
masks its ragged last tile instead, so nothing is padded here.
"""

import ctypes
from typing import List, Optional, Tuple, Union

import torch

from audio_denoising_torch.device import indexed, resolve_device
from audio_denoising_torch.ops.kernels.common import (
    PlanArgs, check_plan, pack_plan_weights, plan_args, plan_cell_math)
from audio_denoising_torch.ops.kernels.weight_ring import (
    RingArgs, WeightRing, cell_layout_floats, cell_matrices)


class _Args(ctypes.Structure):
    """Field-for-field mirror of AdtFusedCellArgs in csrc/fused_cell.cu."""
    _fields_ = ([(f, ctypes.c_void_p)
                 for f in ("x", "hx", "prev", "y", "hx_out")]
                + [("plan", PlanArgs), ("ring", RingArgs)]
                + [(f, ctypes.c_int) for f in ("batch", "n_feat")])


class FusedCell:
    """One plan-cell step for a batch of streams on ``device``; see the
    module docstring."""

    def __init__(self, plan, device: torch.device):
        self.device = device = indexed(device)
        self.n = plan.hidden * plan.compressed
        self.n_feat = plan.up_h_mats[-1].shape[1]
        self.delta = plan.delta
        self.launches = 0
        self.ring = None   # the WeightRing, on the card
        plan = plan.to(device=device, dtype=torch.float32)
        weights, self.skip_flags = pack_plan_weights(plan)
        self.weights: List[torch.Tensor] = [w.contiguous() for w in weights]

        self._lib = None
        if device.type == "cuda":
            from audio_denoising_torch.ops.kernels.build import (
                load_kernel_library)
            with torch.cuda.device(device):   # the card's queries
                self._bind(load_kernel_library("fused_cell").lib)

    def _bind(self, lib) -> None:
        """Binds the built library's C functions and fills the launch
        arguments that do not change from call to call."""
        self._lib = lib
        lib.adt_fused_cell_args_size.restype = ctypes.c_int
        lib.adt_fused_cell_smem_bytes.argtypes = [ctypes.c_void_p]
        lib.adt_fused_cell_smem_bytes.restype = ctypes.c_longlong
        lib.adt_fused_cell.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.adt_fused_cell.restype = ctypes.c_int
        lib.adt_fused_cell_max_clusters.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_int]
        lib.adt_fused_cell_max_clusters.restype = ctypes.c_int
        if lib.adt_fused_cell_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("csrc/fused_cell.cu and _Args disagree on "
                               "the argument layout")
        # the padded operand copies (kernel_operand) live on the cell
        self._kernel_tensors: List[torch.Tensor] = []
        self._base_args = _Args()
        self._base_args.plan = plan_args(
            self.weights, self.skip_flags, self.n_feat, self.n,
            self._kernel_tensors, self.delta)
        self._base_args.n_feat = self.n_feat
        self._check_shared_memory()

    # -- the plain PyTorch version ------------------------------------------
    def reference(self, x: torch.Tensor, hx: torch.Tensor,
                  prev: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        return plan_cell_math(self.weights, self.skip_flags, self.n, x, hx,
                              prev=prev)

    # -- the wrapper ----------------------------------------------------------
    def __call__(self, x: torch.Tensor, hx: torch.Tensor,
                 prev: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        self._check(x, hx, prev)
        if x.device.type == "cpu":
            return self.reference(x, hx, prev)
        return self._launch(x, hx, prev)

    def _check(self, x: torch.Tensor, hx: torch.Tensor,
               prev: Optional[torch.Tensor]) -> None:
        if x.dim() != 2 or x.shape[1] != self.n_feat:
            raise ValueError(f"x must be (B, {self.n_feat}), got "
                             f"{tuple(x.shape)}")
        if tuple(hx.shape) != (x.shape[0], self.n):
            raise ValueError(f"hx must be ({x.shape[0]}, {self.n}), got "
                             f"{tuple(hx.shape)}")
        if (prev is None) == self.delta:
            raise ValueError("a delta (MOMO3) plan takes prev, any other "
                             "plan does not")
        if prev is not None and prev.shape != x.shape:
            raise ValueError(f"prev must be {tuple(x.shape)}, got "
                             f"{tuple(prev.shape)}")
        for name, t in (("x", x), ("hx", hx), ("prev", prev)):
            if t is None:
                continue
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if t.device != x.device:
                raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if x.device.type != self.device.type or (
                x.is_cuda and x.device != self.device):
            raise ValueError(f"this cell was built for {self.device}; got "
                             f"tensors on {x.device}")

    def _check_shared_memory(self) -> None:
        """What this kernel can take: one block's tile of activations and
        a weight ring of at least 2 stages in its shared memory. Sets up
        the ring; raises, as there is no other path to fall back to."""
        layout = int(self._lib.adt_fused_cell_smem_bytes(
            ctypes.byref(self._base_args)))
        if layout < 0:
            raise ValueError("csrc/fused_cell.cu does not take this plan")
        plan = self._base_args.plan
        if layout != 4 * cell_layout_floats(plan):
            raise RuntimeError("csrc/fused_cell.cu and weight_ring."
                               "cell_layout_floats disagree on the layout")
        self.ring = WeightRing(cell_matrices(plan), layout, self.device)
        self._kernel_tensors.append(self.ring.table)
        self._base_args.ring = self.ring.args
        limit = torch.cuda.get_device_properties(
            self.device).shared_memory_per_block_optin
        if self.ring.smem_bytes > limit:
            raise RuntimeError(
                f"the fused cell needs {self.ring.smem_bytes} B of shared "
                f"memory per block; this card allows {limit} B")

    def max_active_clusters(self, blocks: int) -> int:
        """cudaOccupancyMaxActiveClusters of a launch of ``blocks``
        blocks."""
        with torch.cuda.device(self.device):
            return int(self._lib.adt_fused_cell_max_clusters(
                ctypes.byref(self._base_args), blocks))

    def _launch(self, x: torch.Tensor, hx: torch.Tensor,
                prev: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x, hx = x.contiguous(), hx.contiguous()
        y = torch.empty_like(x)
        hx_out = torch.empty_like(hx)
        a = _Args.from_buffer_copy(self._base_args)
        a.batch = x.shape[0]
        a.x, a.hx, a.y, a.hx_out = (t.data_ptr() for t in (x, hx, y, hx_out))
        if self.delta:
            prev = prev.contiguous()
            a.prev = prev.data_ptr()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        # the library sets its attributes and launches on the current card
        with torch.cuda.device(self.device):
            err = self._lib.adt_fused_cell(ctypes.byref(a), stream)
        if err != 0:
            raise RuntimeError(f"fused cell launch failed: cudaError {err}")
        self.launches += 1
        return y, hx_out


def make_fused_cell(plan, device: Optional[Union[str, torch.device]] = None
                    ) -> FusedCell:
    """One-kernel cell step on ``device`` (the card unless ``"cpu"``)."""
    check_plan(plan, plan.up_h_mats[-1].shape[1])
    return FusedCell(plan, resolve_device(device))

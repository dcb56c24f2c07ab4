"""audio_denoising_torch — the PyTorch/CUDA port of ``audio_denoising_tpu``.

A second package beside the JAX one, which stays the reference. Module
names follow the JAX package so each counterpart is easy to find:

- ``config``              — the shared config tree (a copy; stdlib only).
- ``compat``              — ``.npz`` checkpoints and JAX parameter import.
- ``ops``                 — host-side DSP constants and conv wrappers.
- ``ops.kernels``         — the hand-written sm_90a CUDA kernels, each with
                            its plain PyTorch version beside it.
- ``models``              — GRUUNet2 as an ``nn.Module``.
- ``runtime``             — the matrixized cell plan, ``StreamEngine``,
                            batching tick and serving metrics.
- ``apps.engine_serve``   — the batched multi-stream engine daemon.

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``audio_denoising_tpu``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"

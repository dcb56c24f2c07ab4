"""audio_denoising_torch — the PyTorch/CUDA port of ``audio_denoising_tpu``.

A second package beside the JAX one, which stays the reference. Module
names follow the JAX package so each counterpart is easy to find:

- ``config``              — the shared config tree (a copy; stdlib only).
- ``compat``              — ``.npz`` checkpoints and JAX parameter import.
- ``ops``                 — host-side DSP: windows, the mel pair, STFT,
                            Griffin-Lim, the resampler, conv wrappers.
- ``ops.kernels``         — the hand-written sm_90a CUDA kernels (the
                            fused hop, the WebRTC hop), each with its
                            plain PyTorch version beside it.
- ``io``                  — host audio I/O (a copy of the JAX package's:
                            WAV, the codec libraries, the cache, stream
                            helpers, the WebSocket frame codec).
- ``pipeline``            — the offline full-clip denoise and the
                            streaming steps, op by op (the segment
                            family's window chain among them).
- ``models``              — GRUUNet2, the MOMO family, the 2-D U-Nets,
                            the GRU and TRUNet as ``nn.Module``s.
- ``runtime``             — the matrixized cell plan, ``StreamEngine``,
                            batching tick and serving metrics.
- ``apps.offline``        — offline file denoising (CLI ``denoise``).
- ``apps.engine_serve``   — the batched multi-stream engine daemon.
- ``train``               — training: ``TrainingContext``, the host and
                            device samplers, the losses and metrics,
                            distillation.
- ``apps.trainer``, ``apps.evaluate``, ``apps.compare`` — the CLI
                            commands ``train``, ``eval`` and ``compare``.
- ``parallel``            — several devices: the in-process mesh the
                            sharded engine and fused hop run over, the
                            tensor-parallel plan cell, and the process
                            group of the data-parallel train step.

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``audio_denoising_tpu``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"

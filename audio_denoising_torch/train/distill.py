"""Teacher-student distillation targets (JAX counterpart
train/distill.py).

With ``TrainConfig.distill_from`` set, the training target is the
teacher checkpoint's denoised output on each mixture instead of the
clean crop: the mixture goes through the teacher's own offline chain on
the training device, without a gradient, and its output replaces
``clean``. It separates an optimization gap from an information gap:
a causal student trained on a segment teacher's achievable output
closes the part of the gap that was optimization.
"""

import dataclasses
from typing import Callable

import torch


def load_teacher(path: str, student_cfg, device=None
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """-> ``fn(wave (B, L)) -> denoised wave (B, L)`` on ``device`` (the
    card unless ``"cpu"``), computed under ``torch.no_grad()``.

    The teacher runs its serving chain: ``offline_denoise_stateless`` for
    the stateless segment family, ``offline_denoise`` otherwise, with its
    SNR gate forced off (the gate's noise-floor tracker cannot settle
    inside a training crop, and the distilled mapping is the model's, not
    the gate's). A teacher at another sample rate is refused."""
    from audio_denoising_torch import pipeline
    from audio_denoising_torch.device import resolve_device
    from audio_denoising_torch.hub import load_pretrained

    device = resolve_device(device)
    cfg_t, model_t = load_pretrained(path)
    if cfg_t.dsp.sample_rate != student_cfg.dsp.sample_rate:
        raise ValueError(
            f"distillation teacher runs at {cfg_t.dsp.sample_rate} Hz but "
            f"the student trains at {student_cfg.dsp.sample_rate} Hz; "
            f"resampling inside the train step would dominate it: pick a "
            f"same-rate teacher")
    cfg_t = dataclasses.replace(
        cfg_t, serving=dataclasses.replace(cfg_t.serving, snr_gate_db=None))
    model_t = pipeline.serving_model(model_t, device)
    denoise = (pipeline.offline_denoise_stateless
               if hasattr(model_t, "compatible_frames")
               else pipeline.offline_denoise)

    def teacher(wave: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), pipeline.fp32_convs():
            return denoise(cfg_t, model_t, wave)

    return teacher

"""Model hub: one call from a name or path to (cfg, model) (JAX
counterpart hub.py).

Resolves a preset name from ``config.PRESETS`` backed by a converted
checkpoint in ``<repo>/checkpoints/<name>.npz`` (or the preset whose
weights it reuses), or a path to a native ``.npz`` checkpoint. The model
is a float32 ``nn.Module`` on the CPU with the checkpoint's weights.
"""

import dataclasses
import json
import os
from typing import Optional, Tuple

from torch import nn

from audio_denoising_torch.compat import load_params_npz, params_from_jax
from audio_denoising_torch.config import Config, PRESETS, ServingConfig
from audio_denoising_torch.models import build_model

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT_DIR = os.path.join(_REPO_ROOT, "checkpoints")

# Presets that reuse another preset's weights (same architecture and mel
# bins, different DSP/serving config).
_CKPT_ALIASES = {"gruunet2-stream16k": "gruunet2-good"}


def load_pretrained(spec: str, cfg: Optional[Config] = None
                    ) -> Tuple[Config, nn.Module]:
    """-> (cfg, model). ``spec`` is a preset name or an .npz path."""
    if spec in PRESETS:
        cfg = cfg or PRESETS[spec]
        path = os.path.join(CHECKPOINT_DIR,
                            f"{_CKPT_ALIASES.get(spec, spec)}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"preset {spec!r} has no converted checkpoint at {path}")
    elif spec.endswith(".npz"):
        path = spec
    else:
        raise ValueError(
            f"unknown model spec {spec!r}: expected a preset name "
            f"({', '.join(sorted(PRESETS))}) or an .npz path")
    params, meta = load_params_npz(path)
    if cfg is None:
        if "full_config" not in meta:
            raise ValueError(f"{path} embeds no full config; pass cfg= or "
                             f"use a preset name")
        cfg = Config.from_json(json.dumps(meta["full_config"]))
        # the gate tuning is a deployment property, not the weights':
        # serve the current defaults, as the JAX hub does
        d = ServingConfig()
        cfg = dataclasses.replace(cfg, serving=dataclasses.replace(
            cfg.serving, snr_gate_db=d.snr_gate_db,
            snr_gate_width_db=d.snr_gate_width_db,
            snr_gate_estimator=d.snr_gate_estimator,
            snr_gate_tau_s=d.snr_gate_tau_s))
    # a training checkpoint stores its optimizer state beside the weights
    weights = {k: v for k, v in params.items() if not k.startswith("__opt__")}
    model = build_model(cfg.model, num_bins=cfg.dsp.n_mels)
    model.load_params(params_from_jax(weights))
    return cfg, model.eval()

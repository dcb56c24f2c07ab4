"""Model hub: one call from a name or path to (cfg, model) (JAX
counterpart hub.py).

Resolves, in order:

- a preset name from ``config.PRESETS`` backed by a converted checkpoint
  in ``<repo>/checkpoints/<name>.npz`` (or the preset whose weights it
  reuses);
- a path to a native ``.npz`` checkpoint (params and JSON meta);
- a path to a reference torch ``.pth`` checkpoint (the dict format of the
  reference's save_model, app.py:43-91), read by the restricted reader of
  ``compat.torch_loader``;
- a path to a MOMO cell's ``.onnx`` graph (the reference's momo2_*.onnx
  exports, or ``convert`` of a MOMO checkpoint), read by ``compat.onnx``.

The checkpoint's embedded full config is the source of truth when
present; a checkpoint that carries only the model's hyperparameters
(``arch``/``config``: the four shipped ``checkpoints/*.npz`` and every
reference ``.pth``) is served with an assumed DSP, said on stderr, as the
JAX hub does. An ``.onnx`` graph carries no DSP config either: it is
served with the MOMO family's raw front-end at the graph's bin count, said
on stderr. The model is a float32 ``nn.Module`` on the CPU with the
checkpoint's weights.
"""

import dataclasses
import json
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
from torch import nn

from audio_denoising_torch.compat import (
    load_params_npz, load_torch_checkpoint, momo_config_from_onnx,
    onnx_params, params_from_jax, parse_onnx, state_dict_to_params)
from audio_denoising_torch.config import (
    Config, DSPConfig, ModelConfig, PRESETS, ServingConfig)
from audio_denoising_torch.models import build_model

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT_DIR = os.path.join(_REPO_ROOT, "checkpoints")

# Presets that reuse another preset's weights (same architecture and mel
# bins, different DSP/serving config).
_CKPT_ALIASES = {"gruunet2-stream16k": "gruunet2-good"}

def load_pretrained(spec: str, cfg: Optional[Config] = None
                    ) -> Tuple[Config, nn.Module]:
    """-> (cfg, model). ``spec`` is a preset name, an .npz path, a
    reference .pth path or a MOMO cell's .onnx path."""
    if spec in PRESETS:
        return _load_npz(checkpoint_path(spec), cfg or PRESETS[spec])
    if spec.endswith(".npz"):
        return _load_npz(spec, cfg)
    if spec.endswith(".pth"):
        return _load_pth(spec, cfg)
    if spec.endswith(".onnx"):
        return _load_onnx(spec, cfg)
    raise ValueError(
        f"unknown model spec {spec!r}: expected a preset name "
        f"({', '.join(sorted(PRESETS))}), a .npz, .pth or .onnx path")


def checkpoint_path(spec: str) -> str:
    """The file that holds ``spec``'s weights: a preset's converted
    checkpoint, or the path itself."""
    if spec not in PRESETS:
        return spec
    path = os.path.join(CHECKPOINT_DIR,
                        f"{_CKPT_ALIASES.get(spec, spec)}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"preset {spec!r} has no converted checkpoint at {path}")
    return path


def _assumed_cfg(mc: ModelConfig, path: str) -> Config:
    """A checkpoint without a full embedded config carries only the
    model's hyperparameters; the DSP is not derivable from the weights.
    Build the model at its architecture's reference bin count and assume
    the reference socket-path DSP, on stderr (JAX hub.py:60-76)."""
    bins = getattr(build_model(mc), "num_bins", 64)
    dsp = dataclass_replace_dsp(n_fft=1024, hop_length=512, n_mels=bins,
                                reconstruction="phase")
    print(f"[hub] {path}: no DSP config embedded; assuming the reference "
          f"socket-path DSP (n_fft={dsp.n_fft}, hop={dsp.hop_length}, "
          f"n_mels={bins}) — pass cfg= to override", file=sys.stderr)
    return Config(dsp=dsp, model=mc)


def dataclass_replace_dsp(**kw) -> DSPConfig:
    """The default DSPConfig with ``kw`` replaced (JAX hub.py:79)."""
    return dataclasses.replace(DSPConfig(), **kw)


def _reresolve_serving(cfg: Config) -> Config:
    """The SNR gate's tuning and the streamed-segment geometry are
    properties of the deployment, not of the weights: an embedded config
    serves the current class defaults for them, as the JAX hub does; the
    model-bound fields (output gain, state decay, dtype, chunk geometry)
    stay the checkpoint's."""
    d = ServingConfig()
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, snr_gate_db=d.snr_gate_db,
        snr_gate_width_db=d.snr_gate_width_db,
        snr_gate_estimator=d.snr_gate_estimator,
        snr_gate_tau_s=d.snr_gate_tau_s,
        unet_seg_hops=d.unet_seg_hops,
        unet_ctx_samples=d.unet_ctx_samples,
        unet_xfade_samples=d.unet_xfade_samples,
        unet_ctx_left_samples=d.unet_ctx_left_samples))


def _model(cfg: Config, params: Dict[str, np.ndarray]) -> nn.Module:
    # a training checkpoint stores its optimizer state beside the weights
    weights = {k: v for k, v in params.items() if not k.startswith("__opt__")}
    model = build_model(cfg.model, num_bins=cfg.dsp.n_mels)
    model.load_params(params_from_jax(weights))
    return model.eval()


def _load_npz(path: str, cfg: Optional[Config]):
    params, meta = load_params_npz(path)
    if cfg is None:
        if "full_config" in meta:
            cfg = _reresolve_serving(
                Config.from_json(json.dumps(meta["full_config"])))
        elif "arch" in meta and "config" in meta:
            cfg = _assumed_cfg(ModelConfig.from_reference_dict(
                meta["arch"], meta["config"]), path)
        else:
            raise ValueError(f"{path} has no embedded config; pass cfg=")
    return cfg, _model(cfg, params)


def _load_pth(path: str, cfg: Optional[Config]):
    ckpt = load_torch_checkpoint(path)
    if cfg is None:
        arch = ckpt.get("arch") or ckpt.get("model_class") or "GRUUNet2"
        cfg = _assumed_cfg(ModelConfig.from_reference_dict(
            arch, ckpt.get("config", {})), path)
    return cfg, _model(cfg, state_dict_to_params(ckpt["model_state_dict"]))


def _load_onnx(path: str, cfg: Optional[Config]):
    """A MOMO cell graph becomes a servable model (JAX hub.py:132-164):
    its initializers are the torch state-dict keys, so the weights load as
    they are. ONNX carries no DSP config: the MOMO family's raw
    spectrogram front-end at the graph's bin count is assumed (n_fft =
    2 (bins - 1), hop n_fft / 2, the momo3-4d4ea0 preset's reasoning) and
    said on stderr; ``cfg`` overrides it, its model config replaced by
    the graph's. A graph with a ``prev`` input is served as MOMO3's delta
    cell, where the JAX hub reads every graph as MOMO2."""
    g = parse_onnx(path)
    mc, num_bins = momo_config_from_onnx(g)
    if cfg is None:
        n_fft = 2 * (num_bins - 1)
        dsp = dataclass_replace_dsp(n_fft=n_fft, hop_length=n_fft // 2,
                                    n_mels=num_bins, domain="raw",
                                    reconstruction="phase")
        cfg = Config(dsp=dsp, model=mc,
                     serving=ServingConfig(chunk_samples=n_fft // 2))
        print(f"[hub] {path}: ONNX carries no DSP config; assuming the "
              f"MOMO raw front-end (n_fft={n_fft}, hop={n_fft // 2}, "
              f"{num_bins} bins) — pass cfg= to override", file=sys.stderr)
    else:
        cfg = dataclasses.replace(cfg, model=mc)
    model = build_model(mc, num_bins=num_bins)
    model.load_params(onnx_params(g))
    return cfg, model.eval()

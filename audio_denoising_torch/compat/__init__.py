"""Checkpoint interop: the ``.npz`` store, the reference's torch ``.pth``
checkpoints (read without unpickling arbitrary code) and JAX parameter
import."""

from typing import Dict, Mapping

import numpy as np
import torch

from audio_denoising_torch.compat.npz_store import (
    load_params_npz, save_params_npz)
from audio_denoising_torch.compat.torch_loader import (
    load_torch_checkpoint, load_torch_pickle, state_dict_to_params)


def params_from_jax(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX package's flat parameter dict (numpy arrays, or anything
    ``np.asarray`` takes) as a torch state dict. Both packages key
    parameters by the reference's state-dict names
    (``cell.input_gate.downs.{i}.conv.weight``, ...), so the result loads
    into ``models.GRUUNet2`` with ``load_state_dict`` unchanged."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in params.items()}


__all__ = ["load_params_npz", "load_torch_checkpoint", "load_torch_pickle",
           "params_from_jax", "save_params_npz", "state_dict_to_params"]

"""Checkpoint interop: the ``.npz`` store, the reference's torch ``.pth``
checkpoints (read without unpickling arbitrary code), JAX parameter
import, and ONNX: the reader and executor (``parse_onnx``, ``run_graph``)
and the exporter (``write_onnx``, ``export_cell``)."""

from typing import Dict, Mapping

import numpy as np
import torch

from audio_denoising_torch.compat.npz_store import (
    load_params_npz, save_params_npz)
from audio_denoising_torch.compat.onnx import (
    Graph, Node, momo_config_from_onnx, onnx_params, parse_onnx, run_graph)
from audio_denoising_torch.compat.onnx_export import export_cell, write_onnx
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


__all__ = ["Graph", "Node", "export_cell", "load_params_npz",
           "load_torch_checkpoint", "load_torch_pickle",
           "momo_config_from_onnx", "onnx_params", "params_from_jax",
           "parse_onnx", "run_graph", "save_params_npz",
           "state_dict_to_params", "write_onnx"]

"""Native param storage: flat param dict + config as a single ``.npz``.

A copy of the numpy-only store of ``audio_denoising_tpu/compat/
npz_store.py``, so the port reads the committed ``checkpoints/*.npz``, and
writes checkpoints the JAX package reads, without importing it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np


def save_params_npz(path: str, params: Dict[str, np.ndarray],
                    meta: Dict[str, Any]) -> None:
    """Write ``params`` and the JSON-able ``meta`` (for example
    ``{"full_config": json.loads(cfg.to_json())}``) to ``path``, through a
    temporary sibling and a rename, so a killed process never leaves a
    truncated checkpoint behind."""
    arrays = {"param:" + k: np.asarray(v) for k, v in params.items()}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta, default=_json_default).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **arrays)
    # np.savez appends .npz to paths without the suffix
    if not os.path.exists(tmp) and os.path.exists(tmp + ".npz"):
        tmp = tmp + ".npz"
    os.replace(tmp, path)


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, tuple):
        return list(o)
    raise TypeError(type(o))


def load_params_npz(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        params = {k[len("param:"):]: z[k] for k in z.files if k.startswith("param:")}
    return params, meta

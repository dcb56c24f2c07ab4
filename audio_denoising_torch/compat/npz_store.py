"""Native param storage: flat param dict + config as a single ``.npz``.

A copy of the numpy-only loader of ``audio_denoising_tpu/compat/
npz_store.py``, so the port reads the committed ``checkpoints/*.npz``
without importing the JAX package.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np


def load_params_npz(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        params = {k[len("param:"):]: z[k] for k in z.files if k.startswith("param:")}
    return params, meta

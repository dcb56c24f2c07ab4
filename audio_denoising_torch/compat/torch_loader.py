"""Reader of the reference's torch ``.pth`` checkpoints (a copy of the
numpy-only ``audio_denoising_tpu/compat/torch_loader.py``).

The reference persists checkpoints as ``torch.save`` dicts holding model,
optimizer and scheduler state plus config and loss records (app.py:43-91).
A checkpoint is untrusted input, and ``torch.load(weights_only=False)``
runs whatever its pickle names, so the port parses the zip+pickle format
with a restricted unpickler instead, as the JAX package does, and gets
the same dict:

- the archive contains ``<name>/data.pkl`` plus raw little-endian tensor
  storages at ``<name>/data/<key>``;
- tensors appear as persistent-id tuples
  ``('storage', StorageType, key, location, numel)`` rebuilt through
  ``torch._utils._rebuild_tensor_v2``; both are intercepted and mapped to
  numpy, and any other global the pickle names is refused.
"""

from __future__ import annotations

import io
import pickle
import zipfile
from typing import Any, Dict

import numpy as np

_DTYPES = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
    "BFloat16Storage": None,  # handled specially
    "ComplexFloatStorage": np.complex64,
    "ComplexDoubleStorage": np.complex128,
}


class _StorageStub:
    """Stands in for torch storage classes during unpickling."""

    def __init__(self, name: str):
        self.name = name


class _LazyStorage:
    def __init__(self, dtype_name: str, data: bytes):
        self.dtype_name = dtype_name
        self.data = data


def _rebuild_tensor_v2(storage: _LazyStorage, storage_offset, size, stride,
                       requires_grad=False, backward_hooks=None, metadata=None):
    dtype = _DTYPES[storage.dtype_name]
    if storage.dtype_name == "BFloat16Storage":
        raw = np.frombuffer(storage.data, dtype=np.uint16)
        arr = (raw.astype(np.uint32) << 16).view(np.float32)
        itemsize = 2
    else:
        arr = np.frombuffer(storage.data, dtype=dtype)
        itemsize = arr.dtype.itemsize
    del itemsize
    size = tuple(size)
    stride = tuple(stride)
    if len(size) == 0:
        return arr[storage_offset].copy()
    return np.lib.stride_tricks.as_strided(
        arr[storage_offset:],
        shape=size,
        strides=tuple(s * arr.dtype.itemsize for s in stride),
    ).copy()


def _rebuild_parameter(tensor, requires_grad=False, backward_hooks=None):
    return tensor


class _OrderedDictStub(dict):
    pass


class _TorchUnpickler(pickle.Unpickler):
    """Restricted unpickler: only the constructs torch.save emits for plain
    dict checkpoints are allowed; anything else raises."""

    _ALLOWED = {
        ("collections", "OrderedDict"): _OrderedDictStub,
        ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
        ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    }

    def __init__(self, file, storages: Dict[str, bytes]):
        super().__init__(file)
        self._storages = storages

    def find_class(self, module: str, name: str):
        key = (module, name)
        if key in self._ALLOWED:
            return self._ALLOWED[key]
        if module == "torch" and name.endswith("Storage"):
            return _StorageStub(name)
        if module == "torch" and name == "device":
            return lambda *a, **k: str(a[0]) if a else "cpu"
        # dtype objects (torch.float32 etc.) show up in optimizer state.
        # EXPLICIT whitelist — `hasattr(np, name)` would admit hundreds of
        # numpy callables (np.fromfile, np.empty, ...) and let a crafted
        # checkpoint execute them with attacker-controlled args.
        _DTYPES = {"float16", "float32", "float64", "bfloat16",
                   "int8", "int16", "int32", "int64",
                   "uint8", "uint16", "uint32", "uint64", "bool",
                   "complex64", "complex128"}
        if module == "torch" and name in _DTYPES:
            return getattr(np, name, np.float32)
        raise pickle.UnpicklingError(
            f"blocked unpickle of {module}.{name} (restricted reader)")

    def persistent_load(self, pid):
        typename = pid[0]
        if typename != "storage":
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        storage_type, key, _location, _numel = pid[1], pid[2], pid[3], pid[4]
        name = (storage_type.name if isinstance(storage_type, _StorageStub)
                else getattr(storage_type, "__name__", str(storage_type)))
        return _LazyStorage(name, self._storages[str(key)])


def load_torch_pickle(path: str) -> Any:
    """Parse a ``torch.save`` zip archive into plain Python + numpy."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        pkl_name = next(n for n in names if n.endswith("/data.pkl"))
        prefix = pkl_name[: -len("data.pkl")]
        storages = {
            n[len(prefix) + len("data/"):]: zf.read(n)
            for n in names
            if n.startswith(prefix + "data/")
        }
        with zf.open(pkl_name) as f:
            return _TorchUnpickler(io.BytesIO(f.read()), storages).load()


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference checkpoint dict; robust to the format variants the
    reference's loader tolerates (app2.py:46-126): dicts with
    ``model_state_dict``/``state_dict``/bare state dicts, config under
    ``config`` or ``hparams``."""
    obj = load_torch_pickle(path)
    if not isinstance(obj, dict):
        raise ValueError(f"unsupported checkpoint object: {type(obj)}")
    out: Dict[str, Any] = dict(obj)
    if "model_state_dict" in obj:
        sd = obj["model_state_dict"]
    elif "state_dict" in obj:
        sd = obj["state_dict"]
    else:
        sd = {k: v for k, v in obj.items()
              if isinstance(v, np.ndarray)}
    out["model_state_dict"] = dict(sd)
    if "config" not in out and "hparams" in out:
        out["config"] = out["hparams"]
    return out


def state_dict_to_params(state_dict: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Model params are stored as a flat dict keyed exactly like the torch
    state dict (e.g. ``cell.input_gate.downs.0.conv.weight``) so imported
    weights drop straight in; float64 is downcast to float32."""
    params = {}
    for k, v in state_dict.items():
        v = np.asarray(v)
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        params[k] = v
    return params

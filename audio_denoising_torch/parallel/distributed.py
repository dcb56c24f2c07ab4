"""Multi-process initialization (JAX counterpart parallel/distributed.py).

Single-process use never needs this. A data-parallel run starts one
process per card and calls ``initialize()`` once in each, before any
collective; it wraps ``torch.distributed.init_process_group``. The
rendezvous comes from the arguments, else from ``ADT_COORDINATOR``
(``host:port``, or a ``tcp://`` or ``file://`` URL), else from
torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``; each
rank binds ``cuda:LOCAL_RANK`` (or the ``device`` it is given) and joins
over NCCL on the card, over gloo on the CPU.
"""

import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from audio_denoising_torch.device import resolve_device

TIMEOUT_S = 600       # a collective's longest wait before it fails
_bound: Optional[torch.device] = None   # the process group's device


def _init_method(coordinator_address: Optional[str]) -> Optional[str]:
    """The rendezvous URL, or None where nothing names one."""
    address = coordinator_address or os.environ.get("ADT_COORDINATOR")
    if address:
        return address if "://" in address else f"tcp://{address}"
    if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        return "env://"
    return None


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"a multi-process run needs {name} (or the "
                         f"matching argument of initialize)")
    return int(os.environ[name])


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None,
               backend: Optional[str] = None) -> bool:
    """Idempotent ``init_process_group``. Returns True once this process
    has joined a process group, False when nothing names a rendezvous
    (single process). ``device``: the device this rank computes on (the
    card ``cuda:LOCAL_RANK`` by default, ``LOCAL_RANK`` defaulting to the
    rank modulo the card count); ``backend``: NCCL on a card, gloo on the
    CPU by default. ``backend="gloo"`` on a card is for verification on
    one card: gloo also reduces CUDA tensors, so two ranks can share one
    card, which NCCL refuses."""
    global _bound
    if dist.is_initialized():
        return True
    url = _init_method(coordinator_address)
    if url is None and num_processes is None:
        return False
    world = _env_int("WORLD_SIZE", num_processes)
    rank = _env_int("RANK", process_id)
    if device is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        local = int(os.environ.get("LOCAL_RANK", rank % max(count, 1)))
        device = f"cuda:{local}"
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=url or "env://", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _bound = device
    return True


def local_device() -> torch.device:
    """The device ``initialize`` bound this rank to."""
    if _bound is None:
        raise RuntimeError("initialize() has not joined a process group")
    return _bound


def global_mesh(axis_name: str = "streams"):
    """A 1-D ``torch.distributed.device_mesh.DeviceMesh`` over every rank
    of the process group; requires ``initialize()``."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(local_device().type, list(range(dist.get_world_size())),
                      mesh_dim_names=(axis_name,))


def shutdown() -> None:
    """Leave the process group (a no-op where none was joined)."""
    global _bound
    if dist.is_initialized():
        dist.destroy_process_group()
    _bound = None

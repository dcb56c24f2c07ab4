"""In-process device meshes and sharding helpers (JAX counterpart
parallel/mesh.py).

A mesh is a 1-D list of devices along one named axis (``streams``). The
batch (stream slots or training examples) splits over it in contiguous
blocks, one per entry, each on its entry's device; parameters and DSP
constants live on every entry's device. An entry list may repeat a
device: the CPU tests use eight ``cpu`` entries (JAX's tests use eight
virtual CPU devices), and one card listed twice runs the split, the
per-shard launches and the combine on that card.

JAX expresses all of this as shardings that jit turns into placements;
here a sharded value is a plain list of per-entry values, and a sharded
step is a Python loop over the entries. The hop needs no communication
between entries (per-stream recurrence, replicated weights), so nothing
here is a collective: results meet only where a caller gathers them.
"""

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from audio_denoising_torch.device import resolve_device


class Mesh(NamedTuple):
    """A 1-D mesh: ``devices`` (indexed, possibly repeated) along
    ``axis_name``."""
    devices: Tuple[torch.device, ...]
    axis_name: str = "streams"

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis_name,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_name: len(self.devices)}

    @property
    def distinct_cards(self) -> bool:
        """Every entry its own card: the case where work on the entries
        can overlap in time."""
        return all(d.type == "cuda" for d in self.devices) and \
            len(set(self.devices)) == len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "streams",
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` local cards (all of them by
    default), or over ``devices`` (names or ``torch.device``s, repeats
    allowed; ``n_devices`` then takes the first that many). A bare
    ``cuda`` is the current card."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if count == 0:
            raise RuntimeError("no CUDA device is available; pass devices=["
                               "'cpu', ...] for a mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(count)]
    devices = list(devices)[:n_devices] if n_devices else list(devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    devs = tuple(resolve_device(d) for d in devices)
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh spans one device type, got {devs}")
    return Mesh(devs, axis_name)


def _tree_map(fn: Callable, tree):
    """``fn`` over the tensors of a tree of NamedTuples, tuples, lists and
    dicts; None stays None, numpy arrays become tensors."""
    if tree is None:
        return None
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    raise TypeError(f"cannot shard a {type(tree).__name__}")


def split_rows(x: torch.Tensor, n: int, axis: int = 0) -> List[torch.Tensor]:
    """``x`` in ``n`` contiguous blocks along ``axis``, which ``n`` must
    divide."""
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not divide "
                         f"evenly over {n} mesh entries")
    return list(torch.chunk(x, n, dim=axis))


class Sharding(NamedTuple):
    """Where a value lives on ``mesh``: ``axis`` None replicates it (a copy
    on each entry's device); an int splits that axis in contiguous blocks,
    block i on entry i's device."""
    mesh: Mesh
    axis: Optional[int] = 0

    def put(self, tree) -> List[Any]:
        """The per-entry values of ``tree`` (one tree per mesh entry). Each
        is a copy of its own, so an entry's in-place update never reaches
        another's, even on a shared device."""
        if self.axis is None:
            return [_tree_map(lambda x, d=d: x.to(d, copy=True), tree)
                    for d in self.mesh.devices]
        n = self.mesh.size
        return [_tree_map(lambda x, i=i, d=d: split_rows(
            x, n, self.axis)[i].to(d, copy=True), tree)
            for i, d in enumerate(self.mesh.devices)]


def replicated(mesh: Mesh) -> Sharding:
    """Every entry holds the whole value."""
    return Sharding(mesh, None)


def shard_batch(mesh: Mesh, axis_name: str = "streams") -> Sharding:
    """The leading (batch / streams) axis split over the mesh."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not "
                         f"{axis_name!r}")
    return Sharding(mesh, 0)


def shard_pytree_batch(mesh: Mesh, tree, axis_name: str = "streams"
                       ) -> List[Any]:
    """Every leaf of ``tree`` with its leading axis split over the mesh:
    one tree per entry, on the entry's device."""
    return shard_batch(mesh, axis_name).put(tree)


def gather(shards: Sequence, device=None, axis: int = 0):
    """The per-entry trees ``shards`` joined along ``axis`` in mesh order,
    on ``device`` (the first shard's by default)."""
    first = shards[0]
    if isinstance(first, torch.Tensor):
        device = first.device if device is None else device
        return torch.cat([s.to(device) for s in shards], dim=axis)
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(gather([s[j] for s in shards], device, axis)
                             for j in range(len(first))))
    if isinstance(first, (tuple, list)):
        return type(first)(gather([s[j] for s in shards], device, axis)
                           for j in range(len(first)))
    return {k: gather([s[k] for s in shards], device, axis) for k in first}


class ShardedStep:
    """``step(states, chunks, *args) -> (states', outs)`` over per-entry
    lists (``shard_pytree_batch``): entry i's shard runs through
    ``steps[i]``, the step that ``make_step`` built on entry i's device,
    one entry after the other, with no synchronisation between them.
    Every entry gets a step of its own, also where the mesh repeats a
    device, so per-entry weights, state and launch counts never alias.
    ``launches`` sums the entries' kernel launches (steps that count
    them)."""

    def __init__(self, make_step: Callable[[torch.device], Callable],
                 mesh: Mesh, axis_name: str = "streams"):
        shard_batch(mesh, axis_name)          # checks the axis name
        self.mesh = mesh
        self.steps = [make_step(d) for d in mesh.devices]

    @property
    def launches(self) -> int:
        return sum(s.launches for s in self.steps)

    @launches.setter
    def launches(self, n: int) -> None:
        if n:
            raise ValueError("the launch counts can only be reset to 0")
        for s in self.steps:
            s.launches = 0

    def __call__(self, states: Sequence, chunks: Sequence, *args):
        if len(states) != len(self.steps) or len(chunks) != len(self.steps):
            raise ValueError(f"{len(states)} states and {len(chunks)} chunk "
                             f"shards for a mesh of {len(self.steps)} "
                             f"entries")
        outs = [s(state, chunk, *args)
                for s, state, chunk in zip(self.steps, states, chunks)]
        return [o[0] for o in outs], [o[1] for o in outs]


def shard_engine_step(make_step: Callable[[torch.device], Callable],
                      mesh: Mesh, axis_name: str = "streams") -> ShardedStep:
    """A step over the mesh's shards (``ShardedStep``). JAX wraps one
    step in shardings; the port's steps close over their device's
    weights, so a step is built per entry (``step.steps``)."""
    return ShardedStep(make_step, mesh, axis_name)

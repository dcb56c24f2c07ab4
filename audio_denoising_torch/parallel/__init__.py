"""Device-mesh parallelism (JAX counterpart parallel/__init__.py).

The workload's natural axis is the stream (or training example) batch:
the models' parameters are small and live on every device, while stream
state and chunks split over a 1-D ``streams`` mesh. In process, a mesh is
a list of devices (``mesh.py``: the sharded engine and fused hop, and
``tp.py``, the tensor-parallel serving cell); across processes,
``distributed.py`` joins a ``torch.distributed`` process group, over
which ``train.context.make_sharded_train_step`` all-reduces the
gradients of a data-parallel step.
"""

from audio_denoising_torch.parallel.mesh import (
    make_mesh, replicated, shard_batch, shard_engine_step, shard_pytree_batch)
from audio_denoising_torch.parallel.tp import make_tp_plan_cell

__all__ = ["make_mesh", "replicated", "shard_batch", "shard_engine_step",
           "shard_pytree_batch", "make_tp_plan_cell"]

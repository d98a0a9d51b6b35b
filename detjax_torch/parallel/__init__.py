"""Data parallelism over torch.distributed (``detjax/parallel``).

detjax's one ``Mesh(('data',))`` over its chips becomes one process a
device in a process group (NCCL on CUDA, gloo on the CPU), the state made
rank 0's on every rank, each rank fed its shard of the global batch, and
the gradient all-reduce written into the step (``train/step.py``) rather
than inserted by a partitioner. One process over several local devices
serves and evaluates (a single-process :class:`Mesh`).
``make_mesh(spatial=K)`` makes detjax's ``(data, space)`` mesh: each
image's rows split over the K ranks (or, in one process, the K devices)
of its space group, the halo exchanges and gathers written into the model
(``detjax_torch/models/spatial.py``); in one process the shards run on
threads of a ``RowRunner`` (serving and evaluation).
"""

from detjax_torch.parallel.mesh import (
    Mesh,
    global_batch_from_local,
    make_mesh,
    make_parallel_train_step,
    parallel_train_state,
    replicate,
    shard_batch,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "replicate",
    "shard_batch",
    "global_batch_from_local",
    "make_parallel_train_step",
    "parallel_train_state",
]

"""Process-group set-up from ``torchrun``'s environment, the node-aware mesh
and the per-process batch share.

Mirrors ``multimodal_av_model_tpu/parallel/multihost.py:37-133``:

* ``initialize_distributed`` starts the default process group when
  ``torchrun`` (or anything that sets ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR`` and ``MASTER_PORT``) launched the process: ``nccl`` when
  the run's device is the card, ``gloo`` on the CPU.  Without that
  environment it is a no-op that returns ``False``; calling it again
  returns what the first call did;
* ``make_hybrid_mesh`` lays the ``(data, model)`` mesh out so that every
  ``model`` group (tensor parallelism, latency-bound) stays inside one node,
  and ``data`` (gradient reductions) spans the nodes.  A node is
  ``LOCAL_WORLD_SIZE`` consecutive ranks, as ``torchrun`` numbers them;
* ``process_local_batch_size``: each process loads its share of the global
  batch.  The ranks of one ``model`` group compute on the same rows, so the
  share is the global batch over the ``data`` size (JAX, one process per
  node, divides by the process count).
"""

from __future__ import annotations

import os
from datetime import timedelta

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(device: str | None = None) -> bool:
    """Start the default process group from the environment -> whether one
    is up.  ``device``: ``cuda`` or ``cpu`` (default: ``cuda`` when there
    is a card); picks the backend and, on the card, this rank's device
    (``LOCAL_RANK``)."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _ENV):
        return False
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            timeout=timedelta(minutes=10))
    return True


def make_hybrid_mesh(model_parallel: int = 1, device_type: str | None = None):
    """``(data, model)`` mesh whose ``model`` groups never cross a node
    (``multihost.py:86-121``).  Ranks ``[k * model_parallel, (k + 1) *
    model_parallel)`` form ``model`` group ``k``; ``model_parallel`` must
    divide the ranks per node."""
    import torch.distributed as dist

    from .mesh import make_mesh

    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if per_node % model_parallel != 0:
        raise ValueError(
            f"host {dist.get_rank() // per_node} has {per_node} devices, not divisible by "
            f"model_parallel={model_parallel} — a tensor-parallel group "
            f"must stay inside one host's ICI domain")
    return make_mesh(model_parallel=model_parallel, device_type=device_type)


def process_local_batch_size(global_batch_size: int, model_parallel: int = 1) -> int:
    """This process's rows of a global batch: the batch over the ``data``
    size (``multihost.py:124-133``)."""
    import torch.distributed as dist

    n = (dist.get_world_size() if dist.is_initialized() else 1) // model_parallel
    if global_batch_size % n != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n

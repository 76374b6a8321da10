"""Parameter and optimizer-state sharding over the mesh's ``data`` axis with
FSDP2 (``fully_shard``).

Mirrors ``multimodal_av_model_tpu/parallel/fsdp.py:38-93``.  JAX gives each
parameter a ``NamedSharding`` that splits its largest free dimension over
``data`` and lets XLA insert the gathers and reduce-scatters.  Here
``fully_shard`` wraps units of the model: each Conformer block, each block of
the visual ResNet trunk, and the root (the rest).  A unit's parameters are
gathered before its forward and backward, its gradients reduce-scattered
(averaged over ``data``) after, and Adam's moments, made ``like`` the
parameters, stay sharded.  It composes with ``tp.py`` when the tensor plan is
applied first: a column-parallel weight is then split over ``model`` and
again over ``data``.

Differences in where shards live, not in the numbers: FSDP2 splits dim 0 of
every parameter of a unit (JAX picks the largest dimension that divides), and
it cannot leave a small leaf replicated inside a unit, so JAX's
``MIN_SHARD_ELEMS = 4096`` rule (biases, norm scales stay replicated) has no
counterpart.  Frozen parameters keep ``requires_grad``, which a unit allows.
"""

from __future__ import annotations

from torch import nn

from .mesh import DATA_AXIS, refuse_avhubert
from .tp import tp_param_specs


def fsdp_units(model: nn.Module) -> list[nn.Module]:
    """The modules wrapped as their own unit, innermost first (the root
    last)."""
    from ..models.audio import ConformerBlock
    from ..models.visual import BasicBlock

    units = [m for m in model.modules() if isinstance(m, (ConformerBlock, BasicBlock))]
    return units + [model]


def fsdp_param_specs(model: nn.Module, data_parallel: int, model_parallel: int = 1) -> dict:
    """Parameter name -> ``(placement over data, placement over model)``."""
    from torch.distributed.tensor import Replicate, Shard

    tp = tp_param_specs(model, model_parallel)
    data = Shard(0) if data_parallel > 1 else Replicate()
    return {name: (data, spec) for name, spec in tp.items()}


def apply_fsdp(model: nn.Module, mesh) -> nn.Module:
    """``fully_shard`` each unit of ``model`` over the mesh's ``data`` axis,
    in place."""
    refuse_avhubert(model, "FSDP")
    from torch.distributed.fsdp import fully_shard

    for unit in fsdp_units(model):
        fully_shard(unit, mesh=mesh[DATA_AXIS])
    return model

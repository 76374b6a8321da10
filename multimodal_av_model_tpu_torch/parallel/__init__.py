"""The parallel layouts of the training step: the ``(data, model)`` mesh,
process-group set-up, tensor parallelism and FSDP.

Mirrors ``multimodal_av_model_tpu/parallel/{mesh,multihost,tp,fsdp}.py``.
``parallelize`` applies them to a model in the order they compose: the
tensor plan, then the data axis's hooks, then FSDP.
"""

from .fsdp import apply_fsdp, fsdp_param_specs, fsdp_units
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_rank,
    axis_size,
    bind_data_axis,
    copy_into,
    full_tensor,
    gather_rows,
    local_batch_rows,
    local_data_parallelism,
    make_mesh,
    pad_batch_to_multiple,
    process_rows,
    shard_batch,
)
from .multihost import initialize_distributed, make_hybrid_mesh, process_local_batch_size
from .tp import apply_tensor_parallel, tp_param_specs


def parallelize(model, mesh, fsdp: bool = False):
    """``model`` split over ``mesh`` in place: ``tp.py``'s plan over
    ``model``, ``bind_data_axis`` over ``data``, and with ``fsdp`` its
    parameters sharded over ``data``."""
    apply_tensor_parallel(model, mesh)
    bind_data_axis(model, mesh)
    if fsdp:
        apply_fsdp(model, mesh)
    return model


__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "apply_fsdp", "apply_tensor_parallel", "axis_rank",
    "axis_size", "bind_data_axis", "copy_into", "fsdp_param_specs", "fsdp_units",
    "full_tensor", "gather_rows", "initialize_distributed", "local_batch_rows", "local_data_parallelism",
    "make_hybrid_mesh", "make_mesh", "pad_batch_to_multiple", "parallelize",
    "process_local_batch_size", "process_rows", "shard_batch", "tp_param_specs",
]

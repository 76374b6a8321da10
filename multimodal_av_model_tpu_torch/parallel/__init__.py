"""The parallel layouts: the training step's ``(data, model)`` mesh,
process-group set-up, tensor parallelism and FSDP; pipeline parallelism
over a ``pipe`` axis; ring and gather-KV attention with time split over a
mesh axis, and the long-form audio encoder built on them.

Mirrors ``multimodal_av_model_tpu/parallel/{mesh,multihost,tp,fsdp,pp,
sequence,longform}.py``.
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
    make_named_mesh,
    pad_batch_to_multiple,
    process_rows,
    ring_hop,
    shard_batch,
)
from .longform import CPSelfAttention, make_cp_audio_encoder
from .multihost import initialize_distributed, make_hybrid_mesh, process_local_batch_size
from .pp import (
    PIPE_AXIS,
    bubble_fraction,
    pipeline_blocks,
    shard_stacked_params,
    stack_block_params,
    stage_layers,
    unstack_block_params,
)
from .sequence import (
    gather_kv_attention,
    gather_kv_attention_batched,
    gather_time,
    local_block,
    reference_attention,
    ring_attention,
    ring_attention_batched,
)
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
    "CPSelfAttention", "DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "apply_fsdp",
    "apply_tensor_parallel", "axis_rank", "axis_size", "bind_data_axis", "bubble_fraction",
    "copy_into", "fsdp_param_specs", "fsdp_units", "full_tensor", "gather_kv_attention",
    "gather_kv_attention_batched", "gather_rows", "gather_time", "initialize_distributed",
    "local_batch_rows", "local_block", "local_data_parallelism", "make_cp_audio_encoder",
    "make_hybrid_mesh", "make_mesh", "make_named_mesh", "pad_batch_to_multiple", "parallelize",
    "pipeline_blocks", "process_local_batch_size", "process_rows", "reference_attention",
    "ring_attention", "ring_attention_batched", "ring_hop", "shard_batch",
    "shard_stacked_params", "stack_block_params", "stage_layers", "tp_param_specs",
    "unstack_block_params",
]

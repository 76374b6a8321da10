"""Tensor parallelism over the mesh's ``model`` axis: a DTensor plan for
``parallelize_module`` over the port's module names.

Mirrors ``multimodal_av_model_tpu/parallel/tp.py:37-106``'s ``_spec_for``
rules, the megatron two-matmul split:

* the Conformer FFN's first dense (``fc1``, d_model -> ffn_dim) is
  column-parallel and its second (``fc2``) row-parallel, so each FFN has one
  all-reduce;
* ``query``/``key``/``value`` of every attention are column-parallel by heads
  and ``out`` row-parallel: each rank computes ``num_heads / tp`` heads end
  to end (the plan lowers the module's ``num_heads`` to that);
* the audio encoder's wide ``out_proj`` (d_model -> 1024) is column-parallel
  with its output gathered (``Replicate``), since nothing row-parallel
  follows it;
* everything else replicates.

A module whose split axis does not divide by ``model_parallel`` (an odd head
count, say) replicates, as JAX's leaf does (``tp.py:67-87``).  A port
``Dense`` holds ``weight [out, in]`` (flax ``kernel [in, out]``), so
column-parallel is ``Shard(0)`` of the weight and bias, row-parallel
``Shard(1)`` of the weight with the bias replicated.
"""

from __future__ import annotations

from torch import nn

from .mesh import MODEL_AXIS, axis_rank, axis_size, refuse_avhubert

COLWISE, ROWWISE, GATHERED = "colwise", "rowwise", "colwise_gathered"


def _roles(model: nn.Module, model_parallel: int) -> dict[str, str]:
    """Module name -> its split, for the modules that split."""
    from ..models.audio import AudioEncoder, FeedForward
    from ..models.layers import MultiHeadAttention

    roles = {}
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, FeedForward) and m.fc1.out_features % model_parallel == 0:
            roles[pre + "fc1"], roles[pre + "fc2"] = COLWISE, ROWWISE
        elif isinstance(m, MultiHeadAttention) and m.num_heads % model_parallel == 0:
            for proj in ("query", "key", "value"):
                roles[pre + proj] = COLWISE
            roles[pre + "out"] = ROWWISE
        elif isinstance(m, AudioEncoder) and m.out_proj.out_features % model_parallel == 0:
            roles[pre + "out_proj"] = GATHERED
    return roles


def tp_param_specs(model: nn.Module, model_parallel: int) -> dict:
    """Parameter name -> its placement over ``model`` (``Shard(d)`` or
    ``Replicate()``)."""
    from torch.distributed.tensor import Replicate, Shard

    roles = _roles(model, model_parallel) if model_parallel > 1 else {}
    out = {}
    for name, _ in model.named_parameters():
        module, _, leaf = name.rpartition(".")
        role = roles.get(module)
        if role in (COLWISE, GATHERED):
            out[name] = Shard(0)
        elif role == ROWWISE and leaf == "weight":
            out[name] = Shard(1)
        else:
            out[name] = Replicate()
    return out


def apply_tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """Split ``model``'s wide layers over the mesh's ``model`` axis in
    place (nothing to do at size 1)."""
    refuse_avhubert(model, "tensor parallelism")
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    from ..models.audio import FeedForward
    from ..models.layers import MultiHeadAttention

    tp = axis_size(mesh, MODEL_AXIS)
    if tp == 1:
        return model
    roles = _roles(model, tp)
    styles = {COLWISE: ColwiseParallel, ROWWISE: RowwiseParallel,
              GATHERED: lambda: ColwiseParallel(output_layouts=Replicate())}
    parallelize_module(model, mesh[MODEL_AXIS], {n: styles[r]() for n, r in roles.items()})
    rank = axis_rank(mesh, MODEL_AXIS)
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, MultiHeadAttention) and roles.get(pre + "query") == COLWISE:
            m.num_heads //= tp
        elif isinstance(m, FeedForward) and roles.get(pre + "fc1") == COLWISE:
            m.hidden_cols = (rank, tp)
    return model

"""The ``(data, model)`` device mesh, batch placement and the data axis's
hooks into the model.

Mirrors ``multimodal_av_model_tpu/parallel/mesh.py:1-142``.  The JAX mesh is
a grid of devices that one program drives; here every rank is one process
with one device (``torchrun``), and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks with the
dimensions ``("data", "model")``.  So:

* ``shard_batch`` places a process-local batch on this rank's device: the
  rank's rows are the batch it was given (JAX's multi-process input
  pattern); ``process_rows`` cuts a global batch into them;
* ``local_data_parallelism`` is 1 (one device per process) and
  ``local_batch_rows`` the output itself (outputs are rank-local already);
* ``pad_batch_to_multiple`` is an own numpy copy of JAX's;
* ``bind_data_axis`` gives the model what the batch split changes:
  BatchNorm statistics and the fusion's batch-max kept length over the whole
  batch (all-reduced over ``data``, as under ``pjit``) and dropout masks
  drawn for the whole batch, of which each rank keeps its rows
  (``models/layers.py:dropout``).

``full_tensor`` and ``copy_into`` move values between a plain tensor and a
tensor that tensor or data parallelism has split (a ``DTensor``).
``make_named_mesh`` builds a mesh of other axes (``("data", "pipe")`` for
``parallel/pp.py``), and ``ring_hop`` is ``lax.ppermute`` one step round an
axis, with the reverse step as its gradient.
"""

from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              device_type: str | None = None):
    """A ``(data, model)`` mesh over the ``n_devices`` ranks of the process
    group (all of them by default), ``model_parallel`` consecutive ranks to a
    ``model`` group.  ``device_type`` defaults to ``cuda`` when there is a
    card, else ``cpu``."""
    import torch.distributed as dist

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh spans the whole process group: {n} devices asked, "
                         f"{world} ranks")
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return make_named_mesh((n // model_parallel, model_parallel), (DATA_AXIS, MODEL_AXIS),
                           device_type)


def make_named_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
                    device_type: str | None = None):
    """A mesh of ``shape`` over every rank of the process group, its
    dimensions named ``axes`` (the last one over consecutive ranks), as JAX's
    ``Mesh(devices.reshape(shape), axes)``: ``((2, 4), ("data", "pipe"))``
    for the pipeline, ``((4,), ("data",))`` for a sequence axis.
    ``device_type`` defaults to ``cuda`` when there is a card, else ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if int(np.prod(shape)) != dist.get_world_size():
        raise ValueError(f"a mesh spans the whole process group: shape {tuple(shape)}, "
                         f"{dist.get_world_size()} ranks")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh[axis].get_local_rank()


def local_data_parallelism(mesh) -> int:
    """This process's devices along ``data``: one, as every rank is one
    process with one device (JAX's ``mesh.py:97-103`` counts several)."""
    return 1


def local_batch_rows(x) -> np.ndarray:
    """This process's rows of a batch entry or output (a tensor on any
    device, or an array), as numpy: the entry itself, which holds only this
    rank's rows (JAX's ``mesh.py:106-121`` extracts them from a global
    array)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pad_batch_to_multiple(batch: dict, multiple: int) -> dict:
    """Pad the batch axis so it divides ``multiple`` (repeats the last row;
    ``valid`` is 0 on the new rows and ``num_real`` records the true count)
    (``mesh.py:124-142``)."""
    sizes = {v.shape[0] for v in batch.values() if getattr(v, "ndim", 0) > 0}
    if len(sizes) != 1:
        raise ValueError("inconsistent batch axis")
    (b,) = sizes
    rem = (-b) % multiple
    if rem == 0:
        return batch
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.ndim == 0:
            out[k] = v
        else:
            out[k] = np.concatenate([v, np.repeat(v[-1:], rem, axis=0)], axis=0)
    if "valid" in out:
        out["valid"] = out["valid"].copy()
        out["valid"][b:] = 0.0
    out.setdefault("num_real", np.int32(b))
    return out


def process_rows(mesh, batch: dict) -> dict:
    """This rank's rows of a global batch (numpy): the batch padded to a
    multiple of the ``data`` size, then the block of this rank's ``data``
    coordinate; the ranks of one ``model`` group get the same rows.
    ``num_real`` becomes the real rows of the block."""
    dp, r = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)
    padded = pad_batch_to_multiple({k: np.asarray(v) for k, v in batch.items()}, dp)
    n = next(v.shape[0] for v in padded.values() if v.ndim > 0)
    b = n // dp
    out = {k: v[r * b:(r + 1) * b] if v.ndim > 0 else v for k, v in padded.items()}
    if "num_real" in padded:
        out["num_real"] = np.int32(min(max(int(padded["num_real"]) - r * b, 0), b))
    return out


def shard_batch(mesh, batch: dict, device) -> dict:
    """The process-local batch placed on this rank's device: every entry but
    ``num_real`` as a tensor (``mesh.py:69-94``)."""
    from ..train.trainer import place_batch

    return place_batch(batch, device)


def refuse_avhubert(model: torch.nn.Module, what: str) -> None:
    """Raise for ``what``, a layout that splits the flagship's modules, on a
    model built with another ``model.arch``."""
    from ..config import ModelConfig, require_flagship

    cfg = getattr(model, "config", None)
    require_flagship(cfg if isinstance(cfg, ModelConfig) else None, what)


def bind_data_axis(model: torch.nn.Module, mesh) -> None:
    """Make ``model`` compute what one device would on the whole batch when
    its rows are split over the ``data`` axis: BatchNorms all-reduce their
    statistics over it, the fusion its batch-max kept length, and dropout
    and SpecAugment draw for the whole batch."""
    from ..models.audio import AudioEncoder, ConvModule, FeedForward
    from ..models.fusion import CrossAttentionFusion
    from ..models.layers import BatchNorm

    dp = axis_size(mesh, DATA_AXIS)
    if dp == 1:
        return
    group = mesh[DATA_AXIS].get_group()
    rows = (axis_rank(mesh, DATA_AXIS), dp)
    for m in model.modules():
        if isinstance(m, (BatchNorm, CrossAttentionFusion)):
            m.group = group
        elif isinstance(m, (FeedForward, ConvModule, AudioEncoder)):
            m.rows = rows


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over a group whose backward all-reduces the gradient:
    the gradient of the sum of every rank's use of the result."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, differentiably."""
    return _SumOver.apply(x, group)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 over a group; the backward all-reduces the
    gradient of the whole and keeps this rank's rows (the gradient of every
    rank's use of the gathered tensor).  torch's own autograd all-gather
    falls back, off NCCL, to a scatter that takes group ranks for global
    ones, which fails on a sub-group."""

    @staticmethod
    def forward(ctx, x, group, size: int, rank: int):
        parts = [torch.empty_like(x) for _ in range(size)]
        torch.distributed.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.rank, ctx.rows = group, rank, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad.narrow(0, ctx.rank * ctx.rows, ctx.rows), None, None, None


def gather_rows(x: torch.Tensor, mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """The rows of ``x`` of every rank along ``axis``, in rank order, with
    the gradient flowing back to each rank's own rows."""
    return _GatherRows.apply(x, mesh[axis].get_group(), axis_size(mesh, axis),
                             axis_rank(mesh, axis))


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole value of ``t``: gathered if it is a ``DTensor`` (a
    collective: every rank of its mesh must call it), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


@torch.no_grad()
def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the value ``src`` into ``dst`` in place, whatever either's
    layout: a whole tensor is split as ``dst`` is, a ``DTensor`` of another
    layout is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(dst, DTensor):
        if isinstance(src, DTensor):
            src = src.redistribute(dst.device_mesh, dst.placements)
        else:
            src = distribute_tensor(src.to(dst.device, dst.dtype), dst.device_mesh,
                                    dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(full_tensor(src))


def _hop(x: torch.Tensor, group, size: int, rank: int, shift: int) -> torch.Tensor:
    """Send ``x`` to group rank ``rank + shift`` and receive from ``rank -
    shift`` (mod ``size``), both posted before either is waited on."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    to = dist.get_global_rank(group, (rank + shift) % size)
    frm = dist.get_global_rank(group, (rank - shift) % size)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                        dist.P2POp(dist.irecv, out, frm, group)]):
        work.wait()
    return out


class _RingHop(torch.autograd.Function):
    """One step round a ring; the backward is the reverse step, as JAX
    transposes ``ppermute`` (``parallel/pp.py:22-24``)."""

    @staticmethod
    def forward(ctx, x, group, size: int, rank: int):
        ctx.args = (group, size, rank)
        return _hop(x, group, size, rank, 1)

    @staticmethod
    def backward(ctx, grad):
        return _hop(grad, *ctx.args, -1), None, None, None


def ring_hop(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(i, (i + 1) % n)])``: ``x`` goes to the next
    rank along ``axis`` and the previous rank's comes back, differentiably.
    Every rank of the group must call it.  In a group of one it is ``x``
    itself and sends nothing (NCCL cannot send to its own rank)."""
    size = axis_size(mesh, axis)
    if size == 1:
        return x
    return _RingHop.apply(x, mesh[axis].get_group(), size, axis_rank(mesh, axis))

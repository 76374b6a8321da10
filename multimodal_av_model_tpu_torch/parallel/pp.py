"""Pipeline parallelism: GPipe microbatches of the Conformer stack over a
mesh ``pipe`` axis.

Mirrors ``multimodal_av_model_tpu/parallel/pp.py:1-179``.  The L identical
``ConformerBlock``s are stacked (``stack_block_params``: ``blocks.{i}.*`` of
a state dict -> ``{name: [L, ...]}``) and rank ``s`` of the ``pipe`` group
keeps layers ``[s·L/S, (s+1)·L/S)`` as its own blocks
(``shard_stacked_params``, JAX's ``P('pipe')`` on the leading axis): the
weights never move.  ``pipeline_blocks`` runs JAX's schedule
(``pp.py:126-162``) tick by tick: ``M + S - 1`` ticks, stage 0 feeds
microbatch ``t``, stage ``s`` applies its layers to microbatch ``t - s``,
``ring_hop`` (``lax.ppermute``) hands each activation to the next stage, the
last stage keeps the outputs, and a sum over ``pipe`` of zeros-but-last
gives them to every stage.  The stages skip the fill and drain ticks that
JAX computes on clipped microbatch indices and discards.

The gradient comes from autograd, as JAX's from autodiff: the hop's
backward is the reverse hop, and the final sum's backward is the mean of
the stages' cotangents (JAX divides the cotangent of an output replicated
over an axis by its size, then transposes ``psum`` to ``psum``), which is
the gradient of one loss that every stage computes alike.  Each reverse hop
pairs a rank with both its neighbours, so every stage must run every tick's
hop backward: the fill and drain ticks send zeros that take a gradient, and
the states a stage never reads go into the final sum, whose backward gives
them a zero gradient.  Autograd then runs the hops of every rank in the
same, reverse tick order.

With ``data_axis``, each slice of ``data`` runs its own pipeline on its rows
of every microbatch (JAX's ``io_spec = P(None, data)``, ``pp.py:122-124``)
and the rows are summed back over ``data`` the same way, so every rank gets
the whole ``[B, T, d]``.  The parameter gradients on a rank are then its
slice's share: the caller all-reduces (sums) them over ``data``, as the
trainer's mesh path does.
"""

from __future__ import annotations

import torch
from torch import nn

from .mesh import axis_rank, axis_size, ring_hop

PIPE_AXIS = "pipe"


def stack_block_params(encoder_state: dict, num_layers: int) -> dict[str, torch.Tensor]:
    """``blocks.{i}.<name>`` of an audio encoder's state dict (the port's
    ``AudioEncoder`` naming) -> ``{<name>: [L, ...]}`` (``pp.py:47-57``);
    the other entries are left out."""
    names = [k[len("blocks.0."):] for k in encoder_state if k.startswith("blocks.0.")]
    return {n: torch.stack([encoder_state[f"blocks.{i}.{n}"] for i in range(num_layers)])
            for n in names}


def unstack_block_params(stacked: dict, num_layers: int) -> dict[str, torch.Tensor]:
    """The inverse of :func:`stack_block_params` (``pp.py:60-65``)."""
    return {f"blocks.{i}.{n}": t[i] for i in range(num_layers) for n, t in stacked.items()}


def stage_layers(num_layers: int, mesh) -> range:
    """The layers that this rank's stage of ``pipe`` holds."""
    S = axis_size(mesh, PIPE_AXIS)
    if num_layers % S:
        raise ValueError(f"{num_layers} layers not divisible by {S} pipeline stages")
    per = num_layers // S
    s = axis_rank(mesh, PIPE_AXIS)
    return range(s * per, (s + 1) * per)


def shard_stacked_params(stacked: dict, mesh, make_block) -> nn.ModuleList:
    """This rank's stage: one ``make_block()`` for each of its layers
    (``stage_layers``), loaded from the stacked parameters (JAX's
    ``stacked_param_specs`` / ``shard_stacked_params``, ``pp.py:68-76``)."""
    num_layers = next(iter(stacked.values())).shape[0]
    blocks = nn.ModuleList()
    for i in stage_layers(num_layers, mesh):
        block = make_block()
        block.load_state_dict({n: t[i] for n, t in stacked.items()})
        blocks.append(block)
    return blocks


class _SumOfOne(torch.autograd.Function):
    """Sum over a group of a value that one rank holds (zeros elsewhere);
    the backward is the mean of the ranks' cotangents, and ``unused``
    tensors, summed into nothing, get a zero gradient."""

    @staticmethod
    def forward(ctx, x, group, size: int, *unused):
        ctx.group, ctx.size, ctx.unused = group, size, [u.shape for u in unused]
        x = x.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(grad, group=ctx.group)
        zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
        return (grad / ctx.size, None, None) + tuple(zero.expand(u) for u in ctx.unused)


def _sum_of_one(x, mesh, axis, unused=()):
    size = axis_size(mesh, axis)
    if size == 1:
        return x
    return _SumOfOne.apply(x, mesh[axis].get_group(), size, *unused)


def pipeline_blocks(blocks, x: torch.Tensor, frame_valid: torch.Tensor,
                    attn_mask: torch.Tensor, mesh, num_microbatches: int,
                    data_axis: str | None = None) -> torch.Tensor:
    """``x [B, T, d]`` through the L stacked blocks, pipelined over the
    ``pipe`` axis of ``mesh`` (``pp.py:79-173``).

    ``blocks``: this rank's stage (``shard_stacked_params``), run in eval mode
    (no dropout, as JAX's ``deterministic=True``).  ``x``, ``frame_valid
    [B, T]`` and ``attn_mask [B or 1, 1, T, T]`` are the whole batch on every
    rank (JAX replicates them over ``pipe``); only activations travel between
    stages.  ``num_microbatches`` M must divide B, and with ``data_axis`` the
    size of ``data`` must divide each microbatch.  Returns ``[B, T, d]`` on
    every rank, equal (up to rounding) to the L blocks applied in turn.
    Every rank of ``mesh`` must call it; see the module docstring for the
    gradient."""
    from ..models.audio import ConformerBlock

    if not all(isinstance(b, ConformerBlock) for b in blocks):
        raise ValueError("pipeline parallelism runs the flagship's Conformer blocks only; "
                         "model.arch='avhubert' has none")
    S, s = axis_size(mesh, PIPE_AXIS), axis_rank(mesh, PIPE_AXIS)
    M = num_microbatches
    B, T, d = x.shape
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mb = B // M
    dp = axis_size(mesh, data_axis) if data_axis else 1
    if mb % dp:
        raise ValueError(f"microbatch of {mb} rows not divisible by the {data_axis!r} "
                         f"axis size {dp}")
    rows, j = mb // dp, axis_rank(mesh, data_axis) if data_axis else 0

    def mine(t):                               # [B, ...] -> this slice's [M, rows, ...]
        return t.reshape(M, mb, *t.shape[1:])[:, j * rows:(j + 1) * rows]

    xs, valid = mine(x), mine(frame_valid)
    amask = mine(attn_mask.expand(B, *attn_mask.shape[1:]))
    ticks = M + S - 1
    outs, unused, state, state_read = [], [], None, True
    for t in range(ticks):
        m = t - s
        if 0 <= m < M:
            h = xs[m] if s == 0 else state
            state_read = state_read or s > 0
            for block in blocks:
                h = block(h, valid[m], amask[m])
            y = h
            if s == S - 1:
                outs.append(y)
        else:                                  # fill or drain: nothing to compute
            y = torch.zeros_like(xs[0]).requires_grad_(torch.is_grad_enabled())
        if S > 1 and t < ticks - 1:
            if not state_read:
                unused.append(state)
            state, state_read = ring_hop(y, mesh, PIPE_AXIS), False
    if S > 1 and not state_read:
        unused.append(state)
    out = torch.stack(outs) if s == S - 1 else torch.zeros_like(xs)
    out = _sum_of_one(out, mesh, PIPE_AXIS, unused)
    if dp > 1:
        pad = [torch.zeros_like(out[:, :1]).expand(M, n, T, d)
               for n in (j * rows, (dp - 1 - j) * rows)]
        out = _sum_of_one(torch.cat([pad[0], out, pad[1]], dim=1), mesh, data_axis)
    return out.reshape(B, T, d)


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """GPipe's fill and drain share: ``(S - 1) / (M + S - 1)`` (``pp.py:176-179``)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)

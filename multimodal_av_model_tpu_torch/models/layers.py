"""Shared building blocks: dense and norm layers, PReLU, dropout, positions,
one LSTM direction and the BiLSTM, the legacy family's GRU and BiGRU, the
transformer temporal model.

Mirrors ``multimodal_av_model_tpu/models/layers.py:21-355``.  Every
layer keeps f32 parameters and computes in its ``dtype`` (bfloat16 when
serving), as the flax modules do: inputs and parameters are cast at use.
Norms compute their statistics in f32.  Eps values follow flax: LayerNorm and
GroupNorm 1e-6, BatchNorm 1e-5 (``layers.py:52-57``).  Dropout draws from an
explicit ``torch.Generator`` on the tensor's device, never the global RNG.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .. import tracing
from ..ops.lstm_scan import _gru_scan, _lstm_scan, length_mask, lstm_scan
from ..ops.specaugment import block_rows


def _param(*shape) -> nn.Parameter:
    # Filled by init_weights (seeded) or by load_state_dict (from_jax_variables).
    return nn.Parameter(torch.empty(*shape))


class Dense(nn.Linear):
    """``flax.linen.Dense``: ``y = x W^T + b`` computed in ``dtype``.  An
    ``nn.Linear`` (whose initialiser, which draws from the global generator,
    is not run), so the tensor-parallel styles of ``parallel/tp.py`` take it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        nn.Module.__init__(self)
        self.in_features, self.out_features = in_features, out_features
        self.weight = _param(out_features, in_features)
        self.register_parameter("bias", _param(out_features) if bias else None)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` (eps 1e-6), statistics in f32."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, eps: float = 1e-6):
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim)
        self.dtype, self.eps = dtype, eps

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over dim 1 of NCHW (momentum 0.9, eps 1e-5),
    with running statistics as buffers (``layers.py:48-57``).

    Eval normalises with the running statistics.  Train normalises with the
    batch statistics over N, H, W in f32, or in f64 for an f64 input (the
    biased variance) and updates the buffers as flax does, ``0.9 old + 0.1
    batch`` with the *biased* batch variance, unless ``update_stats`` is off
    (the recompute of a checkpointed region, see ``remat``).

    A bf16 or f16 input goes to ``F.batch_norm`` as it is, in either memory
    format, beside the f32 parameters and statistics: one pass over the
    16-bit activation, its statistics and the normalisation computed in f32
    and the output rounded once, as a cast to f32 and back would give within
    one ulp, without the two f32 copies (counted as ``bn_one_pass``).

    ``group``: a process group over which the batch is split (the mesh's
    ``data`` axis, set by ``parallel.bind_data_axis``).  The statistics are
    then those of the whole batch, as under ``pjit``: the sum, then the sum
    of squared deviations, are all-reduced (with their gradients) and divided
    by the global count.  Every rank holds the same number of rows.
    """

    momentum = 0.9

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32, eps: float = 1e-5):
        super().__init__()
        self.weight = _param(channels)
        self.bias = _param(channels)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.dtype, self.eps = dtype, eps
        self.update_stats = True
        self.group = None

    def _global_stats(self, x):
        """Mean and biased variance over dims 0, 2, ... of the batch split
        over ``group`` -> ``(mean, var, count)``."""
        from ..parallel.mesh import sum_over

        dims = [0, *range(2, x.ndim)]
        view = [1, -1] + [1] * (x.ndim - 2)
        n = x.numel() // x.shape[1] * torch.distributed.get_world_size(self.group)
        mean = sum_over(x.sum(dims), self.group) / n
        d = x - mean.view(view)
        var = sum_over((d * d).sum(dims), self.group) / n
        return mean, var, n

    def forward(self, x, train: bool = False):
        if train and self.group is not None:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            view = [1, -1] + [1] * (x.ndim - 2)
            mean, var, n = self._global_stats(xf)
            y = ((xf - mean.view(view)) * torch.rsqrt(var + self.eps).view(view)
                 * self.weight.view(view) + self.bias.view(view))
            if self.update_stats:
                m = self.momentum
                with torch.no_grad():
                    self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                    self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
            return y.to(self.dtype)
        if x.dtype in (torch.bfloat16, torch.float16):
            tracing.count("bn_one_pass")
        if not train:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
            return y.to(self.dtype)
        # At momentum 1 the fused op writes the batch mean and the unbiased
        # batch variance into these buffers, computed once with the output.
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        if self.update_stats:
            n = x.numel() // x.shape[1]
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(var, alpha=(1 - m) * (n - 1) / n)
        return y.to(self.dtype)


def group_size(channels: int) -> int:
    """The adaptive group size of ``layers.py:67``."""
    for gs in (16, 8, 4):
        if channels % gs == 0:
            return gs
    return 1


class GroupNorm(nn.Module):
    """``layers.py:61-68`` adaptive GroupNorm over dim 1 of NCHW (eps 1e-6)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32, eps: float = 1e-6):
        super().__init__()
        self.weight = _param(channels)
        self.bias = _param(channels)
        self.groups = channels // group_size(channels)
        self.dtype, self.eps = dtype, eps

    def forward(self, x, train: bool = False):
        """Stateless: the same in train and eval."""
        y = F.group_norm(x.float(), self.groups, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


def make_norm(kind: str, channels: int, dtype: torch.dtype) -> nn.Module:
    """``layers.py:48-71``: 'batch' or 'group'."""
    if kind == "batch":
        return BatchNorm(channels, dtype)
    if kind == "group":
        return GroupNorm(channels, dtype)
    raise ValueError(f"unknown norm kind {kind!r}")


@contextlib.contextmanager
def running_stats_frozen(modules):
    """Within the block, the ``BatchNorm``s inside ``modules`` leave their
    running statistics alone."""
    norms = [m for mod in modules for m in mod.modules() if isinstance(m, BatchNorm)]
    before = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, b in zip(norms, before):
            m.update_stats = b


@contextlib.contextmanager
def _recompute(modules, caller: int):
    with running_stats_frozen(modules), tracing.counting_for(caller):
        yield


def remat(fn, modules, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward instead of kept.  The recompute leaves the
    running statistics of the ``BatchNorm``s in ``modules`` alone, so they
    update once per forward, as under flax's ``nn.checkpoint``, and counts
    for the thread that ran the forward (on the card autograd's device
    thread recomputes)."""
    caller = threading.get_ident()
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute(modules, caller)))


class PReLU(nn.Module):
    """Per-channel PReLU over dim 1 (``layers.py:21-34``, init 0.25).

    Written with ``maximum``/``minimum`` against zero, as the JAX module is:
    at x = 0 both split the gradient evenly, so the input gradient there is
    ``(1 + alpha) / 2``, as in JAX (``clamp`` would give ``1 + alpha``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = _param(channels)

    def forward(self, x):
        alpha = self.alpha.to(x.dtype).view(1, -1, *([1] * (x.ndim - 2)))
        zero = x.new_zeros(())
        return torch.maximum(x, zero) + alpha * torch.minimum(x, zero)


def make_act(kind: str, channels: int) -> nn.Module:
    """``layers.py:37-45``: 'prelu' or 'relu'."""
    if kind == "prelu":
        return PReLU(channels)
    if kind == "relu":
        return nn.ReLU()
    raise ValueError(f"unknown activation kind {kind!r}")


def dropout(x, rate: float, generator: torch.Generator | None, shape=None,
            rows: tuple[int, int] = (0, 1), cols: tuple[int, int] = (0, 1), parts: int = 1):
    """``flax.linen.Dropout``.  Eval (``generator`` None) or rate 0: ``x``.
    Train: keep each element with probability ``1 - rate`` and scale it by
    ``1 / (1 - rate)``.  The keep mask has ``shape`` (a shape that broadcasts
    to ``x`` shares one draw across the broadcast axes) and is drawn from
    ``generator``, which lives on ``x``'s device.

    Without ``shape``, ``x`` may be one block of a larger tensor split over a
    mesh: block ``rows[0]`` of ``rows[1]`` along dim 0 and ``cols[0]`` of
    ``cols[1]`` along the last dim.  The mask of the whole tensor is drawn
    and this block of it kept, so the ranks of a mesh drop what one device
    dropping the whole tensor would.  ``parts``: ``x`` stacks that many
    equal batches along dim 0 (the double audio pass's two speakers), each
    of them block ``rows[0]`` of its own part of the whole tensor."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    if shape is None:
        shape = list(x.shape)
        shape[0] *= rows[1]
        shape[-1] *= cols[1]
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if rows[1] > 1:
        mask = block_rows(mask, rows, parts)
    if cols[1] > 1:
        mask = mask.narrow(-1, cols[0] * x.shape[-1], x.shape[-1])
    return torch.where(mask, x / keep, 0.0)


class MultiHeadAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention``: q/k/v/out projections,
    query scaled by ``1/sqrt(head_dim)``, masked logits filled with
    ``finfo(dtype).min`` (a fully masked query row gets the mean of V, as in
    flax), softmax, then the output projection.  Written as explicit matmuls
    so padded rows stay finite.  In train mode the attention weights take
    dropout at ``dropout_rate`` with one ``[Tq, Tk]`` mask shared by every
    batch row and head (flax's default ``broadcast_dropout=True``).

    ``num_heads`` is the heads this module computes: under tensor parallelism
    (``parallel/tp.py``) the projections hold ``num_heads / tp`` heads of
    ``head_dim`` each, and the plan lowers it to that."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype, dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.query = Dense(dim, dim, dtype=dtype)
        self.key = Dense(dim, dim, dtype=dtype)
        self.value = Dense(dim, dim, dtype=dtype)
        self.out = Dense(dim, dim, dtype=dtype)
        self.dtype, self.dropout_rate = dtype, dropout_rate

    def forward(self, q_in, kv_in, mask=None, generator=None):
        """``mask`` broadcasts to ``[B, heads, Tq, Tk]``; True = attend.
        ``generator``: train mode (dropout drawn from it); None: eval."""
        B, Tq = q_in.shape[:2]
        H, hd = self.num_heads, self.head_dim

        def heads(x):
            return x.reshape(B, -1, H, hd).transpose(1, 2)         # [B, H, T, hd]

        q = heads(self.query(q_in))
        k = heads(self.key(kv_in))
        v = heads(self.value(kv_in))
        q = q / math.sqrt(hd)
        logits = q @ k.transpose(-1, -2)                           # [B, H, Tq, Tk]
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        weights = dropout(torch.softmax(logits, dim=-1), self.dropout_rate, generator,
                          (1, 1) + tuple(logits.shape[-2:]))
        out = (weights @ v).transpose(1, 2).reshape(B, Tq, H * hd)
        return self.out(out)


def sinusoidal_positions(max_len: int, dim: int, device=None) -> torch.Tensor:
    """Sinusoidal position table ``[max_len, dim]`` in f32 (``layers.py:74-83``)."""
    f32 = torch.float32
    pos = torch.arange(max_len, dtype=f32, device=device)[:, None]
    rate = -torch.log(torch.tensor(10000.0, dtype=f32, device=device)) / dim
    div = torch.exp(torch.arange(0, dim, 2, dtype=f32, device=device) * rate)
    pe = torch.zeros(max_len, dim, dtype=f32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class TransformerTemporalLayer(nn.Module):
    """One pre-LN layer of ``TransformerTemporalBlock``: masked self-attention
    and a GELU (tanh form, flax's ``nn.gelu``) feed-forward, each with a
    residual."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int, dtype: torch.dtype):
        super().__init__()
        self.attn_norm = LayerNorm(dim, dtype)
        self.attn = MultiHeadAttention(dim, num_heads, dtype)
        self.ffn_norm = LayerNorm(dim, dtype)
        self.fc1 = Dense(dim, ffn_dim, dtype=dtype)
        self.fc2 = Dense(ffn_dim, dim, dtype=dtype)

    def forward(self, x, mask):
        h = self.attn_norm(x)
        x = x + self.attn(h, h, mask)
        h = self.fc2(F.gelu(self.fc1(self.ffn_norm(x)), approximate="tanh"))
        return x + h


class TransformerTemporalBlock(nn.Module):
    """Masked self-attention temporal model, the fusion's alternative to the
    BiLSTM (``layers.py:321-355``): sinusoidal positions (made in f32, added
    in ``dtype``), ``num_layers`` pre-LN layers, a final LayerNorm.  With
    ``lengths`` the mask is query and key validity, so a padded query row is
    fully masked and gets the mean of V, as in flax.  JAX builds it with
    dropout 0, so it has no train-mode behaviour."""

    def __init__(self, dim: int, num_layers: int = 2, num_heads: int = 8, ffn_dim: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(TransformerTemporalLayer(dim, num_heads, ffn_dim, dtype)
                                    for _ in range(num_layers))
        self.final_norm = LayerNorm(dim, dtype)
        self.dtype = dtype

    def forward(self, x, lengths=None):
        """``x [B, T, D]``, ``lengths [B]`` or None -> ``[B, T, D]``."""
        B, T, D = x.shape
        mask = None
        if lengths is not None:
            valid = length_mask(lengths, T)
            mask = valid[:, None, None, :] & valid[:, None, :, None]
        x = x.to(self.dtype) + sinusoidal_positions(T, D, x.device).to(self.dtype)[None]
        for layer in self.layers:
            x = layer(x, mask)
        return self.final_norm(x)


class LSTMLayer(nn.Module):
    """One LSTM direction ``[B, T, D] -> [B, T, H]`` (``layers.py:86-132``),
    the masked scan the BiLSTM is held against: past each length the carry
    freezes and the output is exactly 0; ``reverse`` runs it over the
    flipped padded sequence with its mask, so the padding comes first and
    leaves the carry at 0.  Parameters are one direction of
    ``FusedBiLSTMLayer``'s (``from_fused``)."""

    def __init__(self, in_dim: int, hidden: int, reverse: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden, self.reverse, self.dtype = hidden, reverse, dtype
        self.w_ih = _param(4 * hidden, in_dim)
        self.w_hh = _param(4 * hidden, hidden)
        self.b_hh = _param(4 * hidden)

    @classmethod
    def from_fused(cls, layer: "FusedBiLSTMLayer", direction: int) -> "LSTMLayer":
        """Direction ``direction`` (0 forward, 1 backward) of ``layer``,
        with a copy of its parameters."""
        out = cls(layer.w_ih.shape[-1], layer.hidden, reverse=direction == 1, dtype=layer.dtype)
        with torch.no_grad():
            for name in ("w_ih", "w_hh", "b_hh"):
                getattr(out, name).copy_(getattr(layer, name)[direction])
        return out

    def forward(self, x, lengths=None):
        dt = self.dtype
        B, T, _ = x.shape
        valid = (torch.ones(B, T, dtype=torch.bool, device=x.device) if lengths is None
                 else length_mask(lengths, T))
        z = F.linear(x.to(dt), self.w_ih.to(dt)).transpose(0, 1)             # [T, B, 4H]
        keep = valid.transpose(0, 1)[..., None]                              # [T, B, 1]
        if self.reverse:
            z, keep = z.flip(0), keep.flip(0)
        y = _lstm_scan(z[:, None], keep[:, None], self.w_hh.to(dt).t()[None],
                       self.b_hh.to(dt)[None, None])[:, 0]
        if self.reverse:
            y = y.flip(0)
        return y.transpose(0, 1)


class FusedBiLSTMLayer(nn.Module):
    """One bidirectional LSTM layer (``layers.py:182-239``).

    The input projections of both directions for all frames are one matrix
    product; the recurrence of both directions is one ``mmav::lstm_scan``
    (``ops/lstm_scan.py``: on the card one launch of K4 with the frame loop
    inside, on the CPU the plain loop ``_lstm_scan``).  Gate order i, f, g, o
    with one bias on the recurrent side (flax ``OptimizedLSTMCell``).  Past
    each length the carry freezes and the output is zero; the backward
    direction starts at each row's last valid frame.  Parameters stack the
    directions: index 0 forward, 1 backward.
    """

    def __init__(self, in_dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.w_ih = _param(2, 4 * hidden, in_dim)
        self.w_hh = _param(2, 4 * hidden, hidden)
        self.b_hh = _param(2, 4 * hidden)
        self.dtype = dtype

    def forward(self, x, lengths):
        """``x [B, T, D]``, ``lengths [B]`` -> ``[B, T, 2H]``."""
        dt = self.dtype
        B, T, _ = x.shape
        z = F.linear(x.to(dt), self.w_ih.to(dt).flatten(0, 1)).view(B, T, 2, 4 * self.hidden)
        y = lstm_scan(z, lengths, self.w_hh.to(dt), self.b_hh.to(dt))      # [B, T, 2, H]
        return y.view(B, T, 2 * self.hidden)


class BiLSTM(nn.Module):
    """Stacked bidirectional LSTM ``[B, T, D] -> [B, T, 2 hidden]``
    (``layers.py:242-266``)."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_dim] + [2 * hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(FusedBiLSTMLayer(d, hidden, dtype) for d in dims)

    def forward(self, x, lengths=None):
        B, T, _ = x.shape
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int64, device=x.device)
        for layer in self.layers:
            x = layer(x, lengths)
        return x


class GRULayer(nn.Module):
    """One GRU direction ``[B, T, D] -> [B, T, H]`` (``layers.py:269-302``),
    ``reverse`` running it over the flipped padded sequence with its mask.
    Gates r, z, n stack along the rows of ``w_ih [3H, D]``, ``b_ih [3H]`` and
    ``w_hh [3H, H]``; ``b_hn [H]`` is the one recurrent bias."""

    def __init__(self, in_dim: int, hidden: int, reverse: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden, self.reverse, self.dtype = hidden, reverse, dtype
        self.w_ih = _param(3 * hidden, in_dim)
        self.b_ih = _param(3 * hidden)
        self.w_hh = _param(3 * hidden, hidden)
        self.b_hn = _param(hidden)

    def forward(self, x, lengths=None):
        dt = self.dtype
        B, T, _ = x.shape
        valid = (torch.ones(B, T, dtype=torch.bool, device=x.device) if lengths is None
                 else length_mask(lengths, T))
        z = F.linear(x.to(dt), self.w_ih.to(dt), self.b_ih.to(dt)).transpose(0, 1)  # [T, B, 3H]
        keep = valid.transpose(0, 1)[..., None]                                     # [T, B, 1]
        if self.reverse:
            z, keep = z.flip(0), keep.flip(0)
        y = _gru_scan(z[:, None], keep[:, None], self.w_hh.to(dt).t()[None],
                      self.b_hn.to(dt)[None, None])[:, 0]
        if self.reverse:
            y = y.flip(0)
        return y.transpose(0, 1)


class FusedBiGRULayer(nn.Module):
    """One bidirectional GRU layer (``layers.py:305-318``'s ``fwd{i}`` and
    ``bwd{i}``): the input projections of both directions for all frames run
    before the loop, and both directions advance in one step.  Parameters
    stack the directions as ``GRULayer``'s: index 0 forward, 1 backward."""

    def __init__(self, in_dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden, self.dtype = hidden, dtype
        self.w_ih = _param(2, 3 * hidden, in_dim)
        self.b_ih = _param(2, 3 * hidden)
        self.w_hh = _param(2, 3 * hidden, hidden)
        self.b_hn = _param(2, hidden)

    def forward(self, x, valid):
        """``x [B, T, D]``, ``valid [B, T]`` bool -> ``[B, T, 2H]``."""
        dt = self.dtype
        x = x.to(dt)
        w_ih, b_ih = self.w_ih.to(dt), self.b_ih.to(dt)
        zf = F.linear(x, w_ih[0], b_ih[0]).transpose(0, 1)            # [T, B, 3H]
        zb = F.linear(x, w_ih[1], b_ih[1]).transpose(0, 1).flip(0)
        v = valid.transpose(0, 1)
        keep = torch.stack([v, v.flip(0)], dim=1)[..., None]           # [T, 2, B, 1]
        y = _gru_scan(torch.stack([zf, zb], dim=1), keep, self.w_hh.to(dt).transpose(1, 2),
                      self.b_hn.to(dt)[:, None, :])
        y = torch.cat([y[:, 0], y[:, 1].flip(0)], dim=-1)              # [T, B, 2H]
        return y.transpose(0, 1)


class BiGRU(nn.Module):
    """Stacked bidirectional GRU ``[B, T, D] -> [B, T, 2 hidden]``
    (``layers.py:305-318``)."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_dim] + [2 * hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(FusedBiGRULayer(d, hidden, dtype) for d in dims)

    def forward(self, x, lengths=None):
        B, T, _ = x.shape
        valid = (torch.ones(B, T, dtype=torch.bool, device=x.device) if lengths is None
                 else length_mask(lengths, T))
        for layer in self.layers:
            x = layer(x, valid)
        return x


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from ``generator`` (a CPU generator; the draws
    are copied to each parameter's device): weight matrices and conv kernels
    ``N(0, 1/fan_in)`` (flax's lecun scale), biases 0, norm scales 1, PReLU
    slopes 0.25, the SSL mask embedding ``N(0, 0.1^2)`` (``audio.py:198-200``).
    Norm running statistics are reset to 0/1."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("bias") or leaf == "b_hh":
            p.zero_()
        elif leaf == "alpha":
            p.fill_(0.25)
        elif leaf == "mask_embedding":
            p.copy_(torch.empty(p.shape).normal_(0.0, 0.1, generator=generator))
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            fan_in = p.shape[-1] if leaf in ("w_ih", "w_hh") else p[0].numel()
            p.copy_(torch.empty(p.shape).normal_(0.0, 1.0 / math.sqrt(fan_in),
                                                 generator=generator))
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
    return model

"""The recurrence of an LSTM layer, both directions at once, as one operator,
and the plain masked recurrences (LSTM and GRU) of the model's layers.

``mmav::lstm_scan(z, lengths, w_hh, bias, save) -> (y, saved)`` advances
both directions (``D`` = 2) of an LSTM layer over ``z [R, T, D, 4H]``, each frame's
input projections (gates i, f, g, o; flax ``OptimizedLSTMCell``, whose one
bias is the recurrent one), with ``w_hh [D, 4H, H]`` (the parameter's layout)
and ``bias [D, 4H]``.  Direction 0 runs forward in time; direction 1 runs
backward from each row's last valid frame with a zero carry.  Frames at or
past ``lengths [R]`` output exactly 0.  ``y [R, T, D, H]`` is in ``z``'s
dtype, so a bidirectional layer's output is ``y.view(R, T, 2H)``.  These are
``_lstm_scan``'s semantics over the padded flip that ``FusedBiLSTMLayer``
used before this operator.

On a CUDA tensor each operator is one launch of ``csrc/bilstm.cu`` (K4), the
frame loop inside the kernel, or it raises.  With ``save`` the forward also
returns what its backward needs, ``saved [D, T, R, 5, H]`` (i, f, g, o and c
of every valid frame, f32); without it ``saved`` is empty.  The registered
autograd runs ``mmav::lstm_scan_backward`` for the gates' gradient ``dz``
(which flows on into the input projection's backward), then ``dW_hh`` as one
product over all frames and ``db`` as one sum.

On a CPU tensor the forward is the plain loop ``_lstm_scan``, which saves
nothing, and the backward is autograd of that loop, run again.  Every
forward and every backward adds 1 to the recorder's ``lstm_kernel`` counter
of the innermost span of the thread that ran the forward;
``lstm_scan.launches`` counts the launches on the card.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .. import tracing
from . import cuda_build
from .cuda_build import SMEM_LIMIT


def length_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """``[B] -> [B, T]`` boolean validity mask."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def _masked_scan(cell, z: torch.Tensor, keep: torch.Tensor, carry: tuple) -> torch.Tensor:
    """The loop of the plain recurrences: ``cell(z[t], carry) -> (new carry,
    output)`` over the frames of ``z [T, ...]``, from ``carry``.  On the
    frames ``keep [T, ...]`` leaves out the carry freezes and the output is
    0.  Returns the outputs stacked, ``[T, ...]``."""
    ys = []
    for t in range(z.shape[0]):
        new, y = cell(z[t], carry)
        k = keep[t]
        carry = tuple(torch.where(k, n, c) for n, c in zip(new, carry))
        ys.append(torch.where(k, y, 0.0))
    return torch.stack(ys)


def _lstm_scan(z: torch.Tensor, keep: torch.Tensor, w_hh: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The recurrence of ``D`` LSTM directions advanced together: the CPU
    kernel of ``mmav::lstm_scan`` and the loop K4 is held against.

    ``z [T, D, B, 4H]`` holds each frame's input projections (gates i, f,
    g, o), ``keep [T, D, B, 1]`` the frames that advance each direction,
    ``w_hh [D, H, 4H]`` and ``bias [D, 1, 4H]`` the recurrent side (flax
    ``OptimizedLSTMCell``: the one bias is the recurrent one).  The carry
    starts at 0 and freezes on the frames ``keep`` leaves out, whose output
    is 0.  Returns ``[T, D, B, H]``."""
    _, D, B, H4 = z.shape

    def cell(zt, carry):
        h, c = carry
        i, f, g, o = (zt + torch.baddbmm(bias, h, w_hh)).chunk(4, dim=-1)
        nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        nh = torch.sigmoid(o) * torch.tanh(nc)
        return (nh, nc), nh

    zero = z.new_zeros(D, B, H4 // 4)
    return _masked_scan(cell, z, keep, (zero, zero))


def _gru_scan(z: torch.Tensor, keep: torch.Tensor, w_hh: torch.Tensor,
              b_hn: torch.Tensor) -> torch.Tensor:
    """The recurrence of ``D`` GRU directions advanced together.

    ``z [T, D, B, 3H]`` holds each frame's input projections ``x W_i + b_i``
    (gates r, z, n), ``keep [T, D, B, 1]`` the frames that advance each
    direction, ``w_hh [D, H, 3H]`` and ``b_hn [D, 1, H]`` the recurrent side.
    flax's ``GRUCell``: ``r`` and ``z`` have no recurrent bias and ``n =
    tanh(x W_in + b_in + r (h W_hn + b_hn))``, ``h' = (1 - z) n + z h``.  The
    carry starts at 0 and freezes on the frames ``keep`` leaves out, whose
    output is 0.  Returns ``[T, D, B, H]``."""
    _, D, B, H3 = z.shape
    H = H3 // 3

    def cell(zt, carry):
        h, = carry
        hh = torch.bmm(h, w_hh)                                    # [D, B, 3H]
        r = torch.sigmoid(zt[..., :H] + hh[..., :H])
        u = torch.sigmoid(zt[..., H:2 * H] + hh[..., H:2 * H])
        n = torch.tanh(zt[..., 2 * H:] + r * (hh[..., 2 * H:] + b_hn))
        nh = (1.0 - u) * n + u * h
        return (nh,), nh

    return _masked_scan(cell, z, keep, (z.new_zeros(D, B, H),))


# Rows a cluster takes at most (the kernel's row tiles of 8, 2 of them); CTAs
# a cluster at most (the non-portable maximum on the H100).
_MAX_ROWS = 16
_CLUSTERS = (1, 2, 4, 8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _smem_bytes(kind: str, elem: int, cs: int, U: int, rows: int, w_in_smem: bool) -> int:
    """A CTA's shared memory (``csrc/bilstm.cu``: ``forward_smem``,
    ``backward_smem``).  Forward: W_hh's slice ``[4U, KP + 8]``, h twice
    ``[rows, KP + 8]``, the step's inputs ``[rows, 4, U]`` and h ``[rows, U]``;
    in f32 the bias ``[4, U]``, c ``[rows, U]`` and the step's saved values
    ``[rows, 5, U]``; the lengths.  Backward: W_hh^T's slice ``[KP, 4U + 8]``,
    dgates ``[rows, 4U + 8]``, the step's dy ``[rows, U]`` and dgates ``[rows,
    4, U]``; in f32 the partial dh from each CTA twice ``[cs, U, rows]``, the
    step's saved values ``[rows, 6, U]`` and dc ``[rows, U]``; the lengths."""
    KP = cs * U
    if kind == "forward":
        w = 4 * U * (KP + 8) if w_in_smem else 0
        return ((w + 2 * rows * (KP + 8) + 5 * rows * U) * elem + (4 * U + 6 * rows * U) * 4
                + rows * 4)
    w = KP * (4 * U + 8) if w_in_smem else 0
    return ((w + rows * (4 * U + 8) + 5 * rows * U) * elem + (2 * cs * U * rows + 7 * rows * U) * 4
            + rows * 4)


# Clusters past this many CTAs in all wait for a free cluster of SMs more
# often; below it, more and smaller row groups shorten each frame.
_SPREAD_CTAS = 64


@functools.lru_cache(maxsize=256)
def lstm_scan_plan(kind: str, R: int, H: int, elem: int) -> dict:
    """Launch plan of ``csrc/bilstm.cu``'s ``kind`` ("forward" or
    "backward") for ``R`` rows of both directions of ``H`` hidden units in
    elements of ``elem`` bytes.  In bf16 the smallest cluster whose CTAs
    hold their slice of W_hh (``U`` units each, a multiple of 16, ``cs U >=
    H``) in shared memory beside the rest; where none does, and always in
    f32, up to 16 CTAs that read their slices from device scratch
    (``scratch`` elements a cluster).  Rows are split into ``groups`` of
    ``rows`` (8 or 16), a cluster each: the fewest rows a cluster that keep
    all clusters within 64 CTAs, else 16."""
    if kind not in ("forward", "backward"):
        raise ValueError(f"lstm kernel: unknown kind {kind!r}")
    if H < 1:
        raise ValueError(f"lstm kernel: {H} hidden units")
    choices = [r for r in (8, 16) if r <= max(8, min(_MAX_ROWS, _ceil_to(R, 8)))]
    candidates = ([(True, cs) for cs in _CLUSTERS] if elem == 2 else []) + [(False, _CLUSTERS[-1])]
    for w_in_smem, cs in candidates:
        U = _ceil_to(-(-H // cs), 16)
        if -(-H // U) != cs and w_in_smem:
            continue                  # fewer CTAs hold the same slices: a smaller cluster
        cs = -(-H // U)
        fits = [r for r in choices if _smem_bytes(kind, elem, cs, U, r, w_in_smem) <= SMEM_LIMIT]
        if not fits:
            continue
        spread = [r for r in fits if 2 * cs * -(-R // r) <= _SPREAD_CTAS]
        rows = spread[0] if spread else fits[-1]
        KP = cs * U
        scratch = 0 if w_in_smem else cs * (4 * U * (KP + 8) if kind == "forward"
                                            else KP * (4 * U + 8))
        return {"cs": cs, "U": U, "rows": rows, "groups": -(-R // rows), "w_in_smem": w_in_smem,
                "smem_bytes": _smem_bytes(kind, elem, cs, U, rows, w_in_smem),
                "scratch": scratch}
    raise ValueError(f"lstm kernel: {H} hidden units in {elem}-byte elements do not fit a "
                     f"cluster's shared memory")


def _flip_reverse(x: torch.Tensor) -> torch.Tensor:
    """``x [T, 2, ...]`` with direction 1 reversed in time (an involution)."""
    return torch.cat([x[:, :1], x[:, 1:].flip(0)], dim=1)


def _to_scan(x: torch.Tensor) -> torch.Tensor:
    """``[R, T, D, ...]`` -> ``_lstm_scan``'s ``[T, D, R, ...]`` in
    processing order: direction 1 over the flipped padded sequence."""
    return _flip_reverse(x.transpose(0, 1).transpose(1, 2))


def _from_scan(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_to_scan``."""
    return _flip_reverse(x).transpose(1, 2).transpose(0, 1)


def _keep(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """``[T, 2, R, 1]``: the frames that advance each direction, in
    processing order (the padded flip puts direction 1's padding first)."""
    v = length_mask(lengths, T).transpose(0, 1)
    return torch.stack([v, v.flip(0)], dim=1)[..., None]


def _plain(z, lengths, w_hh, bias):
    """``y [R, T, D, H]`` by the plain loop ``_lstm_scan``."""
    keep = _keep(lengths.to(z.device), z.shape[1])
    return _from_scan(_lstm_scan(_to_scan(z), keep, w_hh.transpose(1, 2), bias[:, None, :]))


def _forward_plain(z, lengths, w_hh, bias, save):
    """The CPU kernel of ``mmav::lstm_scan``: the plain loop; it saves
    nothing, since its backward runs the loop again."""
    tracing.count("lstm_kernel", 1)
    return _plain(z, lengths, w_hh, bias).contiguous(), z.new_empty((0,), dtype=torch.float32)


# (dtype, z or dy, lengths, len64, then w, bias, y, saved, scratch forward or
# w, saved, dz, scratch backward, nine ints of shape and plan)
_HEAD = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
_launch_forward = cuda_build.Launcher("bilstm", "mmav_lstm",
                                      _HEAD + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9,
                                      symbol="forward_launch")
_launch_backward = cuda_build.Launcher("bilstm", "mmav_lstm",
                                       _HEAD + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9,
                                       symbol="backward_launch")


def _check(x, lengths, w_hh, what: str):
    """Raise on what the kernel does not take in ``x`` (``z`` or ``dy``),
    ``lengths`` and ``w_hh``; returns ``(R, T, D, H)``."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"lstm kernel: expected f32 or bf16, got {x.dtype}")
    if x.ndim != 4 or x.shape[2] != 2:
        raise ValueError(f"lstm kernel: expected {what} [R, T, 2, ...], got {tuple(x.shape)}")
    R, T, D, _ = x.shape
    H = w_hh.shape[-1]
    if w_hh.shape != (D, 4 * H, H) or w_hh.dtype != x.dtype or w_hh.device != x.device:
        raise ValueError(f"lstm kernel: expected w_hh [{D}, 4H, H] {x.dtype} on {x.device}, got "
                         f"{tuple(w_hh.shape)} {w_hh.dtype} on {w_hh.device}")
    if lengths.shape != (R,) or lengths.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"lstm kernel: expected [{R}] int32 or int64 lengths, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    return R, T, D, H


def _scratch(plan: dict, D: int, dtype, device):
    if plan["w_in_smem"]:
        return None
    return torch.empty((plan["groups"] * D * plan["scratch"],), dtype=dtype, device=device)


def _forward_launch(z, lengths, w_hh, bias, save):
    """The ``"cuda"`` kernel of ``mmav::lstm_scan``: one launch of
    ``csrc/bilstm.cu``'s forward over every row and direction."""
    R, T, D, H = _check(z, lengths, w_hh, "z")
    if z.shape[3] != 4 * H or bias.shape != (D, 4 * H) or bias.dtype != z.dtype:
        raise ValueError(f"lstm kernel: expected z [R, T, {D}, {4 * H}] and bias [{D}, {4 * H}] "
                         f"{z.dtype}, got {tuple(z.shape)} and {tuple(bias.shape)} {bias.dtype}")
    dev = z.device
    y = torch.empty((R, T, D, H), dtype=z.dtype, device=dev)
    saved = torch.empty((D, T, R, 5, H) if save else (0,), dtype=torch.float32, device=dev)
    if R == 0 or T == 0:
        return y, saved
    plan = lstm_scan_plan("forward", R, H, z.element_size())
    z, w_hh, bias, lengths = z.contiguous(), w_hh.contiguous(), bias.contiguous(), lengths.to(dev)
    scratch = _scratch(plan, D, z.dtype, dev)
    _launch_forward(dev, lstm_scan, _DTYPES[z.dtype], z.data_ptr(), lengths.data_ptr(),
                    int(lengths.dtype == torch.int64), w_hh.data_ptr(), bias.data_ptr(),
                    y.data_ptr(), saved.data_ptr() if save else None,
                    None if scratch is None else scratch.data_ptr(), R, T, D, H, plan["cs"],
                    plan["U"], plan["rows"], int(plan["w_in_smem"]), plan["smem_bytes"])
    tracing.count("lstm_kernel", 1)
    return y, saved


def _backward_launch(dy, lengths, w_hh, saved):
    """The ``"cuda"`` kernel of ``mmav::lstm_scan_backward``: one launch of
    ``csrc/bilstm.cu``'s backward."""
    R, T, D, H = _check(dy, lengths, w_hh, "dy")
    if saved.shape != (D, T, R, 5, H) or saved.dtype != torch.float32:
        raise ValueError(f"lstm kernel: expected saved [{D}, {T}, {R}, 5, {H}] float32, got "
                         f"{tuple(saved.shape)} {saved.dtype}")
    dev = dy.device
    dz = torch.empty((R, T, D, 4 * H), dtype=dy.dtype, device=dev)
    if R == 0 or T == 0:
        return dz
    plan = lstm_scan_plan("backward", R, H, dy.element_size())
    dy, w_hh, saved, lengths = (dy.contiguous(), w_hh.contiguous(), saved.contiguous(),
                                lengths.to(dev))
    scratch = _scratch(plan, D, dy.dtype, dev)
    _launch_backward(dev, lstm_scan, _DTYPES[dy.dtype], dy.data_ptr(), lengths.data_ptr(),
                     int(lengths.dtype == torch.int64), w_hh.data_ptr(), saved.data_ptr(),
                     dz.data_ptr(), None if scratch is None else scratch.data_ptr(), R, T, D, H,
                     plan["cs"], plan["U"], plan["rows"], int(plan["w_in_smem"]),
                     plan["smem_bytes"])
    return dz


lstm_scan_op = torch.library.custom_op(
    "mmav::lstm_scan", _forward_launch, mutates_args=(), device_types="cuda",
    schema="(Tensor z, Tensor lengths, Tensor w_hh, Tensor bias, bool save) -> (Tensor, Tensor)")
lstm_scan_op.register_kernel("cpu")(_forward_plain)

lstm_scan_backward_op = torch.library.custom_op(
    "mmav::lstm_scan_backward", _backward_launch, mutates_args=(), device_types="cuda",
    schema="(Tensor dy, Tensor lengths, Tensor w_hh, Tensor saved) -> Tensor")


@lstm_scan_op.register_fake
def _forward_fake(z, lengths, w_hh, bias, save):
    R, T, D, _ = z.shape
    H = w_hh.shape[-1]
    saves = save and z.device.type == "cuda"
    return (z.new_empty((R, T, D, H)),
            z.new_empty((D, T, R, 5, H) if saves else (0,), dtype=torch.float32))


@lstm_scan_backward_op.register_fake
def _backward_fake(dy, lengths, w_hh, saved):
    R, T, D, H = dy.shape
    return dy.new_empty((R, T, D, 4 * H))


def _setup_context(ctx, inputs, output):
    z, lengths, w_hh, bias, _ = inputs
    y, saved = output
    ctx.thread = threading.get_ident()
    ctx.plain = z.device.type != "cuda"
    if ctx.plain:                   # the CPU runs the loop again
        ctx.save_for_backward(lengths, w_hh, z, bias)
    else:
        ctx.save_for_backward(lengths, w_hh, y, saved)


def _backward(ctx, dy, _dsaved):
    tracing.count("lstm_kernel", 1, thread=ctx.thread)
    if ctx.plain:
        lengths, w_hh, z, bias = ctx.saved_tensors
        with torch.enable_grad():
            z, w_hh, bias = (x.detach().requires_grad_() for x in (z, w_hh, bias))
            dz, dw, db = torch.autograd.grad(_plain(z, lengths, w_hh, bias), (z, w_hh, bias), dy)
        return dz, None, dw, db, None
    lengths, w_hh, y, saved = ctx.saved_tensors
    if saved.numel() == 0 and y.numel():
        raise RuntimeError("mmav::lstm_scan ran with save=False: no backward")
    dz = lstm_scan_backward_op(dy.contiguous(), lengths, w_hh, saved)
    # dW_hh = sum over frames of dgates^T h_{t-1}; h_{t-1} is the output one
    # frame earlier in each direction's order (0 before its first frame).
    h_prev = torch.zeros_like(y)
    h_prev[:, 1:, 0] = y[:, :-1, 0]
    if y.shape[2] == 2:
        h_prev[:, :-1, 1] = y[:, 1:, 1]
    dw = torch.einsum("rtdg,rtdh->dgh", dz, h_prev)
    return dz, None, dw, dz.sum((0, 1)), None


lstm_scan_op.register_autograd(_backward, setup_context=_setup_context)


def lstm_scan(z: torch.Tensor, lengths: torch.Tensor, w_hh: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """``y [R, T, D, H]`` of ``mmav::lstm_scan`` (see the module's
    docstring); saves for the backward only where a gradient is wanted."""
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm kernel: unsupported device {z.device}")
    save = torch.is_grad_enabled() and any(x.requires_grad for x in (z, w_hh, bias))
    return lstm_scan_op(z, lengths, w_hh, bias, save)[0]


lstm_scan.launches = 0

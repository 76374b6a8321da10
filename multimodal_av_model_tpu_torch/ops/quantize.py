"""Per-channel symmetric int8 weight-only quantization for serving.

Mirrors ``multimodal_av_model_tpu/ops/quantize.py:45-143`` on the port's
state dicts.  JAX quantizes every float leaf named ``*kernel`` with at least
2 dimensions and ``min_size`` elements: its scale is ``max|w| / 127`` over
``_reduce_axes`` (every axis but the last; axis 0 alone for a 3-D leaf),
floored at 1e-12, and its value ``round(w / s)`` clipped to +-127, in f32.
The port keeps each flax kernel in another layout, so ``kernel_layouts``
says, per port parameter, how to view it so that the scale groups are JAX's:

* Dense ``[out, in]`` (flax ``[in, out]``): one scale per row;
* attention q/k/v ``[H*hd, E]`` (flax ``[E, H, hd]``, axis 0): per row;
  the out projection ``[E, H*hd]`` (flax ``[H, hd, E]``, axis 0 = the
  heads): viewed ``[E, H, hd]``, reduced over the heads;
* 2-D convs ``[O, I, kh, kw]`` (flax HWIO): per output channel;
* the audio subsampling conv ``[d, n_mels, 5]`` and the depthwise conv
  ``[d, 1, k]`` (flax 3-D ``[k, ., .]``, axis 0): over the window only;
* LSTM ``w_ih`` / ``w_hh`` ``[2, 4H, in]``, each the stack of eight flax
  gate kernels ``[in, H]``: per row, with ``min_size`` tested against one
  gate block, as JAX tests each leaf.

Biases, norm scales, PReLU slopes and BatchNorm statistics pass through.
The values are computed as JAX does (a division, not a multiply by a
reciprocal), so the int8 bytes equal JAX's after the layout change.
Dequantization is ``(q.float() * s).to(dtype)``, per forward, on the device
(``QuantizedModel``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn


class KernelLayout(NamedTuple):
    view: tuple[int, ...]       # the shape the tensor is viewed in for its scale
    reduce: tuple[int, ...]     # the view's dims one scale spans
    leaf_size: int              # elements of one flax leaf (the min_size test)


def kernel_layouts(model: nn.Module) -> dict[str, KernelLayout]:
    """Layout of every parameter of ``model`` that holds flax ``*kernel``
    leaves, by state-dict name."""
    from ..models.audio import AudioEncoder, ConvModule
    from ..models.layers import Dense, FusedBiLSTMLayer, MultiHeadAttention
    from ..models.visual import Conv2d

    out: dict[str, KernelLayout] = {}
    for name, m in model.named_modules():
        pre = name + "." if name else ""
        if isinstance(m, (Dense, Conv2d)):
            w = m.weight
            out[pre + "weight"] = KernelLayout(tuple(w.shape), tuple(range(1, w.ndim)),
                                               w.numel())
        elif isinstance(m, ConvModule):
            w = m.depthwise_weight
            out[pre + "depthwise_weight"] = KernelLayout(tuple(w.shape), (2,), w.numel())
        elif isinstance(m, AudioEncoder):
            w = m.subsample_weight
            out[pre + "subsample_weight"] = KernelLayout(tuple(w.shape), (2,), w.numel())
        elif isinstance(m, FusedBiLSTMLayer):
            for p in ("w_ih", "w_hh"):
                w = getattr(m, p)
                out[pre + p] = KernelLayout(tuple(w.shape), (2,), w.numel() // 8)
    for name, m in model.named_modules():
        if isinstance(m, MultiHeadAttention):   # after the loop: its out is a Dense too
            E = m.out.weight.shape[0]
            H = m.num_heads
            out[(name + "." if name else "") + "out.weight"] = KernelLayout(
                (E, H, E // H), (1,), E * E)
    return out


def quantize_state_dict(state: dict[str, torch.Tensor], layouts: dict[str, KernelLayout],
                        min_size: int = 4096):
    """``state`` -> ``(qstate, scales)``: ``qstate`` has every name of
    ``state``, int8 where quantized and the tensor itself elsewhere;
    ``scales`` maps the quantized names to f32 scales shaped to broadcast
    against ``layouts[name].view``."""
    qstate, scales = {}, {}
    for name, t in state.items():
        lay = layouts.get(name)
        if lay is None or not t.is_floating_point() or lay.leaf_size < min_size:
            qstate[name] = t
            continue
        w = t.to(torch.float32).reshape(lay.view)
        s = torch.clamp(w.abs().amax(dim=lay.reduce, keepdim=True) / 127.0, min=1e-12)
        qstate[name] = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8).reshape(t.shape)
        scales[name] = s
    return qstate, scales


def dequantize(q: torch.Tensor, s: torch.Tensor, view: tuple[int, ...], dtype: torch.dtype):
    """One tensor back: ``(q.float() * s).to(dtype)`` in the layout's view."""
    return (q.reshape(view).to(torch.float32) * s).reshape(q.shape).to(dtype)


def dequantize_state_dict(qstate, scales, layouts: dict[str, KernelLayout],
                          dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """Inverse of ``quantize_state_dict``: quantized tensors in ``dtype``,
    the rest as they are."""
    return {name: (dequantize(t, scales[name], layouts[name].view, dtype) if name in scales
                   else t) for name, t in qstate.items()}


def tensor_bytes(tensors: dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors.values())


def quantization_report(state, qstate, scales) -> dict:
    """Byte accounting (``quantize.py:128-143``); ``state`` is the fp state
    dict (counted at 4 bytes per element)."""
    fp32 = sum(t.numel() * 4 for t in state.values())
    qbytes = tensor_bytes(qstate) + tensor_bytes(scales)
    return {"n_quantized": len(scales), "fp32_bytes": fp32, "bf16_bytes": fp32 // 2,
            "int8_bytes": qbytes, "vs_fp32": round(fp32 / qbytes, 2),
            "vs_bf16": round(fp32 / 2 / qbytes, 2)}


class QuantizedModel(nn.Module):
    """A model served from its int8 form: the fp parameters are dropped (the
    module moves to the meta device) and only the int8 tensors, their scales
    and the unquantized tensors stay on ``device``, as this module's buffers
    (``q_<name>`` and ``s_<name>``, each ``.`` of the name spelled ``__``), so
    a ``torch.export`` of it holds them and no fp copy.  Each call
    dequantizes to the model's compute dtype (``model.dtype``) and runs the
    module on the result through ``torch.func.functional_call``, as JAX
    dequantizes inside the jitted forward (``infer.py:65-92``)."""

    def __init__(self, model: nn.Module, device, min_size: int = 4096):
        super().__init__()
        self.layouts = kernel_layouts(model)
        state = {k: v.detach() for k, v in model.state_dict().items()}
        qstate, scales = quantize_state_dict(state, self.layouts, min_size)
        self._names, self._quantized = list(qstate), list(scales)
        for name, t in qstate.items():
            self.register_buffer(_buffer("q", name), t.to(device))
        for name, t in scales.items():
            self.register_buffer(_buffer("s", name), t.to(device))
        self.dtype = model.dtype
        self._module = (model.eval().to("meta"),)     # a tuple: not a submodule, holds no state

    @property
    def model(self) -> nn.Module:
        """The model's module, on the meta device."""
        return self._module[0]

    @property
    def qstate(self) -> dict[str, torch.Tensor]:
        """Every name of the model's state dict: int8 where quantized."""
        return {name: getattr(self, _buffer("q", name)) for name in self._names}

    @property
    def scales(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, _buffer("s", name)) for name in self._quantized}

    @property
    def nbytes(self) -> int:
        """Bytes held on the device: int8 tensors, scales and the rest."""
        return tensor_bytes(self.qstate) + tensor_bytes(self.scales)

    def dequantized(self) -> dict[str, torch.Tensor]:
        return dequantize_state_dict(self.qstate, self.scales, self.layouts, self.dtype)

    def forward(self, *args, **kwargs):
        return torch.func.functional_call(self.model, self.dequantized(), args, kwargs)


def _buffer(kind: str, name: str) -> str:
    return f"{kind}_{name.replace('.', '__')}"

"""Seeded weights, made on the device in one draw.

Every parameter's name and shape come from the system's state dict; the
values follow the usual initialisation of the model: weight matrices and
convolution kernels ``N(0, 1/fan_in)`` (LSTM matrices by their last axis),
biases 0, norm scales 1, PReLU slopes 0.25, BatchNorm running statistics 0
and 1.  One ``torch.randn`` on a generator seeded from ``seed`` fills every
tensor that draws, in state-dict order; the rest are set in place.
"""

from __future__ import annotations

import math

import torch

SEED_WEIGHTS = 0x5EED


def init_rule(name: str, shape) -> tuple[str, float]:
    """``("normal", std)`` or ``("fill", value)`` for a state-dict entry."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_mean":
        return "fill", 0.0
    if leaf == "running_var":
        return "fill", 1.0
    if leaf.endswith("bias") or leaf == "b_hh":
        return "fill", 0.0
    if leaf == "alpha":
        return "fill", 0.25
    if len(shape) == 1:
        return "fill", 1.0
    fan_in = shape[-1] if leaf in ("w_ih", "w_hh") else math.prod(shape[1:])
    return "normal", 1.0 / math.sqrt(fan_in)


def seeded_state_dict(template: dict, seed: int, device) -> dict:
    """``template``: name -> tensor (shapes and dtypes); -> name -> new
    tensor on ``device``, drawn from ``seed``."""
    entries = [(n, tuple(t.shape), t.dtype) for n, t in template.items()]
    drawn = [(n, s) for n, s, _ in entries if init_rule(n, s)[0] == "normal"]
    gen = torch.Generator(device=device).manual_seed(seed ^ SEED_WEIGHTS)
    flat = torch.randn(sum(math.prod(s) for _, s in drawn), generator=gen, device=device)
    out, off = {}, 0
    for name, shape, dtype in entries:
        kind, value = init_rule(name, shape)
        if kind == "normal":
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).mul_(value).to(dtype)
            off += n
        else:
            out[name] = torch.full(shape, value, dtype=dtype, device=device)
    return out

"""Floating-point operations of AV-HuBERT with a CTC head (``model.arch =
"avhubert"``), counted from the configuration and the shapes at 2 operations
per multiply-add, as ``avbench/flops.py`` counts the flagship's.

Counted: every matrix product and convolution, the attention products and
the filterbank projection; elementwise work, norms, softmaxes, the FFT and
the CTC recursion are left out.  Work is counted at the padded shapes the
model computes: the bucket's frames on ``2B`` rows (each speaker's lips
with the mixture), the filterbank on the ``B`` mixtures, the positional
convolution's ``T + 1`` output frames (SamePad drops the last one).  A
training step is the forward plus its backward: twice the forward for each
product, except the products whose only trainable operand is the weight
(the lip frontend's convolution and the audio projection, whose inputs are
data), which count once, and the filterbank, which takes no gradient.
"""

from __future__ import annotations

from .flops import conv_out


def forward_parts(cfg: dict, B: int, T: int, S: int, lip_size: int = 88) -> dict:
    """Forward operations of one batch of ``B`` mixtures by part: ``{name:
    (flops, backward_factor)}``."""
    fe, v, a = cfg["frontend"], cfg["visual"], cfg["avhubert"]
    D, F, R = a["embed_dim"], a["ffn_dim"], 2 * B
    parts: dict[str, tuple[float, float]] = {}

    def add(name, flops, factor=2.0):
        f, k = parts.get(name, (0.0, factor))
        parts[name] = (f + flops, k)

    t_mel = 1 + (S + (fe["n_fft"] if fe["center"] else 0) - fe["n_fft"]) // fe["hop_length"]
    add("filterbank", 2.0 * B * t_mel * (fe["n_fft"] // 2 + 1) * fe["n_mels"], 0.0)
    add("audio_proj", 2.0 * R * T * 4 * fe["n_mels"] * D, 1.0)    # 4 frames stacked

    N = R * T
    h = conv_out(lip_size, 7, 2, 3)
    c0 = v["frontend_channels"]
    add("visual_frontend", 2.0 * N * c0 * 5 * 49 * h * h, 1.0)
    h = conv_out(h, 3, 2, 1)
    c_in, trunk = c0, 0.0
    for stage, (n_blocks, c) in enumerate(zip(v["resnet_layers"], v["resnet_channels"])):
        for b in range(n_blocks):
            s = 2 if stage > 0 and b == 0 else 1
            ho = conv_out(h, 3, s, 1)
            trunk += 2.0 * N * c * c_in * 9 * ho * ho + 2.0 * N * c * c * 9 * ho * ho
            if s != 1 or c_in != c:
                trunk += 2.0 * N * c * c_in * ho * ho
            h, c_in = ho, c
    add("visual_trunk", trunk)
    if v["resnet_channels"][-1] != v["output_dim"]:
        add("visual_proj", 2.0 * N * v["resnet_channels"][-1] * v["output_dim"])

    add("fusion_proj", 2.0 * N * 2 * D * D)
    k = a["conv_pos"]
    add("pos_conv", 2.0 * R * (T + 1 - k % 2) * D * (D // a["conv_pos_groups"]) * k)
    add("layers", a["num_layers"] * (2.0 * N * (4 * D * D + 2 * D * F)))
    add("attention", a["num_layers"] * 2 * 2.0 * R * T * T * D)
    add("head", 2.0 * N * D * cfg["decoder"]["vocab_size"])
    return parts


def forward(cfg: dict, B: int, T: int, S: int, lip_size: int = 88) -> float:
    return sum(f for f, _ in forward_parts(cfg, B, T, S, lip_size).values())


def train_step(cfg: dict, B: int, T: int, S: int, lip_size: int = 88) -> float:
    """Operations of one training step: the forward and its backward."""
    return sum(f * (1.0 + k) for f, k in forward_parts(cfg, B, T, S, lip_size).values())

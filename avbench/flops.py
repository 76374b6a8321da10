"""Floating-point operations of the model, counted from the configuration and the
shapes, at 2 operations per multiply-add.

Counted: every matrix product, convolution, attention product, LSTM gate
product and the mel filterbank; elementwise work, norms, softmaxes, the FFT
and the CTC recursion are left out.  Work is counted at the padded shapes the
model computes (the bucket's frames, every attention cell).  A training step
is the forward plus its backward: twice the forward for each product, except
the products whose only trainable operand is the weight (the lip frontend's
and the audio subsampler's convolutions, whose inputs are data, and each LSTM
direction's first recurrent product, whose carry is 0), which count once, and
the mel filterbank, which takes no gradient.  Recomputation is not counted:
nothing here is read from the implementation.
"""

from __future__ import annotations


def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def audio_frames(cfg: dict, S: int) -> tuple[int, int]:
    """``(mel frames, encoder frames)`` of ``S`` samples."""
    fe, a = cfg["frontend"], cfg["audio"]
    t_mel = 1 + (S + (fe["n_fft"] if fe["center"] else 0) - fe["n_fft"]) // fe["hop_length"]
    return t_mel, -(-t_mel // a["subsample_factor"])


def forward_parts(cfg: dict, B: int, T_v: int, S: int, lip_size: int = 96) -> dict:
    """Forward operations of one batch of ``B`` pairs by part, with the parts
    whose backward differs from twice the forward kept apart:
    ``{name: (flops, backward_factor)}``."""
    fe, a, v, fu = cfg["frontend"], cfg["audio"], cfg["visual"], cfg["fusion"]
    parts: dict[str, tuple[float, float]] = {}

    def add(name, flops, factor=2.0):
        f, k = parts.get(name, (0.0, factor))
        parts[name] = (f + flops, k)

    # Audio: the mixture is encoded once for both speakers (B rows).
    t_mel, T = audio_frames(cfg, S)
    d, ffn = a["d_model"], a["ffn_dim"]
    add("mel_filterbank", 2.0 * B * t_mel * (fe["n_fft"] // 2 + 1) * fe["n_mels"], 0.0)
    add("audio_subsample", 2.0 * B * T * d * fe["n_mels"] * 5, 1.0)
    block = (2 * (2 * 2.0 * B * T * d * ffn)             # two FFNs
             + 4 * 2.0 * B * T * d * d                    # q, k, v, out
             + 2 * 2.0 * B * T * T * d                    # logits, weights x values
             + 2.0 * B * T * d * 2 * d                    # pointwise in (GLU)
             + 2.0 * B * d * a["conv_kernel_size"] * T    # depthwise
             + 2.0 * B * T * d * d)                       # pointwise out
    add("audio_blocks", a["num_layers"] * block)
    add("audio_out", 2.0 * B * T * d * a["output_dim"])
    add("contrastive_proj", 2.0 * 2 * B * T * d * cfg["contrastive"]["projection_dim"])

    # Visual: 2B clips of T_v frames.
    N = 2 * B * T_v
    h = conv_out(lip_size, 7, 2, 3)
    c0 = v["frontend_channels"]
    add("visual_frontend", 2.0 * N * c0 * 5 * 49 * h * h, 1.0)
    h = conv_out(h, 3, 2, 1)                             # max pool
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

    # Fusion on 2B rows of T_v frames.
    R, df = 2 * B, fu["fused_dim"]
    add("fusion_attention", 2.0 * R * T_v * (v["output_dim"] + a["output_dim"]) * df
        + 5 * 2.0 * R * T_v * df * df + 2 * 2.0 * R * T_v * T_v * df)   # + fusion_proj
    if fu["temporal_model"] == "bilstm":
        H, rec, first = df, 0.0, 0.0
        for layer in range(fu["temporal_layers"]):
            d_in = df if layer == 0 else 2 * H
            rec += 2 * 2.0 * R * T_v * d_in * 4 * H + 2 * 2.0 * R * (T_v - 1) * H * 4 * H
            first += 2 * 2.0 * R * H * 4 * H
        add("temporal", rec)
        add("temporal_first_step", first, 1.0)
        width = 2 * H
    else:
        ff = fu["transformer_ffn_dim"]
        layer = (4 * 2.0 * R * T_v * df * df + 2 * 2.0 * R * T_v * T_v * df
                 + 2 * 2.0 * R * T_v * df * ff)
        add("temporal", fu["temporal_layers"] * layer + 2.0 * R * T_v * df * 2 * df)
        width = 2 * df
    add("head", 2.0 * R * T_v * width * cfg["decoder"]["vocab_size"])
    return parts


def forward(cfg: dict, B: int, T_v: int, S: int, lip_size: int = 96) -> float:
    """Operations of one forward pass (a transcription request's model work)."""
    return sum(f for f, _ in forward_parts(cfg, B, T_v, S, lip_size).values())


def train_step(cfg: dict, B: int, T_v: int, S: int, lip_size: int = 96) -> float:
    """Operations of one training step: forward, the contrastive similarity of
    each speaker, and the backward of both."""
    _, T = audio_frames(cfg, S)
    n = B * T
    contrast = 2 * 2.0 * n * n * cfg["contrastive"]["projection_dim"]
    return sum(f * (1.0 + k) for f, k in forward_parts(cfg, B, T_v, S, lip_size).values()) \
        + 3 * contrast

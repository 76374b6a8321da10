"""The two-speaker audio-visual CTC model as plain functions of a flat state dict.

Equations (every product in float32, or on float8 inputs under ``lowp``):

* visual encoder, per lip frame: five neighbouring frames (zero frames past
  the clip's ends) stacked as channels, a 7x7 stride-2 convolution,
  BatchNorm, PReLU, a 3x3 stride-2 max pool (padding -inf), the ResNet-18
  BasicBlocks, a global mean;
* audio encoder: the log-mel of the mixture, a stride-2 convolution of
  kernel 5 with SAME padding and SiLU, sinusoidal positions, Conformer
  blocks (half-step SiLU FFN, masked multi-head self-attention, a GLU and
  depthwise-convolution module over the valid frames, half-step FFN, a final
  LayerNorm), an output projection; the mean of the middle blocks feeds the
  contrastive projection.  Dropout sites, in train mode: after the FFN's
  SiLU and second Dense, on the attention weights (one ``[Tq, Tk]`` mask for
  every row and head), after the convolution module;
* fusion: audio frames where the speaker is silent or padded are dropped
  (stable compaction), the kept frames resampled linearly to the video
  length over the batch's longest kept run, audio queries the video by
  multi-head attention, then a 2-layer BiLSTM (gates i, f, g, o, one bias on
  the recurrent side, the carry held past each length) or pre-LN transformer
  layers and a Dense to twice the width;
* head: a Dense to the vocabulary, log-softmax.

LayerNorm eps 1e-6, BatchNorm eps 1e-5 (train: batch statistics, biased
variance), masked attention logits at float32's lowest value.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .preprocess import OTHER_SOLO, PAD

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per tensor, back in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


class Net:
    """``P``: name -> tensor (the system's state-dict names); ``cfg``: the
    configuration file's ``config`` dict; ``gen``: the dropout generator
    (train mode) or None (eval); ``lowp``: float8 operands."""

    def __init__(self, P: dict, cfg: dict, gen=None, lowp: bool = False,
                 checkpoint_visual: bool = False):
        self.P, self.cfg, self.gen, self.lowp = P, cfg, gen, lowp
        self.checkpoint_visual = checkpoint_visual
        self.train = gen is not None

    # -- products ------------------------------------------------------------

    def q(self, x):
        return fp8(x) if self.lowp else x

    def dense(self, name, x):
        b = self.P.get(name + ".bias")
        return F.linear(self.q(x), self.q(self.P[name + ".weight"]), b)

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)

    def conv2d(self, x, w, stride, padding):
        return F.conv2d(self.q(x), self.q(w), None, stride, padding)

    def conv1d_same(self, x, w, b, stride=1, groups=1):
        """``[B, T, C] -> [B, T_out, C_out]`` with XLA's SAME padding."""
        n, k = x.shape[1], w.shape[-1]
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        h = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
        return F.conv1d(self.q(h), self.q(w), b, stride=stride, groups=groups).transpose(1, 2)

    # -- pieces --------------------------------------------------------------

    def layer_norm(self, name, x):
        return F.layer_norm(x, (x.shape[-1],), self.P[name + ".weight"], self.P[name + ".bias"],
                            1e-6)

    def batch_norm(self, name, x):
        P = self.P
        if self.train:
            return F.batch_norm(x, None, None, P[name + ".weight"], P[name + ".bias"], True,
                                0.0, 1e-5)
        return F.batch_norm(x, P[name + ".running_mean"], P[name + ".running_var"],
                            P[name + ".weight"], P[name + ".bias"], False, 0.0, 1e-5)

    def prelu(self, name, x):
        # maximum/minimum split the gradient at 0 evenly, as the published
        # (JAX) module's does.
        a = self.P[name + ".alpha"].view(1, -1, *([1] * (x.ndim - 2)))
        zero = x.new_zeros(())
        return torch.maximum(x, zero) + a * torch.minimum(x, zero)

    def dropout(self, x, shape=None):
        rate = self.cfg["audio"]["dropout"]
        if not self.train or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(list(shape or x.shape), generator=self.gen, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)

    def attention(self, name, q_in, kv_in, heads, mask=None, drop=False):
        B, Tq, D = q_in.shape
        hd = D // heads

        def split(x):
            return x.reshape(B, -1, heads, hd).transpose(1, 2)

        q = split(self.dense(name + ".query", q_in)) / math.sqrt(hd)
        k = split(self.dense(name + ".key", kv_in))
        v = split(self.dense(name + ".value", kv_in))
        logits = self.matmul(q, k.transpose(-1, -2))
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        if drop:
            w = self.dropout(w, (1, 1) + tuple(logits.shape[-2:]))
        out = self.matmul(w, v).transpose(1, 2).reshape(B, Tq, D)
        return self.dense(name + ".out", out)

    @staticmethod
    def positions(T, D, device):
        pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
        div = torch.exp(torch.arange(0, D, 2, dtype=torch.float32, device=device)
                        * (-math.log(10000.0) / D))
        pe = torch.zeros(T, D, device=device)
        pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * div), torch.cos(pos * div)
        return pe

    # -- visual encoder ----------------------------------------------------------

    def basic_block(self, name, x, stride):
        h = self.conv2d(x, self.P[name + ".conv1.weight"], stride, 1)
        h = self.prelu(name + ".act1", self.batch_norm(name + ".norm1", h))
        h = self.batch_norm(name + ".norm2", self.conv2d(h, self.P[name + ".conv2.weight"], 1, 1))
        if name + ".downsample.0.weight" in self.P:
            x = self.batch_norm(name + ".downsample.1",
                                self.conv2d(x, self.P[name + ".downsample.0.weight"], stride, 0))
        return self.prelu(name + ".act2", h + x)

    def visual(self, lips):
        """``[N, T, 1, H, W]`` -> ``[N, T, output_dim]``."""
        N, T, C, H, W = lips.shape
        xp = F.pad(lips, (0, 0, 0, 0, 0, 0, 2, 2))
        x = torch.cat([xp[:, k:k + T] for k in range(5)], dim=2).reshape(N * T, 5 * C, H, W)
        x = self.conv2d(x, self.P["visual_encoder.frontend_conv.weight"], 2, 3)
        x = self.prelu("visual_encoder.frontend_act",
                       self.batch_norm("visual_encoder.frontend_norm", x))
        x = F.max_pool2d(x, 3, 2, 1)
        v = self.cfg["visual"]
        i = 0
        for stage, n_blocks in enumerate(v["resnet_layers"]):
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                name = f"visual_encoder.trunk.blocks.{i}"
                if self.checkpoint_visual and torch.is_grad_enabled():
                    x = torch.utils.checkpoint.checkpoint(self.basic_block, name, x, stride,
                                                          use_reentrant=False)
                else:
                    x = self.basic_block(name, x, stride)
                i += 1
        x = x.mean(dim=(2, 3)).reshape(N, T, -1)
        if "visual_encoder.proj.weight" in self.P:
            x = self.dense("visual_encoder.proj", x)
        return x

    # -- audio encoder -------------------------------------------------------------

    def conformer_block(self, name, x, valid, attn_mask):
        a = self.cfg["audio"]

        def ffn(sub, x):
            h = self.dropout(F.silu(self.dense(sub + ".fc1", self.layer_norm(sub + ".norm", x))))
            return self.dropout(self.dense(sub + ".fc2", h))

        x = x + 0.5 * ffn(name + ".ff1", x)
        h = self.layer_norm(name + ".attn_norm", x)
        x = x + self.attention(name + ".attn", h, h, a["num_heads"], attn_mask, drop=True)
        c = name + ".conv"
        g, gate = self.dense(c + ".pointwise_in", self.layer_norm(c + ".norm", x)).chunk(2, -1)
        h = torch.where(valid[..., None], g * torch.sigmoid(gate), 0.0)
        h = self.conv1d_same(h, self.P[c + ".depthwise_weight"], self.P[c + ".depthwise_bias"],
                             groups=h.shape[-1])
        h = self.dense(c + ".pointwise_out", F.silu(self.layer_norm(c + ".depthwise_norm", h)))
        x = x + self.dropout(h)
        x = x + 0.5 * ffn(name + ".ff2", x)
        return self.layer_norm(name + ".final_norm", x)

    def audio(self, mel, sample_mask):
        """Log-mel ``[B, T_mel, n_mels]``, sample mask ``[B, S]`` ->
        ``(last, middle, frame_valid)``."""
        a, fe = self.cfg["audio"], self.cfg["frontend"]
        S = sample_mask.shape[1]
        anchors = torch.clamp(torch.arange(mel.shape[1], device=mel.device) * fe["hop_length"],
                              max=S - 1)
        valid = sample_mask.index_select(1, anchors)
        f = a["subsample_factor"]
        x = F.silu(self.conv1d_same(mel, self.P["audio_encoder.subsample_weight"],
                                    self.P["audio_encoder.subsample_bias"], stride=f))
        T = x.shape[1]
        valid = valid[:, ::f][:, :T]
        x = x + self.positions(T, a["d_model"], x.device)[None]
        attn_mask = valid[:, None, None, :] & valid[:, None, :, None]
        hidden = []
        for i in range(a["num_layers"]):
            x = self.conformer_block(f"audio_encoder.blocks.{i}", x, valid, attn_mask)
            hidden.append(x)
        middle = torch.stack([hidden[i] for i in a["middle_layers"]]).mean(dim=0)
        return self.dense("audio_encoder.out_proj", x), middle, valid

    # -- fusion ----------------------------------------------------------------------

    def lstm_layer(self, name, x, valid):
        """Both directions of one BiLSTM layer, ``[B, T, D] -> [B, T, 2H]``."""
        outs = []
        for d in (0, 1):
            w_ih, w_hh = self.P[name + ".w_ih"][d], self.P[name + ".w_hh"][d]
            b = self.P[name + ".b_hh"][d]
            z = F.linear(self.q(x), self.q(w_ih))
            H = w_hh.shape[1]
            h = x.new_zeros(x.shape[0], H)
            c = x.new_zeros(x.shape[0], H)
            ys = [None] * x.shape[1]
            steps = range(x.shape[1]) if d == 0 else reversed(range(x.shape[1]))
            for t in steps:
                gates = z[:, t] + F.linear(self.q(h), self.q(w_hh), b)
                i, f, g, o = gates.chunk(4, dim=-1)
                nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                nh = torch.sigmoid(o) * torch.tanh(nc)
                k = valid[:, t, None]
                c, h = torch.where(k, nc, c), torch.where(k, nh, h)
                ys[t] = torch.where(k, nh, 0.0)
            outs.append(torch.stack(ys, dim=1))
        return torch.cat(outs, dim=-1)

    def temporal(self, x, lengths):
        fu = self.cfg["fusion"]
        T = x.shape[1]
        valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
        if fu["temporal_model"] == "bilstm":
            for i in range(fu["temporal_layers"]):
                x = self.lstm_layer(f"fusion.temporal_bilstm.layers.{i}", x, valid)
            return x
        mask = valid[:, None, None, :] & valid[:, None, :, None]
        x = x + self.positions(T, x.shape[-1], x.device)[None]
        for i in range(fu["temporal_layers"]):
            n = f"fusion.temporal_tf.layers.{i}"
            h = self.layer_norm(n + ".attn_norm", x)
            x = x + self.attention(n + ".attn", h, h, fu["transformer_heads"], mask)
            h = F.gelu(self.dense(n + ".fc1", self.layer_norm(n + ".ffn_norm", x)),
                       approximate="tanh")
            x = x + self.dense(n + ".fc2", h)
        x = self.layer_norm("fusion.temporal_tf.final_norm", x)
        return self.dense("fusion.temporal_out", x)

    def fusion(self, v, a, mask, lengths):
        """Video ``[N, T_v, Dv]``, audio ``[N, T_a, Da]``, speaker mask at the
        audio rate ``[N, T_a]`` -> ``(fused [N, T_v, 2 d], input_lengths [N])``."""
        N, T_v, _ = v.shape
        speech = (mask != OTHER_SOLO) & (mask != PAD)
        order = torch.argsort((~speech).int(), dim=1, stable=True)
        kept = speech.sum(dim=1)
        cvalid = torch.arange(mask.shape[1], device=mask.device)[None] < kept[:, None]
        a_c = torch.where(cvalid[..., None], torch.take_along_dim(a, order[..., None], 1), 0.0)
        m_c = torch.where(cvalid, torch.take_along_dim(mask, order, 1), 0)
        t_in = kept.max().clamp(min=1)
        j = torch.arange(T_v, device=a.device)
        src = j.float() * ((t_in - 1).float() / max(T_v - 1, 1))
        lo = torch.floor(src).long()
        hi = torch.minimum(lo + 1, t_in - 1)
        frac = (src - lo)[None, :, None]
        a_i = a_c[:, lo] + (a_c[:, hi] - a_c[:, lo]) * frac
        m_i = m_c[:, torch.minimum(j * t_in // T_v, t_in - 1)]
        fu = self.cfg["fusion"]
        key_mask = (j[None, :] < lengths[:, None])[:, None, None, :]
        a2v = self.attention("fusion.cross_attn_audio", self.dense("fusion.audio_proj", a_i),
                             self.dense("fusion.visual_proj", v), fu["num_heads"], key_mask)
        fused = self.temporal(self.dense("fusion.fusion_proj", a2v), lengths)
        return fused, (m_i != 0).sum(dim=1)

    # -- the model -------------------------------------------------------------------

    def forward(self, inp: dict, mel: torch.Tensor) -> dict:
        """``inp`` from ``preprocess.model_inputs``; ``mel`` its log-mel."""
        B, T_v = inp["lip1"].shape[:2]
        v = self.visual(torch.cat([inp["lip1"], inp["lip2"]]))
        masks = torch.cat([inp["mask1"], inp["mask2"]])
        if not self.cfg["shared_audio_pass"]:
            raise ValueError("the reference computes the shared audio pass only")
        last, middle, _ = self.audio(mel, (inp["mask1"] != PAD) | (inp["mask2"] != PAD))
        last, middle = torch.cat([last, last]), torch.cat([middle, middle])
        S, T_a = masks.shape[1], last.shape[1]
        mask_ds = masks[:, torch.clamp(torch.arange(T_a, device=masks.device) * S // T_a,
                                       0, S - 1)]
        fused, lengths = self.fusion(v, last, mask_ds, torch.cat([inp["lip1_len"],
                                                                  inp["lip2_len"]]))
        lp = torch.log_softmax(self.dense("decoder.head", fused), dim=-1)
        contrast = self.dense("contrastive_proj", middle)
        return {"log_probs": lp, "input_lengths": lengths, "contrast": contrast,
                "mask_ds": mask_ds, "B": B}

"""AV-HuBERT fine-tuned with CTC, as plain functions of a flat state dict.

Equations (facebookresearch/av_hubert ``avhubert/hubert.py``, ``resnet.py``,
``hubert_asr.py``; arXiv:2201.02184), every product in float32, or on
float8 inputs under ``lowp``; lengths count video frames, and row ``r`` of
the ``[2B]`` batch is speaker ``r // B``'s lips with mixture ``r mod B``:

* audio: the log filterbank of the mixture (``preprocess.log_mel``), its
  frames that run past the mixture's last sample set to 0 (the frames the
  mixture has alone are kept), zero frames to a multiple of 4, four frames
  side by side,
  cut or zero-padded to the video's frames; each row normalised by the mean
  and biased variance of all features of its valid frames (eps 1e-5, no
  affine), padded frames 0; ``Linear(104 -> D)``;
* video: ``model.Net.visual`` (the five-frame frontend, ResNet-18 with
  BatchNorm and PReLU, a global mean, ``Linear(512 -> D)``);
* fusion: ``LayerNorm(concat(audio, video))``, ``Linear(2D -> D)``, padded
  frames 0, plus ``GELU(conv)`` of the weight-normed grouped positional
  convolution (``w = g v / |v|``, each tap's norm over output and input
  channels; padding k / 2, the last frame dropped);
* pre-LN layers: ``x += MHA(LN(x))`` with the padded keys masked, ``x +=
  fc2(GELU(fc1(LN(x))))``, exact GELU; a final LayerNorm (eps 1e-5);
* head: ``Linear(D -> V)``, log-softmax.

Loss: each speaker's CTC negative log-likelihood over its label length,
averaged over the batch, the two speakers averaged; no contrastive term.
Dropout is not modelled: the configuration sets every rate to 0.  With
``checkpoint`` the visual trunk's blocks and the transformer layers are
recomputed in the backward, so the published widths fit in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .model import Net
from .preprocess import PAD

STACK, EPS = 4, 1e-5


def stack_and_fit(fbank: torch.Tensor, order: int, T: int) -> torch.Tensor:
    """``[B, T_f, F] -> [B, T, order * F]``."""
    B, Tf, Fd = fbank.shape
    x = F.pad(fbank, (0, 0, 0, (-Tf) % order)).reshape(B, -1, order * Fd)
    return x[:, :T] if x.shape[1] >= T else F.pad(x, (0, 0, 0, T - x.shape[1]))


def utterance_norm(x: torch.Tensor, lengths: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Each row's valid frames normalised over all their features; the rest 0."""
    out = torch.zeros_like(x)
    for r in range(x.shape[0]):
        n = int(lengths[r])
        if n:
            out[r, :n] = F.layer_norm(x[r, :n], x[r, :n].shape, eps=eps)
    return out


class AVHubertNet(Net):
    """``P``: name -> tensor (the system's state-dict names); ``cfg``: the
    configuration file's ``model`` dict; ``train``: batch statistics in the
    BatchNorms; ``lowp``: float8 operands; ``checkpoint``: recompute the
    trunk's blocks and the layers in the backward."""

    def __init__(self, P: dict, cfg: dict, train: bool = False, lowp: bool = False,
                 checkpoint: bool = False):
        a = cfg["avhubert"]
        if train and any(a[k] for k in ("dropout", "attention_dropout", "activation_dropout")):
            raise ValueError("the reference models no dropout: set the rates to 0")
        super().__init__(P, cfg, gen=None, lowp=lowp, checkpoint_visual=checkpoint)
        self.train, self.checkpoint = train, checkpoint

    def layer_norm(self, name, x):
        return F.layer_norm(x, (x.shape[-1],), self.P[name + ".weight"], self.P[name + ".bias"],
                            EPS)

    def pos_conv(self, x):
        """``[R, T, D]`` (padded frames 0) -> ``GELU(conv)`` ``[R, T, D]``."""
        a = self.cfg["avhubert"]
        v, g = self.P["fusion.pos_conv.weight_v"], self.P["fusion.pos_conv.weight_g"]
        w = v * (g / torch.linalg.vector_norm(v, dim=(0, 1)))
        k = a["conv_pos"]
        h = F.conv1d(self.q(x.transpose(1, 2)), self.q(w), self.P["fusion.pos_conv.bias"],
                     padding=k // 2, groups=a["conv_pos_groups"])
        if k % 2 == 0:
            h = h[..., :-1]
        return F.gelu(h.transpose(1, 2))

    def layer(self, i, x, mask):
        a = self.cfg["avhubert"]
        n = f"encoder.layers.{i}"
        h = self.layer_norm(n + ".attn_norm", x)
        x = x + self.attention(n + ".attn", h, h, a["num_heads"], mask)
        h = F.gelu(self.dense(n + ".fc1", self.layer_norm(n + ".ffn_norm", x)))
        return x + self.dense(n + ".fc2", h)

    def forward(self, inp: dict, fbank: torch.Tensor) -> dict:
        """``inp`` from ``preprocess.model_inputs``; ``fbank`` the mixture's
        log filterbank ``[B, T_f, n_mels]``."""
        a = self.cfg["avhubert"]
        B, T = inp["lip1"].shape[:2]
        lengths = torch.cat([inp["lip1_len"], inp["lip2_len"]])
        valid = torch.arange(T, device=lengths.device)[None] < lengths[:, None]
        video = self.visual(torch.cat([inp["lip1"], inp["lip2"]]))
        fe = self.cfg["frontend"]
        n = (inp["mask1"] != PAD).sum(dim=1) + (fe["n_fft"] if fe["center"] else 0)
        frames = torch.where(n >= fe["n_fft"], 1 + (n - fe["n_fft"]) // fe["hop_length"], 0)
        keep = torch.arange(fbank.shape[1], device=fbank.device)[None] < frames[:, None]
        feats = stack_and_fit(torch.where(keep[..., None], fbank, 0.0), STACK, T)
        audio = self.dense("audio_frontend.proj", utterance_norm(torch.cat([feats, feats]),
                                                                 lengths))
        x = self.dense("fusion.proj", self.layer_norm("fusion.norm",
                                                      torch.cat([audio, video], dim=-1)))
        x = torch.where(valid[..., None], x, 0.0)
        x = x + self.pos_conv(x)
        mask = valid[:, None, None, :]
        for i in range(a["num_layers"]):
            if self.checkpoint and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(self.layer, i, x, mask,
                                                      use_reentrant=False)
            else:
                x = self.layer(i, x, mask)
        x = self.layer_norm("encoder.final_norm", x)
        lp = torch.log_softmax(self.dense("decoder.head", x), dim=-1)
        return {"log_probs": lp, "input_lengths": lengths, "B": B}


def ctc_losses(out: dict, labels: dict, cfg: dict) -> torch.Tensor:
    """The mean over both speakers of each one's batch-mean CTC loss per
    label token (an impossible alignment counts 0)."""
    B, lp, il = out["B"], out["log_probs"], out["input_lengths"]
    total = 0.0
    for s, rows in (("1", slice(0, B)), ("2", slice(B, 2 * B))):
        tgt, ll = labels["text" + s].long(), labels["text" + s + "_lengths"].long()
        per = F.ctc_loss(lp[rows].transpose(0, 1), tgt, il[rows].long(), ll,
                         blank=cfg["decoder"]["blank_id"], reduction="none", zero_infinity=True)
        total = total + (per / ll.clamp(min=1).float()).mean() / 2
    return total

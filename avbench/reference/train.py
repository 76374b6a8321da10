"""One training step of the reference: the losses and two-group Adam.

Loss: for each speaker the CTC negative log-likelihood (blank from the
configuration; an impossible alignment counts 0) over its label length,
averaged over the batch; plus ``lambda_contrastive`` times the mean of the
two speakers' masked contrastive terms.  A contrastive term L2-normalises
the projected audio frames of the whole batch, takes their cosine
similarities over ``temperature`` (in float64), and averages ``-log_softmax``
over (anchor, candidate) cells: anchors are overlap frames, candidates the
target speaker's solo frames (weight ``weight_pos_align``), then the other
speaker's solo frames (weight ``weight_neg_suppress``); the softmax runs over
the candidates alone, and an empty set gives 0.

Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias-corrected) at
``audio_learning_rate`` for the audio encoder and ``learning_rate`` for the
rest, without clipping.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import preprocess
from .model import Net

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def contrastive(feat, mask, cc: dict):
    f = feat.reshape(-1, feat.shape[-1]).double()
    f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12)
    sim = (f @ f.T) / cc["temperature"]
    m = mask.reshape(-1)
    anchors = m == preprocess.OVERLAP

    def term(cands):
        s = torch.where(cands[None, :], sim, -1e30)
        nll = torch.logsumexp(s, dim=1, keepdim=True) - s
        cells = anchors[:, None] & cands[None, :]
        n = cells.sum()
        return torch.where(n > 0, torch.where(cells, nll, 0.0).sum() / n.clamp(min=1), 0.0)

    return (cc["weight_pos_align"] * term(m == preprocess.TARGET_SOLO)
            + cc["weight_neg_suppress"] * term(m == preprocess.OTHER_SOLO)).float()


def losses(net: Net, inp: dict, mel, raw_dev: dict, cfg: dict, train_cfg: dict):
    """-> (total loss, the forward's outputs)."""
    out = net.forward(inp, mel)
    B = out["B"]
    blank = cfg["decoder"]["blank_id"]
    lp, il = out["log_probs"], out["input_lengths"]
    total = 0.0
    for s, rows in (("1", slice(0, B)), ("2", slice(B, 2 * B))):
        labels, ll = raw_dev["text" + s].long(), raw_dev["text" + s + "_lengths"].long()
        per = F.ctc_loss(lp[rows].transpose(0, 1), labels, il[rows].long(), ll, blank=blank,
                         reduction="none", zero_infinity=True)
        ctc = (per / ll.clamp(min=1).float()).mean()
        con = contrastive(out["contrast"][rows], out["mask_ds"][rows], cfg["contrastive"])
        total = total + ctc / 2 + train_cfg["lambda_contrastive"] * con / 2
    return total, out


class Adam:
    """Two-group Adam over the named leaves of ``params``."""

    def __init__(self, params: dict, train_cfg: dict):
        self.params = params
        self.lr = {n: (train_cfg["audio_learning_rate"] if n.startswith("audio_encoder.")
                       else train_cfg["learning_rate"]) for n in params}
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        bc1, bc2 = 1 - BETA1 ** self.t, 1 - BETA2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            self.m[n].mul_(BETA1).add_(g, alpha=1 - BETA1)
            self.v[n].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
            p.sub_(self.lr[n] * (self.m[n] / bc1) / ((self.v[n] / bc2).sqrt() + EPS))

"""Nearest-centroid feature probes on the contrastive features.

Own copy of ``multimodal_av_model_tpu/train/probe.py``: do the model's
per-frame contrastive features (``contrast{n}``, ``models/av_model.py``)
separate the frame classes the masked contrastive loss targets, overlap
against solo?  The outputs may hold tensors (on any device) or arrays.
"""

from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):                 # a torch tensor, possibly on the card
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def collect_frame_features(outputs: list[dict], speaker: int = 1):
    """Per-frame contrastive features and mask labels, stacked over model
    output dicts (``contrast{n}`` ``[B, T, P]``, ``mask_ds{n}`` ``[B, T]``),
    pad frames (3) dropped."""
    feats, labels = [], []
    for out in outputs:
        f = _np(out[f"contrast{speaker}"]).astype(np.float32)
        m = _np(out[f"mask_ds{speaker}"])
        keep = m != 3
        feats.append(f[keep])
        labels.append(m[keep])
    return np.concatenate(feats), np.concatenate(labels)


def nearest_centroid_probe(feats: np.ndarray, labels: np.ndarray, train_frac: float = 0.5,
                           seed: int = 0) -> float:
    """Held-out nearest-centroid accuracy on L2-normalised features: a
    seeded split, one centroid per class from the training half."""
    feats = feats / np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-6)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(feats))
    n_train = int(len(feats) * train_frac)
    tr, te = order[:n_train], order[n_train:]
    classes = np.unique(labels)
    centroids = np.stack([feats[tr][labels[tr] == c].mean(axis=0) for c in classes])
    pred = classes[np.argmax(feats[te] @ centroids.T, axis=-1)]
    return float((pred == labels[te]).mean())


def overlap_vs_solo_labels(mask: np.ndarray) -> np.ndarray:
    """The 3-way mask collapsed to the probe's classes: 1 overlap, 0 solo
    (either speaker's)."""
    return (np.asarray(mask) == 1).astype(np.int32)

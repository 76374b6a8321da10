"""The legacy-v0 sample-directory writer.

Mirrors ``multimodal_av_model_tpu/data/legacy_preprocess.py:26-65``: each
utterance pair's audio is mixed (``mixing.mix_pair``, peak-normalised) into
one ``mixed.wav`` and each side's lip clip is split into per-frame ``.npy``
files, in the layout ``train/legacy.py`` reads
(``sample_NNNN/{frames_A,frames_B,mixed.wav,gt_A.txt,gt_B.txt}``).  An
entry is a ``manifest.SentenceEntry`` or a dict with the same keys.  The text
is ``getattr(entry, "sentence_text", "")``, as in JAX: a ``SentenceEntry``'s
sentence, while a dict has no such attribute, so its text (as any empty one)
is read from ``text_path``.
"""

from __future__ import annotations

import itertools
import os

import numpy as np

from .audio_io import WavCache, write_wav
from .mixing import mix_pair


def build_pair_sample(s1, s2, out_dir: str, sample_rate: int = 16000,
                      wavs: WavCache | None = None) -> str:
    """Write one legacy sample directory for the utterance pair (s1, s2)."""
    wavs = wavs or WavCache(target_sr=sample_rate)
    os.makedirs(out_dir, exist_ok=True)
    a1 = wavs.load_segment(s1["audio_path"], s1["start_time"], s1["end_time"])
    a2 = wavs.load_segment(s2["audio_path"], s2["start_time"], s2["end_time"])
    mixed, _, _ = mix_pair(a1, a2)
    write_wav(os.path.join(out_dir, "mixed.wav"), mixed, sample_rate)

    for side, s in (("A", s1), ("B", s2)):
        frames_dir = os.path.join(out_dir, f"frames_{side}")
        os.makedirs(frames_dir, exist_ok=True)
        clip = np.load(s["lip_path"])
        for t in range(clip.shape[0]):
            np.save(os.path.join(frames_dir, f"{t:05d}.npy"), clip[t])
        text = getattr(s, "sentence_text", "") or ""
        if not text:
            with open(s["text_path"], encoding="utf-8") as f:
                text = f.read().strip()
        with open(os.path.join(out_dir, f"gt_{side}.txt"), "w", encoding="utf-8") as f:
            f.write(text + "\n")
    return out_dir


def build_all_pair_samples(entries, out_root: str, max_pairs: int | None = None,
                           sample_rate: int = 16000) -> list[str]:
    """Every pair of ``entries`` in ``itertools.combinations`` order, at most
    ``max_pairs``, as ``sample_0000``, ``sample_0001``, ..."""
    os.makedirs(out_root, exist_ok=True)
    wavs = WavCache(target_sr=sample_rate)
    dirs = []
    for idx, (s1, s2) in enumerate(itertools.combinations(entries, 2)):
        if max_pairs is not None and idx >= max_pairs:
            break
        out = os.path.join(out_root, f"sample_{idx:04d}")
        dirs.append(build_pair_sample(s1, s2, out, sample_rate, wavs))
    return dirs

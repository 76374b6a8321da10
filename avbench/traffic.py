"""The one generator of the benchmark's inputs, driven by a traffic file.

A traffic file (``avbench/traffic/<mix>.json``) names its runner and gives
the shapes of its raw batches: ``batch`` pairs a batch, lip crops of
``crop`` x ``crop`` x 3 uint8, clips padded to ``bucket`` frames, audio of
``audio_samples_per_frame`` samples a frame.  Speaker 1's clip has ``frames``
frames (a number, or ``[lo, hi]``); speaker 2's clip has as many frames when
``frames2`` is absent and otherwise draws from ``frames2``, and its audio is
``audio2_fraction`` (``[lo, hi]``) of the length its frames give.  Labels
have ``label_len`` tokens (a number or ``[lo, hi]``) below ``vocab``, padded
to ``label_bucket``; ids below ``first_token`` are kept for specials.

Every seed makes the same multiset of sizes: each ``[lo, hi]`` range is
covered by evenly spaced values, one per draw of the pool, and the seed only
shuffles them and fills the contents (uint8 pixels, tones with noise,
labels).  So two seeds do the same work in another order.
"""

from __future__ import annotations

import json
import os

import numpy as np

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traffic")


def load(name: str) -> dict:
    with open(os.path.join(TRAFFIC_DIR, name + ".json")) as f:
        return json.load(f)


def _spread(spec, n: int, rng, integer: bool = True) -> np.ndarray:
    """``n`` values: ``spec`` itself, or evenly spaced over ``[lo, hi]`` and shuffled."""
    if not isinstance(spec, list):
        return np.full(n, spec)
    lo, hi = spec
    vals = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    vals = np.rint(vals).astype(np.int64) if integer else vals
    return rng.permutation(vals)


def raw_batches(mix: dict, seed: int) -> list[dict]:
    """``mix["pool"]`` raw collated batches (numpy) from ``seed``."""
    rng = np.random.default_rng(seed)
    P, B = mix["pool"], mix["batch"]
    n = P * B
    crop, Tv = mix["crop"], mix["bucket"]
    spf = mix["audio_samples_per_frame"]
    S, L = Tv * spf, mix["label_bucket"]
    f1 = _spread(mix["frames"], n, rng)
    f2 = _spread(mix.get("frames2", mix["frames"]), n, rng) if "frames2" in mix else f1
    frac2 = _spread(mix.get("audio2_fraction", 1.0), n, rng, integer=False)
    lab1 = _spread(mix["label_len"], n, rng)
    lab2 = _spread(mix["label_len"], n, rng)
    out = []
    for p in range(P):
        rows = range(p * B, (p + 1) * B)
        batch = {"lip1_raw": np.zeros((B, Tv, crop, crop, 3), np.uint8),
                 "lip2_raw": np.zeros((B, Tv, crop, crop, 3), np.uint8),
                 "audio1": np.zeros((B, S), np.float32), "audio2": np.zeros((B, S), np.float32),
                 "text1": np.zeros((B, L), np.int32), "text2": np.zeros((B, L), np.int32)}
        lens = {k: np.zeros(B, np.int32) for k in ("lip1_lengths", "lip2_lengths", "audio1_len",
                                                     "audio2_len", "text1_lengths",
                                                     "text2_lengths")}
        for b, r in enumerate(rows):
            for s, frames, frac, lab in (("1", f1[r], 1.0, lab1[r]),
                                         ("2", f2[r], frac2[r], lab2[r])):
                T = int(min(frames, Tv))
                batch["lip" + s + "_raw"][b, :T] = rng.integers(0, 256, (T, crop, crop, 3),
                                                                dtype=np.uint8)
                ns = int(min(int(T * spf * frac), S))
                tt = np.arange(ns) / 16000.0
                batch["audio" + s][b, :ns] = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * tt)
                                              + 0.05 * rng.standard_normal(ns))
                nl = int(min(lab, L))
                batch["text" + s][b, :nl] = rng.integers(mix["first_token"], mix["vocab"], nl)
                lens["lip" + s + "_lengths"][b] = T
                lens["audio" + s + "_len"][b] = ns
                lens["text" + s + "_lengths"][b] = nl
        batch.update(lens)
        batch["valid"] = np.ones(B, np.float32)
        out.append(batch)
    return out

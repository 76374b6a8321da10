"""Synthetic corpora on disk in the AI-Hub layout, for end-to-end runs.

Own copy of ``multimodal_av_model_tpu/data/synth_corpus.py:34-190``
(``write_synthetic_corpus``, ``write_raw_media_corpus``): for the same
arguments and seed each writes the same files, byte for byte.
``write_synthetic_corpus`` starts from extracted crops:

* ``input_texts/<base>.json``: a one-element list with ``Sentence_info``,
  ``Video_info`` (``fps``) and ``Audio_info`` (``source_sr``);
* ``wav/<base>.wav``: one source recording per video at ``source_sr``, a
  tone burst over each sentence on noise;
* ``npy/<base>_sentence_<ID>.npy``: uint8 ``[T, 128, 128, 3]`` lip crops,
  ``T = int(duration * fps)``;
* ``text/<base>_sentence_<ID>.txt``: the transcript.

Each video's base name carries its own speaker id (the first 7 ``_``-fields).
One extension: ``sentence_dur`` may be a ``(low, high)`` range, and each
sentence then draws its duration uniformly from it (after its text), so two
sentences of a pair differ in length and the mixture has solo frames (with
one duration for all, the masks are all overlap and the contrastive loss is
exactly 0).

``write_raw_media_corpus`` starts from the media themselves: uncompressed
AVI containers (``data/avi.py:write_avi``) with a bright moving "mouth"
patch, that patch's per-frame box, 48 kHz stereo WAVs and the JSONs; the
crops and transcripts are left for ``data/lip_extract.py:extract_clips`` and
``data/manifest.py:save_all_sentence_labels`` to write.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .audio_io import write_wav


def _sentence_text(tokenizer, rng, min_len=3, max_len=8) -> str:
    """Random in-vocab text (single-character tokens past the specials)."""
    chars = [t for t in tokenizer.id_to_token[5:64] if len(t) == 1 and t != "▁"]
    n = int(rng.integers(min_len, max_len + 1))
    out = []
    for i in range(n):
        out.append(chars[int(rng.integers(0, len(chars)))])
        if i and i < n - 1 and rng.random() < 0.2:
            out.append(" ")
    return "".join(out)


def write_synthetic_corpus(root: str, tokenizer, n_videos: int = 2,
                           sentences_per_video: int = 4, fps: int = 30,
                           source_sr: int = 48000,
                           sentence_dur: float | tuple[float, float] = 0.9,
                           gap: float = 0.3, seed: int = 0) -> dict:
    """Write the corpus under ``root`` -> its directories keyed as the
    ``DataConfig`` fields (``json_folder``, ``npy_dir``, ``text_dir``,
    ``wav_dir``)."""
    rng = np.random.default_rng(seed)
    dirs = {
        "json_folder": os.path.join(root, "input_texts"),
        "npy_dir": os.path.join(root, "npy"),
        "text_dir": os.path.join(root, "text"),
        "wav_dir": os.path.join(root, "wav"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    ranged = isinstance(sentence_dur, (tuple, list))
    longest = max(sentence_dur) if ranged else sentence_dur

    for v in range(n_videos):
        base = f"lip_T_{v + 1}_M_{v + 1:02d}_C{v + 1:03d}_A_001"
        total_dur = sentences_per_video * (longest + gap) + gap
        wav = (rng.standard_normal(int(total_dur * source_sr)) * 0.05).astype(np.float32)

        sentences = []
        for i in range(sentences_per_video):
            start = gap + i * (longest + gap)
            text = _sentence_text(tokenizer, rng)
            dur = float(rng.uniform(*sentence_dur)) if ranged else sentence_dur
            end = start + dur
            sentences.append({"ID": i + 1, "topic": "synthetic", "sentence_text": text,
                              "start_time": round(start, 3), "end_time": round(end, 3)})
            s0, s1 = int(start * source_sr), int(end * source_sr)
            t = np.arange(s1 - s0) / source_sr
            wav[s0:s1] += 0.3 * np.sin(2 * np.pi * (200 + 60 * v + 15 * i) * t).astype(np.float32)

            T = int(dur * fps)
            lips = rng.integers(0, 256, size=(T, 128, 128, 3), dtype=np.uint8)
            np.save(os.path.join(dirs["npy_dir"], f"{base}_sentence_{i + 1}.npy"), lips)
            with open(os.path.join(dirs["text_dir"], f"{base}_sentence_{i + 1}.txt"),
                      "w", encoding="utf-8") as f:
                f.write(text + "\n")

        write_wav(os.path.join(dirs["wav_dir"], base + ".wav"), wav, sr=source_sr)
        meta = [{
            "Video_info": {"FPS": fps, "resolution": "1920x1080"},
            "Audio_info": {"sampling_rate": source_sr, "channel": 1},
            "Sentence_info": sentences,
        }]
        with open(os.path.join(dirs["json_folder"], base + ".json"), "w",
                  encoding="utf-8") as f:
            json.dump(meta, f, ensure_ascii=False)
    return dirs


def write_raw_media_corpus(root: str, tokenizer, n_videos: int = 2,
                           sentences_per_video: int = 3, fps: int = 30,
                           source_sr: int = 48000, width: int = 64, height: int = 48,
                           sentence_dur: float = 0.6, gap: float = 0.2, seed: int = 0) -> dict:
    """Write the raw-media corpus under ``root`` (``synth_corpus.py:112-190``)
    -> its directories: ``json_folder``, ``video_dir`` (``<base>.avi``),
    ``boxes_dir`` (``<base>_boxes.npy``, int32 ``[frames, 4]`` x1, y1, x2,
    y2), ``wav_dir``, and ``text_dir`` and ``npy_dir``, left empty.

    Every number comes from one ``np.random.default_rng(seed)``, in JAX's
    order: per video the frames, then the stereo noise, then each
    sentence's text.  The patch and its boxes are computed, not drawn."""
    from .avi import write_avi

    rng = np.random.default_rng(seed)
    dirs = {
        "json_folder": os.path.join(root, "input_texts"),
        "video_dir": os.path.join(root, "video"),
        "boxes_dir": os.path.join(root, "boxes"),
        "wav_dir": os.path.join(root, "wav"),
        "text_dir": os.path.join(root, "text"),
        "npy_dir": os.path.join(root, "npy"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    for v in range(n_videos):
        base = f"lip_R_{v + 1}_M_{v + 1:02d}_C{v + 1:03d}_A_001"
        total_dur = sentences_per_video * (sentence_dur + gap) + gap
        n_frames = int(total_dur * fps)
        frames = rng.integers(0, 40, size=(n_frames, height, width, 3), dtype=np.uint8)
        bw, bh = 18, 12
        boxes = np.zeros((n_frames, 4), np.int32)
        for t in range(n_frames):
            x1 = int((width - bw - 8) * 0.5 * (1 + np.sin(t / 9.0))) + 4
            y1 = int((height - bh - 8) * 0.5 * (1 + np.cos(t / 7.0))) + 4
            frames[t, y1:y1 + bh, x1:x1 + bw] = 160 + (t * 7) % 80
            boxes[t] = (x1, y1, x1 + bw, y1 + bh)
        write_avi(os.path.join(dirs["video_dir"], base + ".avi"), frames, fps)
        np.save(os.path.join(dirs["boxes_dir"], base + "_boxes.npy"), boxes)

        stereo = (rng.standard_normal((int(total_dur * source_sr), 2)) * 0.05).astype(np.float32)
        sentences = []
        for i in range(sentences_per_video):
            start = gap + i * (sentence_dur + gap)
            end = start + sentence_dur
            sentences.append({"ID": i + 1, "topic": "raw-media",
                              "sentence_text": _sentence_text(tokenizer, rng),
                              "start_time": round(start, 3), "end_time": round(end, 3)})
            s0, s1 = int(start * source_sr), int(end * source_sr)
            t = np.arange(s1 - s0) / source_sr
            tone = 0.3 * np.sin(2 * np.pi * (220 + 50 * v + 20 * i) * t)
            stereo[s0:s1] += tone.astype(np.float32)[:, None]
        write_wav(os.path.join(dirs["wav_dir"], base + ".wav"), stereo, sr=source_sr)
        meta = [{
            "Video_info": {"FPS": fps, "resolution": f"{width}x{height}"},
            "Audio_info": {"sampling_rate": source_sr, "channel": 2},
            "Sentence_info": sentences,
        }]
        with open(os.path.join(dirs["json_folder"], base + ".json"), "w",
                  encoding="utf-8") as f:
            json.dump(meta, f, ensure_ascii=False)
    return dirs

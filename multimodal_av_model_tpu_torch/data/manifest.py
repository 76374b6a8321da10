"""Manifest of the AI-Hub "Lip voice" corpus and its 90/5/5 split.

Own copy of ``multimodal_av_model_tpu/data/manifest.py:27-142``.  Each
``input_texts/<base>.json`` (a one-element list, or the object itself) holds
``Sentence_info: [{ID, topic, sentence_text, start_time, end_time}]``; a
sentence joins ``<npy_dir>/<base>_sentence_<ID>.npy`` (its lip crops),
``<text_dir>/<base>_sentence_<ID>.txt`` (its transcript) and
``<wav_dir>/<base>.wav`` (the whole source recording).  Sentences whose lip
or text file is missing go to a skip list.  The split is a ``random.Random``
shuffle seeded by ``seed``: test first, then val, then train.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass


@dataclass(frozen=True)
class SentenceEntry:
    lip_path: str
    text_path: str
    audio_path: str
    start_time: float
    end_time: float
    sentence_text: str = ""
    sentence_id: int = -1
    base_name: str = ""

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time

    def __getitem__(self, key: str):
        """Mapping-style access, as the reference's dict entries."""
        return getattr(self, key)


def speaker_id_of(path: str) -> str:
    """The first 7 ``_``-fields of the basename name the speaker:
    ``lip_J_1_M_03_C486_A_012_sentence_41`` -> ``lip_J_1_M_03_C486_A``."""
    filename = os.path.splitext(os.path.basename(path))[0]
    return "_".join(filename.split("_")[:7])


def _load_metadata(json_path: str) -> dict:
    with open(json_path, "r", encoding="utf-8") as f:
        payload = json.load(f)
    return payload[0] if isinstance(payload, list) else payload


def build_data_list(json_folder: str, npy_dir: str, text_dir: str, wav_dir: str,
                    require_files: bool = True) -> tuple[list[SentenceEntry], list[str]]:
    """Every sentence of every JSON file (sorted by file name) joined to its
    files -> ``(entries, skipped lip paths)``."""
    entries: list[SentenceEntry] = []
    skipped: list[str] = []
    for filename in sorted(os.listdir(json_folder)):
        if not filename.endswith(".json"):
            continue
        metadata = _load_metadata(os.path.join(json_folder, filename))
        base_name = os.path.splitext(filename)[0]
        wav_path = os.path.join(wav_dir, base_name + ".wav")
        for sent in metadata.get("Sentence_info", []):
            sent_id = sent["ID"]
            lip_path = os.path.join(npy_dir, f"{base_name}_sentence_{sent_id}.npy")
            text_path = os.path.join(text_dir, f"{base_name}_sentence_{sent_id}.txt")
            if require_files and not (os.path.exists(lip_path) and os.path.exists(text_path)):
                skipped.append(lip_path)
                continue
            entries.append(SentenceEntry(
                lip_path=lip_path, text_path=text_path, audio_path=wav_path,
                start_time=float(sent["start_time"]), end_time=float(sent["end_time"]),
                sentence_text=str(sent.get("sentence_text", "")).strip(),
                sentence_id=int(sent_id), base_name=base_name))
    return entries, skipped


def save_sentence_labels(json_path: str, save_dir: str) -> int:
    """One ``<base>_sentence_<ID>.txt`` per sentence -> how many were written."""
    os.makedirs(save_dir, exist_ok=True)
    metadata = _load_metadata(json_path)
    base_name = os.path.splitext(os.path.basename(json_path))[0]
    sentences = metadata["Sentence_info"]
    for sent in sentences:
        out = os.path.join(save_dir, f"{base_name}_sentence_{sent['ID']}.txt")
        with open(out, "w", encoding="utf-8") as f:
            f.write(sent["sentence_text"].strip() + "\n")
    return len(sentences)


def save_all_sentence_labels(json_folder: str, save_dir: str) -> int:
    """``save_sentence_labels`` of every ``*.json`` in ``json_folder``, in
    sorted order -> the sentences written (``manifest.py:118-123``)."""
    total = 0
    for name in sorted(os.listdir(json_folder)):
        if name.endswith(".json"):
            total += save_sentence_labels(os.path.join(json_folder, name), save_dir)
    return total


def train_val_test_split(entries: list, val_frac: float = 0.05, test_frac: float = 0.05,
                         seed: int = 42) -> tuple[list, list, list]:
    """Seeded 90/5/5 split -> ``(train, val, test)``; val and test hold at
    least one entry each when there are any."""
    rng = random.Random(seed)
    shuffled = list(entries)
    rng.shuffle(shuffled)
    n = len(shuffled)
    n_test = max(1, int(round(n * test_frac))) if n else 0
    n_val = max(1, int(round(n * val_frac))) if n else 0
    return (shuffled[n_test + n_val:], shuffled[n_test: n_test + n_val],
            shuffled[:n_test])

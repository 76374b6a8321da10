"""Host data pipeline: pair loading, length-bucketed batching, prefetch.

Mirrors ``multimodal_av_model_tpu/data/pipeline.py:23-261``:

* ``preprocess_lip_clip_host``: ``[T, H, W, C]`` crops -> ``[T, 1, 96, 96]``
  f32 (channel mean, cv2 INTER_LINEAR resize, /255), the resize by the
  native host ops (``runtime/native.py``), as in JAX, or in numpy where they
  did not build;
* ``FilePairSource``: ``load_pair`` (host preprocessing: mixing and lips,
  the ``collate_pairs`` layout) and ``load_pair_raw`` (per-speaker waveforms
  and raw crops for the on-device path, ``collate_pairs_raw``), with source
  WAVs decoded once per file through ``WavCache``;
* ``SyntheticPairSource``: seeded random pairs in the processed layout;
* ``bucketed_batches``: each sample joins the smallest bucket that holds it
  and a bucket's batch goes out when full; leftovers flush padded with their
  last sample, with ``valid`` 0 on the padding rows and ``num_real``;
* ``PrefetchingLoader``: the batch iterator on a worker thread behind a
  bounded queue; with ``device`` set, the worker also copies each array to
  that device (plain blocking copies).  The worker stops when the consumer
  stops reading (it is told so when its iterator is closed, as when ``fit``
  breaks out of an epoch on a signal) instead of waiting on a full queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from ..ops.resize import lerp_table
from .audio_io import WavCache
from .collate import BucketSpec, collate_pairs, pick_bucket
from .mixing import mix_pair


def _resize_bilinear_np(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2 INTER_LINEAR resize over the trailing two axes, with the weights
    of ``ops/resize.py:lerp_table``."""
    ylo, yhi, yf = lerp_table(out_h, images.shape[-2])
    xlo, xhi, xf = lerp_table(out_w, images.shape[-1])
    rows = images[..., ylo, :] + (images[..., yhi, :] - images[..., ylo, :]) * yf[:, None]
    return rows[..., xlo] + (rows[..., xhi] - rows[..., xlo]) * xf


def preprocess_lip_clip_host(lip: np.ndarray, out_size: int = 96) -> np.ndarray:
    """``[T, H, W, C]`` (or grey ``[T, H, W]``) 0..255 -> ``[T, 1, out, out]`` f32."""
    from ..runtime import native

    lip = np.asarray(lip, np.float32)
    if lip.ndim == 4:
        lip = lip.mean(axis=-1)
    resized = native.resize_bilinear(lip, out_size, out_size)
    return (resized / 255.0).astype(np.float32)[:, None, :, :]


class FilePairSource:
    """Per-pair samples from manifest entries, source WAVs cached."""

    def __init__(self, tokenizer, sample_rate: int = 16000, lip_size: int = 96):
        self.tokenizer = tokenizer
        self.lip_size = lip_size
        self._wavs = WavCache(target_sr=sample_rate)

    def _label(self, entry) -> np.ndarray:
        text = getattr(entry, "sentence_text", "") or ""
        if not text:
            with open(entry["text_path"], "r", encoding="utf-8") as f:
                text = f.read().strip()
        return np.asarray(self.tokenizer.encode(text), dtype=np.int64)

    def _audio(self, entry) -> np.ndarray:
        return self._wavs.load_segment(entry["audio_path"], entry["start_time"],
                                       entry["end_time"])

    def load_pair(self, s1, s2) -> dict:
        """Host preprocessing: the mixture, its masks and f32 lips."""
        mixed, mask1, mask2 = mix_pair(self._audio(s1), self._audio(s2))
        lip1 = preprocess_lip_clip_host(np.load(s1["lip_path"]), self.lip_size)
        lip2 = preprocess_lip_clip_host(np.load(s2["lip_path"]), self.lip_size)
        if lip1.shape[0] == 0 or lip2.shape[0] == 0:
            raise RuntimeError("empty lip clip")
        return {"audio": mixed, "mask1": mask1, "mask2": mask2,
                "lip1": lip1, "label1": self._label(s1), "lip1_len": lip1.shape[0],
                "lip2": lip2, "label2": self._label(s2), "lip2_len": lip2.shape[0]}

    def load_pair_raw(self, s1, s2) -> dict:
        """Decode only: per-speaker waveforms and the crops as stored."""
        def raw_lips(path):
            lips = np.load(path)
            if lips.ndim == 3:                  # grey [T, H, W]
                lips = lips[..., None]
            if lips.shape[0] == 0:
                raise RuntimeError("empty lip clip")
            return lips

        a1, a2 = self._audio(s1), self._audio(s2)
        lip1, lip2 = raw_lips(s1["lip_path"]), raw_lips(s2["lip_path"])
        return {"audio1": a1, "audio2": a2,
                "lip1_raw": lip1, "label1": self._label(s1), "lip1_len": lip1.shape[0],
                "lip2_raw": lip2, "label2": self._label(s2), "lip2_len": lip2.shape[0]}


class SyntheticPairSource:
    """Seeded random pairs at realistic shapes, in the processed layout."""

    def __init__(self, tokenizer, seed: int = 0, video_frames: tuple[int, int] = (24, 64),
                 fps: int = 30, sample_rate: int = 16000, lip_size: int = 96,
                 label_len: tuple[int, int] = (5, 25)):
        self.tokenizer = tokenizer
        self.rng = np.random.default_rng(seed)
        self.video_frames = video_frames
        self.fps = fps
        self.sample_rate = sample_rate
        self.lip_size = lip_size
        self.label_len = label_len

    def _one_utterance(self):
        T = int(self.rng.integers(*self.video_frames))
        n_samples = int(T / self.fps * self.sample_rate)
        audio = self.rng.standard_normal(n_samples).astype(np.float32) * 0.1
        lip = self.rng.uniform(0, 1, size=(T, 1, self.lip_size, self.lip_size)).astype(np.float32)
        L = int(self.rng.integers(*self.label_len))
        label = self.rng.integers(5, self.tokenizer.vocab_size, size=L).astype(np.int64)
        return audio, lip, label

    def load_pair(self, *_args) -> dict:
        a1, lip1, label1 = self._one_utterance()
        a2, lip2, label2 = self._one_utterance()
        mixed, mask1, mask2 = mix_pair(a1, a2)
        return {"audio": mixed, "mask1": mask1, "mask2": mask2,
                "lip1": lip1, "label1": label1, "lip1_len": lip1.shape[0],
                "lip2": lip2, "label2": label2, "lip2_len": lip2.shape[0]}


def bucketed_batches(sample_iter: Iterable[dict], specs: Sequence[BucketSpec], batch_size: int,
                     drop_last: bool = False, collate_fn: Callable = collate_pairs
                     ) -> Iterator[dict]:
    """Group samples by bucket into fixed-shape batches; ``collate_fn`` picks
    the layout (``collate_pairs`` or ``collate_pairs_raw``)."""

    def lengths(sample):
        if "audio" in sample:
            return sample["lip1_len"], len(sample["audio"])
        return sample["lip1_len"], max(len(sample["audio1"]), len(sample["audio2"]))

    pending: dict[BucketSpec, list[dict]] = {s: [] for s in specs}
    for sample in sample_iter:
        spec = pick_bucket(specs, *lengths(sample))
        pending[spec].append(sample)
        if len(pending[spec]) == batch_size:
            yield collate_fn(pending[spec], spec)
            pending[spec] = []
    if not drop_last:
        for spec, samples in pending.items():
            if samples:
                n_real = len(samples)
                while len(samples) < batch_size:
                    samples.append(samples[-1])
                batch = collate_fn(samples, spec)
                batch["num_real"] = np.int32(n_real)
                batch["valid"][n_real:] = 0.0   # flush rows carry no loss weight
                yield batch


def _place(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v for k, v in batch.items()}


class PrefetchingLoader:
    """Runs a batch-iterator factory on a worker thread behind a queue of
    ``depth`` batches, re-invoking the factory on every iteration."""

    _DONE = object()

    def __init__(self, batch_factory: Callable[[], Iterable[dict]], depth: int = 2,
                 device=None):
        self.batch_factory = batch_factory
        self.depth = depth
        self.device = device

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err: list[BaseException] = []
        closed = threading.Event()

        def put(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in self.batch_factory():
                    if self.device is not None:
                        batch = _place(batch, self.device)
                    if not put(batch):
                        return
            except BaseException as e:          # surfaced on the consumer
                err.append(e)
            finally:
                put(self._DONE)

        threading.Thread(target=worker, daemon=True, name="prefetch").start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            closed.set()

"""Faults planted in the system under test, for the tests and the calibration
runs that show ``correct`` coming out false: each patches one function of the
timed path while the context is open.

* ``unchanged``: a training step whose optimizer leaves the state as it was;
* ``half``: half of the batch left out, the mean taken over the rest: a
  training step's loss over the first half of the rows (its forward keeps
  every row), a request's forward over the first half;
* ``token``: one decoded id altered where the decode produces it.
"""

from __future__ import annotations

import contextlib


def _half(batch: dict) -> dict:
    """The first half of the rows of a batch."""
    B = batch["lip1"].shape[0]
    return {k: (v[: B // 2] if getattr(v, "ndim", 0) and v.shape[0] == B else v)
            for k, v in batch.items()}


@contextlib.contextmanager
def planted(fault: str, kind: str):
    import torch

    from multimodal_av_model_tpu_torch import infer
    from multimodal_av_model_tpu_torch.train import trainer

    if fault == "unchanged":
        target, name = trainer.GroupAdam, "step"
        def new(self):
            return True
    elif fault == "half" and kind == "train":
        target, name = trainer.MultiSpeakerTrainer, "_place"
        place = trainer.MultiSpeakerTrainer._place
        def new(self, batch):
            placed = place(self, batch)
            B = placed["lip1"].shape[0]
            rows = torch.arange(B, device=placed["lip1"].device)
            return {**placed, "valid": (rows < B // 2).float()}
    elif fault == "half":
        target, name = infer.Transcriber, "transcribe"
        transcribe = infer.Transcriber.transcribe
        def new(self, batch, use_beam=True):
            return transcribe(self, _half(batch), use_beam)
    elif fault == "token":
        target, name = infer, "decode_ids"
        decode = infer.decode_ids

        def new(*args, **kwargs):
            ids, lens = decode(*args, **kwargs)
            ids, lens = ids.clone(), lens.clone()
            ids[0, 0] = 7 if int(ids[0, 0]) != 7 else 8
            lens[0] = max(int(lens[0]), 1)
            return ids, lens
    else:
        raise ValueError(f"no fault {fault!r} for a {kind} cell")
    before = getattr(target, name)
    setattr(target, name, new)
    try:
        yield
    finally:
        setattr(target, name, before)


FAULTS = {"train": ("unchanged", "half"), "transcribe": ("half", "token")}

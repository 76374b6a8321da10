"""Checkpoints with the rolling last / best-WER / best-loss policy.

Mirrors ``multimodal_av_model_tpu/train/checkpoints.py:29-43,127-162,204-320``
in the synchronous single-file layout: a checkpoint is one ``torch.save``
file of a tree (dicts, lists, numbers, tensors; an object with
``state_dict()``, such as the ``TrainState``, is saved as its state dict),
written atomically through a temporary file and ``os.replace``.
``restore_checkpoint`` loads into a template: each object of the template
that has ``load_state_dict`` takes its saved state.  ``graft_subtree`` is
the visual-encoder-only load.  The asynchronous writer and the sharded
layout are not ported.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import torch


def _to_saved(tree: Any) -> Any:
    if hasattr(tree, "state_dict"):
        return tree.state_dict()
    if isinstance(tree, dict):
        return {k: _to_saved(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, tree: Any) -> None:
    """Atomic single-file checkpoint write (``path`` is a file)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".ckpt-")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_to_saved(tree), f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _restore_into(template: Any, saved: Any) -> Any:
    if hasattr(template, "load_state_dict"):
        template.load_state_dict(saved)
        return template
    if isinstance(template, dict):
        return {k: _restore_into(template[k], saved[k]) if k in template else saved[k]
                for k in saved}
    return saved


def restore_checkpoint(path: str, template: Any = None) -> Any:
    """Load a checkpoint file (tensors on the CPU).  With ``template``, each
    object in it that has ``load_state_dict`` takes its saved state and is
    returned in its place."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return saved if template is None else _restore_into(template, saved)


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(path)


def graft_subtree(target: dict, source: dict, prefixes: list[str]) -> dict:
    """``target`` (a state dict) with every entry under each dotted prefix
    taken from ``source``: the partial restore that loads a pretrained
    visual encoder into a fresh model (``checkpoints.py:146-162``)."""
    out = dict(target)
    for prefix in prefixes:
        keys = [k for k in target if k == prefix or k.startswith(prefix + ".")]
        if not keys:
            raise KeyError(f"target has no {prefix}")
        for k in keys:
            out[k] = source[k]
    return out


class CheckpointManager:
    """``last`` every epoch, ``best_wer`` and ``best_loss`` on improvement,
    and a ``best.json`` sidecar holding the bests and the early-stop count,
    so a resumed run keeps them (``checkpoints.py:204-320``, file layout,
    synchronous writes)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.last = os.path.join(directory, "last.ckpt")
        self.best_wer = os.path.join(directory, "best_wer.ckpt")
        self.best_loss = os.path.join(directory, "best_loss.ckpt")
        self._best_path = os.path.join(directory, "best.json")
        self._best_wer = float("inf")
        self._best_loss = float("inf")
        self._no_improve = 0
        if os.path.isfile(self._best_path):
            try:
                with open(self._best_path) as f:
                    best = json.load(f)
                self._best_wer = float(best.get("best_wer", float("inf")))
                self._best_loss = float(best.get("best_loss", float("inf")))
                self._no_improve = int(best.get("no_improve", 0))
            except (ValueError, OSError):
                pass  # unreadable sidecar: fresh bests

    def _save_best(self) -> None:
        tmp = self._best_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"best_wer": self._best_wer, "best_loss": self._best_loss,
                       "no_improve": self._no_improve}, f)
        os.replace(tmp, self._best_path)

    def early_stop_state(self) -> tuple[float, int]:
        """(best eval loss, epochs since improvement) from the sidecar."""
        return self._best_loss, self._no_improve

    def set_no_improve(self, n: int) -> None:
        self._no_improve = int(n)
        self._save_best()

    def on_epoch_end(self, tree: Any, eval_loss: float, eval_wer: float) -> dict:
        saved = {"last": True, "best_wer": False, "best_loss": False}
        paths = [self.last]
        if eval_wer < self._best_wer:
            self._best_wer = eval_wer
            paths.append(self.best_wer)
            saved["best_wer"] = True
        if eval_loss < self._best_loss:
            self._best_loss = eval_loss
            paths.append(self.best_loss)
            saved["best_loss"] = True
        tree = _to_saved(tree)              # one snapshot for every file
        for p in paths:
            save_checkpoint(p, tree)
        if saved["best_wer"] or saved["best_loss"]:
            self._save_best()
        return saved

    def exists(self) -> bool:
        """Is there a committed ``last`` checkpoint to resume from?"""
        return checkpoint_exists(self.last)

    def try_resume(self, template: Any = None) -> Any | None:
        if not self.exists():
            return None
        return restore_checkpoint(self.last, template)

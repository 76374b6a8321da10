"""Checkpoints with the rolling last / best-WER / best-loss policy.

Mirrors ``multimodal_av_model_tpu/train/checkpoints.py:29-320`` in the
single-file layout: a checkpoint is one ``torch.save`` file of a tree (dicts,
lists, numbers, tensors; an object with ``state_dict()``, such as the
``TrainState``, is saved as its state dict), written atomically through a
temporary file and ``os.replace``.  Port checkpoints are not JAX (msgpack)
checkpoints; a JAX ``TrainState`` crosses through
``compat/from_jax.py:train_state_from_jax``.

* ``restore_checkpoint`` loads into a template: each object of the template
  that has ``load_state_dict`` takes its saved state;
* ``graft_subtree`` is the visual-encoder-only load;
* ``AsyncCheckpointer`` writes on a background thread.  The JAX writer may
  queue the live tree because JAX arrays are immutable
  (``checkpoints.py:72-76``); the port's state dict tensors are the
  parameters themselves, which the next optimizer step updates in place, so
  ``save`` first copies every tensor to host memory on the calling thread
  (``host_snapshot``) and only serialisation and disk IO go to the thread;
* ``average_checkpoints`` is the uniform "model soup" of the model's
  floating tensors;
* ``CheckpointManager`` keeps ``last``, ``best_wer`` and ``best_loss`` and a
  ``best.json`` sidecar; ``layout="sharded"`` writes DCP directories
  (``sharded_checkpoints.py``) under the same names.

In a run over a mesh (several processes), the file layout is written by rank
0 alone, of the whole state: ``host_snapshot`` gathers each split tensor
whole, which every rank must call, and only rank 0 writes files (checkpoints,
``best.json``).
"""

from __future__ import annotations

import io
import json
import os
import queue
import tempfile
import threading
from typing import Any

import torch


def _to_saved(tree: Any) -> Any:
    if hasattr(tree, "state_dict"):
        return tree.state_dict()
    if isinstance(tree, dict):
        return {k: _to_saved(v) for k, v in tree.items()}
    return tree


def writes_files() -> bool:
    """Whether this process writes checkpoint files: rank 0 of a process
    group, or a process outside one."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def host_snapshot(tree: Any) -> Any:
    """The saved form of ``tree`` with every tensor copied whole to host
    memory (a tensor split over a mesh is gathered: every rank calls this):
    later in-place updates of the live tensors do not reach it."""
    tree = _to_saved(tree)
    if isinstance(tree, torch.Tensor):
        from ..parallel import full_tensor

        return full_tensor(tree.detach()).to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_snapshot(v) for k, v in tree.items()}
    return tree


def _write_atomic(path: str, data: bytes) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".ckpt-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _write_files(snapshot: Any, paths: list[str]) -> None:
    """Serialise a host snapshot once and write it to every path (on the
    process that writes files)."""
    if not writes_files():
        return
    buf = io.BytesIO()
    torch.save(snapshot, buf)
    for p in paths:
        _write_atomic(p, buf.getbuffer())


def save_checkpoint(path: str, tree: Any) -> None:
    """Atomic single-file checkpoint write (``path`` is a file)."""
    _write_files(host_snapshot(tree), [path])


class AsyncCheckpointer:
    """Checkpoint writes on one background thread, in order.  ``save``
    returns once the snapshot is in host memory; a write's error surfaces on
    the next ``save`` or ``wait``.  ``wait`` before reading a file this
    writer may still be writing."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                snapshot, paths = item
                if self._error is None:
                    _write_files(snapshot, paths)
            except BaseException as e:          # surfaced on wait()
                self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def save(self, tree: Any, paths: list[str]) -> None:
        self._raise_pending()
        self._q.put((host_snapshot(tree), list(paths)))

    def wait(self) -> None:
        """Block until every queued write is on disk; re-raise a failure."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()


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


def average_checkpoints(paths: list[str]) -> dict:
    """Element-wise mean of the model's floating tensors (parameters and
    BatchNorm statistics) over checkpoint files of one training run
    (``checkpoints.py:165-201``).  Returns the first file's payload with the
    means in place; other tensors (integers) and the optimizer state stay the
    first file's.  For serving and eval, not for resuming."""
    if not paths:
        raise ValueError("average_checkpoints needs at least one path")
    payloads = [restore_checkpoint(p) for p in paths]

    def model_of(payload):
        state = payload.get("state", payload)
        return state.get("model", state)

    out = payloads[0]
    models = [model_of(p) for p in payloads]
    target = model_of(out)
    for name, first in models[0].items():
        if torch.is_tensor(first) and first.is_floating_point():
            acc = sum(m[name].to(torch.float64) for m in models)
            target[name] = (acc / len(models)).to(first.dtype)
    return out


class CheckpointManager:
    """``last`` every epoch, ``best_wer`` and ``best_loss`` on improvement,
    and a ``best.json`` sidecar holding the bests and the early-stop count,
    so a resumed run keeps them (``checkpoints.py:204-320``).  With
    ``async_io`` the epoch's files are written by an ``AsyncCheckpointer``;
    ``wait`` (``fit`` calls it at exit) drains it.

    ``layout="sharded"``: each checkpoint is a directory that every rank
    writes its shards into (``sharded_checkpoints.save_sharded``), under the
    same names and rolling policy.  Those writes are collective and always
    synchronous: a barrier on a writer thread against a peer that already
    crashed would hang instead of failing."""

    def __init__(self, directory: str, async_io: bool = False, layout: str = "file"):
        if layout not in ("file", "sharded"):
            raise ValueError(f"unknown checkpoint layout {layout!r}")
        self.dir = directory
        self._layout = layout
        self._async = AsyncCheckpointer() if async_io and layout == "file" else None
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

    def _write(self, tree: Any, paths: list[str]) -> None:
        if self._layout == "sharded":
            from .sharded_checkpoints import save_sharded

            for p in paths:
                save_sharded(p, tree)
        elif self._async is not None:
            self._async.save(tree, paths)
        else:
            _write_files(host_snapshot(tree), paths)

    def _save_best(self) -> None:
        if not writes_files():
            return
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
        self._write(tree, paths)
        if saved["best_wer"] or saved["best_loss"]:
            self._save_best()
        return saved

    def save_now(self, tree: Any) -> None:
        """Synchronous ``last.ckpt`` write (the preemption path), after the
        queued writes, so ``last`` is the newest."""
        self.wait()
        if self._layout == "sharded":
            from .sharded_checkpoints import save_sharded

            save_sharded(self.last, tree)
        else:
            save_checkpoint(self.last, tree)

    def wait(self) -> None:
        """Drain the queued writes (nothing to do when synchronous)."""
        if self._async is not None:
            self._async.wait()

    def exists(self) -> bool:
        """Is there a committed ``last`` checkpoint to resume from?"""
        if self._layout == "sharded":
            from .sharded_checkpoints import sharded_checkpoint_exists

            return sharded_checkpoint_exists(self.last)
        return checkpoint_exists(self.last)

    def try_resume(self, template: Any = None) -> Any | None:
        self.wait()
        if not self.exists():
            return None
        if self._layout == "sharded":
            from .sharded_checkpoints import restore_sharded

            return restore_sharded(self.last, template)
        return restore_checkpoint(self.last, template)

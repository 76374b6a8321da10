"""Sharded (gather-free) checkpoints of state split over a mesh, with
``torch.distributed.checkpoint`` (DCP).

Mirrors ``multimodal_av_model_tpu/train/sharded_checkpoints.py:1-261``.  The
file layout (``checkpoints.py``) gathers every tensor whole onto one host;
for FSDP and tensor-parallel state that re-assembles on one process what the
mesh spreads over all of them.  Here:

* ``save_sharded`` writes, on every rank, only the shards that rank owns
  (DCP plans the writes: a tensor replicated over ranks is written once).
  The save goes into ``<dir>.tmp``; after every rank has finished, rank 0
  writes a ``COMMITTED`` marker and renames the directory into place, so a
  crashed save never replaces the previous checkpoint and is never read;
* ``sharded_checkpoint_exists`` is true only when the marker is there;
* ``restore_sharded`` reads into the *template's* layout, whatever layout
  the checkpoint was written under (FSDP x TP -> one process, DP -> FSDP):
  DCP reads each shard's global region from whichever files hold it.

Every rank of the process group calls both (they are collective).  Numbers,
the epoch and other non-tensor leaves ride in DCP's metadata.  An object in
the tree with ``sharded_state_dict`` (the ``TrainState``) is saved as that,
else as its ``state_dict()``, and takes the restored values through
``load_state_dict``.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

MARKER = "COMMITTED"


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _state_of(tree: Any) -> Any:
    if hasattr(tree, "sharded_state_dict"):
        return tree.sharded_state_dict()
    if hasattr(tree, "state_dict"):
        return tree.state_dict()
    if isinstance(tree, dict):
        return {k: _state_of(v) for k, v in tree.items()}
    return tree


def save_sharded(directory: str, tree: Any) -> None:
    """Write ``tree`` as a sharded checkpoint directory (collective)."""
    import torch.distributed.checkpoint as dcp

    directory = os.path.abspath(directory)
    tmp = directory + ".tmp"
    if _rank() == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _barrier()
    dcp.save(_state_of(tree), checkpoint_id=tmp)
    _barrier()
    if _rank() == 0:
        with open(os.path.join(tmp, MARKER), "w") as f:
            f.write("ok\n")
        shutil.rmtree(directory, ignore_errors=True)
        os.replace(tmp, directory)
    _barrier()


def sharded_checkpoint_exists(directory: str) -> bool:
    return os.path.isfile(os.path.join(directory, MARKER))


def _restore_into(template: Any, state: Any) -> Any:
    if hasattr(template, "load_state_dict"):
        template.load_state_dict(state)
        return template
    if isinstance(template, dict):
        return {k: _restore_into(template[k], state[k]) for k in template}
    return state


def restore_sharded(directory: str, template: Any) -> Any:
    """Read a committed sharded checkpoint into ``template``'s structure and
    layout (collective) and return the template with the values in place
    (non-tensor leaves are returned as read)."""
    import torch.distributed.checkpoint as dcp

    if template is None:
        raise ValueError("restore_sharded needs a template: its tensors' layouts "
                         "define the restored layout")
    directory = os.path.abspath(directory)
    if not sharded_checkpoint_exists(directory):
        raise FileNotFoundError(f"no committed sharded checkpoint at {directory}")
    state = _state_of(template)
    dcp.load(state, checkpoint_id=directory)
    return _restore_into(template, state)

"""Run a function on the ranks of a gloo process group on the CPU, one
spawned process per rank: how the mesh paths are exercised without several
cards (``graft_entry.dryrun_multichip``, the tests).

The ranks meet through a file (``init_method="file://..."``), not a port, so
several groups can run side by side.  Each child runs with one thread and
imports only torch and this package.  ``run_ranks`` joins every child with a
deadline and kills them all if one hangs or fails.

``meshed_train_steps`` is the rank function of the meshed training step: the
flagship at a ``(data, model)`` layout, some steps on a global batch cut into
each rank's rows, and (from rank 0) a file with what the tests compare.
"""

from __future__ import annotations

import multiprocessing
import os
import time
from multiprocessing.connection import wait


def _child(fn, rank: int, world: int, init_file: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, workdir: str, args: tuple = (), timeout: float = 300.0) -> None:
    """``fn(*args)`` on each of ``world`` gloo ranks, spawned, rendezvousing
    through a file under ``workdir``.  Raises if a rank fails or the group
    is not done within ``timeout`` seconds (every child is then killed)."""
    os.makedirs(workdir, exist_ok=True)
    init_file = os.path.join(workdir, "rdzv")
    if os.path.exists(init_file):
        os.unlink(init_file)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, init_file, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        running = {p.sentinel: r for r, p in enumerate(procs)}
        while running:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(running.values())} of {world} still "
                                   f"running after {timeout:.0f} s")
            for sentinel in wait(list(running), left):
                rank = running.pop(sentinel)
                procs[rank].join()
                if procs[rank].exitcode != 0:
                    raise RuntimeError(f"rank {rank} of {world} failed "
                                       f"(exit code {procs[rank].exitcode})")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)


def meshed_train_steps(jobs: list[dict], vocab_path: str, batch: dict) -> None:
    """On one rank, for each job of ``jobs`` in turn: the flagship
    ``MultiSpeakerTrainer`` at ``job["cfg"]`` over a ``(world / m, m)`` CPU
    mesh (``m = job["model_parallel"]``, default 1; FSDP with
    ``job["fsdp"]``), seeded by 0, then the state ``job["state_dict"]`` or the
    sharded checkpoint ``job["restore_from"]`` loaded if given,
    ``job["steps"]`` train steps on this rank's rows of ``batch``, a sharded
    checkpoint written to ``job["save_to"]`` if given, and a greedy
    ``evaluate`` of the rows.  Rank 0 saves ``{"mesh": (data, model),
    "metrics": [per step], "grads": [per step], "state": the whole final
    state, "eval": evaluate's result, "adam_foreach": Adam's choice}`` to
    ``job["out"]``."""
    import torch

    from ..models import MultiSpeakerAVModel
    from ..text import CharTokenizer
    from ..train import MultiSpeakerTrainer
    from ..train.checkpoints import host_snapshot
    from ..train.sharded_checkpoints import restore_sharded, save_sharded
    from .mesh import full_tensor, make_mesh, process_rows

    tok = CharTokenizer(vocab_path)
    for job in jobs:
        mesh = make_mesh(model_parallel=job.get("model_parallel", 1), device_type="cpu")
        rows = process_rows(mesh, batch)
        cfg = job["cfg"]
        trainer = MultiSpeakerTrainer(cfg, MultiSpeakerAVModel(cfg.model), tok, device="cpu",
                                      mesh=mesh, fsdp=job.get("fsdp", False))
        state = trainer.init_state(0)
        if job.get("state_dict") is not None:
            state.load_state_dict(job["state_dict"])
        if job.get("restore_from"):
            restore_sharded(job["restore_from"], {"state": state, "epoch": 0})
        metrics, grads = [], []
        for _ in range(job.get("steps", 0)):
            state, m = trainer.train_step(state, rows)
            metrics.append({k: float(v) for k, v in m.items()})
            grads.append({n: full_tensor(p.grad).clone()
                          for n, p in state.model.named_parameters() if p.grad is not None})
        if job.get("save_to"):
            save_sharded(job["save_to"], {"state": state, "epoch": len(metrics)})
        snapshot = host_snapshot(state)
        evaluated = trainer.evaluate([rows], state, use_beam=False)
        if torch.distributed.get_rank() == 0:
            torch.save({"mesh": tuple(mesh.shape), "metrics": metrics, "grads": grads,
                        "state": snapshot, "eval": evaluated,
                        "adam_foreach": state.optimizer.adam.defaults["foreach"]}, job["out"])

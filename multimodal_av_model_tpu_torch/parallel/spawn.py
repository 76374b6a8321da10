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
``sequence_cases``, ``longform_cases`` and ``pipeline_cases`` run
``parallel/{sequence,longform,pp}.py`` on given inputs for the tests;
``pipeline_leg`` is ``graft_entry.dryrun_multichip``'s pipeline leg.
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


def _save_on_rank0(obj, out: str) -> None:
    import torch
    import torch.distributed as dist

    if dist.get_rank() == 0:
        torch.save(obj, out)


def sequence_cases(cases: list[dict], out: str) -> None:
    """On one rank of a ``(world,)`` mesh named ``data``: for each case,
    ``{"fn": a function name of parallel/sequence.py, "q", "k", "v": the whole
    arrays or tensors, "w": the whole cotangent or None}``, this rank's time blocks (in
    the case's dtype: that of ``q``) through the sharded function, and with
    ``w`` the backward of ``sum(out * w)``.  Rank 0 saves, per case, the
    whole output and, with ``w``, the whole gradients ``dq, dk, dv``
    (gathered along time) to ``out``."""
    import torch

    from . import sequence
    from .mesh import make_named_mesh

    mesh = make_named_mesh((torch.distributed.get_world_size(),), ("data",), "cpu")
    results = []
    for case in cases:
        dim = 1 if case["fn"].endswith("_batched") else 0
        q, k, v = (sequence.local_block(torch.as_tensor(case[n]), mesh, "data", dim)
                   .clone().requires_grad_(case.get("w") is not None) for n in "qkv")
        got = getattr(sequence, case["fn"])(q, k, v, mesh, "data")
        res = {"out": sequence.gather_time(got.detach(), mesh, "data", dim)}
        if case.get("w") is not None:
            w = sequence.local_block(torch.as_tensor(case["w"]), mesh, "data", dim)
            (got.float() * w).sum().backward()
            res.update({f"d{n}": sequence.gather_time(t.grad, mesh, "data", dim)
                        for n, t in zip("qkv", (q, k, v))})
        results.append(res)
    _save_on_rank0(results, out)


def longform_cases(model_cfg, state_dict: dict, jobs: list[dict], out: str) -> None:
    """On one rank of the ``(world, 1)`` mesh: for each job, ``{"impl",
    "audio": [B, S], "sample_mask": [B, S] or None}``, the long-form encoder
    (``make_cp_audio_encoder(model_cfg, mesh, "data", impl)`` loaded with
    ``state_dict``) in eval mode.  Rank 0 saves per job ``{"last",
    "middle", "frame_valid"}`` or ``{"error": the ValueError's text}``."""
    import torch

    from .longform import make_cp_audio_encoder
    from .mesh import make_mesh

    mesh = make_mesh(model_parallel=1, device_type="cpu")
    results = []
    for job in jobs:
        enc = make_cp_audio_encoder(model_cfg, mesh, "data", job["impl"]).eval()
        enc.load_state_dict(state_dict)
        mask = job.get("sample_mask")
        try:
            with torch.no_grad():
                last, middle, valid = enc(torch.from_numpy(job["audio"]),
                                          None if mask is None else torch.from_numpy(mask))
            results.append({"last": last, "middle": middle, "frame_valid": valid})
        except ValueError as e:
            results.append({"error": str(e)})
    _save_on_rank0(results, out)


def pipeline_cases(block_args: tuple, stacked: dict, jobs: list[dict], out: str) -> None:
    """On one rank of a ``(world / 4, 4)`` mesh named ``("data", "pipe")``:
    this stage's ``ConformerBlock(*block_args)``s from ``stacked``, then for
    each job, ``{"x", "frame_valid", "attn_mask": the whole numpy batch,
    "microbatches": M, "data_axis": None or "data", "grad": bool}``,
    ``pipeline_blocks`` and, with ``grad``, the backward of
    ``sum(y * frame_valid)``, the stage's gradients summed over ``data`` (the
    caller's part with ``data_axis``) and put together over ``pipe`` into
    ``{name: [L, ...]}``.  Rank 0 saves per job ``{"y", "grads"}`` to
    ``out``."""
    import torch
    import torch.distributed as dist

    from ..models.audio import ConformerBlock
    from .mesh import make_named_mesh
    from .pp import PIPE_AXIS, pipeline_blocks, shard_stacked_params, stage_layers

    mesh = make_named_mesh((dist.get_world_size() // 4, 4), ("data", PIPE_AXIS), "cpu")
    stacked = {n: torch.as_tensor(t) for n, t in stacked.items()}
    blocks = shard_stacked_params(stacked, mesh, lambda: ConformerBlock(*block_args)).eval()
    layers = stage_layers(next(iter(stacked.values())).shape[0], mesh)
    results = []
    for job in jobs:
        x, valid, amask = (torch.from_numpy(job[k]) for k in ("x", "frame_valid", "attn_mask"))
        y = pipeline_blocks(blocks, x, valid, amask, mesh, job["microbatches"],
                            job.get("data_axis"))
        res = {"y": y.detach()}
        if job.get("grad"):
            (y * valid[..., None]).sum().backward()
            grads = {n: torch.zeros_like(t) for n, t in stacked.items()}
            for j, i in enumerate(layers):
                for n, p in blocks[j].named_parameters():
                    grads[n][i] = p.grad
            for g in grads.values():
                if job.get("data_axis"):
                    dist.all_reduce(g, group=mesh["data"].get_group())
                dist.all_reduce(g, group=mesh[PIPE_AXIS].get_group())
            blocks.zero_grad()
            res["grads"] = grads
        results.append(res)
    _save_on_rank0(results, out)


def pipeline_leg(out: str, num_layers: int = 4, dim: int = 16, T: int = 8,
                 microbatches: int = 2) -> None:
    """``dryrun_multichip``'s pipeline leg (``__graft_entry__.py:221-297``) on
    one rank of a ``(world / 4, 4)`` ``("data", "pipe")`` mesh: ``num_layers``
    seeded ``ConformerBlock(dim, 2 heads, FFN 32, kernel 3)``s, a batch of
    ``4 x data`` rows of ``T`` frames in ``microbatches``; the pipelined
    forward against the blocks applied in turn, then one SGD step (lr 0.1) of
    ``mean(y ** 2)`` through the pipeline, the gradients summed over
    ``data``.  Rank 0 saves ``{"pp_diff", "pp_loss"}`` to ``out``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..models.audio import ConformerBlock
    from ..models.layers import init_weights
    from .mesh import make_named_mesh
    from .pp import PIPE_AXIS, pipeline_blocks, shard_stacked_params, stack_block_params

    data = dist.get_world_size() // 4
    mesh = make_named_mesh((data, 4), ("data", PIPE_AXIS), "cpu")

    def block():
        return ConformerBlock(dim, 2, 32, 3, 0.0, torch.float32)

    seq = torch.nn.ModuleList(init_weights(block(), torch.Generator().manual_seed(i))
                              for i in range(num_layers)).eval()
    stacked = stack_block_params({f"blocks.{k}": v for k, v in seq.state_dict().items()},
                                 num_layers)
    stage = shard_stacked_params(stacked, mesh, block).eval()
    B = 4 * data
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((B, T, dim))
                         .astype(np.float32))
    valid = torch.ones(B, T, dtype=torch.bool)
    amask = torch.ones(B, 1, T, T, dtype=torch.bool)
    with torch.no_grad():
        y_pp = pipeline_blocks(stage, x, valid, amask, mesh, microbatches, "data")
        y_seq = x
        for b in seq:
            y_seq = b(y_seq, valid, amask)
    diff = float((y_pp - y_seq).abs().max())
    loss = (pipeline_blocks(stage, x, valid, amask, mesh, microbatches, "data") ** 2).mean()
    loss.backward()
    with torch.no_grad():
        for p in stage.parameters():
            dist.all_reduce(p.grad, group=mesh["data"].get_group())
            p -= 0.1 * p.grad
    _save_on_rank0({"pp_diff": diff, "pp_loss": loss.item()}, out)

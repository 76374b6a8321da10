"""The meshed training step over several ranks, held against the
one-process step: DP, TP and FSDP with their collectives on NCCL.

    torchrun --standalone --nproc-per-node=4 tools/mesh_check.py          # four CUDA cards
    torchrun --standalone --nproc-per-node=4 tools/mesh_check.py --dtype=float32
    torchrun --standalone --nproc-per-node=4 tools/mesh_check.py --device=cpu --tiny

For each layout over the ranks (DP4, DP2 x TP2, DP2 x TP2 x FSDP; with
another world size, DP over all and, when it is even, DP x TP2 with and
without FSDP), every rank trains the flagship (at the shipped widths,
BatchNorm, dropout 0.1, in ``--dtype`` compute, bf16 by default; ``--tiny``:
``graft_entry``'s tiny flagship in f32)
from one seeded state on its rows of one seeded global batch
(``graft_entry.train_batch`` at ``bench.py``'s 120 frames and labels of 20,
processed lips: K1 runs, K2 does not), 3 steps.  Rank 0 runs the same steps
in one process on the whole batch and compares, at ``chip_smoke.py``
[train-ref]'s bars (``--tiny``: 1e-5 each): every step's loss (1e-3
relative), the first step's ``grad_norm`` (1e-2) and every gradient per
tensor against its norm plus 1e-3 of the global norm (1e-2).  In bf16 a
tensor's bar is the larger of 1e-2 and twice the one-process bf16 step's
own distance from the one-process f32 step on that tensor (two bf16
computations of one sum each carry that rounding; rank 0 runs the f32
step for it).  The later steps' gradients are printed, not held: after a
bf16 step the two runs' parameters differ by rounding that Adam scales to
about the learning rate.  With TP, the parameters the plan leaves whole
must stay bitwise equal across each model group.  Then the DP2 x TP2 x
FSDP state is
written as a sharded checkpoint and restored into a DP layout: tensors
equal.  It prints one line per check, the card and its power limit, and a
last JSON line ``{"ok": ...}``; any miss exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def _steps(trainer, state, batch, n_steps, sync):
    """n_steps train steps -> (metrics, whole gradients, seconds) per step."""
    from multimodal_av_model_tpu_torch.parallel import full_tensor

    out = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        sync()
        dt = time.perf_counter() - t0
        grads = {n: full_tensor(p.grad).float().cpu() for n, p in state.model.named_parameters()
                 if p.grad is not None}
        out.append(({k: float(v) for k, v in m.items()}, grads, dt))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="compute dtype (default: bfloat16, with --tiny float32)")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from multimodal_av_model_tpu_torch import graft_entry
    from multimodal_av_model_tpu_torch.config import torch_dtype
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
    from multimodal_av_model_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        process_rows,
    )
    from multimodal_av_model_tpu_torch.text import CharTokenizer
    from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer
    from multimodal_av_model_tpu_torch.train.checkpoints import host_snapshot
    from multimodal_av_model_tpu_torch.train.sharded_checkpoints import (
        restore_sharded,
        save_sharded,
    )

    if args.device == "cuda" and not torch.cuda.is_available():
        print("mesh_check: no CUDA device (pass --device=cpu for gloo)", file=sys.stderr)
        return 2
    if not initialize_distributed(args.device):
        print("mesh_check: run it under torchrun", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cpu":
        torch.set_num_threads(1)
    rank, world = dist.get_rank(), dist.get_world_size()
    tok = CharTokenizer(graft_entry.VOCAB)
    cfg = graft_entry.flagship_config(tiny=args.tiny)
    cfg.model.visual.norm = "batch"                 # the shipped norm
    cfg.model.decoder.vocab_size = tok.vocab_size
    cfg.model.dtype = args.dtype or ("float32" if args.tiny else "bfloat16")
    if args.tiny:
        batch = graft_entry.train_batch(np.random.default_rng(0), 2 * world, tok.vocab_size)
        bars = (1e-5, 1e-5, 1e-5)
    else:
        batch = graft_entry.train_batch(np.random.default_rng(0), 2 * world, tok.vocab_size,
                                        T_v=120, S=120 * 534, lip=96, label_len=20)
        bars = (1e-3, 1e-2, 1e-2)
    batch["valid"] = np.ones(2 * world, np.float32)
    dtype = torch_dtype(cfg.model.dtype)

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    layouts = [("DP%d" % world, 1, False)]
    if world % 2 == 0 and world > 2:
        layouts += [(f"DP{world // 2} x TP2", 2, False), (f"DP{world // 2} x TP2 x FSDP", 2, True)]
    ref, own_gap = None, {}
    if rank == 0:                                   # the one-process step on the whole batch
        trainer = MultiSpeakerTrainer(cfg, MultiSpeakerAVModel(cfg.model, dtype), tok,
                                      device=args.device)
        ref = _steps(trainer, trainer.init_state(cfg.data.seed), batch, args.steps, sync)
        del trainer
        if dtype != torch.float32:                  # its own rounding: against f32 compute
            trainer = MultiSpeakerTrainer(cfg, MultiSpeakerAVModel(cfg.model, torch.float32),
                                          tok, device=args.device)
            (_, g32, _), = _steps(trainer, trainer.init_state(cfg.data.seed), batch, 1, sync)
            del trainer
            (m1, g1, _) = ref[0]
            floor = 1e-3 * m1["grad_norm"]
            own_gap = {n: float((g1[n] - v).norm() / (v.norm() + floor)) for n, v in g32.items()}
    dist.barrier()
    ok, report = True, {}
    fsdp_state = None
    for name, tp, fsdp in layouts:
        mesh = make_mesh(model_parallel=tp, device_type=args.device)
        trainer = MultiSpeakerTrainer(cfg, MultiSpeakerAVModel(cfg.model, dtype), tok,
                                      device=args.device, mesh=mesh, fsdp=fsdp)
        state = trainer.init_state(cfg.data.seed)
        got = _steps(trainer, state, process_rows(mesh, batch), args.steps, sync)
        drift = None
        if tp > 1:                                  # the model group's copies of whole params
            from torch.distributed.tensor import DTensor

            whole = [p.to_local() if isinstance(p, DTensor) else p
                     for p in state.model.parameters()
                     if not (isinstance(p, DTensor) and "model" in p.device_mesh.mesh_dim_names)]
            mine = torch.cat([w.detach().double().flatten() for w in whole])
            peers = [torch.empty_like(mine) for _ in range(tp)]
            dist.all_gather(peers, mine, group=mesh["model"].get_group())
            drift = max(float((q - peers[0]).abs().max()) for q in peers[1:])
        if rank == 0:
            loss_rel = max(abs(m["loss"] - m1["loss"]) / abs(m1["loss"])
                           for (m, _, _), (m1, _, _) in zip(got, ref))
            gn_rel = abs(got[0][0]["grad_norm"] - ref[0][0]["grad_norm"]) / ref[0][0]["grad_norm"]
            per_step = []
            for (_, g, _), (m1, g1, _) in zip(got, ref):
                floor = 1e-3 * m1["grad_norm"]
                per_step.append(max((float((g[n] - v).norm() / (v.norm() + floor)), n)
                                    for n, v in g1.items()))
            # Step 1, per tensor, against its own bar (the excess over it).
            floor = 1e-3 * ref[0][0]["grad_norm"]
            excess, at = max(
                (float((got[0][1][n] - v).norm() / (v.norm() + floor))
                 - max(bars[2], 2 * own_gap.get(n, 0.0)), n) for n, v in ref[0][1].items())
            good = loss_rel <= bars[0] and gn_rel <= bars[1] and excess <= 0
            ok = ok and good
            ms = [dt * 1e3 for _, _, dt in got]
            report[name] = {"loss_rel": loss_rel, "grad_norm_rel": gn_rel,
                            "grad_rel_by_step": [r for r, _ in per_step], "step_ms": ms,
                            "one_process_ms": [dt * 1e3 for _, _, dt in ref],
                            "adam_foreach": state.optimizer.adam.defaults["foreach"],
                            "bf16_own_gap_at_worst": own_gap.get(per_step[0][1]),
                            "model_group_drift": drift}
            log(f"[mesh] {name} over {world} ranks ({args.device}), {args.steps} steps of "
                f"{2 * world} rows: loss rel {loss_rel:.3g} (<= {bars[0]:g}); step 1 grad_norm "
                f"rel {gn_rel:.3g} (<= {bars[1]:g}), max per-tensor gradient rel "
                f"{per_step[0][0]:.3g} at {per_step[0][1]} (its bar "
                f"{max(bars[2], 2 * own_gap.get(per_step[0][1], 0.0)):.3g}: the one-process "
                f"step's own gap to f32 there {own_gap.get(per_step[0][1], 0.0):.3g}; the "
                f"tightest tensor {excess:+.3g} from its bar at {at}); later steps "
                f"{', '.join(f'{r:.3g} at {n}' for r, n in per_step[1:])}; step ms "
                f"{', '.join(f'{x:.1f}' for x in ms)} (one process: "
                f"{', '.join(f'{dt * 1e3:.1f}' for _, _, dt in ref)})"
                + ("" if drift is None else f"; whole parameters across the model group: max "
                   f"|difference| {drift:.3g} (must be 0)")
                + f" {'ok' if good and not drift else 'FAILED'}")
            ok = ok and not drift
        if fsdp:
            fsdp_state = state
        else:
            del trainer, state
    if fsdp_state is not None:
        with tempfile.TemporaryDirectory(prefix="mmav_mesh_") as tmp:
            obj = [os.path.join(tmp, "ckpt")]
            dist.broadcast_object_list(obj, src=0)      # one directory for every rank
            t0 = time.perf_counter()
            save_sharded(obj[0], {"state": fsdp_state, "epoch": args.steps})
            save_s = time.perf_counter() - t0
            saved = host_snapshot(fsdp_state)
            mesh = make_mesh(model_parallel=1, device_type=args.device)
            trainer = MultiSpeakerTrainer(cfg, MultiSpeakerAVModel(cfg.model, dtype), tok,
                                          device=args.device, mesh=mesh)
            state = trainer.init_state(cfg.data.seed + 1)
            restore_sharded(obj[0], {"state": state, "epoch": 0})
            back = host_snapshot(state)
            dist.barrier()
        if rank == 0:
            pairs = [(f"model.{k}", back["model"][k], v) for k, v in saved["model"].items()]
            pairs += [(f"{m}.{k}", back["optimizer"][m][k], v) for m in ("mu", "nu")
                      for k, v in saved["optimizer"][m].items()]
            differ = [(name, float((a.double() - b.double()).abs().max()))
                      for name, a, b in pairs if not torch.equal(a, b)]
            ok = ok and not differ
            report["checkpoint"] = {"save_s": save_s, "differ": differ[:20]}
            log(f"[mesh] sharded checkpoint under DP x TP2 x FSDP written in {save_s:.2f} s by "
                f"{world} ranks, restored under DP{world}: {len(pairs) - len(differ)} of "
                f"{len(pairs)} tensors equal"
                + (f"; differ (max abs): {differ[:8]}" if differ else ""))
    log(f"[mesh] card {_card()}")
    log(json.dumps({"ok": ok, "world": world, "device": args.device, "report": report}))
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

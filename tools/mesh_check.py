"""The parallel layouts over several ranks, each held against one process,
with their collectives on NCCL: the meshed training step (DP, TP, FSDP), the
long-form encoder's context parallelism and the Conformer pipeline.

    torchrun --standalone --nproc-per-node=4 tools/mesh_check.py          # four CUDA cards
    torchrun --standalone --nproc-per-node=4 tools/mesh_check.py --checks=cp,cp-long,pp
    torchrun --standalone --nproc-per-node=4 tools/mesh_check.py --dtype=float32
    torchrun --standalone --nproc-per-node=4 tools/mesh_check.py --device=cpu --tiny

``--checks`` takes some of ``train``, ``cp``, ``cp-long`` and ``pp`` (default:
all, in that order).

``train``: for each layout over the ranks (DP4, DP2 x TP2, DP2 x TP2 x FSDP;
with another world size, DP over all and, when it is even, DP x TP2 with and
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
equal.

``cp``: the long-form encoder (``parallel/longform.py``: the flagship's audio
encoder in f32, seeded weights, ``--tiny`` the tiny one) with time split over
every rank, ring and gather-KV, on one pad-free stream of about 240 s
(``--tiny`` 4 s) cut so that the ranks divide its encoder frames, against
rank 0's full-attention encoder in one process at JAX's long-form bars
(atol 2e-4, rtol 1e-4); ``cp-long``: the ring alone at about 960 s
(``--tiny`` 16 s), where one card could not hold the full encoder's logits
(8 x 48,000^2 f32 = 74 GB a block), its outputs finite.  Both print the ms
per call and every rank's peak device memory, and hold K1 against its plain
version at the stream's shape on rank 0.  ``pp``: the flagship's 12
Conformer blocks over the ranks as pipeline stages (``parallel/pp.py``, f32,
B = 8 at 201 frames, 4 microbatches), the forward and every parameter's
gradient against rank 0's blocks applied in turn at JAX's bars (2e-5; rtol
5e-4, atol 5e-5), with the ms of each and ``bubble_fraction``.

It prints one line per check, the card and its power limit, and a last JSON
line ``{"ok": ...}``; any miss exits non-zero.
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


def train_checks(args, log, sync) -> tuple[bool, dict]:
    """The meshed training step in each layout against the one-process
    step, and the sharded checkpoint across layouts (``train``)."""
    import torch
    import torch.distributed as dist

    from multimodal_av_model_tpu_torch import graft_entry
    from multimodal_av_model_tpu_torch.config import torch_dtype
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
    from multimodal_av_model_tpu_torch.parallel import make_mesh, process_rows
    from multimodal_av_model_tpu_torch.text import CharTokenizer
    from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer
    from multimodal_av_model_tpu_torch.train.checkpoints import host_snapshot
    from multimodal_av_model_tpu_torch.train.sharded_checkpoints import (
        restore_sharded,
        save_sharded,
    )

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
    return ok, report


def _stream_samples(seconds: float, world: int, cfg) -> int:
    """The longest stream of at most ``seconds`` whose encoder frames the
    ranks divide."""
    from multimodal_av_model_tpu_torch.models import AudioEncoder

    fe = cfg.frontend
    S = int(seconds * fe.sample_rate)
    while AudioEncoder.output_length(cfg.audio, fe, S) % world:
        S -= fe.hop_length
    return S


def _peaks(device: str) -> list[float]:
    """Every rank's peak device memory in GiB (0 on the CPU)."""
    import torch
    import torch.distributed as dist

    mine = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else 0.0
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


def _timed(fn, sync, n: int):
    """``fn()`` once to warm up, then ``n`` times: the ms of each and the
    last result."""
    fn()
    times = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def cp_checks(args, log, sync, seconds: float, impls, reference: bool) -> tuple[bool, dict]:
    """The long-form encoder (``parallel/longform.py``, f32, seeded weights)
    with time split over every rank on one pad-free stream of about
    ``seconds`` (cut so that the ranks divide its encoder frames), each of
    ``impls``: ms per call and every rank's peak memory; with ``reference``,
    ``last`` and ``middle`` against rank 0's full-attention encoder in one
    process at JAX's long-form bars (atol 2e-4, rtol 1e-4), else finite.
    Rank 0 holds K1 against its plain version at the stream's shape."""
    import torch
    import torch.distributed as dist

    from multimodal_av_model_tpu_torch import graft_entry
    from multimodal_av_model_tpu_torch.models import AudioEncoder, init_weights
    from multimodal_av_model_tpu_torch.ops import logmel
    from multimodal_av_model_tpu_torch.parallel import make_cp_audio_encoder, make_mesh

    rank, world, dev = dist.get_rank(), dist.get_world_size(), args.device
    cfg = graft_entry.flagship_config(tiny=args.tiny).model
    S = _stream_samples(seconds, world, cfg)
    wave = torch.from_numpy((np.random.default_rng(0).standard_normal((1, S)) * 0.1)
                            .astype(np.float32)).to(dev)

    def encoder(impl=None):
        enc = (AudioEncoder(cfg.audio, cfg.frontend) if impl is None
               else make_cp_audio_encoder(cfg, mesh, "data", impl))
        return init_weights(enc, torch.Generator().manual_seed(0)).to(dev).eval()

    mesh = make_mesh(model_parallel=1, device_type=dev)
    ok, report, ref = True, {}, None
    tag = f"CP{world} {S / cfg.frontend.sample_rate:.1f} s"
    if rank == 0:
        got, plain = logmel.log_mel_spectrogram_cuda(wave), logmel.log_mel_spectrogram(wave)
        k1_err = float((got - plain).abs().max())
        k1_ok = bool(torch.allclose(got, plain, rtol=2e-3, atol=2e-3))
        ok = ok and k1_ok
        log(f"[mesh] {tag}: K1 {tuple(wave.shape)} -> {tuple(got.shape)} against its plain "
            f"version: max|diff| {k1_err:.3g} (rtol=atol=2e-3) {'ok' if k1_ok else 'FAILED'}")
        report["k1_err"] = k1_err
        del got, plain
        if reference:
            if dev == "cuda":
                torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                times, ref = _timed(lambda: encoder()(wave), sync, 1)
            peak = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else 0.0
            report["full_ms"], report["full_peak_gib"] = times, peak
            log(f"[mesh] {tag}: full attention in one process: {times[0]:.1f} ms, peak "
                f"{peak:.2f} GiB, T_enc {ref[0].shape[1]}")
    dist.barrier()
    for impl in impls:
        enc = encoder(impl)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            times, (last, middle, _) = _timed(lambda: enc(wave), sync, 2)
        peaks = _peaks(dev)
        good = bool(torch.isfinite(last).all() and torch.isfinite(middle).all())
        errs = None
        if rank == 0 and ref is not None:
            errs = [float((a - b).abs().max()) for a, b in ((last, ref[0]), (middle, ref[1]))]
            good = good and all(torch.allclose(a, b, rtol=1e-4, atol=2e-4)
                                for a, b in ((last, ref[0]), (middle, ref[1])))
        ok = ok and good
        report[impl] = {"ms": times, "peak_gib_by_rank": peaks, "max_abs_err": errs}
        log(f"[mesh] {tag}, {impl}: T_enc {last.shape[1]} ({last.shape[1] // world} a rank), "
            f"{', '.join(f'{t:.1f}' for t in times)} ms per call, peak device memory by rank "
            f"{', '.join(f'{p:.2f}' for p in peaks)} GiB; "
            + (f"max|diff| to full attention last {errs[0]:.3g}, middle {errs[1]:.3g} "
               f"(atol 2e-4, rtol 1e-4)" if errs else "finite")
            + f" {'ok' if good else 'FAILED'}")
        del enc, last, middle
    return ok, report


def pp_check(args, log, sync, n_steps: int = 3, microbatches: int = 4) -> tuple[bool, dict]:
    """PP over every rank: the flagship's 12 Conformer blocks (``--tiny``: 4
    of width 32) in f32, seeded, ``12 / world`` a stage on a ``(1, world)``
    ``("data", "pipe")`` mesh; B = 8 rows of 201 frames (``bench.py``'s 120
    frames; ``--tiny`` 21), random lengths, ``microbatches`` microbatches.
    The forward and every parameter's gradient of ``sum(y * valid)`` against
    rank 0's blocks applied in turn (JAX's bars: 2e-5; rtol 5e-4, atol
    5e-5), the ms of a forward and backward of each, ``bubble_fraction``."""
    import torch
    import torch.distributed as dist
    from torch import nn

    from multimodal_av_model_tpu_torch import graft_entry
    from multimodal_av_model_tpu_torch.models import AudioEncoder, init_weights
    from multimodal_av_model_tpu_torch.models.audio import ConformerBlock
    from multimodal_av_model_tpu_torch.parallel import (
        PIPE_AXIS,
        bubble_fraction,
        make_named_mesh,
        pipeline_blocks,
        shard_stacked_params,
        stack_block_params,
        stage_layers,
    )

    rank, world, dev = dist.get_rank(), dist.get_world_size(), args.device
    cfg = graft_entry.flagship_config(tiny=args.tiny).model
    a = cfg.audio
    L = 4 if args.tiny else a.num_layers
    mesh = make_named_mesh((1, world), ("data", PIPE_AXIS), dev)

    def block():
        return ConformerBlock(a.d_model, a.num_heads, a.ffn_dim, a.conv_kernel_size, 0.0,
                              torch.float32)

    seq = init_weights(nn.ModuleList(block() for _ in range(L)),
                       torch.Generator().manual_seed(0)).to(dev).eval()
    stacked = stack_block_params({f"blocks.{k}": v for k, v in seq.state_dict().items()}, L)
    stage = shard_stacked_params(stacked, mesh, block).to(dev).eval()
    B = 8
    T = AudioEncoder.output_length(a, cfg.frontend, (12 if args.tiny else 120) * 534)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, T, a.d_model)).astype(np.float32)).to(dev)
    lens = torch.from_numpy(rng.integers(T // 2, T + 1, size=B)).to(dev)
    valid = torch.arange(T, device=dev)[None] < lens[:, None]
    amask = valid[:, None, None, :] & valid[:, None, :, None]

    def run(fn, module):
        def step():
            module.zero_grad(set_to_none=True)
            y = fn()
            (y * valid[..., None]).sum().backward()
            return y
        return step

    def sequential():
        h = x
        for b in seq:
            h = b(h, valid, amask)
        return h

    times, y = _timed(run(lambda: pipeline_blocks(stage, x, valid, amask, mesh, microbatches),
                          stage), sync, n_steps)
    grads = {n: torch.zeros_like(t) for n, t in stacked.items()}
    for j, i in enumerate(stage_layers(L, mesh)):
        for n, p in stage[j].named_parameters():
            grads[n][i] = p.grad
    for g in grads.values():
        dist.all_reduce(g, group=mesh[PIPE_AXIS].get_group())
    ok, report = True, {"pp_ms": times, "bubble_fraction": bubble_fraction(world, microbatches)}
    if rank == 0:
        seq_times, y_seq = _timed(run(sequential, seq), sync, n_steps)
        want = stack_block_params({f"blocks.{n}": p.grad for n, p in seq.named_parameters()}, L)
        fwd = float((y - y_seq).abs().max().detach())
        excess, at = max((float(((grads[n] - g).abs() / (5e-5 + 5e-4 * g.abs())).max()), n)
                         for n, g in want.items())
        ok = bool(torch.allclose(y, y_seq, rtol=2e-5, atol=2e-5)) and excess <= 1.0
        report.update({"sequential_ms": seq_times, "fwd_err": fwd, "grad_worst": excess})
        log(f"[mesh] PP{world}: {L} blocks x {a.d_model} (f32), {L // world} a stage, B={B}, "
            f"T={T}, M={microbatches}: forward max|diff| {fwd:.3g} (2e-5), gradients of "
            f"sum(y*valid) worst at {excess:.3g} of their bar (rtol 5e-4, atol 5e-5) at {at}; "
            f"forward + backward {', '.join(f'{t:.1f}' for t in times)} ms pipelined, "
            f"{', '.join(f'{t:.1f}' for t in seq_times)} ms sequential in one process; "
            f"bubble_fraction({world}, {microbatches}) = "
            f"{bubble_fraction(world, microbatches):.4f} {'ok' if ok else 'FAILED'}")
    dist.barrier()
    return ok, report


CHECKS = ("train", "cp", "cp-long", "pp")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="compute dtype of train (default: bfloat16, with --tiny float32)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--checks", default=",".join(CHECKS),
                    help=f"some of {','.join(CHECKS)} (default: all)")
    args = ap.parse_args()
    checks = args.checks.split(",")
    if not set(checks) <= set(CHECKS):
        print(f"mesh_check: --checks takes some of {','.join(CHECKS)}", file=sys.stderr)
        return 2

    import torch
    import torch.distributed as dist

    from multimodal_av_model_tpu_torch.parallel import initialize_distributed

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

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    seconds = (4, 16) if args.tiny else (240, 960)
    runs = {"train": lambda: train_checks(args, log, sync),
            "cp": lambda: cp_checks(args, log, sync, seconds[0], ("ring", "gather"), True),
            "cp-long": lambda: cp_checks(args, log, sync, seconds[1], ("ring",), False),
            "pp": lambda: pp_check(args, log, sync)}
    ok, report = True, {}
    for name in checks:
        good, report[name] = runs[name]()
        ok = ok and good
    log(f"[mesh] card {_card()}")
    log(json.dumps({"ok": ok, "world": world, "device": args.device, "report": report}))
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

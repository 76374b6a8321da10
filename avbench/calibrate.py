"""Readings that the limits of ``correct`` are set from, many seeds in one process.

    python3 -m avbench.calibrate --workload av_flagship.train_b8 --seeds 1,2,3 --controls

For each seed: one run of the cell as ``avbench.run`` makes it (with a short
window), whose compared numbers are the program's readings; with
``--controls``, the same numbers of the controls on the same seed, which
the limits must fail:

* ``fp8``: the reference computed on float8 (e4m3) operands, the precision
  below the configuration's bfloat16, in the program's place;
* ``int8`` (transcription): the program serving its own int8 weights
  (``Transcriber(quantize=True)``).

With ``--faults``, the numbers of each fault of ``avbench/faults.py`` that
the cell can have, planted in the program (``unchanged`` needs no run: its
change reads 1).  Training cells add each step's loss gap and the
parameters with the widest gaps, of the program and of the control.

The benchmark's own runs never run the controls.  One JSON line per seed.
"""

from __future__ import annotations

import json
import sys


def controls(cell, seed: int, device: str) -> dict:
    from avbench import harness, traffic
    from avbench.runners import common

    ctx = harness.make_context(cell, seed, device)
    template = common.template(ctx)
    pool = traffic.raw_batches(cell.mix, seed)
    kind = cell.mix["runner"]
    if kind == "train":
        from avbench.runners import train

        steps = cell.mix["check_steps"]
        ref = train.reference_steps(ctx, template, pool, steps)
        low = train.reference_steps(ctx, template, pool, steps, lowp=True)
        return {"fp8": train.compare(low, ref, detail=True)}
    from avbench.runners import transcribe

    job = transcribe.Job(ctx, quantize=True)
    idx = job.sample()
    for i in idx:
        job.unit(i)
    job.sync()
    got = job.served(idx)
    del job
    common.free(device)
    ref = transcribe.reference_outputs(ctx, template, pool, idx)
    low = transcribe.reference_outputs(ctx, template, pool, idx, lowp=True)
    out = {"int8": transcribe.compare(got, ref, ctx, cell.mix["batch"])}
    out["fp8"] = {**transcribe.lp_stats(low, ref), "lp_gap": max(
        transcribe.lp_gap(low[i]["lp"], ref[i]["lp"], ref[i]["len"]) for i in idx)}
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--controls", action="store_true")
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)

    import torch

    from avbench import harness
    from avbench.faults import FAULTS, planted

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell.find(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run(cell, seed, args.seconds, False, "cuda")
        line = {"workload": args.workload, "seed": seed, "correct": out["correct"],
                "program": {k: v["value"] for k, v in out["checks"].items()},
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "detail": out["detail"]}
        if args.controls:
            line["controls"] = controls(cell, seed, "cuda")
        if args.faults:
            line["faults"] = {}
            for fault in FAULTS[cell.mix["runner"]]:
                if fault == "unchanged":
                    continue
                with planted(fault, cell.mix["runner"]):
                    got = harness.run(cell, seed, args.seconds, False, "cuda")
                line["faults"][fault] = {k: v["value"] for k, v in got["checks"].items()}
                line["faults"][fault]["correct"] = got["correct"]
                if got["detail"]:
                    line["faults"][fault]["loss_steps"] = got["detail"]["loss_steps"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of the ``train_avhubert`` and ``train_dp`` cells are
set from, many seeds in one process (``avbench.calibrate`` serves the
runners whose reference is the flagship's ``train`` one).

    python3 -m avbench.controls --workload avhubert_large_ctc.train_b16_f240 --seeds 1,2 --program
    python3 -m avbench.controls --workload av_flagship.train_dp4 --seeds 1,2

For each seed, one JSON line with ``fp8``: the cell's compared numbers of
the reference computed on float8 (e4m3) operands, the precision below the
configuration's bfloat16, against the reference (``train_dp``: at the global
batch, on one card).  With ``--program``, also the program's own numbers
from one run of the cell as ``avbench.run`` makes it, with a short window
(and the cell's cards); with ``--half``, those of a run with half of each
batch's rows left out of the loss (``avbench/faults.py``).  The benchmark's
own runs never run these.
"""

from __future__ import annotations

import json
import sys


def fp8_control(cell, seed: int, device: str) -> dict:
    from avbench import harness, traffic
    from avbench.runners import common, train, train_avhubert, train_dp

    ctx = harness.make_context(cell, seed, device)
    steps = cell.mix["check_steps"]
    if cell.mix["runner"] == "train_dp":
        import dataclasses

        whole = {**cell.mix, "batch": cell.mix["ranks"] * cell.mix["batch"]}
        ctx = dataclasses.replace(ctx, cell=dataclasses.replace(cell, mix=whole))
        template, pool = common.template(ctx), train_dp.global_pool(cell.mix, seed)
        run = train.reference_steps
    else:
        template = dict(train_avhubert.meta_model(ctx).state_dict())
        pool, run = traffic.raw_batches(cell.mix, seed), train_avhubert.reference_steps
    ref = run(ctx, template, pool, steps)
    low = run(ctx, template, pool, steps, lowp=True)
    return train.compare(low, ref, detail=True)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program", action="store_true")
    p.add_argument("--half", action="store_true")
    args = p.parse_args(argv)

    import torch

    from avbench import harness
    from avbench.faults import planted

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell.find(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": args.workload, "seed": seed}
        if args.program:
            out = harness.run(cell, seed, args.seconds, False, "cuda")
            line.update(correct=out["correct"],
                        program={k: v["value"] for k, v in out["checks"].items()},
                        metrics={k: v["value"] for k, v in out["metrics"].items()},
                        peak=out["peak"], detail=out["detail"])
        if args.half:
            with planted("half", "train"):
                got = harness.run(cell, seed, args.seconds, False, "cuda")
            line["half"] = {k: v["value"] for k, v in got["checks"].items()}
        line["fp8"] = fp8_control(cell, seed, "cuda")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

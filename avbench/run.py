"""Run one cell of the benchmark once and print its result line.

    python3 -m avbench.run --workload av_flagship.train_b8 --seed 7 --seconds 40 --trace 0

Needs the CUDA cards the cell asks for: without them it exits 1 and prints
no result.  ``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1``
attaches the span hooks, profiles a bounded stretch after the window and
prints the per-layer metrics, ``device.busy_s``/``window_s`` and a
``breakdown``.  Every run checks what the timed path produced against the
plain reference (``avbench/reference``) and prints each compared number
beside its limit, last on standard error and last in the result line.
"""

from __future__ import annotations

import os
import sys
import time

_T_IMPORT = time.perf_counter()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches stay at fixed paths inside the checkout, so a
# checkout's first run builds and every later run finds them.
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(_ROOT, "build", "torch_extensions"))
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from avbench import harness

    age = harness.process_age()
    t_start = time.perf_counter() - age if age else _T_IMPORT
    try:
        cell = harness.Cell.find(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"avbench: cannot resolve {args.workload}: {e!r}", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"avbench: needs {cell.entry['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import multimodal_av_model_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"avbench: the system under test is not in this checkout: {e}", file=sys.stderr)
        return 1

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = harness.forbidden_modules()
    if found:
        print(f"avbench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.entry["chips"], "memory_peak_bytes": out["peak"]}
    if args.trace:
        device.update(out["trace"])
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    if args.trace:
        line["breakdown"] = out["breakdown"]
    line["info"] = {"units": out["units"], "window_s": out["window_s"], "unit_ms": out["unit_ms"],
                    "setup_phases_s": out["setup_phases_s"],
                    "launches": out["launches"], "power_limit": harness.power_limit()}
    line["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

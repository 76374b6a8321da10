"""Readings that the limits of the Whisper-Flamingo cell are set from, many
seeds in one process.

    python3 -m avbench.calibrate_whisper_flamingo --seeds 1,2 --program --faults --fp8

For each seed, one JSON line with, as asked: ``program``, the cell's compared
numbers from one run as ``avbench.run`` makes it with a short window;
``faults``, those of a run with each fault of ``FAULTS`` planted in the
system under test; ``fp8``, the reference computed on float8 (e4m3)
operands, the precision below the configuration's bfloat16, against the
reference, compared as the runner compares the program (its ``compare`` and
``probe_compare``) and judged against the cell's limits (``correct``).  The
benchmark's own runs never run these.
"""

from __future__ import annotations

import contextlib
import json
import sys

WORKLOAD = "whisper_flamingo_large.train_b16_w30"


@contextlib.contextmanager
def planted(fault: str):
    """Patch one method of the system while open:

    * ``gates_skipped``: every gated cross-attention block returns its input,
      tied to its gates at weight 0 so that the backward runs;
    * ``proj_grad_dropped``: the video projection's output detached, so it
      takes no gradient;
    * ``half_batch``: each speaker's cross-entropy over the first half of its
      rows alone;
    * ``mask_dropped``: the gated attention attends to the padded video
      frames too."""
    import torch

    from multimodal_av_model_tpu_torch.models import whisper_flamingo as wf
    from multimodal_av_model_tpu_torch.train.trainer import MultiSpeakerTrainer

    if fault == "gates_skipped":
        target, name = wf.GatedCrossAttention, "forward"

        def new(self, x, video, mask):
            return x + 0.0 * (self.attn_gate + self.ff_gate).to(x.dtype)
    elif fault == "proj_grad_dropped":
        target, name = wf.WhisperFlamingo, "project_video"

        def new(self, video):
            return self.video_proj(video).detach()
    elif fault == "half_batch":
        target, name = MultiSpeakerTrainer, "_token_ce"
        whole = MultiSpeakerTrainer._token_ce

        def half(logits, targets, valid=None):
            h = logits.shape[0] // 2
            return whole(logits[:h], targets[:h], None if valid is None else valid[:h])

        new = staticmethod(half)
    elif fault == "mask_dropped":
        target, name = wf.GatedCrossAttention, "forward"

        def new(self, x, video, mask):
            dt = x.dtype
            x = x + torch.tanh(self.attn_gate).to(dt) * self.attn(self.attn_ln(x), video)
            return x + torch.tanh(self.ff_gate).to(dt) * self.ff(self.ff_ln(x))
    else:
        raise ValueError(f"no fault {fault!r}")
    before = target.__dict__[name]
    setattr(target, name, new)
    try:
        yield
    finally:
        setattr(target, name, before)


FAULTS = ("gates_skipped", "proj_grad_dropped", "half_batch", "mask_dropped")


def fp8_control(cell, seed: int, device: str) -> dict:
    """The reference on float8 operands against the reference, with the
    runner's comparisons and the cell's limits."""
    from avbench import harness, traffic
    from avbench.runners import train_avhubert
    from avbench.runners import train_whisper_flamingo as runner

    ctx = harness.make_context(cell, seed, device)
    model = train_avhubert.meta_model(ctx)
    template = dict(model.state_dict())
    names = runner.trainable(model, dict(model.named_parameters()))
    pool = traffic.raw_batches(cell.mix, seed)
    steps, probe = cell.mix["check_steps"], {}
    ref = runner.reference_steps(ctx, template, names, pool, steps, probe=probe)
    low = runner.reference_steps(ctx, template, names, pool, steps, lowp=True)
    out = runner.compare(low, ref)
    out["frozen_moved"] = 0.0
    xattn, detail = runner.probe_compare(runner.reference_probe(ctx, probe, pool[0], lowp=True),
                                         runner.reference_probe(ctx, probe, pool[0]),
                                         probe["x"])
    out.update(xattn)
    out["detail"].update(xattn=detail)
    limits = cell.limits["limits"]
    out["correct"] = all(out[k] <= limits[k] for k in limits)
    out["failing"] = sorted(k for k in limits if out[k] > limits[k])
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--fp8", action="store_true")
    args = p.parse_args(argv)

    import torch

    from avbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell.find(WORKLOAD)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": WORKLOAD, "seed": seed}
        if args.program:
            out = harness.run(cell, seed, args.seconds, False, "cuda")
            line.update(correct=out["correct"],
                        program={k: v["value"] for k, v in out["checks"].items()},
                        metrics={k: v["value"] for k, v in out["metrics"].items()},
                        peak=out["peak"], detail=out["detail"])
        if args.faults:
            line["faults"] = {}
            for fault in FAULTS:
                with planted(fault):
                    got = harness.run(cell, seed, args.seconds, False, "cuda")
                line["faults"][fault] = {"correct": got["correct"],
                                         **{k: v["value"] for k, v in got["checks"].items()}}
        if args.fp8:
            line["fp8"] = fp8_control(cell, seed, "cuda")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

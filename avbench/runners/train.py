"""Runner ``train``: raw collated batch -> ``device_preprocessed_batches`` ->
``MultiSpeakerTrainer.train_step``, one step a unit.

Set-up builds one training state (seeded weights, two-group Adam, the
dropout generator) and drives it through the traffic's ``warmup`` steps on
the pool's batches in turn, the same call as the window's; the first
``check_steps`` of them, on batches whose rows all differ, are what the
check follows.  From them it keeps each step's loss, each parameter's first
gradient as Adam got it (its first moment over ``1 - b1``), and each
parameter's change over the checked steps.  After the window the state is
freed and the reference runs the same steps from the same weights, batches
and dropout draws.  Compared, by the worst step or the worst parameter:

* ``lp_rms``: the root mean square of ``log-prob - reference's`` of the
  first step's forward, over every token of every valid frame of both
  speakers (steady from seed to seed); ``lp_err``, the widest such gap,
  swings with one token of one frame;
* ``loss_gap``: ``|loss - ref| / |ref|`` of the first step (the later steps'
  gaps grow with the drift of the parameters, and swing from seed to seed);
* ``grad_gap``: the worst parameter's ``|norm - ref norm| / max(ref norm,
  median ref norm)`` of the first gradient;
* ``update_gap``: the worst parameter's same gap of its change over the
  checked steps, so that a parameter left unmoved or moved double reads 1;
* ``grad_diff``: the median parameter's ``|g - ref g| / max(ref norm,
  median ref norm)`` of the first gradient.  A gap of norms does not see a
  gradient taken over other rows, whose norm is alike; the norm of the
  difference does.

Parameters whose reference gradient is under a thousandth of the median
parameter's are left out (they move under Adam by round-off alone).
"""

from __future__ import annotations

import time

import numpy as np

from .. import flops, traffic
from ..reference import preprocess as ref_pre
from ..reference.model import Net
from ..reference.train import BETA1, Adam, losses
from . import common

KIND = "train"


class Job:
    def __init__(self, ctx):
        import torch

        from multimodal_av_model_tpu_torch.data.device_pipeline import (
            device_preprocessed_batches,
        )
        from multimodal_av_model_tpu_torch.train.trainer import MultiSpeakerTrainer, TrainState

        self.ctx, self.mix = ctx, ctx.mix
        self.device = ctx.device
        self._preprocess = device_preprocessed_batches
        self.pool = traffic.raw_batches(self.mix, ctx.seed)
        model, self.template = common.seeded_model(ctx)
        self.trainer = MultiSpeakerTrainer(ctx.config, model, None, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(ctx.dropout_seed)
        self.state = TrainState(0, model, self.trainer.make_optimizer(), gen)
        self.next_unit = self.mix["warmup"]
        self.failed_units = 0
        self.metrics = None

    # -- the timed path ---------------------------------------------------------

    def unit(self, i: int, spans=None) -> None:
        raw = self.pool[i % len(self.pool)]
        if spans is not None:
            self.sync()
            t0 = time.perf_counter()
        (batch,) = self._preprocess([raw], out_size=self.mix["lip_size"], device=self.device)
        if spans is not None:
            self.sync()
            spans.add("preprocess", time.perf_counter() - t0)
        self.state, self.metrics = self.trainer.train_step(self.state, batch)

    def sync(self) -> None:
        common.sync(self.device)

    def attach(self, spans) -> None:
        """A training step's spans come from ``unit`` alone."""

    # -- set-up -------------------------------------------------------------------

    def warm_up(self) -> None:
        import torch

        model, adam = self.state.model, self.state.optimizer.adam
        named = list(model.named_parameters())
        before = [p.detach().to("cpu", copy=True) for _, p in named]
        losses_, first = [], {}

        def keep(mod, args, out):
            first.update(log_probs(out))

        hook = model.register_forward_hook(keep)
        for k in range(self.mix["check_steps"]):
            self.unit(k)
            hook.remove()                       # the first step's forward alone
            losses_.append(self.metrics["loss"])
            if k == 0:
                # An optimizer that holds no moment after the step got no gradient.
                g1 = {n: (adam.state[p]["exp_avg"].float() / (1 - BETA1)).cpu()
                      if "exp_avg" in adam.state[p] else torch.zeros(p.shape)
                      for n, p in named}
        dp = {n: p.detach().cpu() - b for (n, p), b in zip(named, before)}
        self.program = {"loss": [float(x) for x in losses_], **first, "grad": g1, "update": dp}
        del before
        for k in range(self.mix["check_steps"], self.mix["warmup"]):
            self.unit(k)
        self.sync()

    # -- results --------------------------------------------------------------------

    def end_to_end(self, lat, window_s: float) -> dict:
        return {"train_utt_per_s": self.mix["batch"] * len(lat) / window_s}

    def flops_per_unit(self) -> float:
        B, T, S = common.shapes(self.mix)
        return flops.train_step(self.ctx.model, B, T, S, self.mix["lip_size"])

    def kernel_work(self) -> dict:
        return common.kernel_work(self.mix, self.ctx.model["frontend"])

    def launches(self) -> dict:
        return common.launches()

    def check(self) -> dict:
        loss = float(self.metrics["loss"])
        B = self.mix["batch"]
        # A step whose forward left rows of its batch out, or whose loss is
        # not finite, failed.
        if not np.isfinite(loss) or any(lp.shape[0] != B for lp in self.program["lp"]):
            self.failed_units += 1
        del self.state, self.trainer, self.metrics
        common.free(self.device)
        ref = reference_steps(self.ctx, self.template, self.pool, self.mix["check_steps"])
        out = compare(self.program, ref, detail=True)
        self.detail = out.pop("detail")
        return out


def reference_steps(ctx, template: dict, pool: list, steps: int, lowp: bool = False) -> dict:
    """The reference's first ``steps`` training steps from ``ctx.seed``'s
    weights on ``pool``'s batches: each step's loss, each parameter's first
    gradient and its change, on the host."""
    import torch

    from .. import weights

    dev = ctx.device
    P = weights.seeded_state_dict(template, ctx.seed, dev)
    names = [n for n in template if not n.endswith(("running_mean", "running_var"))]
    params = {n: P[n].clone().requires_grad_() for n in names}
    net = Net({**P, **params}, ctx.model,
              gen=torch.Generator(device=dev).manual_seed(ctx.dropout_seed), lowp=lowp,
              checkpoint_visual=ctx.mix["batch"] > 8)
    adam = Adam(params, ctx.train)
    out = {"loss": [], "grad": {}, "update": {}}
    with common.full_f32():
        for k in range(steps):
            raw = pool[k % len(pool)]
            inp = ref_pre.model_inputs(raw, dev, ctx.mix["lip_size"])
            mel = ref_pre.log_mel(inp["audio"], ctx.model["frontend"])
            labels = {key: torch.from_numpy(raw[key]).to(dev)
                      for key in ("text1", "text1_lengths", "text2", "text2_lengths")}
            loss, fwd = losses(net, inp, mel, labels, ctx.model, ctx.train)
            grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
            out["loss"].append(float(loss.detach()))
            if k == 0:
                B = fwd["B"]
                out.update(log_probs({"log_probs1": fwd["log_probs"][:B],
                                      "log_probs2": fwd["log_probs"][B:],
                                      "input_lengths1": fwd["input_lengths"][:B],
                                      "input_lengths2": fwd["input_lengths"][B:]}))
                out["grad"] = {n: g.detach().cpu() for n, g in grads.items()}
            adam.step(grads)
            del loss, grads, inp, mel, fwd
    with torch.no_grad():
        out["update"] = {n: (params[n] - P[n]).cpu() for n in names}
    del P, params, net, adam
    common.free(dev)
    return out


def log_probs(out: dict) -> dict:
    """Each speaker's log-probabilities and lengths of a forward, on the host."""
    return {"lp": [out[f"log_probs{s}"].detach().float().cpu() for s in "12"],
            "len": [out[f"input_lengths{s}"].detach().cpu() for s in "12"]}


def lp_gaps(prog: dict, ref: dict) -> tuple[float, float]:
    """``(widest, root mean square)`` log-probability gap over the valid
    frames of the rows both have."""
    worst, squares, count = 0.0, 0.0, 0
    for lp, lens, rlp, rlens in zip(prog["lp"], prog["len"], ref["lp"], ref["len"]):
        for r in range(min(lp.shape[0], rlp.shape[0])):
            n = int(min(lens[r], rlens[r]))
            if n:
                d = (lp[r, :n] - rlp[r, :n]).double()
                worst = max(worst, float(d.abs().max()))
                squares, count = squares + float((d * d).sum()), count + d.numel()
    return worst, (squares / count) ** 0.5 if count else 0.0


def compare(prog: dict, ref: dict, detail: bool = False) -> dict:
    """The compared numbers (module docstring); with ``detail`` also each
    step's loss gap and the parameters with the widest gaps."""
    import torch

    steps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    norm = {key: {n: float(torch.linalg.vector_norm(t)) for n, t in ref[key].items()}
            for key in ("grad", "update")}
    med_g = float(np.median(list(norm["grad"].values())))
    kept = [n for n, g in norm["grad"].items() if g >= 1e-3 * med_g]
    scale, gaps = {}, {}
    for key in ("grad", "update"):
        r = norm[key]
        med = float(np.median([r[n] for n in kept]))
        scale[key] = {n: max(r[n], med) for n in kept}
        gaps[key] = {n: abs(float(torch.linalg.vector_norm(prog[key][n])) - r[n]) / scale[key][n]
                     for n in kept}
    diff = {n: float(torch.linalg.vector_norm(prog["grad"][n].float() - ref["grad"][n]))
            / scale["grad"][n] for n in kept}
    worst, rms = lp_gaps(prog, ref)
    res = {"lp_rms": rms, "lp_err": worst, "loss_gap": steps[0],
           "grad_gap": max(gaps["grad"].values()), "update_gap": max(gaps["update"].values()),
           "grad_diff": float(np.median(list(diff.values())))}
    if detail:
        def top(d):
            return dict(sorted(d.items(), key=lambda kv: -kv[1])[:8])

        res["detail"] = {"loss_steps": steps, "loss_prog": prog["loss"], "loss_ref": ref["loss"],
                         "grad": top(gaps["grad"]), "update": top(gaps["update"]),
                         "grad_diff": top(diff),
                         "left_out": sorted(set(norm["grad"]) - set(kept))}
    return res

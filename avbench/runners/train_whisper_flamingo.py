"""Runner ``train_whisper_flamingo``: Whisper-Flamingo (``model.arch =
"whisper_flamingo"``, ``models/whisper_flamingo.py``) fine-tuned with the
lips: raw collated batch -> ``device_preprocessed_batches`` (the mixture
padded to Whisper's 30 s window, the prompt, shifted targets and eot built)
-> ``MultiSpeakerTrainer.train_step``, one step a unit, the model built by
``build_av_model`` on seeded weights with Whisper and the video encoder
frozen.

Set-up is the train runner's (``runners/train.py``): the first
``check_steps`` of the ``warmup`` steps are what the check follows.  From
them it keeps the first step's teacher-forced log-probabilities at every
target position, each trainable's first gradient as Adam got it, each
trainable's change over the checked steps, and the largest change of any
frozen state-dict entry.  The reference (``reference/whisper_flamingo.py``,
float32 with TF32 off, the decoder's layers recomputed in the backward) then
runs the same steps from the same weights and batches.  Compared:

* ``lp_rms``: the root mean square of ``log-prob - reference's`` over the
  whole vocabulary at every target position (text and eot) of every row of
  both speakers, first step; ``lp_err``, the widest, is printed;
* ``grad_gap``, ``update_gap`` and ``grad_diff`` over the trainable leaves
  (the gated blocks and the video projection), as the train runner's, but
  for the leaves whose reference first gradient is under ``NOISE_FLOOR`` (a
  tenth) of the median leaf's (the train runner leaves out those under a
  thousandth): the gated attention's LayerNorm, query and key, and the gates
  that read as little.  With random weights and random crops the frozen
  video encoder gives every frame of a row nearly the same features (their
  spread across frames is printed, ``video_spread``), so the attention
  pattern over them moves nothing and those gradients are bf16 round-off,
  which Adam, normalising each element, turns into full-size steps of random
  sign; ``loss_gap`` is printed;
* ``xattn_out`` and ``xattn_grad``: what the gaps above cannot see, the gated
  attention's query, key and video mask, held on a probe of the block's
  code.  After the checked steps, the first, middle and last gated blocks
  (``probe_blocks``) of the timed path's model are each loaded into a
  float32 ``GatedCrossAttention`` and, with TF32 off, take the input that
  reached the block in the first step, the mask the model built for it, and
  probe video features drawn ``N(0, 1)`` from the seed (the scale of the
  projected features, but with frames that differ, so each query's
  attention logits spread by about 1); a seeded cotangent is pulled back
  through each.  The reference's gated block (``WhisperFlamingoNet.gated``)
  does the same on the block's weights, with the mask it builds from the
  raw batch's lengths.  Float32 on both sides, since in bf16 the blocks past
  the first add their increment to a residual stream that random weights
  make large, so the rounding of that sum alone moves their gradients by
  tens of percent; the timed path's bf16 is held by the gaps above.
  ``xattn_out``: the worst block's ``|out - ref|`` over ``|ref out -
  input|`` (the block's own increment); ``xattn_grad``: the worst leaf's
  ``|g - ref g| / max(ref norm, median ref norm)`` of its block's leaves;
* ``frozen_moved``: the largest ``|change|`` of any frozen parameter or
  buffer over the checked steps; Whisper and the video encoder must not move.

A traced run times, by forward hooks on the model's modules,
``wf_audio_encoder`` (K1, Whisper's epilogue and the audio encoder),
``wf_video_encoder`` (the video encoder), ``wf_decoder`` (the decoder with
its gated blocks) and ``wf_xattn`` (the 32 gated blocks).
"""

from __future__ import annotations

import time

import numpy as np

from .. import flops_whisper_flamingo, traffic, weights
from ..reference import preprocess as ref_pre
from ..reference.train import BETA1, Adam
from ..reference.whisper_flamingo import IGNORE, WhisperFlamingoNet, ce_loss, labels
from . import common, train, train_avhubert

KIND = "train"
NOISE_FLOOR = 0.1
PROBE_SEED = 0x9A7ED


def trainable(model, names) -> list[str]:
    """The names outside ``model``'s frozen modules (its ``frozen_prefixes``)."""
    return [n for n in names if not n.startswith(model.frozen_prefixes)]


def probe_blocks(n_layers: int) -> list[int]:
    """The gated blocks the probe holds: the first, the middle one and the last."""
    return sorted({0, n_layers // 2, n_layers - 1})


def probe_tensors(ctx, rows: int, positions: int) -> dict:
    """The probe's video features ``[rows, bucket, D]`` and cotangent ``[rows,
    positions, D]``, ``N(0, 1)`` from the seed, f32 on ``ctx.device``."""
    import torch

    D = ctx.model["whisper_flamingo"]["n_text_state"]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed ^ PROBE_SEED)
    video = torch.randn(rows, ctx.mix["bucket"], D, generator=gen, device=ctx.device)
    cot = torch.randn(rows, positions, D, generator=gen, device=ctx.device)
    return {"video": video, "cot": cot}


def video_spread(video, valid) -> float:
    """The median over rows of the features' root-mean-square deviation from
    the row's mean over its valid frames, over their root mean square:
    ``video [R, T, C]``, ``valid [R, T]``."""
    import torch

    v, keep = video.float(), valid[..., None].float()
    n = keep.sum(1).clamp(min=1)
    mean = (v * keep).sum(1, keepdim=True) / n[:, None]
    dev = (((v - mean) ** 2 * keep).sum((1, 2)) / n[:, 0]).sqrt()
    rms = ((v ** 2 * keep).sum((1, 2)) / n[:, 0]).sqrt()
    return float(torch.median(dev / rms.clamp(min=1e-30)))


def port_probe(ctx, model, inputs: dict, masks: dict) -> dict:
    """The probe on the system's gated blocks: ``inputs[i]``, ``masks[i]``
    what block ``i`` got in the timed path -> each block's input, weights,
    output and its weights' gradients, on the host, from a float32 copy of
    the block."""
    import torch

    from multimodal_av_model_tpu_torch.models.whisper_flamingo import GatedCrossAttention

    w = ctx.model["whisper_flamingo"]
    out = {"x": {}, "params": {}, "out": {}, "grad": {}}
    for i, x in inputs.items():
        block = GatedCrossAttention(w["n_text_state"], w["n_text_head"], torch.float32)
        block.load_state_dict(model.gated[i].state_dict())
        block.to(x.device)
        t = probe_tensors(ctx, x.shape[0], x.shape[1])
        names, params = zip(*block.named_parameters())
        with common.full_f32(), torch.enable_grad():
            y = block(x.float(), t["video"], masks[i])
            grads = torch.autograd.grad((y * t["cot"]).sum(), params, allow_unused=True)
        out["x"][i] = x.float().cpu()
        out["params"][i] = {n: p.detach().cpu() for n, p in zip(names, params)}
        out["out"][i] = y.detach().cpu()
        out["grad"][i] = {n: (torch.zeros(p.shape) if g is None else g.cpu())
                          for n, p, g in zip(names, params, grads)}
    return out


def reference_probe(ctx, probe: dict, raw: dict, lowp: bool = False) -> dict:
    """The reference's gated blocks on ``probe``'s inputs and weights, with the
    video mask built from ``raw``'s lip lengths; float8 operands with
    ``lowp``."""
    import torch

    dev = ctx.device
    lengths = torch.from_numpy(np.concatenate([raw["lip1_lengths"], raw["lip2_lengths"]]))
    T = ctx.mix["bucket"]
    vmask = (torch.arange(T)[None] < lengths[:, None].long())[:, None, None, :].to(dev)
    out = {"out": {}, "grad": {}}
    with common.full_f32():
        for i, x in probe["x"].items():
            P = {f"gated.{i}.{n}": t.to(dev).requires_grad_()
                 for n, t in probe["params"][i].items()}
            net = WhisperFlamingoNet(P, ctx.model, lowp=lowp)
            t = probe_tensors(ctx, x.shape[0], x.shape[1])
            y = net.gated(i, x.to(dev), t["video"], vmask)
            grads = torch.autograd.grad((y * t["cot"]).sum(), list(P.values()))
            out["out"][i] = y.detach().cpu()
            out["grad"][i] = {n.split(".", 2)[2]: g.cpu() for n, g in zip(P, grads)}
    return out


def probe_compare(got: dict, ref: dict, x: dict) -> tuple[dict, dict]:
    """-> ``({"xattn_out", "xattn_grad"}, per block: the output gap and the
    three widest leaves' gaps)``."""
    import torch

    def norm(t):
        return float(torch.linalg.vector_norm(t.double()))

    outs, grads, detail = [], [], {}
    for i in ref["out"]:
        o = norm(got["out"][i] - ref["out"][i]) / norm(ref["out"][i] - x[i])
        r = {n: norm(g) for n, g in ref["grad"][i].items()}
        med = float(np.median(list(r.values())))
        gaps = {n: norm(got["grad"][i][n] - g) / max(r[n], med)
                for n, g in ref["grad"][i].items()}
        outs.append(o)
        grads.append(max(gaps.values()))
        detail[i] = {"out": o, **dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:3])}
    return {"xattn_out": max(outs), "xattn_grad": max(grads)}, detail


def target_log_probs(logits, targets) -> dict:
    """Per speaker, ``[B, t, V]`` log-probabilities at each row's target
    positions (zero rows past them) and the count of each row's targets, on
    the host; ``logits``, ``targets``: lists of the two speakers'."""
    import torch

    out = {"lp": [], "len": []}
    for lg, tg in zip(logits, targets):
        lg, keep = lg.detach(), tg != IGNORE
        counts = keep.sum(dim=1)
        lp = torch.zeros(lg.shape[0], int(counts.max()), lg.shape[-1])
        for r in range(lg.shape[0]):
            lp[r, :int(counts[r])] = torch.log_softmax(lg[r][keep[r]].float(), dim=-1).cpu()
        out["lp"].append(lp)
        out["len"].append(counts.cpu())
    return out


class Job(train.Job):
    def __init__(self, ctx):
        import torch

        from multimodal_av_model_tpu_torch.data.device_pipeline import (
            device_preprocessed_batches,
        )
        from multimodal_av_model_tpu_torch.models.whisper_flamingo import pipeline_options
        from multimodal_av_model_tpu_torch.train.trainer import MultiSpeakerTrainer, TrainState

        self.ctx, self.mix = ctx, ctx.mix
        self.device = ctx.device
        self._preprocess = device_preprocessed_batches
        self.pool = traffic.raw_batches(self.mix, ctx.seed)
        model, self.template = train_avhubert.seeded_model(ctx)
        self.pipeline = pipeline_options(ctx.config.model)
        self.trainer = MultiSpeakerTrainer(ctx.config, model, None, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(ctx.dropout_seed)
        self.state = TrainState(0, model, self.trainer.make_optimizer(), gen)
        self.next_unit = self.mix["warmup"]
        self.failed_units = 0
        self.metrics = None
        self.batch = None

    # -- the timed path ---------------------------------------------------------

    def unit(self, i: int, spans=None) -> None:
        raw = self.pool[i % len(self.pool)]
        if spans is not None:
            self.sync()
            t0 = time.perf_counter()
        (self.batch,) = self._preprocess([raw], out_size=self.mix["lip_size"],
                                         device=self.device, **self.pipeline)
        if spans is not None:
            self.sync()
            spans.add("preprocess", time.perf_counter() - t0)
        self.state, self.metrics = self.trainer.train_step(self.state, self.batch)

    def attach(self, spans) -> None:
        model = self.state.model
        spans.hook("wf_audio_encoder", model.audio_encoder)
        spans.hook("wf_video_encoder", model.video_encoder)
        spans.hook("wf_decoder", model.decoder)
        for block in model.gated:
            spans.hook("wf_xattn", block)

    # -- set-up -------------------------------------------------------------------

    def warm_up(self) -> None:
        import torch

        model, adam = self.state.model, self.state.optimizer.adam
        named = dict(model.named_parameters())
        train_names = trainable(model, named)
        frozen = {n: t for n, t in model.state_dict().items() if n not in train_names}
        before = {n: named[n].detach().to("cpu", copy=True) for n in train_names}
        frozen_before = {n: t.detach().to("cpu", copy=True) for n, t in frozen.items()}
        losses_, first, x_in, masks = [], {}, {}, {}

        def keep(mod, args, out):
            first.update(target_log_probs([out["logits1"], out["logits2"]],
                                          [self.batch["targets1"], self.batch["targets2"]]))

        def spread(mod, args, out):
            first["video_spread"] = video_spread(out, args[1])

        def block_input(i):
            def hook(mod, args):
                x_in[i], masks[i] = args[0].detach().clone(), args[2]
            return hook

        blocks = probe_blocks(len(model.gated))
        hooks = [model.register_forward_hook(keep),
                 model.video_encoder.register_forward_hook(spread),
                 *(model.gated[i].register_forward_pre_hook(block_input(i)) for i in blocks)]
        for k in range(self.mix["check_steps"]):
            self.unit(k)
            for h in hooks:                     # the first step's forward alone
                h.remove()
            hooks = []
            losses_.append(self.metrics["loss"])
            if k == 0:
                g1 = {n: (adam.state[named[n]]["exp_avg"].float() / (1 - BETA1)).cpu()
                      if "exp_avg" in adam.state[named[n]] else torch.zeros(named[n].shape)
                      for n in train_names}
        dp = {n: named[n].detach().cpu() - before[n] for n in train_names}
        moved = max(float((t.detach().float() - frozen_before[n].to(t.device).float())
                          .abs().max()) if t.numel() else 0.0 for n, t in frozen.items())
        self.frozen_held = all(not named[n].requires_grad and named[n].grad is None
                               for n in named if n not in train_names)
        self.train_names = train_names
        self.program = {"loss": [float(x) for x in losses_], **first, "grad": g1, "update": dp,
                        "frozen_moved": moved,
                        "probe": port_probe(self.ctx, model, x_in, masks)}
        del before, frozen_before, x_in, masks
        for k in range(self.mix["check_steps"], self.mix["warmup"]):
            self.unit(k)
        self.sync()

    # -- results --------------------------------------------------------------------

    def positions(self) -> int:
        """The decoder's positions: the prompt and the label bucket."""
        return len(self.ctx.model["whisper_flamingo"]["prompt"]) + self.mix["label_bucket"]

    def flops_per_unit(self) -> float:
        return flops_whisper_flamingo.train_step(self.ctx.model, self.mix["batch"],
                                                 self.mix["bucket"], self.positions(),
                                                 self.mix["lip_size"])

    def kernel_work(self) -> dict:
        m = self.ctx.model
        window = 2 * m["whisper_flamingo"]["n_audio_ctx"] * m["frontend"]["hop_length"]
        return {"logmel_kernel": flops_whisper_flamingo.k1(self.mix["batch"], window,
                                                           m["frontend"])}

    def check(self) -> dict:
        loss = float(self.metrics["loss"])
        B = self.mix["batch"]
        if (not np.isfinite(loss) or any(lp.shape[0] != B for lp in self.program["lp"])
                or not self.frozen_held):
            self.failed_units += 1
        del self.state, self.trainer, self.metrics, self.batch
        common.free(self.device)
        ref = reference_steps(self.ctx, self.template, self.train_names, self.pool,
                              self.mix["check_steps"])
        out = compare(self.program, ref)
        out["frozen_moved"] = self.program["frozen_moved"]
        probe = self.program["probe"]
        xattn, xattn_detail = probe_compare(probe, reference_probe(self.ctx, probe, self.pool[0]),
                                            probe["x"])
        out.update(xattn)
        self.detail = out.pop("detail")
        self.detail.update(leaves=leaf_table(self.program, ref), xattn=xattn_detail,
                           video_spread=self.program["video_spread"])
        return out


def compare(prog: dict, ref: dict) -> dict:
    """``train.compare`` over the leaves whose reference first gradient is at
    least ``NOISE_FLOOR`` of the median leaf's; the others are listed in the
    detail's ``left_out``."""
    import torch

    norm = {n: float(torch.linalg.vector_norm(g)) for n, g in ref["grad"].items()}
    med = float(np.median(list(norm.values())))
    kept = {n for n, g in norm.items() if g >= NOISE_FLOOR * med}

    def only(d):
        return {**d, "grad": {n: d["grad"][n] for n in kept},
                "update": {n: d["update"][n] for n in kept}}

    out = train.compare(only(prog), only(ref), detail=True)
    out["detail"]["left_out"] = sorted(set(norm) - kept)
    return out


def leaf_table(prog: dict, ref: dict) -> dict:
    """Per trainable leaf: its reference first gradient's norm over the
    median leaf's, and its change's norm gap as ``update_gap`` takes it."""
    import torch

    def norms(key):
        return {n: float(torch.linalg.vector_norm(t)) for n, t in ref[key].items()}

    g, u = norms("grad"), norms("update")
    med_g, med_u = float(np.median(list(g.values()))), float(np.median(list(u.values())))
    return {n: [g[n] / med_g, abs(float(torch.linalg.vector_norm(prog["update"][n])) - u[n])
                / max(u[n], med_u)] for n in g}


def reference_steps(ctx, template: dict, names: list, pool: list, steps: int,
                    lowp: bool = False, probe: dict | None = None) -> dict:
    """The reference's first ``steps`` training steps from ``ctx.seed``'s
    weights on ``pool``'s batches, ``names`` trained: each step's loss, the
    first step's target log-probabilities, each trainable's first gradient
    and its change, on the host; on float8 operands with ``lowp``.  With a
    ``probe`` dict, it gains what ``reference_probe`` reads of the
    ``probe_blocks``: the input that reached each in the first step, and its
    weights then."""
    import torch

    dev = ctx.device
    w = ctx.model["whisper_flamingo"]
    P = weights.seeded_state_dict(template, ctx.seed, dev)
    params = {n: P[n].clone().requires_grad_() for n in names}
    net = WhisperFlamingoNet({**P, **params}, ctx.model, lowp=lowp, checkpoint=True)
    if probe is not None:
        blocks = probe_blocks(w["n_text_layer"])
        probe.update(x={}, params={i: {n.split(".", 2)[2]: P[n].detach().float().cpu()
                                       for n in names if n.startswith(f"gated.{i}.")}
                                   for i in blocks})
        gated = net.gated

        def keep_input(i, x, video, vmask):
            if i in blocks and i not in probe["x"]:
                probe["x"][i] = x.detach().float().cpu()
            return gated(i, x, video, vmask)

        net.gated = keep_input
    adam = Adam(params, ctx.train)
    out = {"loss": [], "grad": {}, "update": {}}
    with common.full_f32():
        for k in range(steps):
            raw = pool[k % len(pool)]
            inp = ref_pre.model_inputs(raw, dev, ctx.mix["lip_size"])
            rows = [labels(torch.from_numpy(raw["text" + s]).to(dev), raw[f"text{s}_lengths"], w)
                    for s in "12"]
            tokens = torch.cat([rows[0][0], rows[1][0]])
            targets = torch.cat([rows[0][1], rows[1][1]])
            fwd = net.forward(inp, tokens)
            loss = ce_loss(fwd["logits"], targets, fwd["B"])
            grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
            out["loss"].append(float(loss.detach()))
            if k == 0:
                B = fwd["B"]
                lg = fwd["logits"].detach()
                out.update(target_log_probs([lg[:B], lg[B:]], [targets[:B], targets[B:]]))
                out["grad"] = {n: g.detach().cpu() for n, g in grads.items()}
            adam.step(grads)
            del loss, grads, inp, fwd
    with torch.no_grad():
        out["update"] = {n: (params[n] - P[n]).cpu() for n in names}
    del P, params, net, adam
    common.free(dev)
    return out

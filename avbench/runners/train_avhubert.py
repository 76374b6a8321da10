"""Runner ``train_avhubert``: ``runners/train.py``'s step, set-up and check on
AV-HuBERT (``model.arch = "avhubert"``, ``models/avhubert.py``): raw collated
batch -> ``device_preprocessed_batches`` -> ``MultiSpeakerTrainer.train_step``,
one step a unit, the model built by ``build_av_model`` on seeded weights.

The check is the train runner's (``lp_rms``, ``grad_gap``, ``update_gap``,
``grad_diff``; its docstring), against ``reference/avhubert.py``'s steps in
float32 with TF32 off, the trunk's blocks and the transformer layers
recomputed in the backward so the published widths fit.  A traced run times,
by forward hooks on the model's modules, ``avhubert_layers`` (the transformer
layers and final LayerNorm) and ``avhubert_frontends`` (the visual encoder,
the audio front end with K1, and the fusion with the positional
convolution).
"""

from __future__ import annotations

import numpy as np

from .. import flops_avhubert, traffic, weights
from ..reference import preprocess as ref_pre
from ..reference.avhubert import AVHubertNet, ctc_losses
from ..reference.train import Adam
from . import common, train

KIND = "train"


def meta_model(ctx):
    """The system's model of ``ctx.config`` (``build_av_model``), on the meta
    device."""
    import torch

    from multimodal_av_model_tpu_torch.config import torch_dtype
    from multimodal_av_model_tpu_torch.models import build_av_model

    with torch.device("meta"):
        return build_av_model(ctx.config.model, torch_dtype(ctx.config.model.dtype))


def seeded_model(ctx):
    """The system's model on ``ctx.device`` with the weights of ``ctx.seed``;
    -> ``(model, template)``."""
    model = meta_model(ctx)
    template = dict(model.state_dict())
    model = model.to_empty(device=ctx.device)
    model.load_state_dict(weights.seeded_state_dict(template, ctx.seed, ctx.device), strict=True)
    return model, template


class Job(train.Job):
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
        model, self.template = seeded_model(ctx)
        self.trainer = MultiSpeakerTrainer(ctx.config, model, None, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(ctx.dropout_seed)
        self.state = TrainState(0, model, self.trainer.make_optimizer(), gen)
        self.next_unit = self.mix["warmup"]
        self.failed_units = 0
        self.metrics = None

    def attach(self, spans) -> None:
        model = self.state.model
        spans.hook("avhubert_layers", model.encoder)
        for module in (model.visual_encoder, model.audio_frontend, model.fusion):
            spans.hook("avhubert_frontends", module)

    def flops_per_unit(self) -> float:
        B, T, S = common.shapes(self.mix)
        return flops_avhubert.train_step(self.ctx.model, B, T, S, self.mix["lip_size"])

    def check(self) -> dict:
        loss = float(self.metrics["loss"])
        B = self.mix["batch"]
        if not np.isfinite(loss) or any(lp.shape[0] != B for lp in self.program["lp"]):
            self.failed_units += 1
        del self.state, self.trainer, self.metrics
        common.free(self.device)
        ref = reference_steps(self.ctx, self.template, self.pool, self.mix["check_steps"])
        out = train.compare(self.program, ref, detail=True)
        self.detail = out.pop("detail")
        return out


def reference_steps(ctx, template: dict, pool: list, steps: int, lowp: bool = False) -> dict:
    """The reference's first ``steps`` training steps from ``ctx.seed``'s
    weights on ``pool``'s batches (``train.reference_steps``' outputs), on
    float8 operands with ``lowp``."""
    import torch

    dev = ctx.device
    P = weights.seeded_state_dict(template, ctx.seed, dev)
    names = [n for n in template if not n.endswith(("running_mean", "running_var"))]
    params = {n: P[n].clone().requires_grad_() for n in names}
    net = AVHubertNet({**P, **params}, ctx.model, train=True, lowp=lowp, checkpoint=True)
    adam = Adam(params, ctx.train)
    out = {"loss": [], "grad": {}, "update": {}}
    with common.full_f32():
        for k in range(steps):
            raw = pool[k % len(pool)]
            inp = ref_pre.model_inputs(raw, dev, ctx.mix["lip_size"])
            fbank = ref_pre.log_mel(inp["audio"], ctx.model["frontend"])
            labels = {key: torch.from_numpy(raw[key]).to(dev)
                      for key in ("text1", "text1_lengths", "text2", "text2_lengths")}
            fwd = net.forward(inp, fbank)
            loss = ctc_losses(fwd, labels, ctx.model)
            grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
            out["loss"].append(float(loss.detach()))
            if k == 0:
                B = fwd["B"]
                out.update(train.log_probs({"log_probs1": fwd["log_probs"][:B],
                                            "log_probs2": fwd["log_probs"][B:],
                                            "input_lengths1": fwd["input_lengths"][:B],
                                            "input_lengths2": fwd["input_lengths"][B:]}))
                out["grad"] = {n: g.detach().cpu() for n, g in grads.items()}
            adam.step(grads)
            del loss, grads, inp, fbank, fwd
    with torch.no_grad():
        out["update"] = {n: (params[n] - P[n]).cpu() for n in names}
    del P, params, net, adam
    common.free(dev)
    return out

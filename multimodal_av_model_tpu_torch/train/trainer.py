"""Training runtime of the two-speaker models (``models.build_av_model``).

Mirrors ``multimodal_av_model_tpu/train/trainer.py:44-578``, the training
step up to the whole run (``fit``: epochs, eval, rolling checkpoints, CSV
logs, early stop, preemption):

* total loss ``(ctc1 + ctc2) / 2 + lambda_contrastive * (contrast1 +
  contrast2) / 2``, each CTC term per sample over its label length, flush
  rows (``valid`` 0) weighted out;
* Adam in two groups, ``learning_rate`` and ``audio_learning_rate`` for the
  audio encoder (``trainer.py:52-84,141-161``).  Frozen parameters are left
  out of the optimizer but keep their gradient, which the ``grad_norm``
  metric counts as optax's ``global_norm(grads)`` does (``trainer.py:303``);
  only the visual encoder under ``stop_visual_grad`` takes none;
* optax's placement inside each group: clipping by that group's norm, the
  learning-rate schedule read at the update count before it is incremented,
  and gradient accumulation as ``optax.MultiSteps`` (a running mean over k
  micro-batches, the schedule advancing once per update);
* bf16 compute with f32 parameters needs no loss scaling (bf16 has f32's
  exponent range);
* a model without contrastive taps (``model.arch = "avhubert"``, an
  early-fusion encoder that has no audio encoder to tap) trains on the CTC
  terms alone: ``contrast1`` and ``contrast2`` read 0, and
  ``contrastive_only`` or a mesh raise;
* an attention decoder (``model.arch = "whisper_flamingo"``) trains on the
  teacher-forced cross-entropy: each speaker's term is the mean over rows of
  each row's token-mean over its targets (``targets{1,2}``, flush rows
  weighted out), the two averaged (metrics ``loss, ce1, ce2, grad_norm``).
  Its frozen modules (the model's ``frozen_prefixes``) hold no gradient and
  no Adam state; it trains through ``train_step`` alone: ``eval_step``,
  ``evaluate``, ``train_epoch``, ``fit`` and a mesh raise.

The trainer runs on the card unless built with ``device="cpu"``.  Its state
lives in a ``TrainState``; ``train_step(state, batch)`` updates it in place
and returns it with the step's metrics as device tensors.

With a ``mesh`` (``parallel.make_mesh``; ``trainer.py:172-210, 348-365,
458-486``) each rank is given its process-local rows and the step computes
what one device computes on the whole batch, as JAX's sharded step does:

* ``init_state`` seeds the whole model, then splits it (``parallel.parallelize``:
  the tensor plan over ``model``, FSDP over ``data`` with ``fsdp``);
* BatchNorm statistics and dropout masks are the whole batch's
  (``parallel.bind_data_axis``);
* the contrastive term spans every row, so the projected features and masks
  are all-gathered over ``data`` (with their gradient) before it;
* the CTC normaliser is the global valid count, all-reduced.  Gradients are
  averaged over ``data`` (by FSDP, or by one all-reduce without it), so each
  rank's objective is its rows' share of the loss times the ``data`` size;
  the metrics are the global values;
* clipping norms and ``grad_norm`` are taken over whole gradients; the
  parameters the tensor plan leaves whole share one gradient across each
  ``model`` group, so their copies cannot drift apart;
* ``evaluate`` decodes each rank's rows and sums the error counts over
  ``data``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..config import CTC_ARCHS, Config, require_arch
from ..infer import decode_ids, load_fusion_lm
from ..models.av_model import MultiSpeakerAVModel
from ..models.layers import init_weights
from ..ops.contrastive import contrastive_loss_with_mask
from ..ops.ctc import ctc_greedy_decode, ctc_loss
from ..ops.metrics import cer_counts, rate_from_counts, wer_counts
from ..parallel.mesh import local_batch_rows
from ..text.korean import jamo_counts
from ..tracing import span
from .checkpoints import CheckpointManager, writes_files
from .logging_utils import CsvLogger, StepTimer, TensorBoardLogger
from .preempt import GracefulShutdown
from .profiling import NonFiniteLossError, check_finite

GROUPS = ("base", "audio")
METRIC_KEYS = ("loss", "ctc1", "ctc2", "contrast1", "contrast2", "grad_norm")


def _local(t: torch.Tensor) -> torch.Tensor:
    """The rank-local block of a (possibly split) tensor, sharing storage."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _on_model_axis(t: torch.Tensor) -> bool:
    """Whether ``t`` is split over the mesh's ``model`` axis (by the tensor
    plan), so each rank of a ``model`` group holds its own block."""
    from torch.distributed.tensor import DTensor

    from ..parallel import MODEL_AXIS

    return isinstance(t, DTensor) and MODEL_AXIS in (t.device_mesh.mesh_dim_names or ())


def _layout(t: torch.Tensor):
    """``(mesh, placements)`` of a tensor split over a mesh, else None."""
    from torch.distributed.tensor import DTensor

    return (t.device_mesh, t.placements) if isinstance(t, DTensor) else None


def total_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together, whole: tensors split over a
    mesh are normed per layout and the partial norms reduced."""
    from ..parallel import full_tensor

    by_layout: dict = {}
    for t in tensors:
        by_layout.setdefault(_layout(t), []).append(t)
    norms = [full_tensor(torch.nn.utils.get_total_norm(ts)) for ts in by_layout.values()]
    return norms[0] if len(norms) == 1 else torch.linalg.vector_norm(torch.stack(norms))


def place_batch(batch: dict, device) -> dict:
    """Every entry of ``batch`` but ``num_real`` as a tensor on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items() if k != "num_real"}


def label_params(names: Iterable[str], frozen_prefixes: tuple[str, ...] = (),
                 audio_trainable_layers: tuple[int, ...] | None = None) -> dict[str, str]:
    """Parameter name -> "base", "audio" (the audio encoder) or "frozen"
    (``trainer.py:52-84``).  Names and prefixes are the port's dotted
    parameter names.  With ``audio_trainable_layers`` only those Conformer
    blocks of the audio encoder stay "audio"; the rest of it is frozen."""
    trainable = (None if audio_trainable_layers is None
                 else tuple(f"audio_encoder.blocks.{i}." for i in audio_trainable_layers))
    labels = {}
    for name in names:
        if any(name.startswith(p) for p in frozen_prefixes):
            labels[name] = "frozen"
        elif name.startswith("audio_encoder."):
            labels[name] = "audio" if trainable is None or name.startswith(trainable) else "frozen"
        else:
            labels[name] = "base"
    return labels


def make_lr_schedule(tcfg, base_lr: float) -> Callable[[int], float]:
    """The group's learning rate as a function of its update count
    (``trainer.py:87-110``, optax's schedules written out)."""
    if tcfg.lr_schedule == "constant":
        return lambda count: base_lr
    warm = max(tcfg.warmup_steps, 1)
    if tcfg.lr_schedule == "warmup_cosine":
        # optax.warmup_cosine_decay_schedule: linear 0 -> peak over `warm`
        # updates, then cosine decay to lr_min_ratio * peak at `decay`.
        decay = max(tcfg.decay_steps, tcfg.warmup_steps + 1) - warm
        end = base_lr * tcfg.lr_min_ratio
        alpha = 0.0 if base_lr == 0.0 else end / base_lr

        def warmup_cosine(count: int) -> float:
            if count < warm:
                return base_lr * count / warm
            t = min(count - warm, decay)
            cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
            return base_lr * ((1.0 - alpha) * cosine + alpha)

        return warmup_cosine
    if tcfg.lr_schedule == "noam":
        def noam(count: int) -> float:
            s = max(count, 1)
            return base_lr * math.sqrt(warm) * min(s ** -0.5, s * warm ** -1.5)

        return noam
    raise ValueError(f"unknown lr_schedule {tcfg.lr_schedule!r}")


class GroupAdam:
    """Adam over the "base" and "audio" groups (b1 0.9, b2 0.999, eps 1e-8
    outside the square root, as optax places it), with per-group clipping,
    schedules and optax ``MultiSteps`` accumulation.  Call ``step()`` after
    each micro-batch's backward; it returns whether it applied an update.
    Its state dict is keyed by parameter name."""

    def __init__(self, named_params: list[tuple[str, torch.nn.Parameter]],
                 labels: dict[str, str], tcfg):
        self.tcfg = tcfg
        self.names = {g: [n for n, _ in named_params if labels[n] == g] for g in GROUPS}
        by_name = dict(named_params)
        self.params = {g: [by_name[n] for n in self.names[g]] for g in GROUPS}
        base_lr = {"base": tcfg.learning_rate, "audio": tcfg.audio_learning_rate}
        self.schedules = {g: make_lr_schedule(tcfg, base_lr[g]) for g in GROUPS}
        # torch's multi-tensor Adam cannot mix tensors of several layouts
        # (plain and split over a mesh): then it steps parameter by parameter.
        layouts = {_layout(p) for g in GROUPS for p in self.params[g]}
        self.adam = torch.optim.Adam(
            [{"params": self.params[g], "lr": 0.0, "name": g} for g in GROUPS if self.params[g]],
            betas=(0.9, 0.999), eps=1e-8, foreach=None if len(layouts) <= 1 else False)
        self.updates = 0            # optax's count: updates applied so far
        self.mini_step = 0          # micro-batches in the accumulator
        self._acc: list[torch.Tensor] | None = None

    def _named(self) -> list[tuple[str, torch.nn.Parameter]]:
        return [(n, p) for g in GROUPS for n, p in zip(self.names[g], self.params[g])]

    def step(self) -> bool:
        params = [p for _, p in self._named()]
        for p in params:
            if p.grad is None:          # cut by stop_visual_grad: optax sees zeros
                p.grad = torch.zeros_like(p)
        k = self.tcfg.grad_accum_steps
        if k > 1:
            grads = [p.grad for p in params]
            if self._acc is None:
                self._acc = [g.clone() for g in grads]
            else:                       # running mean, as MultiSteps' _acc_update
                n = self.mini_step
                acc = [_local(a) for a in self._acc]
                torch._foreach_mul_(acc, float(n))
                torch._foreach_add_(acc, [_local(g) for g in grads])
                torch._foreach_div_(acc, float(n + 1))
            self.mini_step += 1
            if self.mini_step < k:
                return False
            for p, a in zip(params, self._acc):
                p.grad = a
            self._acc, self.mini_step = None, 0
        clip = self.tcfg.grad_clip_norm
        for group in self.adam.param_groups:
            if clip:                    # optax.clip_by_global_norm over this group
                grads = [p.grad for p in group["params"]]
                norm = total_norm(grads)
                torch._foreach_mul_([_local(g) for g in grads],
                                    torch.where(norm < clip, 1.0, clip / norm))
            group["lr"] = self.schedules[group["name"]](self.updates)
        self.adam.step()
        self.updates += 1
        return True

    def init_moments(self) -> None:
        """Give every parameter its (zero) Adam moments now, as optax's
        ``init`` does, so the state dict names them all before the first
        update (a sharded checkpoint restores into that template)."""
        for _, p in self._named():
            if not self.adam.state.get(p):
                self.adam.state[p] = {"step": torch.tensor(float(self.updates)),
                                      "exp_avg": torch.zeros_like(p),
                                      "exp_avg_sq": torch.zeros_like(p)}

    def state_dict(self) -> dict:
        mu, nu = {}, {}
        for n, p in self._named():
            st = self.adam.state.get(p)
            if st:
                mu[n], nu[n] = st["exp_avg"], st["exp_avg_sq"]
        acc = None if self._acc is None else {
            n: a for (n, _), a in zip(self._named(), self._acc)}
        return {"updates": self.updates, "mini_step": self.mini_step, "mu": mu, "nu": nu,
                "acc": acc}

    def load_state_dict(self, sd: dict) -> None:
        """Take ``sd``'s values (whole tensors, or split as the parameters
        are) into this optimizer's own tensors."""
        from ..parallel import copy_into

        def like(p, value):
            out = torch.zeros_like(p)
            copy_into(out, value)
            return out

        self.updates, self.mini_step = int(sd["updates"]), int(sd["mini_step"])
        for n, p in self._named():
            if n in sd["mu"]:
                self.adam.state[p] = {
                    "step": torch.tensor(float(self.updates)),
                    "exp_avg": like(p, sd["mu"][n]),
                    "exp_avg_sq": like(p, sd["nu"][n])}
            else:
                self.adam.state.pop(p, None)
        acc = sd.get("acc")
        self._acc = None if acc is None else [like(p, acc[n]) for n, p in self._named()]


@dataclasses.dataclass
class TrainState:
    """``step`` counts ``train_step`` calls (micro-batches); the model holds
    the parameters and BatchNorm statistics; ``generator`` draws dropout."""

    step: int
    model: MultiSpeakerAVModel
    optimizer: GroupAdam
    generator: torch.Generator

    def state_dict(self) -> dict:
        """Parameters and moments as the model holds them (split over a
        mesh, they are ``DTensor``s; ``checkpoints.host_snapshot`` gathers
        them whole)."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def sharded_state_dict(self) -> dict:
        """``state_dict`` with every Adam moment present: the template a
        sharded checkpoint is written from and restored into."""
        self.optimizer.init_moments()
        return self.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        """Take ``sd`` (whole tensors, or split as the model is) in place."""
        from torch.distributed.tensor import DTensor

        from ..parallel import copy_into

        self.step = int(sd["step"])
        own = self.model.state_dict()
        if any(isinstance(v, DTensor) for v in own.values()):
            if set(own) != set(sd["model"]):
                raise KeyError("state dict keys differ from the model's: "
                               f"{sorted(set(own) ^ set(sd['model']))[:8]}")
            for k, v in own.items():
                copy_into(v, sd["model"][k])
        else:
            self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        if "generator" in sd:
            self.generator.set_state(sd["generator"])


def seeded_state(model, make_optimizer: Callable[[], GroupAdam], device, seed: int) -> TrainState:
    """A fresh ``TrainState``: parameters from ``init_weights`` with a
    generator seeded by ``seed``, ``make_optimizer()``, and a dropout
    generator on ``device`` seeded by ``seed`` as well."""
    init_weights(model, torch.Generator().manual_seed(seed))
    return TrainState(0, model, make_optimizer(), torch.Generator(device=device).manual_seed(seed))


def one_group_adam(model, tcfg) -> GroupAdam:
    """``GroupAdam`` with every parameter in one group at ``tcfg``'s
    learning rate, schedule and clipping (optax's ``chain(clip_by_global_norm,
    adam(schedule))`` over the whole tree); no accumulation."""
    named = list(model.named_parameters())
    return GroupAdam(named, {n: "base" for n, _ in named},
                     dataclasses.replace(tcfg, grad_accum_steps=1))


@dataclasses.dataclass
class MultiSpeakerTrainer:
    """The train and eval steps and the epoch loops of the flagship model.
    ``mesh``: a ``(data, model)`` ``DeviceMesh`` this rank belongs to (each
    rank then gets its process-local rows); ``fsdp``: shard parameters and
    Adam's moments over ``data``."""

    config: Config
    model: MultiSpeakerAVModel
    tokenizer: Any
    frozen_prefixes: tuple[str, ...] = ()
    device: str = "cuda"
    mesh: Any = None
    fsdp: bool = False

    def __post_init__(self):
        from ..parallel import DATA_AXIS, MODEL_AXIS, axis_size

        if self.mesh is not None:
            require_arch(self.config.model, "the meshed training step (data, tensor and "
                                                "FSDP parallelism)")
        if self.config.train.contrastive_only:
            require_arch(self.config.model, "train.contrastive_only (the contrastive "
                                                "taps of the audio encoder)")
        self.device = torch.device(self.device)
        self.model = self.model.to(self.device)
        self.lm = load_fusion_lm(self.config.decode.lm_path, self.device)
        self.data_size = axis_size(self.mesh, DATA_AXIS)
        self._data_group = None if self.data_size == 1 else self.mesh[DATA_AXIS].get_group()
        tp = axis_size(self.mesh, MODEL_AXIS)
        self._model_group = None if tp == 1 else self.mesh[MODEL_AXIS].get_group()
        self._split = False

    # -- state ---------------------------------------------------------------

    def make_optimizer(self) -> GroupAdam:
        named = list(self.model.named_parameters())
        frozen = tuple(self.frozen_prefixes) + getattr(self.model, "frozen_prefixes", ())
        labels = label_params([n for n, _ in named], frozen,
                              self.config.train.audio_trainable_layers)
        return GroupAdam(named, labels, self.config.train)

    def init_state(self, seed: int = 0) -> TrainState:
        """``seeded_state`` of the model with a fresh two-group optimizer.
        With a mesh the seeded model is then split over it, once: a second
        call raises."""
        if self._split:
            raise ValueError("a meshed trainer's model is split by its first init_state")

        def make_optimizer():
            if self.mesh is not None:
                from ..parallel import parallelize

                parallelize(self.model, self.mesh, self.fsdp)
                self._split = True
            return self.make_optimizer()

        return seeded_state(self.model, make_optimizer, self.device, seed)

    # -- loss ----------------------------------------------------------------

    def _place(self, batch: dict) -> dict:
        """The batch on this rank's device: under a mesh the batch is this
        process's rows (``parallel.shard_batch``)."""
        if self.mesh is not None:
            from ..parallel import shard_batch

            return shard_batch(self.mesh, batch, self.device)
        return place_batch(batch, self.device)

    def _losses(self, model, batch: dict, generator, train: bool):
        """``trainer.py:222-287``: the total loss, the metrics and the model
        outputs, on a placed batch."""
        frozen_visual = any(p.startswith("visual_encoder") for p in self.frozen_prefixes)
        tokens = {k: batch[k] for k in ("tokens1", "tokens2") if k in batch}
        with span("train.forward"):
            out = model(batch["lip1"], batch["lip2"], batch["audio"], batch["mask1"],
                        batch["mask2"], batch["lip1_lengths"], batch["lip2_lengths"],
                        train=train, stop_visual_grad=frozen_visual, generator=generator,
                        **tokens)
        if "logits1" in out:
            with span("train.losses"):
                ce1, ce2 = (self._token_ce(out["logits" + s], batch["targets" + s],
                                           batch.get("valid")) for s in "12")
                loss = (ce1 + ce2) / 2
            return loss, {"loss": loss, "ce1": ce1, "ce2": ce2}, out
        with span("train.losses"):
            ccfg = self.config.model.contrastive
            blank = self.config.model.decoder.blank_id
            valid = batch.get("valid")
            mask_ds1, mask_ds2 = out.get("mask_ds1"), out.get("mask_ds2")
            if valid is not None and mask_ds1 is not None:
                # Flush rows (valid 0) become pad for the contrastive loss and get
                # no CTC weight: a flush batch gives its unpadded batch's loss.
                row_ok = (valid > 0)[:, None]
                mask_ds1 = torch.where(row_ok, mask_ds1, 3)
                mask_ds2 = torch.where(row_ok, mask_ds2, 3)
            group = self._data_group

            def contrast(feat, mask):
                if group is not None:       # every row of the batch is a candidate
                    from ..parallel import gather_rows

                    feat, mask = gather_rows(feat, self.mesh), gather_rows(mask, self.mesh)
                return contrastive_loss_with_mask(feat, mask, ccfg.temperature,
                                                  ccfg.weight_pos_align, ccfg.weight_neg_suppress)

            if "contrast1" in out:
                con1 = contrast(out["contrast1"], mask_ds1)
                con2 = contrast(out["contrast2"], mask_ds2)
            else:                           # no taps: the CTC terms alone
                con1 = con2 = torch.zeros((), device=out["log_probs1"].device)

            def weighted_ctc(lp, labels, il, ll):
                """-> (this rank's objective term, the global value)."""
                per = ctc_loss(lp, labels, il, ll, blank, reduction="none")
                per = per / ll.clamp(min=1).float()
                if group is None:
                    v = per.mean() if valid is None else \
                        (per * valid).sum() / valid.sum().clamp(min=1.0)
                    return v, v
                w = torch.ones_like(per) if valid is None else valid
                num = (per * w).sum()
                sums = torch.stack([num.detach(), w.sum()])
                torch.distributed.all_reduce(sums, group=group)
                den = sums[1].clamp(min=1.0)
                return self.data_size * num / den, sums[0] / den

            if self.config.train.contrastive_only:
                ctc1 = ctc2 = torch.zeros((), device=con1.device)
                total = loss = (con1 + con2) / 2
            else:
                obj1, ctc1 = weighted_ctc(out["log_probs1"], batch["text1"], out["input_lengths1"],
                                          batch["text1_lengths"])
                obj2, ctc2 = weighted_ctc(out["log_probs2"], batch["text2"], out["input_lengths2"],
                                          batch["text2_lengths"])
                lam = self.config.train.lambda_contrastive
                total = (obj1 + obj2) / 2 + lam * (con1 + con2) / 2
                loss = (ctc1 + ctc2) / 2 + lam * (con1 + con2) / 2
            metrics = {"loss": loss, "ctc1": ctc1, "ctc2": ctc2,
                       "contrast1": con1, "contrast2": con2}
        return total, metrics, out

    @staticmethod
    def _token_ce(logits, targets, valid=None):
        """The mean over rows (weighted by ``valid``) of each row's mean
        cross-entropy over its target positions (``targets`` not
        ``IGNORE``)."""
        from ..data.device_pipeline import IGNORE

        B, n, V = logits.shape
        per = torch.nn.functional.cross_entropy(logits.reshape(B * n, V), targets.reshape(-1),
                                                ignore_index=IGNORE, reduction="none")
        per = per.view(B, n).sum(dim=1) / (targets != IGNORE).sum(dim=1).clamp(min=1)
        if valid is None:
            return per.mean()
        return (per * valid).sum() / valid.sum().clamp(min=1.0)

    # -- steps ---------------------------------------------------------------

    def train_step(self, state: TrainState, batch: dict):
        """Forward, backward and (every ``grad_accum_steps``-th call) an
        optimizer update -> ``(state, metrics)``, the metrics ``loss, ctc1,
        ctc2, contrast1, contrast2, grad_norm`` as device scalars: reading
        them is left to the caller.  The step is not free of host syncs:
        ``F.ctc_loss`` copies its two length tensors to the host once per
        speaker.  The gradients stay in the parameters' ``.grad`` until the
        next step (clipped in place when ``grad_clip_norm`` is set).  Spans
        (``tracing``): ``train.step`` and its ``train.forward``,
        ``train.losses``, ``train.backward``, ``train.allreduce`` (over a
        mesh without FSDP) and ``train.optimizer``."""
        with span("train.step"):
            model = state.model
            model.zero_grad(set_to_none=True)
            total, metrics, _ = self._losses(model, self._place(batch), state.generator, True)
            with span("train.backward"):
                total.backward()
            if self._data_group is not None and not self.fsdp:
                self._average_grads(model.parameters(), self._data_group)
            if self._model_group is not None:
                # The parameters the tensor plan leaves whole are computed on
                # every rank of a ``model`` group alike; nondeterministic kernels
                # (cuDNN's) would let the copies drift apart, so they share one
                # gradient.
                self._average_grads([p for p in model.parameters() if not _on_model_axis(p)],
                                    self._model_group)
            with span("train.optimizer"):
                metrics["grad_norm"] = total_norm(
                    [p.grad for p in model.parameters() if p.grad is not None])
                state.optimizer.step()
            state.step += 1
            return state, {k: v.detach() for k, v in metrics.items()}

    @staticmethod
    def _average_grads(params, group) -> None:
        """Average the gradients of ``params`` over ``group`` as one flat
        all-reduce (over ``data``: the reduction FSDP does when it shards).
        Span (``tracing``): ``train.allreduce``, the flattening, the
        all-reduce and the copy back."""
        from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

        grads = [_local(p.grad) for p in params if p.grad is not None]
        if not grads:
            return
        with span("train.allreduce"):
            flat = _flatten_dense_tensors(grads)
            torch.distributed.all_reduce(flat, group=group)
            flat /= torch.distributed.get_world_size(group)
            torch._foreach_copy_(grads, _unflatten_dense_tensors(flat, grads))

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict):
        """Eval-mode losses and outputs, with greedy ids (``trainer.py:312-331``)."""
        require_arch(self.config.model, "eval_step", CTC_ARCHS)
        _, metrics, out = self._losses(state.model, self._place(batch), None, False)
        blank = self.config.model.decoder.blank_id
        res = {k: out[k] for k in ("log_probs1", "input_lengths1", "log_probs2",
                                   "input_lengths2", "contrast1", "mask_ds1",
                                   "contrast2", "mask_ds2") if k in out}
        for s in ("1", "2"):
            res["greedy" + s], res[f"greedy{s}_len"] = ctc_greedy_decode(
                out["log_probs" + s], out["input_lengths" + s], blank)
        return metrics, res

    # -- host orchestration --------------------------------------------------

    def train_epoch(self, batches: Iterable[dict], log_every: int | None = None,
                    log_fn: Callable[[str], None] = print, state: TrainState | None = None,
                    stop=None):
        """``trainer.py:367-436`` -> ``(state, mean loss, throughput)``.  With
        ``async_dispatch`` the metrics (and the audio length) fold into sums
        on the device with an all-finite flag, and the host reads them only at
        log points and at the end, where ``check_finite`` raises.  The
        throughput's ``input_wait_s`` is the time spent getting each next
        batch (the loader's queue, and for device-preprocessed batches their
        copy to the device and K2's launch), ``first_input_wait_s`` that of
        the first batch alone, and ``elapsed_s`` the epoch's seconds."""
        if state is None:
            raise ValueError("train_epoch needs a state (init_state)")
        require_arch(self.config.model, "train_epoch", CTC_ARCHS)
        log_every = log_every or self.config.train.log_every
        timer = StepTimer()
        sr = self.config.data.sample_rate
        guard = self.config.train.check_finite
        deferred = self.config.train.async_dispatch
        total, n = 0.0, 0
        acc = ok = None
        last_drained = -1
        batch_iter = iter(batches)
        for i in itertools.count():
            t_wait = time.perf_counter()
            batch = next(batch_iter, None)
            timer.input_waits.append(time.perf_counter() - t_wait)
            if batch is None:
                break
            if stop is not None and stop.requested:
                break
            state, metrics = self.train_step(state, batch)
            audio_len = torch.as_tensor(batch["audio_lengths"], device=self.device)
            if deferred:
                packed = torch.stack([metrics[k].float() for k in METRIC_KEYS]
                                     + [audio_len.sum().float()])
                acc = packed if acc is None else acc + packed
                good = torch.isfinite(packed[:-1]).all()
                ok = good if ok is None else ok & good
                timer.tick(batch["audio"].shape[0])
            else:
                loss = float(metrics["loss"])
                if guard:
                    check_finite({"loss": loss}, step=i)
                total += loss
                timer.tick(batch["audio"].shape[0], float(audio_len.sum()) / sr)
            n += 1
            if i % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}         # host sync
                if deferred:
                    if guard and not bool(ok):
                        raise NonFiniteLossError(
                            f"non-finite metrics in steps {last_drained + 1}..{i}")
                    timer.audio_seconds = float(acc[-1]) / sr
                last_drained = i
                tp = timer.summary()
                log_fn(f"[batch {i}] loss={m['loss']:.4f} ctc1={m['ctc1']:.4f} "
                       f"ctc2={m['ctc2']:.4f} con1={m['contrast1']:.4f} "
                       f"con2={m['contrast2']:.4f} gnorm={m['grad_norm']:.3f} "
                       f"utt/s={tp['utterances_per_sec']:.2f} rtf={tp['rtf']:.2f}")
        if deferred and acc is not None:
            if guard and not bool(ok):
                raise NonFiniteLossError(
                    f"non-finite metrics in steps {last_drained + 1}..{n - 1}")
            total = float(acc[0])
            timer.audio_seconds = float(acc[-1]) / sr
        return state, total / max(n, 1), timer.summary()

    def evaluate(self, batches: Iterable[dict], state: TrainState, use_beam: bool = True):
        """``trainer.py:441-493`` -> ``(avg_loss, avg_wer, cer, {"wer1",
        "wer2", "jer"})``; the loss is the CTC mean, decoding per
        ``config.decode`` (or greedy), rates from summed error counts."""
        require_arch(self.config.model, "evaluate", CTC_ARCHS)
        refs1, hyps1, refs2, hyps2 = [], [], [], []
        total, n = 0.0, 0
        for batch in batches:
            num_real = int(batch.get("num_real", batch["audio"].shape[0]))
            metrics, out = self.eval_step(state, batch)
            total += (float(metrics["ctc1"]) + float(metrics["ctc2"])) / 2
            n += 1
            decoded = []
            for s in ("1", "2"):
                if use_beam:
                    ids, lens = decode_ids(self.config, out["log_probs" + s],
                                           out["input_lengths" + s], True, self.lm)
                else:
                    ids, lens = out["greedy" + s], out[f"greedy{s}_len"]
                decoded.append((local_batch_rows(ids), local_batch_rows(lens)))
            t1, l1 = local_batch_rows(batch["text1"]), local_batch_rows(batch["text1_lengths"])
            t2, l2 = local_batch_rows(batch["text2"]), local_batch_rows(batch["text2_lengths"])
            (ids1, len1), (ids2, len2) = decoded
            for b in range(num_real):
                hyps1.append(self.tokenizer.decode(ids1[b, : len1[b]].tolist()))
                refs1.append(self.tokenizer.decode(t1[b, : l1[b]].tolist()))
                hyps2.append(self.tokenizer.decode(ids2[b, : len2[b]].tolist()))
                refs2.append(self.tokenizer.decode(t2[b, : l2[b]].tolist()))
        counts = torch.tensor([
            *wer_counts(refs1, hyps1), *wer_counts(refs2, hyps2),
            *cer_counts(refs1 + refs2, hyps1 + hyps2),
            *jamo_counts(refs1 + refs2, hyps1 + hyps2), total, n], dtype=torch.float64)
        if self._data_group is not None:
            # Each rank scored its rows: the additive counts sum over ``data``
            # (the ranks of one ``model`` group scored the same rows).
            counts = counts.to(self.device)
            torch.distributed.all_reduce(counts, group=self._data_group)
        c = counts.tolist()
        wer1, wer2 = rate_from_counts(c[0], c[1]), rate_from_counts(c[2], c[3])
        return (c[8] / max(c[9], 1), (wer1 + wer2) / 2, rate_from_counts(c[4], c[5]),
                {"wer1": wer1, "wer2": wer2, "jer": rate_from_counts(c[6], c[7])})

    def fit(self, state: TrainState, train_factory: Callable[[], Iterable[dict]],
            val_factory: Callable[[], Iterable[dict]], log_fn: Callable[[str], None] = print,
            start_epoch: int = 1) -> TrainState:
        """The training run (``trainer.py:495-578``): for each epoch from
        ``start_epoch`` to ``max_epochs``, ``train_epoch`` over
        ``train_factory()``, ``evaluate`` over ``val_factory()``, one
        ``[epoch N]`` line, a row in ``train_log.csv`` and ``eval_log.csv``
        (appended to when resuming), the rolling checkpoints of
        ``{"state", "epoch"}``, and early stop after ``early_stop_patience``
        epochs without a better eval loss (the count survives a resume in
        ``best.json``).  A SIGTERM or SIGINT (``handle_signals``) ends the
        epoch at the next step, saves ``last.ckpt`` as the previous epoch, so
        a resume redoes it, and returns."""
        require_arch(self.config.model, "the training run (fit)", CTC_ARCHS)
        tcfg = self.config.train
        resume = start_epoch > 1
        ckpts = CheckpointManager(tcfg.checkpoint_dir, async_io=tcfg.async_checkpoint,
                                  layout=tcfg.checkpoint_layout)
        writer = writes_files()         # over a mesh, rank 0 alone writes the logs

        def log_path(name):
            return f"{tcfg.checkpoint_dir}/{name}" if writer else os.devnull

        train_log = CsvLogger(log_path("train_log.csv"), ["epoch", "loss"], resume=resume)
        eval_log = CsvLogger(log_path("eval_log.csv"),
                             ["epoch", "eval_loss", "wer1", "wer2", "average_wer", "cer", "jer"],
                             resume=resume)
        tb = TensorBoardLogger(tcfg.tensorboard_dir if writer else "")
        best_loss, no_improve = ckpts.early_stop_state() if resume else (float("inf"), 0)
        with GracefulShutdown(enable=tcfg.handle_signals) as stop:
            for epoch in range(start_epoch, tcfg.max_epochs + 1):
                state, train_loss, throughput = self.train_epoch(
                    train_factory(), log_fn=log_fn, state=state, stop=stop)
                if stop.requested:
                    ckpts.save_now({"state": state, "epoch": epoch - 1})
                    log_fn(f"preempted: saved {ckpts.last} mid-epoch {epoch} "
                           f"(resume will redo the epoch)")
                    break
                eval_loss, eval_wer, eval_cer, per = self.evaluate(val_factory(), state)
                log_fn(f"[epoch {epoch}] train_loss={train_loss:.4f} eval_loss={eval_loss:.4f} "
                       f"wer={eval_wer:.3f} cer={eval_cer:.3f} "
                       f"utt/s={throughput['utterances_per_sec']:.2f} "
                       f"input_wait={throughput['input_wait_s']:.3f}s "
                       f"first_batch_wait={throughput['first_input_wait_s']:.3f}s "
                       f"train_s={throughput['elapsed_s']:.3f}")
                tb.scalars(epoch, **{
                    "train/loss": train_loss, "eval/loss": eval_loss, "eval/wer": eval_wer,
                    "eval/cer": eval_cer, "eval/jer": per["jer"],
                    "throughput/utt_per_sec": throughput["utterances_per_sec"]})
                train_log.log(epoch=epoch, loss=f"{train_loss:.4f}")
                eval_log.log(epoch=epoch, eval_loss=f"{eval_loss:.4f}",
                             wer1=f"{per['wer1']:.4f}", wer2=f"{per['wer2']:.4f}",
                             average_wer=f"{eval_wer:.4f}", cer=f"{eval_cer:.4f}",
                             jer=f"{per['jer']:.4f}")
                ckpts.on_epoch_end({"state": state, "epoch": epoch}, eval_loss, eval_wer)
                if eval_loss < best_loss:
                    best_loss, no_improve = eval_loss, 0
                else:
                    no_improve += 1
                ckpts.set_no_improve(no_improve)
                if no_improve >= tcfg.early_stop_patience:
                    log_fn(f"early stop after {no_improve} epochs without improvement")
                    break
        ckpts.wait()
        train_log.close()
        eval_log.close()
        tb.close()
        return state

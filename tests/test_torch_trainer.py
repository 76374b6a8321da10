"""PyTorch port, training step: ``MultiSpeakerTrainer`` held against the JAX
``MultiSpeakerTrainer`` from the same state (carried by
``train_state_from_jax``) on the same batch, plus the optimizer against optax
and the checkpoint manager against the JAX manager.  CPU, tiny widths,
``norm="batch"``, audio dropout 0 (the two libraries draw different masks).

Tolerances (f32 on both sides; the residue is summation order through a few
layers and a 2-layer BiLSTM):
* metrics: rtol 1e-4 (atol 1e-6);
* gradients, per tensor: ``|g - g_jax| <= 1e-3 |g_jax| + 1e-7``;
* parameters: Adam's first updates are about +-lr per element whatever the
  gradient's size, so elements whose JAX gradient is below 1e-7 are left
  out, and the rest agree to ``2e-2 * lr`` per step taken;
* BatchNorm running statistics: rtol 1e-4 (atol 1e-5);
* optimizer against optax on fixed gradients: rtol 1e-5 (atol 1e-8);
* bf16 loss within 2e-2 (relative) of JAX's bf16 loss.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization
from flax.traverse_util import flatten_dict, unflatten_dict

from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu.train import MultiSpeakerTrainer as JTrainer
from multimodal_av_model_tpu.train.checkpoints import CheckpointManager as JManager
from multimodal_av_model_tpu.train.trainer import label_params as j_label_params
from multimodal_av_model_tpu.train.trainer import make_lr_schedule as j_schedule
from multimodal_av_model_tpu.train.trainer import make_optimizer as j_make_optimizer
from multimodal_av_model_tpu_torch.compat import from_jax_variables, train_state_from_jax
from multimodal_av_model_tpu_torch.config import TrainConfig
from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
from multimodal_av_model_tpu_torch.text import CharTokenizer
from multimodal_av_model_tpu_torch.train import (
    CheckpointManager,
    GroupAdam,
    MultiSpeakerTrainer,
    NonFiniteLossError,
    graft_subtree,
    label_params,
    make_lr_schedule,
    restore_checkpoint,
    save_checkpoint,
)
from test_models import tiny_config
from test_torch_models import port_config, to_np
from test_trainer import tiny_batch

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
KEYS = ("loss", "ctc1", "ctc2", "contrast1", "contrast2", "grad_norm")
LR = 1e-4


def _cfg():
    cfg = tiny_config()
    cfg.model.decoder.vocab_size = 800
    cfg.model.visual.norm = "batch"
    cfg.model.audio.dropout = 0.0
    cfg.train.log_every = 1000
    return cfg


def _jax_step(trainer):
    """The JAX trainer's ``train_step`` body, also returning the gradients."""
    def step(state, batch):
        rng, step_rng = jax.random.split(state.rng)
        (_, (metrics, new_stats, _)), grads = jax.value_and_grad(
            lambda p: trainer._losses(p, state.batch_stats, batch, step_rng, True),
            has_aux=True)(state.params)
        updates, new_opt = trainer._tx.update(grads, state.opt_state, state.params)
        metrics["grad_norm"] = optax.global_norm(grads)
        return (state.replace(step=state.step + 1, params=optax.apply_updates(state.params, updates),
                              batch_stats=new_stats, opt_state=new_opt, rng=rng),
                metrics, grads)
    return jax.jit(step)


@pytest.fixture(scope="module")
def ref():
    """Three JAX steps from one state, with everything the tests compare."""
    jtok = JTokenizer(VOCAB)
    cfg = _cfg()
    batch = tiny_batch(jtok)
    jt = JTrainer(cfg, JModel(cfg.model), jtok)
    state = jt.init_state(0, batch)
    sd0 = serialization.to_state_dict(jax.device_get(state))
    step = _jax_step(jt)
    placed = jt._place(batch)
    steps = []
    for _ in range(3):
        state, metrics, grads = step(state, placed)
        steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                      "grads": from_jax_variables({"params": to_np(grads)}),
                      "state": from_jax_variables({"params": to_np(state.params),
                                                   "batch_stats": to_np(state.batch_stats)})})
    return {"cfg": cfg, "batch": batch, "sd0": sd0, "steps": steps, "jt": jt,
            "jstate0": jax.device_get(jt.init_state(0, batch))}


def _port(cfg, sd0=None, frozen_prefixes=(), dtype=torch.float32):
    pcfg = port_config(cfg)
    trainer = MultiSpeakerTrainer(pcfg, MultiSpeakerAVModel(pcfg.model, dtype),
                                  CharTokenizer(VOCAB), frozen_prefixes, device="cpu")
    state = trainer.init_state(0)
    if sd0 is not None:
        state.load_state_dict(train_state_from_jax(sd0))
    return trainer, state


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(ref, n_steps):
    trainer, state = _port(ref["cfg"], ref["sd0"])
    initial = {k: v.clone() for k, v in state.model.state_dict().items()}
    for i in range(n_steps):
        state, metrics = trainer.train_step(state, ref["batch"])
        want = ref["steps"][i]
        for k in KEYS:
            np.testing.assert_allclose(metrics[k].item(), want["metrics"][k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i + 1} {k}")
        for name, p in state.model.named_parameters():
            g, g_ref = p.grad, want["grads"][name]
            assert torch.linalg.vector_norm(g - g_ref) <= \
                1e-3 * torch.linalg.vector_norm(g_ref) + 1e-7, f"step {i + 1} grad {name}"
    assert state.step == n_steps and state.optimizer.updates == n_steps
    want = ref["steps"][n_steps - 1]["state"]
    moved = ref["steps"][0]["grads"]
    for name, value in state.model.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(value, want[name], rtol=1e-4, atol=1e-5, msg=name)
            assert not torch.equal(value, initial[name]), name
            continue
        sel = moved[name].abs() >= 1e-7
        diff = (value - want[name])[sel].abs()
        assert diff.numel() == 0 or diff.max() <= 2e-2 * LR * n_steps, name
        assert not torch.equal(value, initial[name]) or not sel.any(), name


def test_labels_match_jax_through_the_bridge(ref):
    """Labels as numbers (base 0, audio 1, frozen 2) in the flax tree, through
    the bridge: every port tensor is uniform and equals its own label."""
    codes = {"base": 0.0, "audio": 1.0, "frozen": 2.0}
    params = ref["jstate0"].params
    for frozen, layers in (((), None), (("visual_encoder",), (1,)), (("decoder",), (0, 2))):
        jl = flatten_dict(j_label_params(params, frozen, layers))
        p_flat = flatten_dict(params)
        tree = unflatten_dict({k: np.full(np.shape(p_flat[k]), codes[v], np.float32)
                               for k, v in jl.items()})
        bridged = from_jax_variables({"params": tree})
        port = label_params(bridged, frozen, layers)
        assert set(port) == set(bridged)
        for name, x in bridged.items():
            assert torch.all(x == codes[port[name]]), (frozen, layers, name)


def test_frozen_visual_trunk_and_partial_audio_unfreeze():
    """``frozen_prefixes=("visual_encoder",)`` cuts the visual gradient
    (stop_visual_grad) but its BatchNorm statistics still update; audio
    blocks outside ``audio_trainable_layers`` keep their gradient (counted in
    grad_norm) but do not move."""
    cfg = _cfg()
    cfg.train.audio_trainable_layers = (1,)
    trainer, state = _port(cfg, frozen_prefixes=("visual_encoder",))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = trainer.train_step(state, tiny_batch(JTokenizer(VOCAB)))
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    torch.testing.assert_close(metrics["grad_norm"],
                               torch.linalg.vector_norm(torch.stack(
                                   [torch.linalg.vector_norm(g) for g in grads])))
    after = state.model.state_dict()
    for name, p in state.model.named_parameters():
        if name.startswith("visual_encoder."):
            assert p.grad is None and torch.equal(after[name], before[name]), name
        elif name.startswith("audio_encoder.") and not name.startswith("audio_encoder.blocks.1."):
            assert p.grad is not None and torch.equal(after[name], before[name]), name
        elif name.startswith(("audio_encoder.blocks.1.attn.query", "decoder.")):
            assert not torch.equal(after[name], before[name]), name
    assert not torch.equal(after["visual_encoder.frontend_norm.running_mean"],
                           before["visual_encoder.frontend_norm.running_mean"])


@pytest.mark.parametrize("kind", ["warmup_cosine", "noam"])
def test_schedules_match_optax(kind):
    tc = TrainConfig(lr_schedule=kind, warmup_steps=10, decay_steps=30, lr_min_ratio=0.1)
    ours, theirs = make_lr_schedule(tc, 3e-4), j_schedule(tc, 3e-4)
    counts = range(45)
    np.testing.assert_allclose([ours(c) for c in counts],
                               [float(theirs(jnp.asarray(c))) for c in counts],
                               rtol=1e-5, atol=1e-12)
    assert ours(0) == (0.0 if kind == "warmup_cosine" else ours(1))


def _toy_params(seed=0):
    """A flax-shaped tree with an audio encoder of three blocks, its torch
    counterpart (same names in the port's spelling), and a name map."""
    rng = np.random.default_rng(seed)
    shapes = {("audio_encoder", "block0", "k"): (3, 4), ("audio_encoder", "block1", "k"): (5,),
              ("audio_encoder", "block2", "k"): (2, 2), ("decoder", "head", "kernel"): (4, 3),
              ("fusion", "w"): (6,)}
    flat = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    names = {k: ".".join(p.replace("block", "blocks.") for p in k) for k in flat}
    torch_params = [(names[k], torch.nn.Parameter(torch.from_numpy(v.copy())))
                    for k, v in flat.items()]
    return unflatten_dict(flat), torch_params, names


@pytest.mark.parametrize("schedule,clip,accum", [
    ("constant", None, 1), ("warmup_cosine", 0.5, 1), ("noam", None, 2),
    ("warmup_cosine", 0.05, 2)])
def test_group_adam_matches_optax(schedule, clip, accum):
    """The port's optimizer against the JAX trainer's optax chain on the same
    gradients: per-group clipping (one group's gradients are 100x the
    other's), the schedules' count convention (warmup_cosine's first update
    has lr 0), MultiSteps accumulation, a frozen block left alone."""
    from multimodal_av_model_tpu.config import Config as JConfig

    jc = JConfig()
    jc.train.lr_schedule, jc.train.grad_clip_norm = schedule, clip
    jc.train.grad_accum_steps, jc.train.warmup_steps, jc.train.decay_steps = accum, 2, 6
    jc.train.audio_trainable_layers = (1, 2)
    params, named, names = _toy_params()
    tx = j_make_optimizer(jc, params)
    opt_state = tx.init(params)
    labels = label_params([n for n, _ in named], (), (1, 2))
    jl = flatten_dict(j_label_params(params, (), (1, 2)))
    assert {names[k]: v for k, v in jl.items()} == labels
    port = GroupAdam(named, labels, port_config(jc).train)
    rng = np.random.default_rng(1)
    for i in range(8):
        grads = {k: (rng.standard_normal(v.shape) * (100.0 if k[0] == "audio_encoder" else 1.0)
                     ).astype(np.float32) for k, v in flatten_dict(params).items()}
        updates, opt_state = tx.update(unflatten_dict(grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for (name, p), k in zip(named, grads):
            p.grad = torch.from_numpy(grads[k].copy())
        applied = port.step()
        assert applied == ((i + 1) % accum == 0)
        if clip and applied:
            for group in port.adam.param_groups:
                norm = torch.nn.utils.get_total_norm([p.grad for p in group["params"]])
                assert norm <= clip * (1 + 1e-5)
        for (name, p), k in zip(named, flatten_dict(params)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(flatten_dict(params)[k]),
                                       rtol=1e-5, atol=1e-8, err_msg=f"update {i} {name}")


def test_train_state_from_jax_resumes_mid_accumulation(ref):
    """A JAX optimizer state with ``MultiSteps`` one micro-batch into its
    second update (count 1, warmup_cosine, per-group clipping) carries over:
    the port's next micro-batch gives optax's update."""
    from multimodal_av_model_tpu.config import Config as JConfig

    jc = JConfig()
    jc.train.lr_schedule, jc.train.warmup_steps, jc.train.decay_steps = "warmup_cosine", 2, 6
    jc.train.grad_accum_steps, jc.train.grad_clip_norm = 2, 0.5
    jc.train.audio_trainable_layers = (1,)
    js = ref["jstate0"]
    params = to_np(js.params)
    tx = j_make_optimizer(jc, params)
    opt = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
             for _ in range(4)]
    for g in grads[:3]:
        updates, opt = update(g, opt, params)
        params = to_np(optax.apply_updates(params, updates))
    sd = train_state_from_jax(serialization.to_state_dict(
        {"step": 3, "params": params, "batch_stats": to_np(js.batch_stats), "opt_state": opt}))
    assert sd["optimizer"]["updates"] == 1 and sd["optimizer"]["mini_step"] == 1
    updates, opt = update(grads[3], opt, params)
    want = from_jax_variables({"params": to_np(optax.apply_updates(params, updates))})

    trainer, state = _port(ref["cfg"])
    trainer.config.train = port_config(jc).train
    state.optimizer = trainer.make_optimizer()
    state.load_state_dict(sd)
    g4 = from_jax_variables({"params": grads[3]})
    for name, p in state.model.named_parameters():
        p.grad = g4[name].clone()
    assert state.optimizer.step()
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], rtol=1e-5, atol=1e-7, msg=name)


def test_grad_accumulation_equals_one_step_on_the_mean_gradient():
    _, named_a, _ = _toy_params()
    _, named_b, _ = _toy_params()
    labels = label_params([n for n, _ in named_a])
    acc = GroupAdam(named_a, labels, TrainConfig(grad_accum_steps=2))
    one = GroupAdam(named_b, labels, TrainConfig())
    rng = np.random.default_rng(2)
    g = [[torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) for _, p in named_a]
         for _ in range(2)]
    for micro in g:
        for (_, p), x in zip(named_a, micro):
            p.grad = x.clone()
        acc.step()
    for (_, p), x, y in zip(named_b, *g):
        p.grad = (x + y) / 2
    one.step()
    for (name, a), (_, b) in zip(named_a, named_b):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9, msg=name)


def test_contrastive_only_and_flush_rows():
    """contrastive_only drops the CTC terms; a flush batch (a duplicated row
    with valid 0) gives its unpadded batch's loss."""
    jtok = JTokenizer(VOCAB)
    batch = tiny_batch(jtok)
    cfg = _cfg()
    trainer, state = _port(cfg)
    flush = {k: np.concatenate([v, v[:1]]) for k, v in batch.items()}
    flush["valid"] = np.array([1, 1, 0], np.float32)
    m, _ = trainer.eval_step(state, batch)
    m_flush, _ = trainer.eval_step(state, flush)
    for k in ("loss", "ctc1", "ctc2", "contrast1", "contrast2"):
        torch.testing.assert_close(m_flush[k], m[k], rtol=1e-5, atol=1e-6, msg=k)

    cfg.train.contrastive_only = True
    trainer, state = _port(cfg)
    state, m = trainer.train_step(state, batch)
    assert m["ctc1"].item() == 0.0 and m["ctc2"].item() == 0.0
    torch.testing.assert_close(m["loss"], (m["contrast1"] + m["contrast2"]) / 2)
    assert m["grad_norm"].item() > 0


def test_eval_step_and_evaluate_match_jax(ref):
    jt, jstate = ref["jt"], ref["jstate0"]
    j_metrics, j_out = jt.eval_step(jstate, jt._place(ref["batch"]))
    trainer, state = _port(ref["cfg"], ref["sd0"])
    metrics, out = trainer.eval_step(state, ref["batch"])
    for s in ("1", "2"):
        np.testing.assert_array_equal(out["greedy" + s].numpy(), np.asarray(j_out["greedy" + s]))
        np.testing.assert_array_equal(out[f"greedy{s}_len"].numpy(),
                                      np.asarray(j_out[f"greedy{s}_len"]))
    for k in ("loss", "ctc1", "ctc2", "contrast1", "contrast2"):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]), rtol=1e-4, atol=1e-6)
    got = trainer.evaluate([ref["batch"]], state, use_beam=False)
    want = jt.evaluate([ref["batch"]], jstate, use_beam=False)
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-4)
    assert got[3] == pytest.approx(want[3])


def test_bf16_step_loss_near_jax_bf16(ref):
    cfg = ref["cfg"]
    jt = JTrainer(cfg, JModel(cfg.model, dtype=jnp.bfloat16), JTokenizer(VOCAB))
    js = ref["jstate0"]
    loss = jax.jit(lambda p, s, b, r: jt._losses(p, s, b, r, True)[0])(
        js.params, js.batch_stats, jt._place(ref["batch"]), js.rng)
    trainer, state = _port(cfg, ref["sd0"], dtype=torch.bfloat16)
    state, metrics = trainer.train_step(state, ref["batch"])
    assert torch.isfinite(metrics["grad_norm"])
    np.testing.assert_allclose(metrics["loss"].item(), float(loss), rtol=2e-2)


def test_checkpoint_resume_equals_uninterrupted_run(tmp_path):
    """With dropout on, so the generator's state is carried too."""
    cfg = _cfg()
    cfg.model.audio.dropout = 0.1
    batch = tiny_batch(JTokenizer(VOCAB))
    trainer, state = _port(cfg)
    state, _ = trainer.train_step(state, batch)
    path = str(tmp_path / "ckpt" / "a.ckpt")
    save_checkpoint(path, {"state": state, "epoch": 3})
    state, m_next = trainer.train_step(state, batch)

    fresh, fresh_state = _port(cfg)
    fresh_state.model.load_state_dict(
        {k: torch.zeros_like(v) for k, v in fresh_state.model.state_dict().items()})
    restored = restore_checkpoint(path, template={"state": fresh_state, "epoch": 0})
    assert restored["epoch"] == 3 and restored["state"] is fresh_state
    assert fresh_state.step == 1 and fresh_state.optimizer.updates == 1
    fresh_state, m_resumed = fresh.train_step(fresh_state, batch)
    for k in KEYS:
        assert torch.equal(m_resumed[k], m_next[k]), k
    for (name, a), b in zip(state.model.state_dict().items(),
                            fresh_state.model.state_dict().values()):
        assert torch.equal(a, b), name
    raw = restore_checkpoint(path)
    grafted = graft_subtree(fresh_state.model.state_dict(), raw["state"]["model"],
                            ["visual_encoder"])
    assert torch.equal(grafted["visual_encoder.frontend_conv.weight"],
                       raw["state"]["model"]["visual_encoder.frontend_conv.weight"])
    assert grafted["decoder.head.weight"] is fresh_state.model.state_dict()["decoder.head.weight"] \
        or torch.equal(grafted["decoder.head.weight"], fresh_state.model.decoder.head.weight)
    with pytest.raises(KeyError):
        graft_subtree(grafted, raw["state"]["model"], ["no_such_module"])


def test_checkpoint_manager_matches_jax_manager(tmp_path):
    history = [(3.0, 0.9), (2.0, 0.95), (2.5, 0.8), (2.5, 0.85), (1.0, 0.7)]
    ours, theirs = CheckpointManager(str(tmp_path / "t")), JManager(str(tmp_path / "j"))
    for i, (loss, wer) in enumerate(history):
        a = ours.on_epoch_end({"x": torch.tensor([float(i)]), "epoch": i}, loss, wer)
        b = theirs.on_epoch_end({"x": np.array([float(i)]), "epoch": i}, loss, wer)
        assert a == b, i
        ours.set_no_improve(i)
        theirs.set_no_improve(i)
        assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    with open(tmp_path / "t" / "best.json") as f, open(tmp_path / "j" / "best.json") as g:
        assert json.load(f) == json.load(g)
    again = CheckpointManager(str(tmp_path / "t"))
    assert again.early_stop_state() == JManager(str(tmp_path / "j")).early_stop_state()
    assert again.try_resume()["epoch"] == 4
    assert restore_checkpoint(again.best_wer)["epoch"] == 4
    assert restore_checkpoint(again.best_loss)["epoch"] == 4


def test_train_epoch_folds_metrics_and_raises_on_non_finite():
    batch = tiny_batch(JTokenizer(VOCAB))
    losses = {}
    for deferred in (True, False):
        cfg = _cfg()
        cfg.train.async_dispatch = deferred
        trainer, state = _port(cfg)
        lines = []
        state, losses[deferred], tp = trainer.train_epoch([batch, batch], log_every=1,
                                                          log_fn=lines.append, state=state)
        assert len(lines) == 2 and lines[0].startswith("[batch 0] loss=")
        assert tp["utterances_per_sec"] > 0 and tp["rtf"] > 0 and state.step == 2
    assert losses[True] == pytest.approx(losses[False], rel=1e-6)
    bad = dict(batch, audio=np.full_like(batch["audio"], np.nan))
    for deferred in (True, False):
        cfg = _cfg()
        cfg.train.async_dispatch = deferred
        trainer, state = _port(cfg)
        with pytest.raises(NonFiniteLossError):
            trainer.train_epoch([batch, bad], log_every=100, log_fn=lambda s: None, state=state)

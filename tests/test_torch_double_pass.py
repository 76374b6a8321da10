"""PyTorch port, ``model.shared_audio_pass=false``: the reference-shaped
double audio pass (``multimodal_av_model_tpu/models/av_model.py:113-130``),
the audio encoder on ``[2B]`` rows, each under its own speaker's mask.

* in eval it equals the shared pass with the same parameters (JAX's
  ``tests/test_round3_fixes.py:330``, rtol = atol = 1e-5), and JAX's double
  pass on converted weights (``tests/test_torch_models.py``'s bar, 2e-4);
* one f32 train step with dropout 0 against JAX's with the same flag, at
  ``tests/test_torch_trainer.py``'s bars (metrics rtol 1e-4, atol 1e-6;
  gradients per tensor ``|g - g_jax| <= 1e-3 |g_jax| + 1e-7``);
* under a world-2 gloo mesh, with dropout 0.1 and SpecAugment on, the
  meshed step equals the one-process step at ``tests/test_torch_parallel.py``'s
  bars (metrics rtol 1e-5; gradients per tensor ``|g - g_1| <= 1e-5 |g_1| +
  1e-8 |G_1|``), for the double pass (a rank's ``[2b]`` encoder rows are two
  blocks of the global ``[2B]``, and each dropout and SpecAugment draw keeps
  both) and for the default shared pass (SpecAugment draws for the whole
  batch there too);
* the CLI takes the override and trains.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu.train import MultiSpeakerTrainer as JTrainer
from multimodal_av_model_tpu_torch import config as tcfg
from multimodal_av_model_tpu_torch import graft_entry
from multimodal_av_model_tpu_torch import main as pmain
from multimodal_av_model_tpu_torch.compat import from_jax_variables, train_state_from_jax
from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel, init_weights
from multimodal_av_model_tpu_torch.models.layers import dropout
from multimodal_av_model_tpu_torch.ops.specaugment import block_rows, draw_spec_augment
from multimodal_av_model_tpu_torch.parallel.spawn import meshed_train_steps, run_ranks
from multimodal_av_model_tpu_torch.text import CharTokenizer
from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer, restore_checkpoint
from test_models import tiny_config
from test_torch_cli import SMALL, TINY
from test_torch_models import _av_inputs, port_config, t, to_np
from test_trainer import tiny_batch

VOCAB = graft_entry.VOCAB
KEYS = ("loss", "ctc1", "ctc2", "contrast1", "contrast2", "grad_norm")
N_STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _double(cfg):
    cfg.model.shared_audio_pass = False
    return cfg


def test_double_pass_equals_the_shared_pass_in_eval():
    """Both passes see the same mixture, and the masks share their padding
    (the collate invariant), so the encodings are the same."""
    cfg = port_config(tiny_config())
    shared = init_weights(MultiSpeakerAVModel(cfg.model), torch.Generator().manual_seed(0))
    double = MultiSpeakerAVModel(_double(port_config(tiny_config())).model)
    double.load_state_dict(shared.state_dict())
    inputs = [t(x) for x in _av_inputs()]
    with torch.no_grad():
        out_s, out_d = shared.eval()(*inputs), double.eval()(*inputs)
    assert set(out_s) == set(out_d)
    for k in out_s:
        np.testing.assert_allclose(out_d[k].numpy(), out_s[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_double_pass_eval_forward_matches_jax():
    jcfg = _double(tiny_config())
    inputs = _av_inputs()
    v = to_np(JModel(jcfg.model).init(jax.random.PRNGKey(9), *map(jnp.asarray, inputs)))
    ref = JModel(jcfg.model).apply(v, *map(jnp.asarray, inputs))
    model = MultiSpeakerAVModel(port_config(jcfg).model).eval()
    assert not model.config.shared_audio_pass
    model.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        out = model(*map(t, inputs))
    for s in ("1", "2"):
        lens = np.asarray(ref["input_lengths" + s])
        np.testing.assert_array_equal(out["input_lengths" + s].numpy(), lens)
        for b, n in enumerate(lens):
            np.testing.assert_allclose(out["log_probs" + s][b, :n].numpy(),
                                       np.asarray(ref["log_probs" + s])[b, :n],
                                       rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out["contrast" + s].numpy(), np.asarray(ref["contrast" + s]),
                                   rtol=2e-4, atol=2e-4)


def _jax_step(trainer):
    def step(state, batch):
        _, step_rng = jax.random.split(state.rng)
        (_, (metrics, _, _)), grads = jax.value_and_grad(
            lambda p: trainer._losses(p, state.batch_stats, batch, step_rng, True),
            has_aux=True)(state.params)
        metrics["grad_norm"] = optax.global_norm(grads)
        return metrics, grads
    return jax.jit(step)


def test_double_pass_train_step_matches_jax():
    cfg = _double(tiny_config())
    cfg.model.decoder.vocab_size = 800
    cfg.model.visual.norm = "batch"
    cfg.model.audio.dropout = 0.0
    cfg.train.log_every = 1000
    jtok = JTokenizer(VOCAB)
    batch = tiny_batch(jtok)
    jt = JTrainer(cfg, JModel(cfg.model), jtok)
    jstate = jt.init_state(0, batch)
    sd0 = serialization.to_state_dict(jax.device_get(jstate))
    metrics, grads = _jax_step(jt)(jstate, jt._place(batch))
    want = from_jax_variables({"params": to_np(grads)})

    pcfg = port_config(cfg)
    trainer = MultiSpeakerTrainer(pcfg, MultiSpeakerAVModel(pcfg.model), CharTokenizer(VOCAB),
                                  device="cpu")
    state = trainer.init_state(0)
    state.load_state_dict(train_state_from_jax(sd0))
    state, got = trainer.train_step(state, batch)
    for k in KEYS:
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for name, p in state.model.named_parameters():
        g_ref = want[name]
        assert torch.linalg.vector_norm(p.grad - g_ref) <= \
            1e-3 * torch.linalg.vector_norm(g_ref) + 1e-7, name


# -- the rows a mesh rank keeps ----------------------------------------------------


@pytest.mark.parametrize("n,parts", [(2, 2), (3, 2), (2, 1)])
def test_placed_draws_are_blocks_of_the_whole_batch_draw(n, parts):
    """Rank ``r`` of ``n`` with ``parts`` stacked batches of ``b`` rows keeps
    rows ``j * n * b + r * b ...`` of part ``j`` of the whole draw, in
    dropout and in SpecAugment alike."""
    b, T, F = 2, 40, 16
    whole = torch.arange(parts * n * b * 3.0).reshape(parts * n * b, 3)
    for r in range(n):
        want = torch.cat([whole[(j * n + r) * b:(j * n + r + 1) * b] for j in range(parts)])
        torch.testing.assert_close(block_rows(whole, (r, n), parts), want)

    x = torch.ones(parts * b, T, F)
    full = dropout(torch.ones(parts * n * b, T, F), 0.5, torch.Generator().manual_seed(0))
    valid = torch.ones(parts * n * b, T, dtype=torch.bool)
    valid[1, 30:] = False
    whole_draws = draw_spec_augment(torch.Generator().manual_seed(0), valid, F, 2, 5, 2, 0.2)
    for r in range(n):
        mine = dropout(x, 0.5, torch.Generator().manual_seed(0), rows=(r, n), parts=parts)
        torch.testing.assert_close(mine, block_rows(full, (r, n), parts))
        placed = draw_spec_augment(torch.Generator().manual_seed(0),
                                   block_rows(valid, (r, n), parts), F, 2, 5, 2, 0.2,
                                   rows=(r, n), parts=parts)
        for field in ("freq_width", "freq_start", "time_width", "time_start"):
            torch.testing.assert_close(getattr(placed, field),
                                       block_rows(getattr(whole_draws, field), (r, n), parts))


# -- the double pass over a mesh of 2 gloo processes ----------------------------


def _mesh_cfg(shared: bool):
    cfg = graft_entry.flagship_config(tiny=True)
    cfg.model.decoder.vocab_size = 800
    a = cfg.model.audio
    a.dropout = 0.1
    a.specaug_freq_masks, a.specaug_freq_width = 2, 10
    a.specaug_time_masks, a.specaug_time_frac = 2, 0.2
    cfg.model.shared_audio_pass = shared
    cfg.train.log_every = 1000
    return cfg


@pytest.fixture(scope="module", params=["shared", "double"])
def meshed_and_one(request, tmp_path_factory):
    cfg = _mesh_cfg(request.param == "shared")
    batch = graft_entry.train_batch(np.random.default_rng(0), 4, 800)
    batch["valid"] = np.ones(4, np.float32)
    work = str(tmp_path_factory.mktemp(f"{request.param}_dp2"))
    out = os.path.join(work, "out.pt")
    run_ranks(meshed_train_steps, 2, work,
              ([{"out": out, "cfg": cfg, "steps": N_STEPS}], VOCAB, batch), timeout=240)
    trainer = MultiSpeakerTrainer(cfg, MultiSpeakerAVModel(cfg.model), CharTokenizer(VOCAB),
                                  device="cpu")
    state = trainer.init_state(0)
    one = {"metrics": [], "grads": []}
    for _ in range(N_STEPS):
        state, m = trainer.train_step(state, batch)
        one["metrics"].append({k: float(v) for k, v in m.items()})
        one["grads"].append({n: p.grad.clone() for n, p in state.model.named_parameters()
                             if p.grad is not None})
    return torch.load(out, weights_only=True), one


def test_meshed_step_equals_the_one_process_step(meshed_and_one):
    got, want = meshed_and_one
    assert got["mesh"] == (2, 1)
    for i in range(N_STEPS):
        for k in KEYS:
            np.testing.assert_allclose(got["metrics"][i][k], want["metrics"][i][k], rtol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
        total = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in want["grads"][i].values()]))
        assert set(got["grads"][i]) == set(want["grads"][i])
        for name, g1 in want["grads"][i].items():
            err = torch.linalg.vector_norm(got["grads"][i][name] - g1)
            assert err <= 1e-5 * torch.linalg.vector_norm(g1) + 1e-8 * total, \
                f"step {i + 1} grad {name}: {err:.3e}"


# -- the CLI ---------------------------------------------------------------------


def test_the_override_parses_and_round_trips_through_to_dict():
    cfg = tcfg.from_flat_overrides(["model.shared_audio_pass=false"])
    assert cfg.model.shared_audio_pass is False
    assert tcfg.to_dict(cfg)["model"]["shared_audio_pass"] is False
    assert tcfg.Config().model.shared_audio_pass is True


def test_cli_trains_with_the_double_pass(tmp_path, capsys):
    seen = []
    fit = MultiSpeakerTrainer.fit

    def spy(self, state, *a, **kw):
        seen.append(self.model.config.shared_audio_pass)
        return fit(self, state, *a, **kw)

    MultiSpeakerTrainer.fit = spy
    try:
        pmain.main(TINY + SMALL + ["--synthetic", "train.max_epochs=1",
                                   "data.video_buckets=(64,)", "model.shared_audio_pass=false",
                                   f"train.checkpoint_dir={tmp_path}"])
    finally:
        MultiSpeakerTrainer.fit = fit
    assert seen == [False]
    assert "[epoch 1]" in capsys.readouterr().out
    assert restore_checkpoint(os.path.join(tmp_path, "last.ckpt"))["epoch"] == 1

"""PyTorch port, the SSL family: ``ops/ssl.py`` and ``train/ssl_pretrain.py``
held against the JAX package on the CPU, tiny widths, f32.

* ``make_span_mask``: byte-equal for the same numpy generator;
* ``masked_infonce_loss``: within 1e-6 relative, its gradient within 1e-5,
  with a sample that has no masked frame;
* ``MaskedAudioPretrainModel``'s forward (eval and train with dropout 0):
  predictions and targets within 1e-4;
* 1 and 3 steps of ``MaskedAudioPretrainer`` from one state (carried by
  ``ssl_state_from_jax``), dropout 0, the same spans: the bars of
  ``tests/test_torch_trainer.py`` (loss rtol 1e-4; each gradient within
  1e-3 of its norm; parameters within ``2e-2 * lr`` per step on elements
  whose gradient is at least 1e-7);
* a resumed ``--family=ssl`` run equals the uninterrupted one exactly (the
  dropout generator and the span schedule carried), and the SSL encoder
  grafts into the flagship without ``mask_embedding``.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from multimodal_av_model_tpu.models.audio import AudioEncoder as JAudio
from multimodal_av_model_tpu.ops.ssl import make_span_mask as j_make_span_mask
from multimodal_av_model_tpu.ops.ssl import masked_infonce_loss as j_infonce
from multimodal_av_model_tpu.train.ssl_pretrain import MaskedAudioPretrainer as JPretrainer
from multimodal_av_model_tpu.train.ssl_pretrain import (
    flagship_audio_params as j_flagship_audio_params,
)
from multimodal_av_model_tpu_torch import main as pmain
from multimodal_av_model_tpu_torch.compat import ssl_pretrain_from_jax, ssl_state_from_jax
from multimodal_av_model_tpu_torch.models import AudioEncoder
from multimodal_av_model_tpu_torch.ops.ssl import make_span_mask, masked_infonce_loss
from multimodal_av_model_tpu_torch.train import (
    MaskedAudioPretrainer,
    MultiSpeakerTrainer,
    flagship_audio_params,
    restore_checkpoint,
)
from test_models import tiny_config
from test_torch_cli import TINY
from test_torch_models import port_config, to_np

LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("batch,length,prob,span,seed", [
    (4, 200, 0.065, 10, 0), (3, 57, 0.2, 4, 1), (2, 6, 0.01, 10, 2), (5, 3, 0.5, 3, 3),
    (8, 500, 0.0, 10, 4)])
def test_span_mask_is_byte_equal(batch, length, prob, span, seed):
    got = make_span_mask(batch, length, prob, span, np.random.default_rng(seed))
    want = j_make_span_mask(batch, length, prob, span, np.random.default_rng(seed))
    assert got.dtype == want.dtype == bool and got.tobytes() == want.tobytes()
    assert (got.sum(axis=1) >= 2).all()
    # Fewer frames than min_masked cannot hold two starts: both raise alike.
    for fn in (make_span_mask, j_make_span_mask):
        with pytest.raises(ValueError):
            fn(batch, 1, 0.0, span, np.random.default_rng(seed))


def test_infonce_matches_jax_with_an_unmasked_sample():
    rng = np.random.default_rng(0)
    B, T, D = 3, 12, 8
    preds = rng.standard_normal((B, T, D)).astype(np.float32)
    tgts = rng.standard_normal((B, T, D)).astype(np.float32)
    spans = rng.random((B, T)) < 0.4
    spans[1] = False                              # a sample with no masked frame
    valid = np.arange(T)[None, :] < np.array([[12], [9], [7]])
    for temperature in (0.1, 0.5):
        j_loss, j_grad = jax.value_and_grad(j_infonce)(jnp.asarray(preds), jnp.asarray(tgts),
                                                       spans, valid, temperature)
        p = torch.from_numpy(preds).requires_grad_()
        loss = masked_infonce_loss(p, torch.from_numpy(tgts), torch.from_numpy(spans),
                                   torch.from_numpy(valid), temperature)
        loss.backward()
        assert torch.isfinite(loss)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grad), rtol=1e-5, atol=1e-7)
        assert (p.grad[1] == 0).all()
    none = masked_infonce_loss(torch.from_numpy(preds), torch.from_numpy(tgts),
                               torch.zeros(B, T, dtype=torch.bool), torch.from_numpy(valid))
    assert none.item() == 0.0


def _cfg(dropout=0.0):
    cfg = tiny_config()
    cfg.model.decoder.vocab_size = 800
    cfg.model.audio.dropout = dropout
    cfg.train.learning_rate = LR
    return cfg


def _batch(seed=0, B=2, S=6400):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((B, S)) * 0.3).astype(np.float32)
    mask1 = np.full((B, S), 1, np.int32)
    mask1[1, S * 3 // 4:] = 3                     # speaker 1's padding
    return {"audio": audio, "mask1": mask1}


def _jax_step(jt):
    """``MaskedAudioPretrainer.train_step``'s body, also returning the gradients."""
    from multimodal_av_model_tpu.ops.ssl import masked_infonce_loss as loss_fn
    import optax

    def step(params, opt_state, key, audio, sample_mask, spans):
        key, drop_key = jax.random.split(key)

        def f(p):
            preds, targets, fv = jt.model.apply({"params": p}, audio, sample_mask, spans,
                                                train=True, rngs={"dropout": drop_key})
            return loss_fn(preds, targets, spans, fv, jt.temperature)

        loss, grads = jax.value_and_grad(f)(params)
        updates, opt_state = jt._tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, key, loss, grads
    return jax.jit(step)


@pytest.fixture(scope="module")
def ref():
    cfg = _cfg()
    jt = JPretrainer(cfg)
    batch = _batch()
    state = jt.init_state(0, batch)
    sd0 = serialization.to_state_dict(jax.device_get(state))
    audio, sample_mask = batch["audio"], batch["mask1"] != 3
    T = jt.enc_frames(audio.shape[1])
    span_rng = np.random.default_rng(5)
    spans = [j_make_span_mask(2, T, 0.2, 4, span_rng) for _ in range(3)]
    step = _jax_step(jt)
    params, opt, key = state["params"], state["opt_state"], state["key"]
    steps = []
    for s in spans:
        params, opt, key, loss, grads = step(params, opt, key, audio, sample_mask, s)
        steps.append({"loss": float(loss),
                      "grads": ssl_pretrain_from_jax({"params": to_np(grads)}),
                      "params": ssl_pretrain_from_jax({"params": to_np(params)})})
    return {"cfg": cfg, "jt": jt, "batch": batch, "sd0": sd0, "spans": spans,
            "steps": steps, "variables": {"params": to_np(state["params"])}}


def _port(ref):
    pt = MaskedAudioPretrainer(port_config(ref["cfg"]), device="cpu")
    state = pt.init_state(0)
    state.load_state_dict(ssl_state_from_jax(ref["sd0"]))
    return pt, state


@pytest.mark.parametrize("train", [False, True])
def test_pretrain_model_forward_matches_jax(ref, train):
    jt, batch = ref["jt"], ref["batch"]
    spans = ref["spans"][0]
    sample_mask = batch["mask1"] != 3
    jp, jtgt, jfv = jt.model.apply(ref["variables"], batch["audio"], sample_mask, spans,
                                   train=train, rngs={"dropout": jax.random.PRNGKey(0)})
    pt, state = _port(ref)
    with torch.no_grad():
        p, tgt, fv = state.model(torch.from_numpy(batch["audio"]), torch.from_numpy(sample_mask),
                                 torch.from_numpy(spans),
                                 generator=torch.Generator() if train else None)
    np.testing.assert_array_equal(fv.numpy(), np.asarray(jfv))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=1e-4, atol=1e-4)
    assert not tgt.requires_grad and tgt.dtype == torch.float32


def test_state_bridge_and_graft_params(ref):
    pt, state = _port(ref)
    sd = state.model.state_dict()
    assert "audio_encoder.mask_embedding" in sd and "ssl_head.weight" in sd
    graft = flagship_audio_params(sd)
    want = j_flagship_audio_params(ref["variables"]["params"])
    assert "mask_embedding" not in want
    assert set(graft) == {k for k in sd if k.startswith("audio_encoder.")} - {
        "audio_encoder.mask_embedding"}
    torch.testing.assert_close(graft["audio_encoder.out_proj.weight"],
                               torch.from_numpy(np.array(want["out_proj"]["kernel"]).T.copy()))
    for n in (1, 3200, 6400, 160000):
        c, f = port_config(ref["cfg"]).model.audio, port_config(ref["cfg"]).model.frontend
        assert AudioEncoder.output_length(c, f, n) == JAudio.output_length(
            ref["cfg"].model.audio, ref["cfg"].model.frontend, n)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_pretrainer_steps_match_jax(ref, n_steps):
    pt, state = _port(ref)
    initial = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = ref["batch"]
    for i in range(n_steps):
        state, loss = pt.train_step(state, batch["audio"], batch["mask1"] != 3, ref["spans"][i])
        want = ref["steps"][i]
        np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-4, atol=1e-6)
        for name, p in state.model.named_parameters():
            g, g_ref = p.grad, want["grads"][name]
            assert torch.linalg.vector_norm(g - g_ref) <= \
                1e-3 * torch.linalg.vector_norm(g_ref) + 1e-7, f"step {i + 1} grad {name}"
    assert state.step == state.optimizer.updates == n_steps
    want = ref["steps"][n_steps - 1]["params"]
    moved = ref["steps"][0]["grads"]
    for name, value in state.model.state_dict().items():
        sel = moved[name].abs() >= 1e-7
        diff = (value - want[name])[sel].abs()
        assert diff.numel() == 0 or diff.max() <= 2e-2 * LR * n_steps, name
        assert not torch.equal(value, initial[name]) or not sel.any(), name


def test_fit_draws_spans_from_the_generator_it_is_given(ref):
    pt, state = _port(ref)
    batches = [ref["batch"]] * 2
    logs = []
    state, last = pt.fit(state, batches, log_every=1, log_fn=logs.append,
                         span_rng=np.random.default_rng(11))
    assert state.step == 2 and len(logs) == 2 and logs[0].startswith("[ssl 0] infonce=")
    pt2, state2 = _port(ref)
    rng = np.random.default_rng(11)
    T = pt2.enc_frames(6400)
    for b in batches:
        spans = make_span_mask(2, T, pt2.mask_prob, pt2.span, rng)
        state2, loss = pt2.train_step(state2, b["audio"], b["mask1"] != 3, spans)
    assert last == loss.item()


# -- the CLI ------------------------------------------------------------------

def _fixed_build_data(cfg, tokenizer, synthetic, device="cuda", device_put=True):
    """The same two batches every epoch (the real samplers advance across
    epochs, in both packages, so a resumed process draws other pairs)."""
    batches = [_batch(1), _batch(2)]
    return (lambda: iter(batches)), (lambda: iter(batches))


def _ssl_run(ckpt, epochs, monkeypatch):
    monkeypatch.setattr(pmain, "build_data", _fixed_build_data)
    out = io.StringIO()
    for e in epochs:
        with contextlib.redirect_stdout(out):
            pmain.main(TINY + ["--family=ssl", f"train.checkpoint_dir={ckpt}",
                               f"train.max_epochs={e}", "train.log_every=1",
                               "train.ssl_mask_prob=0.2", "train.ssl_mask_span=4"])
    return restore_checkpoint(os.path.join(ckpt, "last.ckpt")), out.getvalue()


def test_resumed_ssl_run_equals_the_uninterrupted_one(tmp_path, monkeypatch):
    """With dropout on (TINY keeps the default 0.1), so the generator counts."""
    whole, out = _ssl_run(str(tmp_path / "a"), [2], monkeypatch)
    parts, out2 = _ssl_run(str(tmp_path / "b"), [1, 2], monkeypatch)
    assert "[ssl epoch 2] infonce=" in out
    assert f"resuming ssl from {tmp_path / 'b' / 'last.ckpt'} at epoch 2" in out2
    assert whole["epoch"] == parts["epoch"] == 2 and whole["state"]["step"] == 4
    assert torch.equal(whole["state"]["generator"], parts["state"]["generator"])
    for k, v in whole["state"]["model"].items():
        assert torch.equal(v, parts["state"]["model"][k]), k
    # The printed losses of epoch 2 agree too.
    assert out.splitlines()[-1] == out2.splitlines()[-1]


def test_eval_and_infer_refuse_the_ssl_family(tmp_path):
    with pytest.raises(SystemExit, match="finetune an SSL checkpoint first"):
        pmain.main(TINY + ["--family=ssl", "--eval", f"train.checkpoint_dir={tmp_path}"])
    with pytest.raises(SystemExit, match="--infer serves decoder-bearing families"):
        pmain.main(TINY + ["--family=ssl", "--infer", f"train.checkpoint_dir={tmp_path}"])


def test_ssl_checkpoint_grafts_into_the_flagship(tmp_path, monkeypatch):
    """``train.audio_init_ckpt``: the flagship's audio encoder at the start of
    ``fit`` is the SSL encoder, ``mask_embedding`` left out."""
    src, _ = _ssl_run(str(tmp_path / "ssl"), [1], monkeypatch)
    monkeypatch.undo()
    seen = {}
    fit = MultiSpeakerTrainer.fit

    def spy(self, state, *a, **kw):
        seen["model"] = {k: v.clone() for k, v in state.model.state_dict().items()}
    monkeypatch.setattr(MultiSpeakerTrainer, "fit", spy)
    source = str(tmp_path / "ssl" / "last.ckpt")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pmain.main(TINY + ["--synthetic", f"train.checkpoint_dir={tmp_path / 'av'}",
                           f"train.audio_init_ckpt={source}", "train.max_epochs=1"])
    assert f"grafted audio encoder from {source}" in out.getvalue()
    monkeypatch.setattr(MultiSpeakerTrainer, "fit", fit)
    audio = {k: v for k, v in seen["model"].items() if k.startswith("audio_encoder.")}
    ssl_model = src["state"]["model"]
    assert "audio_encoder.mask_embedding" in ssl_model
    assert set(audio) == set(flagship_audio_params(ssl_model))
    for k, v in audio.items():
        assert torch.equal(v, ssl_model[k]), k

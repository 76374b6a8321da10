"""PyTorch port, the transformer temporal model (``fusion.temporal_model=
"transformer"``): ``TransformerTemporalBlock``, the fusion's transformer
branch and the whole flagship with it, held against the JAX package with flax
parameters carried over by ``compat/from_jax.py`` (CPU, f32, tiny widths).

Bars: module outputs within ``tests/test_torch_models.py``'s ``RTOL``/``ATOL``
on valid rows (padded query rows too: both sides give them the mean of V);
ids and texts exact; training steps within ``tests/test_torch_trainer.py``'s
bars (metrics rtol 1e-4, gradients per tensor, parameters per element)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from multimodal_av_model_tpu.infer import Transcriber as JTranscriber
from multimodal_av_model_tpu.models import CrossAttentionFusion as JFusion
from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
from multimodal_av_model_tpu.models.layers import TransformerTemporalBlock as JBlock
from multimodal_av_model_tpu.ops.prefix_beam_search import prefix_beam_search_decode as j_beam
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu.train import MultiSpeakerTrainer as JTrainer
from multimodal_av_model_tpu_torch.compat import from_jax_variables, train_state_from_jax
from multimodal_av_model_tpu_torch.compat.from_jax import fusion_from_jax, transformer_from_jax
from multimodal_av_model_tpu_torch.infer import Transcriber, decode_ids
from multimodal_av_model_tpu_torch.models import CrossAttentionFusion, MultiSpeakerAVModel
from multimodal_av_model_tpu_torch.models.layers import TransformerTemporalBlock
from multimodal_av_model_tpu_torch.text import CharTokenizer
from test_models import tiny_config
from test_torch_models import ATOL, RTOL, _av_inputs, perturb_batch_stats, port_config, t, to_np
from test_torch_trainer import KEYS, LR, _jax_step, _port
from test_trainer import tiny_batch

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
BATCH_KEYS = ("lip1", "lip2", "audio", "mask1", "mask2", "lip1_lengths", "lip2_lengths")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny models run many small ops, which torch's thread pool slows when
    the suite's workers already share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf_config(norm="batch"):
    cfg = tiny_config()
    cfg.model.fusion.temporal_model = "transformer"
    cfg.model.visual.norm = norm
    return cfg


def _perturb_params(v, seed):
    """Non-trivial LayerNorm scales and biases, so their order is checked."""
    rng = np.random.default_rng(seed)
    v = to_np(v)
    v["params"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.3 * rng.standard_normal(a.shape).astype(np.float32)
        if p[-1].key in ("scale", "bias") else a, v["params"])
    return v


@pytest.mark.parametrize("lengths", [None, (7, 4, 1)])
def test_transformer_block_matches_jax(lengths):
    """Two pre-LN layers, 4 heads, FFN 32; with lengths below T the padded
    query rows are fully masked on both sides."""
    B, T, D = 3, 7, 16
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    jm = JBlock(D, num_layers=2, num_heads=4, ffn_dim=32)
    args = (jnp.asarray(x),) if lens is None else (jnp.asarray(x), jnp.asarray(lens))
    v = _perturb_params(jm.init(jax.random.PRNGKey(2), *args), 3)
    ref = np.asarray(jm.apply(v, *args))

    tm = TransformerTemporalBlock(D, num_layers=2, num_heads=4, ffn_dim=32)
    tm.load_state_dict(transformer_from_jax(v), strict=True)
    with torch.no_grad():
        got = tm(t(x), None if lens is None else t(lens)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_transformer_fusion_matches_jax():
    cfg = _tf_config()
    B, T_v, T_a = 3, 7, 11
    rng = np.random.default_rng(4)
    vis = rng.standard_normal((B, T_v, 24)).astype(np.float32)
    aud = rng.standard_normal((B, T_a, 48)).astype(np.float32)
    mask = rng.integers(0, 4, size=(B, T_a)).astype(np.int32)
    vlen = np.array([7, 5, 3], np.int32)
    args = tuple(map(jnp.asarray, (vis, aud, mask, vlen)))
    jm = JFusion(cfg.model.fusion)
    v = _perturb_params(jm.init(jax.random.PRNGKey(5), *args), 6)
    j_fused, j_len = jm.apply(v, *args)

    tm = CrossAttentionFusion(port_config(cfg).model.fusion, 24, 48).eval()
    tm.load_state_dict(fusion_from_jax(v), strict=True)
    assert not hasattr(tm, "temporal_bilstm")
    with torch.no_grad():
        fused, lens = tm(t(vis), t(aud), t(mask), t(vlen))
    assert fused.shape == (B, T_v, 2 * cfg.model.fusion.fused_dim)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(j_len))
    np.testing.assert_allclose(fused.numpy(), np.asarray(j_fused), rtol=RTOL, atol=ATOL)


def test_unknown_temporal_model_is_refused():
    cfg = port_config(tiny_config()).model.fusion
    cfg.temporal_model = "gru"
    with pytest.raises(ValueError, match="unknown temporal model"):
        CrossAttentionFusion(cfg, 24, 48)


@pytest.fixture(scope="module")
def flagship():
    cfg = _tf_config()
    inputs = _av_inputs(seed=21)
    v = perturb_batch_stats(jax.jit(JModel(cfg.model).init)(jax.random.PRNGKey(22),
                                                            *map(jnp.asarray, inputs)))
    model = MultiSpeakerAVModel(port_config(cfg).model).eval()
    model.load_state_dict(from_jax_variables(v), strict=True)
    return cfg, v, inputs, model


def test_transformer_flagship_eval_forward_matches_jax(flagship):
    """Log-probs on valid frames within RTOL/ATOL, lengths and masks exact,
    and the prefix-beam and greedy ids of the port's log-probs equal JAX's
    decoders on JAX's log-probs."""
    cfg, v, inputs, model = flagship
    ref = JModel(cfg.model).apply(v, *map(jnp.asarray, inputs))
    with torch.no_grad():
        out = model(*map(t, inputs))
    pcfg = port_config(cfg)
    for s in ("1", "2"):
        lens = np.asarray(ref["input_lengths" + s])
        np.testing.assert_array_equal(out["input_lengths" + s].numpy(), lens)
        np.testing.assert_array_equal(out["mask_ds" + s].numpy(), np.asarray(ref["mask_ds" + s]))
        got, want = out["log_probs" + s].numpy(), np.asarray(ref["log_probs" + s])
        for b, n in enumerate(lens):
            np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=RTOL, atol=ATOL)
        ids, n = decode_ids(pcfg, out["log_probs" + s], out["input_lengths" + s])
        j_ids, j_n, _ = j_beam(ref["log_probs" + s], ref["input_lengths" + s], 5, 8, 3)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(n.numpy(), np.asarray(j_n))


@pytest.mark.parametrize("use_beam", [True, False])
def test_transformer_transcriber_matches_jax(flagship, use_beam):
    cfg, v, inputs, model = flagship
    batch = dict(zip(BATCH_KEYS, inputs))
    ref = JTranscriber(cfg, JTokenizer(VOCAB), v, dtype=jnp.float32).transcribe(batch, use_beam)
    got = Transcriber(port_config(cfg), CharTokenizer(VOCAB), model,
                      device="cpu").transcribe(batch, use_beam)
    assert got == ref


# -- training ---------------------------------------------------------------


def _train_cfg():
    cfg = _tf_config()
    cfg.model.decoder.vocab_size = 800
    cfg.model.audio.dropout = 0.0
    cfg.train.log_every = 1000
    return cfg


@pytest.fixture(scope="module")
def ref():
    """Three JAX steps of the transformer flagship from one state."""
    jtok = JTokenizer(VOCAB)
    cfg = _train_cfg()
    batch = tiny_batch(jtok)
    jt = JTrainer(cfg, JModel(cfg.model), jtok)
    state = jt.init_state(0, batch)
    states = [serialization.to_state_dict(jax.device_get(state))]
    step = _jax_step(jt)
    placed = jt._place(batch)
    steps = []
    for _ in range(3):
        state, metrics, grads = step(state, placed)
        states.append(serialization.to_state_dict(jax.device_get(state)))
        steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                      "grads": from_jax_variables({"params": to_np(grads)}),
                      "state": from_jax_variables({"params": to_np(state.params),
                                                   "batch_stats": to_np(state.batch_stats)})})
    return {"cfg": cfg, "batch": batch, "states": states, "steps": steps}


def _check_steps(ref, start, n_steps):
    """The port from JAX's state after ``start`` steps, ``n_steps`` steps on:
    metrics and gradients at every step, parameters and statistics at the
    end, against the JAX steps ``start + 1 ..``."""
    trainer, state = _port(ref["cfg"], ref["states"][start])
    assert any(k.startswith("fusion.temporal_tf.") for k in state.model.state_dict())
    initial = {k: v.clone() for k, v in state.model.state_dict().items()}
    grads = None
    for i in range(start, start + n_steps):
        state, metrics = trainer.train_step(state, ref["batch"])
        if grads is None:
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        want = ref["steps"][i]
        for k in KEYS:
            np.testing.assert_allclose(metrics[k].item(), want["metrics"][k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i + 1} {k}")
        for name, p in state.model.named_parameters():
            g, g_ref = p.grad, want["grads"][name]
            assert torch.linalg.vector_norm(g - g_ref) <= \
                1e-3 * torch.linalg.vector_norm(g_ref) + 1e-7, f"step {i + 1} grad {name}"
    assert state.step == start + n_steps and state.optimizer.updates == start + n_steps
    want = ref["steps"][start + n_steps - 1]["state"]
    moved = ref["steps"][start]["grads"]
    unresolved = total = 0
    for name, value in state.model.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(value, want[name], rtol=1e-4, atol=1e-5, msg=name)
            continue
        sel = moved[name].abs() >= 1e-7
        # Adam moves an element by about lr whatever its gradient's size, so
        # an element whose gradient is f32 noise in both packages (here 1 of
        # ~10^5 at 1.7e-7 against a grad_norm of 89, the two sides 1.2e-7
        # apart) moves differently; such elements are counted, not compared.
        noise = (grads[name] - moved[name]).abs() > 0.5 * moved[name].abs()
        unresolved += int((sel & noise).sum())
        total += int(sel.sum())
        sel &= ~noise
        diff = (value - want[name])[sel].abs()
        assert diff.numel() == 0 or diff.max() <= 2e-2 * LR * n_steps, name
        assert not torch.equal(value, initial[name]) or not sel.any(), name
    assert unresolved <= 1e-4 * total, (unresolved, total)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_transformer_train_steps_match_jax(ref, n_steps):
    _check_steps(ref, 0, n_steps)


def test_transformer_train_state_resumes_from_jax(ref):
    """A JAX ``TrainState`` one step in (non-zero Adam moments on
    ``temporal_tf``) carried by ``train_state_from_jax``: its moments equal
    JAX's, and two more port steps match JAX's steps 2 and 3."""
    sd = ref["states"][1]
    carried = train_state_from_jax(sd)
    assert carried["step"] == 1 and carried["optimizer"]["updates"] == 1
    tf = _adam(sd)
    for moment in ("mu", "nu"):
        leaves = tf[moment]["fusion"]["temporal_tf"]
        got = carried["optimizer"][moment]
        for i in range(2):
            want = np.asarray(leaves[f"Dense_{2 * i}"]["kernel"]).T
            assert np.abs(want).max() > 0
            np.testing.assert_array_equal(got[f"fusion.temporal_tf.layers.{i}.fc1.weight"].numpy(),
                                          want)
        np.testing.assert_array_equal(got["fusion.temporal_tf.final_norm.weight"].numpy(),
                                      np.asarray(leaves["LayerNorm_4"]["scale"]))
    _check_steps(ref, 1, 2)


def _adam(sd):
    """The base group's Adam state of a JAX ``TrainState`` state dict."""
    from multimodal_av_model_tpu_torch.compat.from_jax import _find_adam

    return _find_adam(sd["opt_state"]["inner_states"]["base"])

"""PyTorch port, train-mode modules: BatchNorm with batch statistics, PReLU's
gradient at 0, the visual encoder's train forward and backward (with and
without recomputation), and dropout.  Held against the JAX modules with the
weights carried by the bridge, on the same numpy inputs (CPU, f32).

Tolerances: BatchNorm output and statistics rtol 1e-5 (atol 1e-5); visual
encoder outputs and statistics 2e-4 as in ``test_torch_models.py``; its
weight gradients per tensor ``|g - g_jax| <= 1e-3 |g_jax| + 1e-6``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from multimodal_av_model_tpu.models import VisualEncoder as JVisual
from multimodal_av_model_tpu.models.layers import PReLU as JPReLU
from multimodal_av_model_tpu_torch.compat.from_jax import visual_encoder_from_jax
from multimodal_av_model_tpu_torch.models import AudioEncoder, VisualEncoder, init_weights
from multimodal_av_model_tpu_torch.models.layers import (
    BatchNorm,
    MultiHeadAttention,
    PReLU,
    dropout,
)
from test_models import tiny_config
from test_torch_models import port_config, to_np


def t(x):
    return torch.from_numpy(np.array(x))


def test_batchnorm_train_matches_flax():
    """Output with batch statistics, and running statistics updated as
    ``0.9 old + 0.1 batch`` with the biased batch variance."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 5, 7, 3)) * 2 + 1).astype(np.float32)      # NHWC
    mean0 = rng.uniform(-1, 1, 3).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}
    y_ref, upd = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])

    bn = BatchNorm(3)
    bn.load_state_dict({"weight": t(scale), "bias": t(bias), "running_mean": t(mean0),
                        "running_var": t(var0)})
    y = bn(t(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]), rtol=1e-5, atol=1e-6)
    # Eval uses the running statistics and leaves them alone.
    before = bn.running_var.clone()
    y_eval = bn(t(x).permute(0, 3, 1, 2))
    assert torch.equal(bn.running_var, before)
    assert not torch.allclose(y_eval, y.permute(0, 3, 1, 2))


def test_prelu_gradient_at_zero_matches_jax():
    """At exactly 0 JAX splits the tie: d/dx = (1 + alpha) / 2, not 1 + alpha."""
    x = np.array([[-1.0, 0.0, 0.0, 2.0], [0.0, -0.5, 3.0, 0.0]], np.float32)[..., None, None]
    alpha = np.array([0.25, 0.4, 0.1, 0.7], np.float32)
    w = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    jm = JPReLU()
    jx = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))                 # NHWC, channels last
    jw = jnp.asarray(np.transpose(w, (0, 2, 3, 1)))
    g_x, g_p = jax.grad(lambda xx, a: (jm.apply({"params": {"alpha": a}}, xx) * jw).sum(),
                        argnums=(0, 1))(jx, jnp.asarray(alpha))

    m = PReLU(4)
    m.alpha.data = t(alpha)
    xt = t(x).requires_grad_(True)
    (m(xt) * t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.transpose(np.asarray(g_x), (0, 3, 1, 2)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m.alpha.grad.numpy(), np.asarray(g_p), rtol=1e-6, atol=1e-7)
    assert xt.grad[0, 1, 0, 0].item() == pytest.approx(w[0, 1, 0, 0] * (1 + 0.4) / 2)


def _visual_case(norm, remat):
    cfg = tiny_config()
    cfg.model.visual.norm = norm
    cfg.model.visual.remat = remat
    cfg.model.visual.output_dim = 20
    B, T, HW = 2, 6, 24
    rng = np.random.default_rng(2)
    lips = rng.uniform(0, 1, (B, T, HW, HW, 1)).astype(np.float32)
    # Zero-padded frames past a clip's length; the time-folded conv reads two
    # frames back, so frames 4 and 5 of row 1 see zeros only.
    lips[1, 2:] = 0.0
    w = rng.standard_normal((B, T, 20)).astype(np.float32)
    return cfg, lips, w


@pytest.mark.parametrize("remat", ["none", "frontend"])
@pytest.mark.parametrize("norm", ["batch", "group"])
def test_visual_encoder_train_step_matches_jax(norm, remat):
    """Train forward, the weight gradients of ``sum(out * w)`` and the
    updated BatchNorm statistics against JAX.  The zero-padded frames stay
    exactly 0 through GroupNorm, so PReLU's gradient at 0 is exercised."""
    cfg, lips, w = _visual_case(norm, remat)
    jm = JVisual(cfg.model.visual)
    v = to_np(jm.init(jax.random.PRNGKey(3), jnp.asarray(lips)))

    def loss(params):
        variables = dict(v, params=params)
        out, upd = jm.apply(variables, jnp.asarray(lips), True, mutable=["batch_stats"])
        return (out * jnp.asarray(w)).sum(), (out, upd)

    (_, (j_out, j_upd)), j_grads = jax.value_and_grad(loss, has_aux=True)(v["params"])

    tm = VisualEncoder(port_config(cfg).model.visual)
    tm.load_state_dict(visual_encoder_from_jax(v), strict=True)
    out = tm(t(lips), train=True)
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=2e-4, atol=2e-4)
    ref_grads = visual_encoder_from_jax({"params": to_np(j_grads)})
    for name, p in tm.named_parameters():
        g, ref = p.grad.numpy(), ref_grads[name].numpy()
        assert np.linalg.norm(g - ref) <= 1e-3 * np.linalg.norm(ref) + 1e-6, name
    if norm == "batch":
        ref_stats = visual_encoder_from_jax(dict(to_np(j_upd), params=v["params"]))
        for name, buf in tm.named_buffers():
            np.testing.assert_allclose(buf.numpy(), ref_stats[name].numpy(),
                                       rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("remat", ["frontend", "stage1", "full"])
def test_remat_updates_running_statistics_once(remat):
    """Recomputation in the backward leaves the statistics of the forward:
    after one step they equal those without recomputation, and so do the
    gradients."""
    cfg, lips, w = _visual_case("batch", "none")
    runs = {}
    for mode in ("none", remat):
        cfg.model.visual.remat = mode
        tm = init_weights(VisualEncoder(port_config(cfg).model.visual),
                          torch.Generator().manual_seed(4))
        (tm(t(lips), train=True) * t(w)).sum().backward()
        runs[mode] = ({k: b.clone() for k, b in tm.named_buffers()},
                      {k: p.grad.clone() for k, p in tm.named_parameters()})
    (stats, grads), (stats_r, grads_r) = runs["none"], runs[remat]
    for k in stats:
        assert not torch.equal(stats[k], torch.zeros_like(stats[k])) or "mean" not in k
        torch.testing.assert_close(stats_r[k], stats[k], rtol=0, atol=0)
    for k in grads:
        torch.testing.assert_close(grads_r[k], grads[k], rtol=1e-5, atol=1e-6)


def test_visual_encoder_rejects_unknown_remat():
    cfg = tiny_config()
    cfg.model.visual.remat = "some"
    with pytest.raises(ValueError, match="remat"):
        VisualEncoder(port_config(cfg).model.visual)


# -- dropout ------------------------------------------------------------------

def test_dropout_keep_fraction_and_scale():
    x = torch.ones(1_000_000)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 3e-3        # ~10 standard deviations
    assert torch.all(y[kept] == 1 / 0.9)
    assert dropout(x, 0.1, None) is x                           # eval: unchanged
    assert torch.all(dropout(x, 1.0, torch.Generator()) == 0)


def test_dropout_mask_broadcasts_one_draw():
    y = dropout(torch.ones(3, 4, 5, 6), 0.5, torch.Generator().manual_seed(1), (1, 1, 5, 6))
    assert torch.equal(y, y[:1, :1].expand_as(y))


def test_attention_dropout_mask_is_shared_across_rows_and_heads():
    """flax's ``broadcast_dropout``: one [Tq, Tk] mask for every batch row and
    head, so two identical rows give identical outputs in train mode."""
    mha = MultiHeadAttention(8, 2, torch.float32, dropout_rate=0.3)
    init_weights(mha, torch.Generator().manual_seed(2))
    row = torch.randn(1, 7, 8, generator=torch.Generator().manual_seed(3))
    x = row.expand(2, 7, 8).contiguous()
    out = mha(x, x, generator=torch.Generator().manual_seed(4))
    assert torch.equal(out[0], out[1])
    assert not torch.allclose(out, mha(x, x))                  # dropout did act


def _audio(dropout_rate):
    cfg = tiny_config()
    cfg.model.audio.dropout = dropout_rate
    pc = port_config(cfg).model
    return init_weights(AudioEncoder(pc.audio, pc.frontend), torch.Generator().manual_seed(5))


def test_audio_dropout_eval_unchanged_and_seeded():
    wave = torch.randn(2, 3200, generator=torch.Generator().manual_seed(6))
    m, m0 = _audio(0.1), _audio(0.0)
    with torch.no_grad():
        eval_out = m(wave)[0]
        torch.testing.assert_close(eval_out, m0(wave)[0], rtol=0, atol=0)
        a = m(wave, generator=torch.Generator().manual_seed(7))[0]
        b = m(wave, generator=torch.Generator().manual_seed(7))[0]
        c = m(wave, generator=torch.Generator().manual_seed(8))[0]
        train0 = m0(wave, generator=torch.Generator().manual_seed(7))[0]
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert not torch.allclose(a, eval_out)
    torch.testing.assert_close(train0, eval_out, rtol=0, atol=0)   # rate 0: no change


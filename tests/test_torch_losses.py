"""PyTorch port, losses: the CTC loss and the masked contrastive loss held
against the JAX functions on the same numpy inputs (CPU, f32), values and
gradients.

CTC gradients are compared with respect to the logits before a
``log_softmax``: ATen's CTC backward returns ``exp(log_probs) - posterior``,
which is the gradient only through a ``log_softmax`` (the port's decoder
always applies one).  ``test_ctc_log_probs_gradient_is_not_jax`` pins that
difference so the comparison is not "fixed" to the other variable later.
Tolerances: values rtol 1e-5 (atol 1e-5), gradients atol 1e-5 (f32 sums in
two libraries).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_av_model_tpu.ops.contrastive import contrastive_loss_with_mask as j_contrastive
from multimodal_av_model_tpu.ops.ctc import ctc_loss as j_ctc
from multimodal_av_model_tpu_torch.ops.contrastive import contrastive_loss_with_mask
from multimodal_av_model_tpu_torch.ops.ctc import ctc_loss

BLANK = 3


def _ctc_case(seed=0, B=5, T=12, V=9, L=6):
    """Ragged input and label lengths; row 3 cannot align (label longer than
    its input), row 4 has an empty label.  Labels avoid the blank and repeat
    a token so the skip rule is exercised."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2.0
    labels = rng.choice([0, 1, 2, 4, 5, 6, 7, 8], size=(B, L)).astype(np.int32)
    labels[0, 1] = labels[0, 0]
    il = np.array([12, 9, 7, 3, 5], np.int32)[:B]
    ll = np.array([6, 3, 4, 5, 0], np.int32)[:B]
    return logits, labels, il, ll


def _jax_loss(logits, labels, il, ll, reduction):
    def f(x):
        lp = jax.nn.log_softmax(x, axis=-1)
        out = j_ctc(lp, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll), BLANK,
                    reduction=reduction)
        return out, lp
    return f


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_ctc_values_and_logit_gradients_match_jax(reduction):
    logits, labels, il, ll = _ctc_case()
    f = _jax_loss(logits, labels, il, ll, reduction)
    j_val, _ = f(jnp.asarray(logits))
    j_grad = jax.grad(lambda x: f(x)[0].sum())(jnp.asarray(logits))

    x = torch.from_numpy(logits).requires_grad_(True)
    val = ctc_loss(torch.log_softmax(x, -1), torch.from_numpy(labels), torch.from_numpy(il),
                   torch.from_numpy(ll), BLANK, reduction=reduction)
    val.sum().backward()
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(j_val), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), rtol=0, atol=1e-5)
    if reduction == "none":
        per = val.detach().numpy()
        assert per[3] == 0.0                     # impossible alignment -> 0 (zero_infinity)
        assert np.isfinite(per).all() and per[4] > 0    # empty label: the all-blank path
        assert np.all(x.grad.numpy()[3] == 0)    # and no gradient from it


def test_ctc_log_probs_gradient_is_not_jax():
    """With respect to ``log_probs`` the two libraries differ (by about 0.75
    at this size); only the logit gradient is comparable."""
    logits, labels, il, ll = _ctc_case(seed=1)
    lp_np = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    keep = il != 3                               # leave out the zeroed row
    j_grad = jax.grad(lambda lp: j_ctc(lp, jnp.asarray(labels), jnp.asarray(il),
                                       jnp.asarray(ll), BLANK, reduction="sum"))(
        jnp.asarray(lp_np))
    lp = torch.from_numpy(lp_np).requires_grad_(True)
    ctc_loss(lp, torch.from_numpy(labels), torch.from_numpy(il), torch.from_numpy(ll),
             BLANK, reduction="sum").backward()
    diff = np.abs(lp.grad.numpy() - np.asarray(j_grad))[keep].max()
    assert diff > 0.1


def test_ctc_blank_zero_and_long_inputs_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 40, 6)).astype(np.float32)
    labels = rng.integers(1, 6, size=(3, 10)).astype(np.int32)
    il, ll = np.array([40, 31, 25], np.int32), np.array([10, 7, 1], np.int32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    ref = j_ctc(jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll), 0,
                reduction="none")
    got = ctc_loss(torch.from_numpy(lp), torch.from_numpy(labels), torch.from_numpy(il),
                   torch.from_numpy(ll), 0, reduction="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="reduction"):
        ctc_loss(torch.from_numpy(lp), torch.from_numpy(labels), torch.from_numpy(il),
                 torch.from_numpy(ll), 0, reduction="max")


def _contrastive_case(seed, B=3, T=10, D=6, codes=(0, 1, 2, 3)):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = rng.choice(codes, size=(B, T)).astype(np.int32)
    mask[-1, T // 2:] = 3                        # a padded tail
    return feat, mask


@pytest.mark.parametrize("codes", [(0, 1, 2, 3), (1, 2, 3), (0, 2, 3), (0, 3), (1, 3)],
                         ids=["all", "no-other-solo", "no-anchor", "only-other", "only-anchor"])
def test_contrastive_values_and_gradients_match_jax(codes):
    """Values and feature gradients against JAX, including empty anchor or
    candidate sets (a term is then 0) and pad rows."""
    feat, mask = _contrastive_case(3, codes=codes)
    kw = dict(temperature=0.07, weight_pos_align=1.0, weight_neg_suppress=0.3)
    j_val, j_grad = jax.value_and_grad(
        lambda f: j_contrastive(f, jnp.asarray(mask), **kw))(jnp.asarray(feat))
    x = torch.from_numpy(feat).requires_grad_(True)
    val = contrastive_loss_with_mask(x, torch.from_numpy(mask), **kw)
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), rtol=0, atol=1e-5)
    assert np.all(x.grad.numpy()[mask == 3] == 0)       # pad rows take no part
    if 1 not in codes:
        assert val.item() == 0.0


def test_contrastive_flat_input_and_weights():
    feat, mask = _contrastive_case(4, B=1, T=16)
    kw = dict(temperature=0.2, weight_pos_align=0.5, weight_neg_suppress=2.0)
    ref = j_contrastive(jnp.asarray(feat[0]), jnp.asarray(mask[0]), **kw)
    got = contrastive_loss_with_mask(torch.from_numpy(feat[0]), torch.from_numpy(mask[0]), **kw)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, atol=1e-6)
    assert got.dtype == torch.float32

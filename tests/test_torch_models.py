"""PyTorch port, model half: AudioEncoder, VisualEncoder, CrossAttentionFusion,
BiLSTM and the whole MultiSpeakerAVModel eval forward, each run with flax
``init`` parameters carried over by the weight bridge and held against the
JAX module on the same numpy inputs (f32 on the CPU, tiny widths)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_av_model_tpu.models import AudioEncoder as JAudio
from multimodal_av_model_tpu.models import CrossAttentionFusion as JFusion
from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
from multimodal_av_model_tpu.models import VisualEncoder as JVisual
from multimodal_av_model_tpu.models.layers import BiLSTM as JBiLSTM
from multimodal_av_model_tpu_torch import config as tcfg
from multimodal_av_model_tpu_torch.compat.from_jax import (
    audio_encoder_from_jax,
    bilstm_from_jax,
    from_jax_variables,
    fusion_from_jax,
    visual_encoder_from_jax,
)
from multimodal_av_model_tpu_torch.models import (
    AudioEncoder,
    CrossAttentionFusion,
    MultiSpeakerAVModel,
    VisualEncoder,
    init_weights,
)
from multimodal_av_model_tpu_torch.models.layers import BiLSTM
from test_models import tiny_config

# f32 on both sides; the residual differences are summation order (XLA vs
# ATen GEMMs/convs) compounded through a few layers.
RTOL = ATOL = 2e-4


def port_config(jax_cfg) -> tcfg.Config:
    """The port's Config with every field it shares copied from a JAX Config
    (the port's own fields, ``model.arch`` and ``model.avhubert``, keep their
    defaults)."""
    def copy(dst, src):
        for f in dataclasses.fields(dst):
            if not hasattr(src, f.name):
                continue
            v = getattr(src, f.name)
            if dataclasses.is_dataclass(v):
                copy(getattr(dst, f.name), v)
            else:
                setattr(dst, f.name, v)
        return dst
    return copy(tcfg.Config(), jax_cfg)


def to_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def perturb_batch_stats(variables, seed=0):
    """Non-trivial running statistics, so eval BatchNorm is really exercised."""
    rng = np.random.default_rng(seed)
    v = to_np(variables)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (rng.uniform(-0.5, 0.5, a.shape) if p[-1].key == "mean"
                          else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32),
            v["batch_stats"])
    return v


def t(x):
    return torch.from_numpy(np.asarray(x))


def _speech_masks(B, S, seed):
    """Per-speaker 0/1/2/3 masks with shared padding, from random lengths."""
    rng = np.random.default_rng(seed)
    pos = np.arange(S)[None]
    l1 = rng.integers(S // 3, S + 1, size=B)[:, None]
    l2 = rng.integers(S // 3, S + 1, size=B)[:, None]
    both = (pos < l1) & (pos < l2)
    m1 = np.where(both, 1, np.where(pos < l1, 2, 0))
    m2 = np.where(both, 1, np.where(pos < l2, 2, 0))
    pad = pos >= np.maximum(l1, l2)
    return (np.where(pad, 3, m1).astype(np.int32), np.where(pad, 3, m2).astype(np.int32))


def test_audio_encoder_matches_jax():
    cfg = tiny_config().model
    B, S = 2, 4000
    rng = np.random.default_rng(0)
    wave = rng.standard_normal((B, S)).astype(np.float32)
    smask = np.arange(S)[None] < np.array([[S], [S * 2 // 3]])
    jm = JAudio(cfg.audio, cfg.frontend)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(wave))
    j_last, j_mid, j_valid, _ = jm.apply(v, jnp.asarray(wave), jnp.asarray(smask))

    pc = port_config(tiny_config()).model
    tm = AudioEncoder(pc.audio, pc.frontend).eval()
    tm.load_state_dict(audio_encoder_from_jax(to_np(v)), strict=True)
    with torch.no_grad():
        last, mid, valid = tm(t(wave), t(smask))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    # Padded frames are excluded: fusion drops them and they never reach an output.
    keep = np.asarray(j_valid)[..., None]
    for got, ref in ((last, j_last), (mid, j_mid)):
        np.testing.assert_allclose(got.numpy() * keep, np.asarray(ref) * keep,
                                   rtol=RTOL, atol=ATOL)
    assert np.isfinite(last.numpy()).all()        # padded query rows stay finite


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_visual_encoder_matches_jax(norm):
    cfg = tiny_config()
    cfg.model.visual.norm = norm
    cfg.model.visual.output_dim = 20          # exercises the output Dense
    B, T, HW = 2, 4, 24
    lips = np.random.default_rng(2).uniform(0, 1, (B, T, HW, HW, 1)).astype(np.float32)
    jm = JVisual(cfg.model.visual)
    v = perturb_batch_stats(jm.init(jax.random.PRNGKey(3), jnp.asarray(lips)))
    ref = np.asarray(jm.apply(v, jnp.asarray(lips)))

    tm = VisualEncoder(port_config(cfg).model.visual).eval()
    tm.load_state_dict(visual_encoder_from_jax(v), strict=True)
    with torch.no_grad():
        got = tm(t(lips)).numpy()
    assert got.shape == (B, T, 20)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_fusion_matches_jax():
    cfg = tiny_config()
    B, T_v, T_a = 3, 7, 11
    rng = np.random.default_rng(4)
    vis = rng.standard_normal((B, T_v, 24)).astype(np.float32)
    aud = rng.standard_normal((B, T_a, 48)).astype(np.float32)
    mask = rng.integers(0, 4, size=(B, T_a)).astype(np.int32)
    vlen = np.array([7, 5, 3], np.int32)
    jm = JFusion(cfg.model.fusion)
    v = jm.init(jax.random.PRNGKey(5), jnp.asarray(vis), jnp.asarray(aud), jnp.asarray(mask),
                jnp.asarray(vlen))
    j_fused, j_len = jm.apply(v, jnp.asarray(vis), jnp.asarray(aud), jnp.asarray(mask),
                              jnp.asarray(vlen))

    tm = CrossAttentionFusion(port_config(cfg).model.fusion, 24, 48).eval()
    tm.load_state_dict(fusion_from_jax(to_np(v)), strict=True)
    with torch.no_grad():
        fused, lens = tm(t(vis), t(aud), t(mask), t(vlen))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(j_len))
    np.testing.assert_allclose(fused.numpy(), np.asarray(j_fused), rtol=RTOL, atol=ATOL)
    # Past each length the BiLSTM output is zero.
    assert np.all(fused.numpy()[2, 3:] == 0)


def test_bilstm_matches_jax():
    B, T, D, H = 3, 6, 5, 4
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = np.array([6, 4, 1], np.int32)
    jm = JBiLSTM(H, 2)
    v = to_np(jm.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(lens)))
    # Non-zero recurrent biases, so their gate order is checked too.
    v["params"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a + rng.standard_normal(a.shape).astype(np.float32)
        if p[-1].key == "bias" else a, v["params"])
    ref = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(lens)))
    tm = BiLSTM(D, H, 2)
    tm.load_state_dict(bilstm_from_jax(v), strict=True)
    with torch.no_grad():
        got = tm(t(x), t(lens)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _av_inputs(B=2, T=6, HW=24, S=3204, seed=8):
    rng = np.random.default_rng(seed)
    lip1 = rng.uniform(0, 1, (B, T, 1, HW, HW)).astype(np.float32)
    lip2 = rng.uniform(0, 1, (B, T, 1, HW, HW)).astype(np.float32)
    audio = rng.standard_normal((B, S)).astype(np.float32) * 0.3
    m1, m2 = _speech_masks(B, S, seed)
    l1 = np.array([T, T - 2], np.int32)[:B]
    l2 = np.array([T - 1, T], np.int32)[:B]
    return lip1, lip2, audio, m1, m2, l1, l2


@pytest.mark.parametrize("dtype,tol", [("float32", RTOL), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("norm", ["batch", "group"])
def test_full_model_eval_forward_matches_jax(norm, dtype, tol):
    """Log-probs on valid frames within ``tol``, input_lengths and mask_ds
    exact; in f32 the contrastive taps (a training output) too.  In bfloat16,
    the serving dtype, the two frameworks round at different places; their gap
    (about 2e-3 here) is the size of the gap between JAX's own bf16 and f32
    runs, so the bar is 1e-2."""
    cfg = tiny_config()
    cfg.model.visual.norm = norm
    inputs = _av_inputs()
    v = perturb_batch_stats(JModel(cfg.model).init(jax.random.PRNGKey(9),
                                                   *map(jnp.asarray, inputs)))
    ref = JModel(cfg.model, dtype=getattr(jnp, dtype)).apply(v, *map(jnp.asarray, inputs))

    tm = MultiSpeakerAVModel(port_config(cfg).model, dtype=getattr(torch, dtype)).eval()
    tm.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        out = tm(*map(t, inputs))
    assert set(out) == set(ref)
    for s in ("1", "2"):
        lens = np.asarray(ref["input_lengths" + s])
        np.testing.assert_array_equal(out["input_lengths" + s].numpy(), lens)
        np.testing.assert_array_equal(out["mask_ds" + s].numpy(), np.asarray(ref["mask_ds" + s]))
        for key in ("log_probs", "contrast") if dtype == "float32" else ("log_probs",):
            got, want = out[key + s].float().numpy(), np.asarray(ref[key + s], np.float32)
            for b in range(got.shape[0]):
                n = lens[b] if key == "log_probs" else got.shape[1]
                np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=tol, atol=tol)


def test_bridge_rejects_unknown_and_leftover_keys():
    cfg = tiny_config()
    inputs = _av_inputs()
    v = to_np(JModel(cfg.model).init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs)))
    v["params"]["decoder"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unconsumed"):
        from_jax_variables(v)
    with pytest.raises(KeyError, match="collection"):
        from_jax_variables({"params": {}, "cache": {}})


def test_seeded_init_is_deterministic_and_finite():
    pc = port_config(tiny_config()).model
    a = init_weights(MultiSpeakerAVModel(pc), torch.Generator().manual_seed(0))
    b = init_weights(MultiSpeakerAVModel(pc), torch.Generator().manual_seed(0))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    with torch.no_grad():
        out = a.eval()(*map(t, _av_inputs()))
    lp = out["log_probs1"]
    assert torch.isfinite(lp).all()
    torch.testing.assert_close(lp.logsumexp(-1), torch.zeros(lp.shape[:2]), atol=1e-4, rtol=0)

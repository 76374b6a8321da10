"""PyTorch port, long-form context parallelism (``parallel/longform.py``): the
audio encoder with ring or gather-KV attention split over 4 gloo ranks (one
spawned group for the module, ``parallel/spawn.py:longform_cases``), loaded
with JAX's parameters through ``audio_encoder_from_jax``, held against JAX's
``make_cp_audio_encoder`` on a 4-device mesh and against the port's own
full-attention encoder, at JAX's tiny config and ``tests/test_longform.py``'s
input (B = 2, S = 3520, so that T_enc = 12 divides 4).

Tolerances: ``last`` and ``middle`` within atol 2e-4, rtol 1e-4 (JAX's
long-form bars; f32, summation order only).  The attention slot left empty is
the standard encoder exactly.  Both packages drop the mask in the CP
attention (``longform.py:50``), so a padded batch gives the same result in
both and differs from the standard encoder on the valid frames.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_av_model_tpu.models.audio import AudioEncoder as JAudio
from multimodal_av_model_tpu.parallel import make_mesh as j_make_mesh
from multimodal_av_model_tpu.parallel.longform import make_cp_audio_encoder as j_make_cp
from multimodal_av_model_tpu_torch.compat.from_jax import audio_encoder_from_jax
from multimodal_av_model_tpu_torch.models import AudioEncoder
from multimodal_av_model_tpu_torch.models.layers import MultiHeadAttention
from multimodal_av_model_tpu_torch.parallel.longform import CPSelfAttention
from multimodal_av_model_tpu_torch.parallel.spawn import longform_cases, run_ranks
from test_models import tiny_config
from test_torch_models import port_config, to_np

WORLD, B, S = 4, 2, 3520
ATOL, RTOL = 2e-4, 1e-4


def _audio(S=S):
    return (np.random.default_rng(0).standard_normal((B, S)).astype(np.float32) * 0.1)


def _padded_mask():
    return np.arange(S)[None] < np.array([[S], [S * 2 // 3]])


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config()
    audio = _audio()
    params = jax.jit(JAudio(cfg.model.audio, cfg.model.frontend).init)(
        jax.random.PRNGKey(0), jnp.asarray(audio))["params"]
    return cfg, params, port_config(cfg).model, audio_encoder_from_jax({"params": to_np(params)})


@pytest.fixture(scope="module")
def ported(setup, tmp_path_factory):
    """Every case on one spawned group of 4 gloo ranks."""
    _, _, pcfg, sd = setup
    work = str(tmp_path_factory.mktemp("longform"))
    jobs = {"ring": {"impl": "ring", "audio": _audio()},
            "gather": {"impl": "gather", "audio": _audio()},
            "ring_padded": {"impl": "ring", "audio": _audio(), "sample_mask": _padded_mask()},
            "indivisible": {"impl": "ring", "audio": _audio(3360)}}      # T_enc = 11
    out = os.path.join(work, "out.pt")
    run_ranks(longform_cases, WORLD, work, (pcfg, sd, list(jobs.values()), out), timeout=180)
    return dict(zip(jobs, torch.load(out, weights_only=True)))


def _jax_cp(cfg, params, impl, audio, mask=None):
    enc = j_make_cp(cfg.model, j_make_mesh(n_devices=WORLD), seq_axis="data", impl=impl)
    args = (jnp.asarray(audio),) if mask is None else (jnp.asarray(audio), jnp.asarray(mask))
    last, middle, _, _ = jax.jit(enc.apply)({"params": params}, *args)
    return np.asarray(last), np.asarray(middle)


def _full(pcfg, sd, audio, mask=None):
    enc = AudioEncoder(pcfg.audio, pcfg.frontend).eval()
    enc.load_state_dict(sd)
    with torch.no_grad():
        return enc(torch.from_numpy(audio), None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("impl", ["ring", "gather"])
def test_cp_encoder_matches_jax(setup, ported, impl):
    cfg, params, _, _ = setup
    last, middle = _jax_cp(cfg, params, impl, _audio())
    assert ported[impl]["last"].shape == (B, 12, cfg.model.audio.output_dim)
    np.testing.assert_allclose(ported[impl]["last"].numpy(), last, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ported[impl]["middle"].numpy(), middle, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["ring", "gather"])
def test_cp_encoder_matches_the_full_attention_encoder(setup, ported, impl):
    _, _, pcfg, sd = setup
    last, middle, valid = _full(pcfg, sd, _audio())
    torch.testing.assert_close(ported[impl]["last"], last, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(ported[impl]["middle"], middle, atol=ATOL, rtol=RTOL)
    assert torch.equal(ported[impl]["frame_valid"], valid)


def test_an_empty_attention_slot_is_the_standard_encoder(setup):
    _, _, pcfg, sd = setup
    wave = torch.from_numpy(_audio())
    outs = []
    for kwargs in ({}, {"attention": None}, {"attention": MultiHeadAttention}):
        enc = AudioEncoder(pcfg.audio, pcfg.frontend, **kwargs).eval()
        enc.load_state_dict(sd, strict=True)
        assert all(type(b.attn) is MultiHeadAttention for b in enc.blocks)
        with torch.no_grad():
            outs.append(enc(wave))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_cp_attention_keeps_the_mha_parameters(setup):
    _, _, pcfg, sd = setup
    attn = CPSelfAttention(32, 2, mesh=None)
    assert set(attn.state_dict()) == set(MultiHeadAttention(32, 2, torch.float32).state_dict())
    with pytest.raises(ValueError, match="impl 'flash'"):
        CPSelfAttention(32, 2, mesh=None, impl="flash")
    with pytest.raises(ValueError, match="d_model 30 not divisible by 4 heads"):
        CPSelfAttention(30, 4, mesh=None)


def test_a_padded_batch_drops_the_mask_in_both_packages(setup, ported):
    """JAX-side quirk, recorded in ROADMAP Queue 3: the CP attention is full
    attention, so padded frames are attended to, unlike the standard
    encoder's; the port mirrors it."""
    cfg, params, pcfg, sd = setup
    got = ported["ring_padded"]
    last, middle = _jax_cp(cfg, params, "ring", _audio(), _padded_mask())
    np.testing.assert_allclose(got["last"].numpy(), last, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["middle"].numpy(), middle, atol=ATOL, rtol=RTOL)
    std_last, _, valid = _full(pcfg, sd, _audio(), _padded_mask())
    assert torch.equal(got["frame_valid"], valid) and not valid[1].all()
    assert float((got["last"][1][valid[1]] - std_last[1][valid[1]]).abs().max()) > 1e-2
    torch.testing.assert_close(got["last"][0], std_last[0], atol=ATOL, rtol=RTOL)


def test_a_length_the_axis_does_not_divide_raises_in_both_packages(setup, ported):
    cfg, params, _, _ = setup
    assert "T=11 is not divisible by the 'data' axis size 4" in ported["indivisible"]["error"]
    with pytest.raises(ValueError):
        _jax_cp(cfg, params, "ring", _audio(3360))

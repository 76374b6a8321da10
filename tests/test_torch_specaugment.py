"""PyTorch port, SpecAugment (``ops/specaugment.py``) against the JAX
``spec_augment``.

The two libraries cannot draw the same random numbers, so the parity cases
recompute JAX's draws from its key with its own ``jax.random`` splits and
feed them to the port's apply:

* on features whose f32 sums are exact (multiples of 1/8, small), the result
  equals JAX's bit for bit;
* on real log-mel features the stripes and every untouched cell are equal,
  and the fill (a mean JAX sums in f32, the port in f64) is within 1e-6
  relative.

The port's own draws are held to JAX's bounds; padding frames stay
untouched; SpecAugment is off by default and runs in the audio encoder only
in train mode, on K1's detached output.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_av_model_tpu.config import AudioEncoderConfig as JAudioConfig
from multimodal_av_model_tpu.ops.specaugment import spec_augment as j_spec_augment
from multimodal_av_model_tpu_torch.config import AudioEncoderConfig, AudioFrontendConfig
from multimodal_av_model_tpu_torch.models import AudioEncoder, init_weights
from multimodal_av_model_tpu_torch.models import audio as audio_module
from multimodal_av_model_tpu_torch.ops.logmel import log_mel_spectrogram
from multimodal_av_model_tpu_torch.ops.specaugment import (
    SpecAugmentDraws,
    apply_spec_augment,
    draw_spec_augment,
    spec_augment,
)

# (freq_masks, freq_mask_width, time_masks, time_mask_frac)
SETTINGS = [(2, 27, 2, 0.05), (2, 7, 0, 0.05), (0, 27, 3, 0.2), (3, 5, 2, 0.3), (1, 40, 1, 1.0)]


def jax_draws(key, frame_valid, n_bins, fm, fw, tm, tf) -> SpecAugmentDraws:
    """JAX's stripes for ``key``: the splits and bounds of
    ``multimodal_av_model_tpu/ops/specaugment.py:52-76``, as port tensors."""
    B = frame_valid.shape[0]
    valid_len = jnp.maximum(jnp.asarray(frame_valid).sum(axis=1), 1)
    k_f, k_t = jax.random.split(key)
    empty = np.zeros((B, 0), np.int64)
    fwid = fst = twid = tst = empty
    if fm > 0 and fw > 0:
        ks = jax.random.split(k_f, 2)
        width = jax.random.randint(ks[0], (B, fm), 0, fw + 1)
        start = (jax.random.uniform(ks[1], (B, fm)) * jnp.maximum(n_bins - width, 1)).astype(
            jnp.int32)
        fwid, fst = np.asarray(width), np.asarray(start)
    if tm > 0 and tf > 0:
        ks = jax.random.split(k_t, 2)
        max_w = jnp.maximum(valid_len.astype(jnp.float32) * tf, 1.0)
        width = (jax.random.uniform(ks[0], (B, tm)) * (max_w[:, None] + 1.0)).astype(jnp.int32)
        start = (jax.random.uniform(ks[1], (B, tm))
                 * jnp.maximum(valid_len[:, None] - width, 1)).astype(jnp.int32)
        twid, tst = np.asarray(width), np.asarray(start)
    return SpecAugmentDraws(*(torch.from_numpy(np.asarray(a, np.int64))
                              for a in (fwid, fst, twid, tst)))


def _valid(B, T, lengths):
    return np.arange(T)[None, :] < np.asarray(lengths)[:, None]


def _both(mel, valid, seed, setting):
    fm, fw, tm, tf = setting
    key = jax.random.PRNGKey(seed)
    want = np.asarray(j_spec_augment(key, jnp.asarray(mel), jnp.asarray(valid), freq_masks=fm,
                                     freq_mask_width=fw, time_masks=tm, time_mask_frac=tf))
    draws = jax_draws(key, valid, mel.shape[2], fm, fw, tm, tf)
    got = apply_spec_augment(torch.from_numpy(mel), torch.from_numpy(valid), draws).numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("setting", SETTINGS)
def test_apply_with_jax_draws_is_exact(seed, setting):
    """Features on a 1/8 grid: every partial sum of the fill is exact in
    f32, in any order, so the whole result must be bit-equal."""
    rng = np.random.default_rng(seed)
    B, T, F = 3, 60, 20
    mel = (rng.integers(-512, 512, size=(B, T, F)) / 8.0).astype(np.float32)
    valid = _valid(B, T, [60, 41, 7])
    got, want = _both(mel, valid, seed, setting)
    np.testing.assert_array_equal(got, want)
    assert (got != mel).any()


@pytest.mark.parametrize("setting", SETTINGS[:2])
def test_apply_with_jax_draws_on_log_mel(setting):
    rng = np.random.default_rng(5)
    wave = torch.from_numpy((rng.standard_normal((2, 16000)) * 0.3).astype(np.float32))
    mel = log_mel_spectrogram(wave).numpy()                        # [2, 101, 80]
    valid = _valid(2, mel.shape[1], [101, 64])
    got, want = _both(mel, valid, 7, setting)
    changed = want != mel
    np.testing.assert_array_equal(got != mel, changed)
    np.testing.assert_array_equal(got[~changed], want[~changed])
    np.testing.assert_allclose(got[changed], want[changed], rtol=1e-6, atol=0)


def test_port_draws_keep_jax_bounds():
    g = torch.Generator().manual_seed(0)
    B, T, F, W, frac = 64, 300, 80, 27, 0.05
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    valid = torch.arange(T)[None, :] < lengths[:, None]
    widths_seen = set()
    for _ in range(20):
        d = draw_spec_augment(g, valid, F, 3, W, 4, frac)
        assert d.freq_width.shape == (B, 3) and d.time_width.shape == (B, 4)
        assert d.freq_width.min() >= 0 and d.freq_width.max() <= W
        assert (d.freq_start >= 0).all() and (d.freq_start < (F - d.freq_width).clamp(min=1)).all()
        max_w = (lengths.float() * frac).clamp(min=1.0)[:, None]
        assert (d.time_width >= 0).all() and (d.time_width < max_w + 1).all()
        assert (d.time_start >= 0).all()
        assert (d.time_start < (lengths[:, None] - d.time_width).clamp(min=1)).all()
        widths_seen |= set(d.freq_width.flatten().tolist())
    assert widths_seen == set(range(W + 1))
    off = draw_spec_augment(g, valid, F, 0, W, 2, 0.0)
    assert off.freq_width.shape == off.time_width.shape == (B, 0)


def test_padding_frames_are_left_untouched():
    g = torch.Generator().manual_seed(3)
    mel = torch.randn(4, 50, 16, generator=g)
    lengths = torch.tensor([50, 30, 12, 1])
    valid = torch.arange(50)[None, :] < lengths[:, None]
    out = spec_augment(g, mel, valid, freq_masks=3, freq_mask_width=8, time_masks=3,
                       time_mask_frac=0.5)
    assert torch.equal(out[~valid], mel[~valid])
    assert not torch.equal(out[valid], mel[valid])
    for b, n in enumerate(lengths.tolist()):
        changed = out[b, :n] != mel[b, :n]
        if changed.any():                       # the fill is the valid frames' mean
            torch.testing.assert_close(out[b, :n][changed],
                                       mel[b, :n].mean().expand(int(changed.sum())))


def _tiny_encoder(**specaug):
    cfg = AudioEncoderConfig(d_model=16, num_layers=2, num_heads=2, ffn_dim=32,
                             conv_kernel_size=5, middle_layers=(0, 1), output_dim=16,
                             dropout=0.0, **specaug)
    enc = AudioEncoder(cfg, AudioFrontendConfig(n_mels=16))
    return init_weights(enc, torch.Generator().manual_seed(0))


def test_default_is_off():
    for name in ("specaug_freq_masks", "specaug_freq_width", "specaug_time_masks",
                 "specaug_time_frac"):
        assert getattr(AudioEncoderConfig(), name) == getattr(JAudioConfig(), name)
    assert AudioEncoderConfig().specaug_freq_masks == AudioEncoderConfig().specaug_time_masks == 0
    enc = _tiny_encoder()
    wave = torch.randn(2, 3200, generator=torch.Generator().manual_seed(1)) * 0.3
    g = torch.Generator().manual_seed(9)
    before = g.get_state()
    train = enc(wave, generator=g)[0]
    assert torch.equal(train, enc(wave)[0]) and torch.equal(g.get_state(), before)


def test_encoder_applies_it_in_train_mode_only(monkeypatch):
    """On K1's detached output, with the config's stripes, drawn from the
    dropout generator; its result is what the subsampler reads."""
    seen = []

    def spy(generator, mel, frame_valid, **kw):
        out = spec_augment(generator, mel, frame_valid, **kw)
        seen.append((mel, out, kw))
        return out

    monkeypatch.setattr(audio_module, "spec_augment", spy)
    enc = _tiny_encoder(specaug_freq_masks=2, specaug_freq_width=5, specaug_time_masks=2,
                        specaug_time_frac=0.2)
    wave = torch.randn(2, 3200, generator=torch.Generator().manual_seed(1)) * 0.3
    mask = torch.arange(3200)[None, :] < torch.tensor([[3200], [2000]])
    eval_out = enc(wave, mask)[0]
    assert not seen
    g = torch.Generator().manual_seed(4)
    state = g.get_state()
    train_out = enc(wave, mask, generator=g)[0]
    (mel, out, kw), = seen
    assert not mel.requires_grad and kw == {"freq_masks": 2, "freq_mask_width": 5,
                                            "time_masks": 2, "time_mask_frac": 0.2,
                                            "rows": (0, 1), "parts": 1}
    assert not torch.equal(out, mel) and not torch.equal(train_out, eval_out)
    replay = torch.Generator().manual_seed(0)
    replay.set_state(state)
    anchors = torch.clamp(torch.arange(mel.shape[1]) * 160, max=3199)
    assert torch.equal(spec_augment(replay, mel, mask[:, anchors], **kw), out)

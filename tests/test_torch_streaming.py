"""PyTorch port, streaming: ``StreamingAudioTranscriber``,
``StreamingAVTranscriber`` and ``StreamingPool`` held against the JAX
package's (CPU, f32, tiny widths).

As ``tests/test_streaming*.py`` do, frame-local oracle forwards (each frame's
log-probs set by one sample or lip pixel) isolate the window, mask, carry
and commit logic from the encoders; then the real models run on weights
converted from JAX.  Texts are compared exactly, for the block sizes of the
JAX tests: port against JAX, and against the offline oracle."""

import copy
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from multimodal_av_model_tpu.config import Config as JConfig
from multimodal_av_model_tpu.models import AudioOnlyCTC as JAudioOnly
from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
from multimodal_av_model_tpu.ops.prefix_beam_search import prefix_beam_search_decode as j_prefix
from multimodal_av_model_tpu.streaming import StreamingAudioTranscriber as JStream
from multimodal_av_model_tpu.streaming import StreamingAVTranscriber as JAVStream
from multimodal_av_model_tpu.streaming import StreamingPool as JPool
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu_torch.compat import audio_only_from_jax, from_jax_variables
from multimodal_av_model_tpu_torch.models import AudioOnlyCTC, MultiSpeakerAVModel
from multimodal_av_model_tpu_torch.ops.prefix_beam_search import prefix_beam_search_decode
from multimodal_av_model_tpu_torch.streaming import (
    StreamingAudioTranscriber,
    StreamingAVTranscriber,
    StreamingPool,
)
from multimodal_av_model_tpu_torch.text import CharTokenizer
from test_models import tiny_config as model_tiny_config
from test_torch_models import port_config

V, BLANK, LIP = 16, 3, 8
VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny models run many small ops, which torch's thread pool slows when
    the suite's workers already share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class IdTokenizer:
    vocab_size = V

    def decode(self, ids):
        return "".join(chr(ord("a") + i) for i in ids)


def audio_config():
    """``tests/test_streaming.py``'s tiny audio-only config."""
    cfg = JConfig()
    cfg.model.decoder.vocab_size, cfg.model.decoder.blank_id = V, BLANK
    a = cfg.model.audio
    a.d_model, a.num_layers, a.num_heads, a.ffn_dim, a.output_dim = 16, 2, 2, 32, 16
    a.middle_layers = (0, 1)
    cfg.model.frontend.n_mels = 16
    cfg.model.frontend.use_pallas = False
    return cfg


# -- frame-local oracles, one per package ---------------------------------------

def j_local_forward(variables, window, sample_mask):
    """Frame t's token is set by the window sample at its anchor t * 320."""
    S = window.shape[1]
    anchors = jnp.minimum(jnp.arange(S // 320 + 1) * 320, S - 1)
    tok = (jnp.take(window, anchors, axis=1) * 100).astype(jnp.int32) % V
    return jax.nn.log_softmax(jax.nn.one_hot(tok, V) * 10.0, axis=-1)


def local_forward(window, sample_mask):
    S = window.shape[1]
    anchors = torch.clamp(torch.arange(S // 320 + 1) * 320, max=S - 1)
    tok = (window[:, anchors] * 100).to(torch.int32) % V
    return torch.log_softmax(F.one_hot(tok.long(), V).float() * 10.0, dim=-1)


def offline_collapse(toks):
    out, prev = [], BLANK
    for t in toks:
        if t != prev and t != BLANK:
            out.append(int(t))
        prev = t
    return out


def piecewise_signal(rng, n_frames):
    """Frame values constant over runs of 1-5 frames (as the JAX tests)."""
    vals = []
    while sum(len(v) for v in vals) < n_frames:
        vals.append([rng.integers(0, V)] * int(rng.integers(1, 6)))
    frames = np.concatenate(vals)[:n_frames]
    return np.repeat(frames.astype(np.float32) / 100.0 + 0.001, 320)


def _feed(stream, signal, block):
    return "".join(stream.feed(signal[i:i + block])
                   for i in range(0, len(signal), block)) + stream.flush()


@pytest.mark.parametrize("block", [160, 320, 1000, 7 * 320, 10_000])
def test_audio_greedy_stream_matches_jax_and_offline(block):
    rng = np.random.default_rng(block)
    cfg = audio_config()
    signal = piecewise_signal(rng, 40)
    kw = dict(chunk_seconds=0.2, context_seconds=0.4, algorithm="greedy")
    got = _feed(StreamingAudioTranscriber(port_config(cfg), IdTokenizer(), device="cpu",
                                          forward_fn=local_forward, **kw), signal, block)
    want = _feed(JStream(cfg, IdTokenizer(), {}, forward_fn=j_local_forward, **kw), signal,
                 block)
    toks = [int(signal[min(t * 320, len(signal) - 1)] * 100) % V for t in range(40)]
    assert got == want == IdTokenizer().decode(offline_collapse(toks))


def test_audio_stream_boundary_repeat_and_reset():
    """A token spanning a chunk boundary is emitted once; ``flush`` resets."""
    cfg = port_config(audio_config())
    s = StreamingAudioTranscriber(cfg, IdTokenizer(), device="cpu", chunk_seconds=0.2,
                                  context_seconds=0.2, forward_fn=local_forward,
                                  algorithm="greedy")
    signal = np.repeat(np.array([3] * 5 + [7] * 10 + [3] * 5, np.float32) / 100.0 + 0.001,
                       320)
    assert s.feed(signal) + s.flush() == "h"
    assert s.text == ""
    part = s.feed(signal)
    assert s.text == part


@pytest.mark.parametrize("block", [1000, 3200, 10_000])
def test_audio_prefix_beam_stream_matches_jax_and_offline(block):
    """The streamed prefix-beam text equals the offline prefix beam over the
    whole utterance's frames, in both packages."""
    cfg = audio_config()
    signal = piecewise_signal(np.random.default_rng(7), 40)
    lp = np.asarray(j_local_forward(None, jnp.asarray(signal[None]), None))
    ids, n, _ = j_prefix(lp, np.array([lp.shape[1]]), cfg.decode.beam_width,
                         cfg.decode.prefix_top_k, BLANK)
    want = IdTokenizer().decode(np.asarray(ids)[0, :int(n[0])].tolist())
    p_ids, p_n, _ = prefix_beam_search_decode(local_forward(torch.from_numpy(signal[None]), None),
                                              torch.tensor([lp.shape[1]]), 5, 8, BLANK)
    assert IdTokenizer().decode(p_ids[0, :int(p_n[0])].tolist()) == want
    kw = dict(chunk_seconds=0.2, context_seconds=0.4, algorithm="prefix_beam")
    got = _feed(StreamingAudioTranscriber(port_config(cfg), IdTokenizer(), device="cpu",
                                          forward_fn=local_forward, **kw), signal, block)
    jax_got = _feed(JStream(cfg, IdTokenizer(), {}, forward_fn=j_local_forward, **kw), signal,
                    block)
    assert got == jax_got == want


def test_audio_prefix_beam_capacity_shift_matches_jax():
    """120 frames through a 24-token buffer: committed tokens shift out and
    the text equals a 512-token buffer's, in both packages."""
    cfg = audio_config()
    signal = piecewise_signal(np.random.default_rng(3), 120)
    texts = {}
    for cap in (24, 512):
        kw = dict(chunk_seconds=0.2, context_seconds=0.4, algorithm="prefix_beam",
                  beam_capacity=cap)
        s = StreamingAudioTranscriber(port_config(cfg), IdTokenizer(), device="cpu",
                                      forward_fn=local_forward, **kw)
        texts["port", cap] = s.feed(signal) + s.flush()
        js = JStream(cfg, IdTokenizer(), {}, forward_fn=j_local_forward, **kw)
        texts["jax", cap] = js.feed(signal) + js.flush()
    assert len(set(texts.values())) == 1 and len(texts["port", 24]) > 10


# -- the real audio-only model ----------------------------------------------------

@pytest.fixture(scope="module")
def audio_model():
    """A tiny ``AudioOnlyCTC`` in both packages, the shipped 800-token
    vocabulary, JAX variables at the streaming window's shape."""
    jtok = JTokenizer(VOCAB)
    cfg = model_tiny_config()
    cfg.model.decoder.vocab_size = jtok.vocab_size
    window = 12000                                    # 0.25 s chunk + 0.5 s context
    v = jax.jit(JAudioOnly(cfg.model).init)(jax.random.PRNGKey(0),
                                            jnp.zeros((1, window)), jnp.ones((1, window), bool))
    v = jax.tree.map(np.asarray, v)
    model = AudioOnlyCTC(port_config(cfg).model)
    model.load_state_dict(audio_only_from_jax(v), strict=True)
    return cfg, v, model, jtok, CharTokenizer(VOCAB)


@pytest.mark.parametrize("algorithm,quantize", [("greedy", False), ("prefix_beam", False),
                                                ("greedy", True)])
def test_audio_stream_real_model_matches_jax(audio_model, algorithm, quantize):
    cfg, v, model, jtok, tok = audio_model
    audio = (np.random.default_rng(1).standard_normal(int(1.3 * 16000)) * 0.3).astype(
        np.float32)
    kw = dict(chunk_seconds=0.25, context_seconds=0.5, algorithm=algorithm, quantize=quantize,
              quantize_min_size=256)
    if quantize:                      # the int8 form moves its module to the meta device
        model = copy.deepcopy(model)
    got = _feed(StreamingAudioTranscriber(port_config(cfg), tok, model, device="cpu", **kw),
                audio, 1500)
    want = _feed(JStream(cfg, jtok, v, dtype=jnp.float32, **kw), audio, 1500)
    assert got == want and len(got) > 3


def test_pool_matches_single_stream_and_jax(audio_model):
    """Three concurrent streams of different lengths and feed blocks: each
    equals a single-stream greedy run, and JAX's pool."""
    cfg, v, model, jtok, tok = audio_model
    rng = np.random.default_rng(0)
    lengths, blocks = (9000, 6500, 12000), (700, 1100, 2500)
    audios = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in lengths]
    kw = dict(chunk_seconds=0.25, context_seconds=0.5)
    pool = StreamingPool(port_config(cfg), tok, model, max_streams=4, device="cpu", **kw)
    jpool = JPool(cfg, jtok, v, max_streams=4, dtype=jnp.float32, **kw)
    texts = {}
    for name, p in (("port", pool), ("jax", jpool)):
        sids = [p.open() for _ in audios]
        out = [""] * 3
        for step in range(max(n // b + 1 for n, b in zip(lengths, blocks))):
            for i, sid in enumerate(sids):
                lo = step * blocks[i]
                if lo < lengths[i]:
                    out[i] += p.feed(sid, audios[i][lo:lo + blocks[i]])
        texts[name] = [o + p.flush(sid) for o, sid in zip(out, sids)]
    single = [_feed(StreamingAudioTranscriber(port_config(cfg), tok, model, device="cpu",
                                              algorithm="greedy", **kw), a, b)
              for a, b in zip(audios, blocks)]
    assert texts["port"] == texts["jax"] == single


def test_pool_slot_lifecycle_and_text(audio_model):
    cfg, _, model, _, tok = audio_model
    pool = StreamingPool(port_config(cfg), tok, model, max_streams=2, device="cpu",
                         chunk_seconds=0.25, context_seconds=0.5)
    sids = [pool.open(), pool.open()]
    with pytest.raises(RuntimeError, match="busy"):
        pool.open()
    audio = (np.random.default_rng(1).standard_normal(8000) * 0.3).astype(np.float32)
    emitted = pool.feed(sids[0], audio)
    assert pool.text(sids[0]) == emitted
    emitted += pool.flush(sids[0])                    # flush frees the slot
    assert pool.text(sids[0]) == emitted and pool.active_streams == 1
    assert pool.open() == sids[0]
    pool.close(sids[1])
    with pytest.raises(ValueError, match="not open"):
        pool.feed(sids[1], audio)


# -- AV ------------------------------------------------------------------------

def j_av_forward(variables, lip1, lip2, audio, m1, m2, len1, len2):
    """Visual frame t's token for a speaker is set by its lips' [0, 0] pixel."""
    def lp(lips):
        tok = (lips[:, :, 0, 0, 0] * 100).astype(jnp.int32) % V
        return jax.nn.log_softmax(jax.nn.one_hot(tok, V) * 10.0, axis=-1)
    return lp(lip1), lp(lip2)


def av_forward(lip1, lip2, audio, m1, m2, len1, len2):
    def lp(lips):
        tok = (lips[:, :, 0, 0, 0] * 100).to(torch.int32) % V
        return torch.log_softmax(F.one_hot(tok.long(), V).float() * 10.0, dim=-1)
    return lp(lip1), lp(lip2)


def frame_signal(rng, n_frames):
    vals = []
    while sum(len(v) for v in vals) < n_frames:
        vals.append([int(rng.integers(0, V))] * int(rng.integers(1, 5)))
    toks = np.concatenate(vals)[:n_frames].astype(np.float32)
    lips = np.zeros((n_frames, 1, LIP, LIP), np.float32)
    lips[:, 0, 0, 0] = toks / 100.0 + 0.001
    return lips, toks.astype(np.int64)


def _feed_av(stream, lips1, lips2, audio, block, spf):
    got = ["", ""]
    for i in range(0, lips1.shape[0], block):
        j = min(i + block, lips1.shape[0])
        for s, t in enumerate(stream.feed(lips1[i:j], lips2[i:j], audio[i * spf:j * spf])):
            got[s] += t
    for s, t in enumerate(stream.flush()):
        got[s] += t
    return got


@pytest.mark.parametrize("block_frames", [1, 3, 5, 11, 100])
def test_av_greedy_stream_matches_jax_and_offline(block_frames):
    rng = np.random.default_rng(block_frames)
    cfg = audio_config()
    n, spf = 37, cfg.data.audio_samples_per_video_frame
    (lips1, toks1), (lips2, toks2) = frame_signal(rng, n), frame_signal(rng, n)
    audio = rng.standard_normal(n * spf).astype(np.float32) * 0.1
    kw = dict(chunk_frames=5, context_frames=10, lip_size=LIP, algorithm="greedy")
    got = _feed_av(StreamingAVTranscriber(port_config(cfg), IdTokenizer(), device="cpu",
                                          forward_fn=av_forward, **kw),
                   lips1, lips2, audio, block_frames, spf)
    want = _feed_av(JAVStream(cfg, IdTokenizer(), {}, forward_fn=j_av_forward, **kw),
                    lips1, lips2, audio, block_frames, spf)
    assert got == want == [IdTokenizer().decode(offline_collapse(t)) for t in (toks1, toks2)]


def test_av_prefix_beam_stream_matches_jax_and_offline():
    """Soft per-frame distributions, so the beam really sums alignments: the
    streamed ids of each speaker equal one offline prefix beam."""
    rng = np.random.default_rng(7)
    n = 24
    tables = [np.asarray(jax.nn.log_softmax(rng.standard_normal((n, V)) * 2.0, -1), np.float32)
              for _ in range(2)]

    def j_soft(variables, lip1, lip2, *rest):
        def lp(lips, table):
            idx = jnp.clip((lips[:, :, 0, 0, 0] * 1000).astype(jnp.int32) - 1, 0, n - 1)
            return jnp.asarray(table)[idx]
        return lp(lip1, tables[0]), lp(lip2, tables[1])

    def soft(lip1, lip2, *rest):
        def lp(lips, table):
            idx = torch.clamp((lips[:, :, 0, 0, 0] * 1000).to(torch.int32) - 1, 0, n - 1)
            return torch.from_numpy(table)[idx.long()]
        return lp(lip1, tables[0]), lp(lip2, tables[1])

    cfg = audio_config()
    cfg.decode.prefix_top_k = V
    lips = np.zeros((2, n, 1, LIP, LIP), np.float32)
    lips[:, :, 0, 0, 0] = (np.arange(n, dtype=np.float32) + 1) / 1000.0
    spf = cfg.data.audio_samples_per_video_frame
    audio = np.zeros(n * spf, np.float32)
    kw = dict(chunk_frames=5, context_frames=10, lip_size=LIP, algorithm="prefix_beam")
    got = _feed_av(StreamingAVTranscriber(port_config(cfg), IdTokenizer(), device="cpu",
                                          forward_fn=soft, **kw), lips[0], lips[1], audio, 5,
                   spf)
    want = _feed_av(JAVStream(cfg, IdTokenizer(), {}, forward_fn=j_soft, **kw),
                    lips[0], lips[1], audio, 5, spf)
    offline = []
    for table in tables:
        ids, lens, _ = j_prefix(jnp.asarray(table)[None], jnp.asarray([n]), 5, V, BLANK)
        offline.append(IdTokenizer().decode(np.asarray(ids)[0, :int(lens[0])].tolist()))
    assert got == want == offline


@pytest.mark.parametrize("algorithm", ["greedy", "prefix_beam"])
def test_av_stream_real_model_matches_jax(algorithm):
    """The tiny flagship (BiLSTM fusion, GroupNorm) streamed in both packages
    on the same weights and media: equal texts; ``flush`` resets."""
    jtok, tok = JTokenizer(VOCAB), CharTokenizer(VOCAB)
    cfg = model_tiny_config()
    cfg.model.decoder.vocab_size = jtok.vocab_size
    F_, H, spf = 8, 24, cfg.data.audio_samples_per_video_frame
    z = jnp.zeros((1, F_, 1, H, H))
    m = jnp.full((1, F_ * spf), 2, jnp.int32)
    n_f = jnp.full((1,), F_, jnp.int32)
    v = jax.tree.map(np.asarray, jax.jit(JModel(cfg.model).init)(
        jax.random.PRNGKey(0), z, z, jnp.zeros((1, F_ * spf)), m, m, n_f, n_f))
    model = MultiSpeakerAVModel(port_config(cfg).model)
    model.load_state_dict(from_jax_variables(v), strict=True)
    rng = np.random.default_rng(0)
    n = 14
    lips = rng.uniform(size=(2, n, 1, H, H)).astype(np.float32)
    audio = rng.standard_normal(n * spf).astype(np.float32) * 0.3
    kw = dict(chunk_frames=4, context_frames=4, lip_size=H, algorithm=algorithm)
    s = StreamingAVTranscriber(port_config(cfg), tok, model, device="cpu", **kw)
    got = _feed_av(s, lips[0], lips[1], audio, 3, spf)
    want = _feed_av(JAVStream(cfg, jtok, v, dtype=jnp.float32, **kw), lips[0], lips[1], audio,
                    3, spf)
    assert got == want and s.text(0) == s.text(1) == ""

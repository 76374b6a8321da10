"""PyTorch port, decoders: the reference path beam, the streaming prefix-beam
step and the bigram LM, each held against the JAX package on the same inputs
(CPU, seeded numpy log-probs).  Ids and lengths exact; scores to 1e-4 (f32
exp/log in two libraries)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_av_model_tpu.config import DecodeConfig as JDecodeConfig
from multimodal_av_model_tpu.ops.beam_search import beam_search_decode as j_ref_beam
from multimodal_av_model_tpu.ops.prefix_beam_search import (
    prefix_beam_search_decode as j_prefix,
    prefix_beam_state_init as j_init,
    prefix_beam_stream_step as j_step,
)
from multimodal_av_model_tpu.streaming import _PrefixBeamStream as JStream
from multimodal_av_model_tpu.text import ngram_lm as j_lm
from multimodal_av_model_tpu_torch.config import Config, DecodeConfig
from multimodal_av_model_tpu_torch.infer import decode_ids
from multimodal_av_model_tpu_torch.ops.beam_search import beam_search_decode
from multimodal_av_model_tpu_torch.ops import prefix_beam_search as pbs
from multimodal_av_model_tpu_torch.ops.prefix_beam_search import (
    prefix_beam_search_decode,
    prefix_beam_state_init,
    prefix_beam_stream_step,
)
from multimodal_av_model_tpu_torch.streaming import _PrefixBeamStream
from multimodal_av_model_tpu_torch.text import ngram_lm


def _log_probs(B, T, V, seed, scale=3.0):
    """Seeded, tie-free log-softmaxed scores, blank-heavy like CTC output;
    row 0 is full length, the others random."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)) * scale
    logits[..., 3] += 2.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lens = rng.integers(1, T + 1, size=B).astype(np.int32)
    lens[0] = T
    return lp.astype(np.float32), lens


@pytest.mark.parametrize("beam_width", [1, 3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_beam_matches_jax(beam_width, seed):
    lp, lens = _log_probs(4, 24, 10, seed)
    ids, n, score = beam_search_decode(torch.from_numpy(lp), torch.from_numpy(lens), beam_width,
                                       3)
    j_ids, j_n, j_score = j_ref_beam(jnp.asarray(lp), jnp.asarray(lens), beam_width, 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(j_n))
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), rtol=1e-4, atol=1e-4)


def test_reference_beam_merges_paths_as_a_dict():
    """Few tokens and a wide beam: many candidates are the same path, so the
    merge (first slot, group max) and the stable ranking decide the ids."""
    lp, lens = _log_probs(3, 16, 4, seed=5, scale=1.0)
    ids, n, _ = beam_search_decode(torch.from_numpy(lp), torch.from_numpy(lens), 4, 3)
    j_ids, j_n, _ = j_ref_beam(jnp.asarray(lp), jnp.asarray(lens), 4, 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(j_n))


def test_decode_ids_serves_every_algorithm():
    lp, lens = _log_probs(3, 20, 12, seed=2)
    cfg = Config()
    args = (torch.from_numpy(lp), torch.from_numpy(lens))
    for algorithm, want in (("reference_beam", j_ref_beam(jnp.asarray(lp), jnp.asarray(lens),
                                                          5, 3)),
                            ("prefix_beam", j_prefix(jnp.asarray(lp), jnp.asarray(lens), 5, 8,
                                                     3))):
        cfg.decode.algorithm = algorithm
        ids, n = decode_ids(cfg, *args)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(n.numpy(), np.asarray(want[1]))
    cfg.decode.algorithm = "no_such"
    with pytest.raises(ValueError, match="unknown decode algorithm"):
        decode_ids(cfg, *args)


@pytest.mark.parametrize("chunks", [(8, 8, 8), (5, 11, 8), (1,) * 24, (24,)])
def test_stream_step_matches_offline_in_both_packages(chunks):
    """Feeding chunks through the stream step equals one offline pass, in the
    port and in JAX, and the two packages' states agree after every chunk."""
    T, V, W, K = 24, 8, 4, 6
    lp, _ = _log_probs(1, T, V, seed=0, scale=2.0)
    lp = lp[0]
    want, want_n, _ = j_prefix(jnp.asarray(lp)[None], jnp.asarray([T]), W, K, 3)
    mine, mine_n, _ = prefix_beam_search_decode(torch.from_numpy(lp)[None],
                                                torch.tensor([T]), W, K, 3)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(want))
    state, j_state, pos = prefix_beam_state_init(W, T), j_init(W, T), 0
    for c in chunks:
        state = prefix_beam_stream_step(state, torch.from_numpy(lp[pos:pos + c]), c, top_k=K,
                                        blank_id=3)
        j_state = j_step(j_state, jnp.asarray(lp[pos:pos + c]), c, top_k=K, blank_id=3)
        pos += c
        for a, b in zip(state[:2], j_state[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(state[2:], j_state[2:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    n = int(state[1][0])
    assert n == int(want_n[0])
    np.testing.assert_array_equal(state[0][0, :n].numpy(), np.asarray(want)[0, :n])


def test_stream_step_frames_past_length_are_identity():
    lp, _ = _log_probs(1, 10, 8, seed=1, scale=2.0)
    lp = torch.from_numpy(lp[0])
    state = prefix_beam_state_init(4, 32)
    full = prefix_beam_stream_step(state, lp[:6], 6, top_k=6, blank_id=3)
    padded = prefix_beam_stream_step(state, lp, 6, top_k=6, blank_id=3)
    for a, b in zip(full, padded):
        assert torch.equal(a, b)


def test_stream_step_with_an_lm_matches_jax():
    T, V = 16, 12
    lp, _ = _log_probs(1, T, V, seed=3, scale=2.0)
    rng = np.random.default_rng(4)
    table = ngram_lm.train_bigram_lm([rng.integers(0, V, 12) for _ in range(30)], V)
    state, j_state = prefix_beam_state_init(5, 40), j_init(5, 40)
    for lo in (0, 7):
        part = lp[0, lo:lo + 9]
        state = prefix_beam_stream_step(state, torch.from_numpy(part), len(part), 8, 3,
                                        torch.from_numpy(table), 0.5, 0.3)
        j_state = j_step(j_state, jnp.asarray(part), len(part), 8, 3, jnp.asarray(table), 0.5,
                         0.3)
    for a, b in zip(state[:2], j_state[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _advance_both(n_frames, capacity, pieces, lp):
    """The port's and JAX's ``_PrefixBeamStream`` over the same advances."""
    ours = _PrefixBeamStream(DecodeConfig(beam_width=4, prefix_top_k=6), 3, n_frames, capacity)
    theirs = JStream(JDecodeConfig(beam_width=4, prefix_top_k=6), 3, n_frames, capacity)
    got, want = [], []
    for start, end in pieces:
        got.append(ours.advance(torch.from_numpy(lp), start, end))
        want.append(theirs.advance(jnp.asarray(lp), start, end))
        assert ours.committed == theirs.committed
        np.testing.assert_array_equal(ours.state[0].numpy(), np.asarray(theirs.state[0]))
    return got + [ours.tail()], want + [theirs.tail()]


def test_prefix_beam_stream_clamps_its_slice_as_jax():
    """A window whose new frames would run past the log-probs: JAX's
    ``dynamic_slice_in_dim`` moves the start back so the slice fits, and so
    does the port (a torch slice would come out short instead)."""
    lp, _ = _log_probs(1, 10, 8, seed=6, scale=2.0)
    got, want = _advance_both(5, 64, [(6, 10), (7, 9), (0, 5)], lp[0])
    assert got == want
    with pytest.raises(ValueError, match="fewer than"):
        _PrefixBeamStream(DecodeConfig(), 3, 12, 64).advance(torch.from_numpy(lp[0]), 0, 10)


def _runs(seed, n_frames, V=16):
    """Log-probs of a frame-local oracle: runs of 1-5 frames of one token,
    each frame a one-hot of weight 10 (as ``tests/test_streaming.py``)."""
    rng, vals = np.random.default_rng(seed), []
    while sum(len(v) for v in vals) < n_frames:
        vals.append([rng.integers(0, V)] * int(rng.integers(1, 6)))
    logits = np.eye(V)[np.concatenate(vals)[:n_frames]] * 10.0
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("seed,stalls", [(1, False), (0, True)])
def test_prefix_beam_stream_shifts_committed_tokens_out(seed, stalls):
    """120 frames in advances of 10 into a buffer of 24 tokens: the
    committed tokens shift out (``lens.max() > C - 2 * n_frames``), the two
    packages alike after every advance.  With seed 1 the text equals that of
    a buffer that never fills.  With seed 0 a beam that differs early stays
    among the live ones, nothing more commits, the buffer fills and later
    tokens are lost, in JAX as in the port (ROADMAP Queue 3)."""
    lp = _runs(seed, 120)
    ours = _PrefixBeamStream(DecodeConfig(), 3, 10, 24)
    big = _PrefixBeamStream(DecodeConfig(), 3, 10, 512)
    theirs = JStream(JDecodeConfig(), 3, 10, 24)
    got, ref, want = [], [], []
    for lo in range(0, 120, 10):
        w = lp[lo:lo + 10]
        got += ours.advance(torch.from_numpy(w), 0, 10)
        ref += big.advance(torch.from_numpy(w), 0, 10)
        want += theirs.advance(jnp.asarray(w), 0, 10)
        assert ours.committed == theirs.committed
        np.testing.assert_array_equal(ours.state[0].numpy(), np.asarray(theirs.state[0]))
    assert ours.committed < len(got)                        # tokens were shifted out
    assert big.committed == len(ref)                        # and never in the big buffer
    got, ref, want = got + ours.tail(), ref + big.tail(), want + theirs.tail()
    assert got == want and len(ref) > 30
    assert (got != ref) == stalls


def test_bigram_lm_is_a_copy_of_jax(tmp_path):
    rng = np.random.default_rng(0)
    seqs = [rng.integers(-1, 21, int(rng.integers(0, 15))) for _ in range(40)]
    lm = ngram_lm.train_bigram_lm(seqs, 20, add_k=0.3)
    want = j_lm.train_bigram_lm(seqs, 20, add_k=0.3)
    np.testing.assert_array_equal(lm, want)
    np.testing.assert_allclose(np.exp(lm).sum(1), 1.0, rtol=1e-5)
    assert ngram_lm.mean_token_logprob(lm, seqs) == j_lm.mean_token_logprob(want, seqs)
    assert ngram_lm.sequence_logprob(lm, [1, 2, 3]) == j_lm.sequence_logprob(want, [1, 2, 3])
    path = str(tmp_path / "lm.npy")
    ngram_lm.save_bigram_lm(path, lm)
    np.testing.assert_array_equal(ngram_lm.load_bigram_lm(path), j_lm.load_bigram_lm(path))
    np.save(path, lm[:5])
    with pytest.raises(ValueError, match="not a bigram LM table"):
        ngram_lm.load_bigram_lm(path)


# --- mmav::prefix_beam: the operator every decode goes through ----------------------------


def _op_args(kind, seed=3):
    """Operator arguments: a fresh decode, a carried state of capacity 9, or a
    fresh decode with a bigram LM; small CPU shapes."""
    lp, lens = _log_probs(3, 12, 10, seed, scale=2.0)
    lm = None
    state = (None,) * 4
    if kind == "state":
        state = tuple(x[None].repeat(3, *([1] * x.ndim)) for x in prefix_beam_state_init(4, 9))
    if kind == "lm":
        lm = torch.from_numpy(np.log(np.random.default_rng(seed).dirichlet(
            np.ones(10), 11)).astype(np.float32))
    return (torch.from_numpy(lp), torch.from_numpy(lens), *state, lm, 4, 6, 3, -1, 0.3, 0.5)


@pytest.mark.parametrize("kind", ["fresh", "state", "lm"])
def test_prefix_beam_operator_passes_opcheck(kind):
    """Schema (no aliasing, no mutation), fake tensors against the CPU kernel,
    and AOT dispatch with dynamic shapes."""
    torch.library.opcheck(pbs.prefix_beam_op, _op_args(kind))


@pytest.mark.parametrize("kind", ["fresh", "state", "lm"])
def test_prefix_beam_fake_gives_the_outputs_shapes_and_dtypes(kind):
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _op_args(kind)
    real = pbs.prefix_beam_op(*args)
    with FakeTensorMode() as mode:
        fake = pbs.prefix_beam_op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                                    for a in args))
    B, T = args[0].shape[:2]
    W, C = (4, T) if kind != "state" else (4, 9)
    want = [((B, W, C), torch.int32), ((B, W), torch.int64), ((B, W), torch.float32),
            ((B, W), torch.float32), ((B, C), torch.int32), ((B,), torch.int32),
            ((B,), torch.float32)]
    for r, f, (shape, dtype) in zip(real, fake, want):
        assert tuple(r.shape) == tuple(f.shape) == shape
        assert r.dtype == f.dtype == dtype


def test_prefix_beam_operator_equals_the_plain_loop_on_the_cpu():
    """On a CPU tensor the operator is the plain loop: the offline decode
    against JAX's, and the state it returns against the stream step's."""
    before = pbs.prefix_beam.launches
    lp, lens = _log_probs(4, 20, 12, seed=7)
    state, ids, n, score = pbs.prefix_beam(torch.from_numpy(lp), torch.from_numpy(lens))
    j_ids, j_n, j_score = j_prefix(jnp.asarray(lp), jnp.asarray(lens), 5, 8, 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(j_n))
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), rtol=1e-5, atol=1e-4)
    assert state[0].shape == (4, 5, 20) and torch.equal(state[0][:, 0], ids)
    one = prefix_beam_stream_step(prefix_beam_state_init(5, 20), torch.from_numpy(lp[1]),
                                  int(lens[1]))
    for a, b in zip(one, state):
        assert torch.equal(a, b[1])
    assert pbs.prefix_beam.launches == before              # the CPU never launches


def test_prefix_beam_state_init_is_one_live_empty_prefix():
    prefixes, lens, pb, pnb = prefix_beam_state_init(3, 4)
    assert torch.equal(prefixes, torch.full((3, 4), -1, dtype=torch.int32))
    assert torch.equal(lens, torch.zeros(3, dtype=torch.int64))
    assert torch.equal(pb, torch.tensor([0.0, pbs._NEG_INF, pbs._NEG_INF]))
    assert torch.equal(pnb, torch.full((3,), pbs._NEG_INF))


@pytest.mark.parametrize("with_lm", [False, True])
def test_export_holds_the_decode_as_one_operator_node(with_lm):
    """A module that decodes exports as one ``mmav::prefix_beam`` node, not an
    unrolled frame loop, and the exported program decodes as the module."""

    class Decode(torch.nn.Module):
        def forward(self, lp, lens, lm):
            ids, n, score = prefix_beam_search_decode(lp, lens, 4, 6, 3, lm=lm,
                                                      lm_weight=0.3 if with_lm else 0.0)
            return ids, n, score

    lp, lens = _log_probs(3, 16, 10, seed=8)
    lm = (torch.from_numpy(np.log(np.random.default_rng(1).dirichlet(np.ones(10), 11))
                           .astype(np.float32)) if with_lm else None)
    args = (torch.from_numpy(lp), torch.from_numpy(lens), lm)
    program = torch.export.export(Decode(), args)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("mmav.prefix_beam.default") == 1
    assert len(targets) < 20
    for got, want in zip(program.module()(*args), Decode()(*args)):
        assert torch.equal(got, want)

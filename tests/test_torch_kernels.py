"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where there is no CUDA device (the decision is made
in the fixture, at run time).  On a machine with the card:

    python -m pytest tests/test_torch_kernels.py -m gpu -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_av_model_tpu_torch.ops.logmel import (
    log_mel_spectrogram,
    log_mel_spectrogram_cuda,
    logmel_plan,
)
from multimodal_av_model_tpu_torch.ops import prefix_beam_search as pbs
from multimodal_av_model_tpu_torch.ops.resize import (
    lip_band_plan,
    lip_frames_preprocess,
    lip_preprocess_cuda,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain version in full f32
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(4, 68352), (3, 12345), (1, 4000), (16000,)])
def test_logmel_kernel_matches_plain(cuda, shape):
    """Bar of tests/test_pallas_logmel.py: rtol = atol = 2e-3."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32)).to(cuda)
    before = log_mel_spectrogram_cuda.launches
    got = log_mel_spectrogram_cuda(x)
    torch.cuda.synchronize()
    assert log_mel_spectrogram_cuda.launches == before + 1
    ref = log_mel_spectrogram(x)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3)
    raw = log_mel_spectrogram_cuda(x, apply_log=False)
    torch.testing.assert_close(raw, log_mel_spectrogram(x, apply_log=False),
                               rtol=2e-3, atol=1e-2)


@pytest.mark.parametrize("shape,center", [((1, 201), True), ((1, 400), False),
                                          ((2, 400 + 160 * 20), False)])
def test_logmel_kernel_edge_lengths(cuda, shape, center):
    """The shortest centred input (S = 201, T = 2), one frame without centring
    (S = 400, T = 1) and a partial last m-tile, with and without the log."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32)).to(cuda)
    for apply_log, atol in ((True, 2e-3), (False, 1e-2)):
        got = log_mel_spectrogram_cuda(x, center=center, apply_log=apply_log)
        ref = log_mel_spectrogram(x, center=center, apply_log=apply_log)
        torch.cuda.synchronize()
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, rtol=2e-3, atol=atol)


def test_logmel_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 4000, device=cuda)
    with pytest.raises(TypeError):
        log_mel_spectrogram_cuda(x.double())
    with pytest.raises(ValueError):
        log_mel_spectrogram_cuda(x, win_length=320)
    with pytest.raises(ValueError):
        log_mel_spectrogram_cuda(torch.zeros(4000, 2, device=cuda).t())


@pytest.mark.parametrize("shape", [(4, 153600), (16, 153600)])
def test_logmel_kernel_at_26_bins(cuda, shape):
    """AV-HuBERT's filterbank: 26 bins, no centring, mel supports of 48 bins
    (the kernel's 3-chunk instance), at the 80-bin tests' bars.  K1 runs once
    a mixture: ``[16, 153600]`` is 16 mixtures of 240 video frames at 25 fps."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32)).to(cuda)
    kw = dict(n_mels=26, center=False)
    assert logmel_plan(*shape, n_mels=26, center=False)["mel_width"] == 48
    before = log_mel_spectrogram_cuda.launches
    got = log_mel_spectrogram_cuda(x, **kw)
    torch.cuda.synchronize()
    assert log_mel_spectrogram_cuda.launches == before + 1
    ref = log_mel_spectrogram(x, **kw)
    assert got.shape == ref.shape == (shape[0], 1 + (shape[1] - 400) // 160, 26)
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(log_mel_spectrogram_cuda(x, apply_log=False, **kw),
                               log_mel_spectrogram(x, apply_log=False, **kw),
                               rtol=2e-3, atol=1e-2)


def test_avhubert_forward_on_the_card_matches_reference(cuda):
    """AV-HuBERT at a mid width (4 layers of 256, the 4-stage trunk at a
    quarter of its channels, conv_pos 16 in 4 groups) in float32 on the card,
    with K1 and K2 on its path, against ``avbench/reference/avhubert.py``
    with TF32 off, on 88x88 lips.  Bar 5e-3 on the log-probabilities: K1's
    features meet the plain filterbank to its 2e-3 bar, and the difference
    passes through the normalisation and 4 layers."""
    from avbench import traffic, weights
    from avbench.reference import preprocess as ref_pre
    from avbench.reference.avhubert import AVHubertNet
    from multimodal_av_model_tpu_torch.config import Config, to_dict
    from multimodal_av_model_tpu_torch.data.device_pipeline import device_preprocessed_batches
    from multimodal_av_model_tpu_torch.models import build_av_model

    torch.backends.cudnn.allow_tf32 = False
    cfg = Config()
    m = cfg.model
    m.arch, m.dtype = "avhubert", "float32"
    m.frontend.n_mels, m.frontend.center = 26, False
    a = m.avhubert
    a.embed_dim, a.num_layers, a.num_heads, a.ffn_dim, a.conv_pos, a.conv_pos_groups = \
        256, 4, 4, 1024, 16, 4
    a.dropout = a.attention_dropout = a.activation_dropout = 0.0
    m.visual.frontend_channels, m.visual.resnet_channels = 16, (16, 32, 64, 128)
    m.visual.output_dim = 256
    model = build_av_model(m)
    P = weights.seeded_state_dict(dict(model.state_dict()), 3, "cuda")
    model = model.to(cuda).eval()
    model.load_state_dict(P)
    mix = {"batch": 2, "bucket": 64, "frames": [40, 64], "audio2_fraction": [0.6, 1.0],
           "crop": 128, "lip_size": 88, "audio_samples_per_frame": 640, "label_len": 5,
           "label_bucket": 8, "first_token": 4, "vocab": 800, "pool": 1}
    raw = traffic.raw_batches(mix, 2**31 + 17)[0]
    (batch,) = device_preprocessed_batches([raw], out_size=88, device="cuda")
    keys = ("lip1", "lip2", "audio", "mask1", "mask2", "lip1_lengths", "lip2_lengths")
    with torch.no_grad():
        out = model(*[torch.as_tensor(batch[k]).to(cuda) for k in keys])
        d = to_dict(cfg)["model"]
        inp = ref_pre.model_inputs(raw, cuda, 88)
        ref = AVHubertNet(P, d).forward(inp, ref_pre.log_mel(inp["audio"], d["frontend"]))
    worst = 0.0
    for s, rows in (("1", slice(0, 2)), ("2", slice(2, 4))):
        for r in range(2):
            n = int(out["input_lengths" + s][r])
            worst = max(worst, float((out["log_probs" + s][r, :n]
                                      - ref["log_probs"][rows][r, :n]).abs().max()))
    print(f"AV-HuBERT mid width on the card vs reference: max |d log-prob| {worst:.3g}")
    assert worst <= 5e-3


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape,out", [((512, 128, 128, 3), 96), ((7, 50, 70, 1), 96),
                                       ((5, 128, 128, 3), 40), ((3, 37, 53, 3), 96),
                                       ((3, 37, 53, 4), 96)])
def test_lip_kernel_matches_plain(cuda, dtype, shape, out):
    """Bar of tests/test_lip_kernel.py: rtol 1e-4, atol 1e-3.  C = 1 and 3 take
    the kernel's fixed channel counts, C = 4 its run-time one."""
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.integers(0, 256, size=shape).astype(np.uint8))
    frames = frames.to(device=cuda, dtype=dtype)
    before = lip_preprocess_cuda.launches
    got = lip_preprocess_cuda(frames, out)
    torch.cuda.synchronize()
    assert lip_preprocess_cuda.launches == before + 1
    torch.testing.assert_close(got, lip_frames_preprocess(frames, out), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape,out", [((7, 50, 70, 1), 96), ((3, 37, 53, 3), 96),
                                       ((3, 37, 53, 4), 96)])
def test_lip_kernel_unaligned_base(cuda, dtype, shape, out):
    """A view that starts one frame into a larger buffer (a narrow along N, still
    contiguous): frames of 3,500, 5,883 and 7,844 bytes, so no 16-byte alignment.
    C = 4 takes the kernel's run-time channel count."""
    rng = np.random.default_rng(4)
    big = torch.from_numpy(rng.integers(0, 256, size=(shape[0] + 1,) + shape[1:]).astype(np.uint8))
    frames = big.to(device=cuda, dtype=dtype).narrow(0, 1, shape[0])
    assert frames.is_contiguous() and frames.storage_offset() > 0
    got = lip_preprocess_cuda(frames, out)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, lip_frames_preprocess(frames, out), rtol=1e-4, atol=1e-3)


def test_launches_above_48kb_of_shared_memory(cuda):
    """Both kernels opt in to more than 48 KB of dynamic shared memory: K1 at
    every shape, K2 for float32 crops at the serving shape."""
    assert logmel_plan(4, 68352)["smem_bytes"] > 48 * 1024
    assert lip_band_plan(128, 128, 3, 96, 96, 4)["smem_bytes"] > 48 * 1024
    rng = np.random.default_rng(6)
    x = torch.from_numpy((0.3 * rng.standard_normal((4, 68352))).astype(np.float32)).to(cuda)
    torch.testing.assert_close(log_mel_spectrogram_cuda(x), log_mel_spectrogram(x),
                               rtol=2e-3, atol=2e-3)
    frames = torch.from_numpy(rng.integers(0, 256, size=(16, 128, 128, 3)).astype(np.float32))
    frames = frames.to(cuda)
    torch.testing.assert_close(lip_preprocess_cuda(frames), lip_frames_preprocess(frames),
                               rtol=1e-4, atol=1e-3)


def test_lip_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        lip_preprocess_cuda(torch.zeros(2, 8, 8, 3, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        lip_preprocess_cuda(torch.zeros(2, 8, 8, 3, device=cuda).permute(0, 2, 1, 3))


# --- K3: the prefix-beam kernel against the plain loop on the same CUDA inputs ----------

_OUTS = ("prefixes", "lens", "pb", "pnb", "ids", "out_len", "score")


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _assert_same_decode(got, want):
    """Prefixes, lengths and ids exactly; the log-masses within 1e-5, relative
    above magnitude 1 (a float32 ulp at 256 is 3e-5: the two sides run the same
    arithmetic, so more than a few ulp apart is a fault)."""
    for name, g, w in zip(_OUTS, got, want):
        if name in ("pb", "pnb", "score"):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name


def _both(cuda, lp, lens, state=None, W=5, K=8, blank=3, pad=-1, lm=None, lw=0.0, lb=0.0,
          dtype=torch.float32):
    lp = torch.from_numpy(lp).to(cuda, dtype)
    lens = torch.as_tensor(lens).to(cuda)
    st = (None,) * 4 if state is None else tuple(x.to(cuda) for x in state)
    lm = None if lm is None else torch.from_numpy(lm).to(cuda)
    args = (lp, lens, *st, lm, W, K, blank, pad, lw, lb)
    got = pbs.prefix_beam_op(*args)
    want = pbs._prefix_beam_plain(*args)
    torch.cuda.synchronize()
    return got, want


def _fresh_state(B, W, C):
    return tuple(x[None].repeat(B, *([1] * x.ndim)) for x in pbs.prefix_beam_state_init(W, C))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_beam_kernel_at_the_cells_shape(cuda, dtype):
    """[8, 128, 800], lengths U[64, 128], beam 5, top-k 8: a request's two
    speakers as one batch, read in f32 (the cells) and in bf16."""
    rng = np.random.default_rng(10)
    lp = _log_softmax(3.0 * rng.standard_normal((8, 128, 800)))
    lens = rng.integers(64, 129, 8)
    got, want = _both(cuda, lp, lens, dtype=dtype)
    _assert_same_decode(got, want)
    assert (got[5].cpu().numpy() > 0).all()


@pytest.mark.parametrize("case", ["lengths_0_and_T", "one_beam", "k_at_least_v", "ties",
                                  "lm", "pad_id"])
def test_prefix_beam_kernel_edge_cases(cuda, case):
    rng = np.random.default_rng(11)
    B, T, V = 4, 40, 30
    lp = _log_softmax(2.0 * rng.standard_normal((B, T, V)))
    lens = np.array([0, T, 17, 1])
    kw = {}
    if case == "one_beam":
        kw = dict(W=1)
    elif case == "k_at_least_v":
        lp = _log_softmax(2.0 * rng.standard_normal((B, T, 6)))
        kw = dict(K=9)
    elif case == "ties":                    # a few distinct values: ties everywhere
        lp = np.log(np.array([0.05, 0.15, 0.3, 0.5], np.float32))[rng.integers(0, 4, (B, T, V))]
        lp = lp.astype(np.float32)
    elif case == "lm":
        lm = np.log(rng.dirichlet(np.ones(V), V + 1)).astype(np.float32)
        kw = dict(lm=lm, lw=0.4, lb=0.7)
    elif case == "pad_id":
        kw = dict(pad=0, blank=0)
    got, want = _both(cuda, lp, lens, **kw)
    _assert_same_decode(got, want)
    assert got[5][0].item() == 0 and got[1].shape == (B, kw.get("W", 5))


def test_prefix_beam_kernel_fills_the_capacity(cuda):
    """A stream state of 6 tokens fed 60 frames that keep emitting: rows fill
    their buffer and stay full."""
    rng = np.random.default_rng(12)
    lp = _log_softmax(6.0 * rng.standard_normal((3, 60, 20)))
    got, want = _both(cuda, lp, np.array([60, 45, 5]), state=_fresh_state(3, 5, 6))
    _assert_same_decode(got, want)
    assert got[1][:2].max().item() == 6


def test_prefix_beam_kernel_long_stream(cuda):
    """C = 512 with T = 1,600: the top-K tiles, the copies of long rows and a
    full buffer."""
    rng = np.random.default_rng(13)
    lp = _log_softmax(5.0 * rng.standard_normal((2, 1600, 64)))
    got, want = _both(cuda, lp, np.array([1600, 1333]), state=_fresh_state(2, 5, 512))
    _assert_same_decode(got, want)
    assert got[1].max().item() == 512


def test_prefix_beam_kernel_prefixes_in_device_memory(cuda):
    """8 beams of 4,000 tokens (256 KB of prefix buffers) do not fit in shared
    memory: the rows live in device memory, the same code reads them there."""
    assert not pbs.prefix_beam_plan(300, 8, 8, 4000)["rows_in_smem"]
    rng = np.random.default_rng(16)
    lp = _log_softmax(4.0 * rng.standard_normal((2, 300, 50)))
    got, want = _both(cuda, lp, np.array([300, 211]), state=_fresh_state(2, 8, 4000), W=8)
    _assert_same_decode(got, want)


def test_prefix_beam_kernel_stream_in_chunks_equals_one_pass(cuda):
    """Chunks through prefix_beam_stream_step on the card give the offline
    decode's state, and the plain loop's."""
    rng = np.random.default_rng(14)
    T = 70
    lp = torch.from_numpy(_log_softmax(2.5 * rng.standard_normal((T, 40)))).to(cuda)
    state = pbs.prefix_beam_state_init(5, T, cuda)
    plain = tuple(x.clone() for x in state)
    pos = 0
    for c in (9, 1, 30, 17, 13):
        state = pbs.prefix_beam_stream_step(state, lp[pos:pos + c], c)
        plain = pbs._prefix_beam_plain(lp[None, pos:pos + c], torch.tensor([c], device=cuda),
                                       *(x[None] for x in plain), None, 5, 8, 3, -1, 0.0,
                                       0.0)[:4]
        plain = tuple(x[0] for x in plain)
        pos += c
    whole, ids, out_len, _ = pbs.prefix_beam(lp[None], torch.tensor([T], device=cuda))
    torch.cuda.synchronize()
    for a, b, p in zip(state, whole, plain):
        assert torch.equal(a, b[0]) if a.dtype != torch.float32 else torch.allclose(a, b[0])
        assert torch.equal(a, p) if a.dtype != torch.float32 else torch.allclose(a, p)
    assert torch.equal(ids[0, :out_len[0]], state[0][0, :state[1][0]])


# Two 12-token prefixes, tokens below 32 and none the blank, whose 64-bit
# prefix hashes are equal under the kernel's multiply-add (h = h * kHashMul +
# token + 1, mod 2**64).  The hash is linear in the tokens, so the pair was
# found by lattice reduction over the differences of the tokens.
_COLLIDING = ([4, 4, 6, 8, 14, 10, 4, 4, 4, 4, 19, 4],
              [5, 12, 4, 4, 4, 4, 18, 6, 22, 17, 4, 21])


def _kernel_hash(tokens):
    src = (Path(pbs.__file__).parent.parent / "csrc" / "prefix_beam.cu").read_text()
    mul = int(re.search(r"kHashMul = (0x[0-9A-Fa-f]+)ull", src).group(1), 16)
    h = 0
    for t in tokens:
        h = (h * mul + t + 1) % 2**64
    return h


def test_prefix_beam_colliding_pair_collides_under_the_kernels_hash():
    """Runs anywhere (no card needed): the pair below is what the collision
    test on the card says it is."""
    a, b = _COLLIDING
    assert len(a) == len(b) and a != b and min(a + b) > 3 and max(a + b) < 32
    assert _kernel_hash(a) == _kernel_hash(b)


def test_prefix_beam_kernel_hash_collision(cuda):
    """Beams 0 and 1 of a carried state are the colliding pair (in both
    orders) and hold most of the mass, so through every frame the two
    lineages keep beams with the same suffix: candidates that match by length
    and hash but not by their rows.  The kernel's fallback search must keep
    them apart, as the plain loop does."""
    rng = np.random.default_rng(17)
    B, W, C, T, V = 2, 5, 40, 10, 32
    a, b = _COLLIDING
    prefixes = np.full((B, W, C), -1, np.int32)
    lens = np.zeros((B, W), np.int64)
    for r, (first, second) in enumerate(((a, b), (b, a))):
        for w, row in enumerate((first, second, [7, 9, 11], [20, 21])):
            prefixes[r, w, :len(row)] = row
            lens[r, w] = len(row)
    pb = np.tile(np.array([-1.0, -1.05, -4.0, -4.5, -6.0], np.float32), (B, 1))
    pnb = np.tile(np.array([-1.1, -1.0, -4.2, -5.0, -6.5], np.float32), (B, 1))
    state = tuple(torch.from_numpy(x) for x in (prefixes, lens, pb, pnb))
    lp = _log_softmax(rng.standard_normal((B, T, V)))
    got, want = _both(cuda, lp, np.array([T, 6]), state=state)
    _assert_same_decode(got, want)
    for r in range(B):                      # the collision is still live at the end
        rows = [tuple(x[:n]) for x, n in zip(got[0][r].tolist(), got[1][r].tolist())]
        tails_a = {x[12:] for x in rows if x[:12] == tuple(a)}
        tails_b = {x[12:] for x in rows if x[:12] == tuple(b)}
        assert tails_a & tails_b


def test_prefix_beam_kernel_is_one_launch_a_decode(cuda):
    rng = np.random.default_rng(15)
    lp = torch.from_numpy(_log_softmax(rng.standard_normal((8, 128, 800)))).to(cuda)
    lens = torch.full((8,), 128, device=cuda)
    for _ in range(2):
        before = pbs.prefix_beam.launches
        pbs.prefix_beam_search_decode(lp, lens)
        assert pbs.prefix_beam.launches == before + 1


def test_prefix_beam_kernel_rejects_what_it_does_not_take(cuda):
    lp = torch.zeros(2, 5, 10, device=cuda)
    lens = torch.full((2,), 5, device=cuda)
    with pytest.raises(TypeError):
        pbs.prefix_beam_search_decode(lp.double(), lens)
    with pytest.raises(ValueError):
        pbs.prefix_beam_search_decode(lp, lens.float())
    with pytest.raises(ValueError):
        pbs.prefix_beam_search_decode(lp, lens, blank_id=10)


# K4: the LSTM recurrence (csrc/bilstm.cu) against the plain loop.


def _lstm_inputs(cuda, R, T, H, lengths, seed=20, D=2):
    """f64 inputs at the model's scales: z ~ N(0, 1) (the input projections),
    W_hh ~ U(+-1/sqrt(H)), bias ~ N(0, 0.1)."""
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(R, T, D, 4 * H, generator=g, dtype=torch.float64)
    w = (torch.rand(D, 4 * H, H, generator=g, dtype=torch.float64) * 2 - 1) / H ** 0.5
    b = 0.1 * torch.randn(D, 4 * H, generator=g, dtype=torch.float64)
    dy = torch.randn(R, T, D, H, generator=g, dtype=torch.float64)
    lens = torch.as_tensor(lengths, dtype=torch.int64)
    return tuple(x.to(cuda) for x in (z, w, b, dy, lens))


def _lstm_run(fn, z, w, b, dy, lens, dtype):
    """``y`` and the gradients of ``(y * dy).sum()`` for ``z``, ``w``, ``b``
    in ``dtype``, through ``fn`` (the operator or the plain loop), in f64."""
    z, w, b = (x.to(dtype).requires_grad_() for x in (z, w, b))
    y = fn(z, lens, w, b)
    grads = torch.autograd.grad((y.double() * dy).sum(), (z, w, b))
    return [x.detach().double() for x in (y, *grads)]


def _lstm_plain(z, lens, w, b):
    from multimodal_av_model_tpu_torch.ops import lstm_scan as ls
    return ls._forward_plain(z, lens, w, b, False)[0]


def _lstm_errors(cuda, R, T, H, lengths, dtype, seed=20):
    """Max abs error of the kernel and of the plain loop in ``dtype``, each
    against the f64 plain loop: ``{name: (kernel, plain)}`` for y, dz, dW, db."""
    from multimodal_av_model_tpu_torch.ops.lstm_scan import lstm_scan
    args = _lstm_inputs(cuda, R, T, H, lengths, seed)
    ref = _lstm_run(_lstm_plain, *args, torch.float64)
    got = _lstm_run(lstm_scan, *args, dtype)
    plain = _lstm_run(_lstm_plain, *args, dtype)
    torch.cuda.synchronize()
    lens = args[4].cpu()
    for r, n in enumerate(lens.tolist()):          # exactly 0 past each length
        assert not got[0][r, n:].any() and not got[1][r, n:].any()
    names = ("y", "dz", "dw", "db")
    return {k: ((g - f).abs().max().item(), (p - f).abs().max().item())
            for k, g, p, f in zip(names, got, plain, ref)}


@pytest.mark.parametrize("R", [8, 16])
def test_lstm_kernel_at_the_cells_shape_bf16(cuda, R):
    """[128, 2, R, 2048] in bf16 (a request's 8 rows, a train_b8 step's 16),
    lengths U[64, 128]: against the f64 loop the kernel's error in y and in
    every gradient is at most the bf16 plain loop's, with 10 % slack."""
    from multimodal_av_model_tpu_torch.ops.lstm_scan import lstm_scan_plan
    lengths = np.random.default_rng(21).integers(64, 129, R)
    plan = lstm_scan_plan("forward", R, 512, 2)
    assert plan["cs"] == 16 and plan["w_in_smem"]
    for k, (kern, plain) in _lstm_errors(cuda, R, 128, 512, lengths, torch.bfloat16).items():
        assert kern <= 1.1 * plain, (k, kern, plain)


@pytest.mark.parametrize("R", [8, 16])
def test_lstm_kernel_at_the_cells_shape_f32(cuda, R):
    """The same in f32, where W_hh (4 MiB a direction) does not fit the
    cluster and each CTA reads its slice from L2: within 2e-5 of f64."""
    from multimodal_av_model_tpu_torch.ops.lstm_scan import lstm_scan_plan
    lengths = np.random.default_rng(22).integers(64, 129, R)
    assert not lstm_scan_plan("forward", R, 512, 4)["w_in_smem"]
    for k, (kern, plain) in _lstm_errors(cuda, R, 128, 512, lengths, torch.float32).items():
        assert kern <= max(1.1 * plain, 2e-5), (k, kern, plain)


LSTM_LENGTHS = {"ones": [1, 1, 1], "full": [9, 9, 9, 9, 9], "equal": [5] * 4,
                "different": [9, 1, 4, 7, 2, 8, 3], "with_zero": [0, 9, 3]}


@pytest.mark.parametrize("H", [8, 16, 20, 32, 96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(LSTM_LENGTHS))
def test_lstm_kernel_small_and_odd_hidden(cuda, H, dtype, case):
    """In bf16 one CTA at small H and 4 at H = 256, in f32 W_hh from scratch
    in clusters of 1 to 16; H of 8 and 20, whose CTAs hold units past H, copy
    inputs and outputs element by element.  Lengths of 1, of T, all equal,
    all different and a row of 0 frames."""
    lengths = LSTM_LENGTHS[case]
    errors = _lstm_errors(cuda, len(lengths), 9, H, lengths, dtype, seed=H)
    for k, (kern, plain) in errors.items():
        assert kern <= max(1.1 * plain, 2e-5 if dtype == torch.float32 else 0.0), (k, kern, plain)


def test_lstm_kernel_reverse_direction_starts_at_the_last_valid_frame(cuda):
    """The backward direction's first step is a zero-carry step on frame
    len - 1: h = o tanh(i g) from that frame's gates alone."""
    from multimodal_av_model_tpu_torch.ops.lstm_scan import lstm_scan
    z, w, b, _, lens = _lstm_inputs(cuda, 3, 10, 32, [10, 6, 1])
    with torch.no_grad():
        y = lstm_scan(z.float(), lens, w.float(), b.float())
    for r, n in enumerate(lens.tolist()):
        i, f, g, o = (z[r, n - 1, 1] + b[1]).float().chunk(4)
        want = torch.sigmoid(o) * torch.tanh(torch.sigmoid(i) * torch.tanh(g))
        torch.testing.assert_close(y[r, n - 1, 1], want, rtol=1e-5, atol=1e-6)
        assert not y[r, n:].any()


def test_bilstm_on_the_card_matches_the_plain_loop_through_both_layers(cuda):
    """Two stacked layers in bf16 at the flagship's width, 8 rows: the output
    and the gradients of the input and of every parameter against the f64
    plain loop, within the bf16 plain loop's error and 10 %."""
    import torch.nn.functional as F
    from multimodal_av_model_tpu_torch.models.layers import BiLSTM
    from multimodal_av_model_tpu_torch.ops.lstm_scan import lstm_scan
    g = torch.Generator().manual_seed(23)
    model = BiLSTM(512, 512, 2).to(cuda)
    for p in model.parameters():
        p.data = ((torch.rand(p.shape, generator=g) * 2 - 1) / 512 ** 0.5).to(cuda)
    x = torch.randn(8, 128, 512, generator=g).to(cuda)
    dy = torch.randn(8, 128, 1024, generator=g, dtype=torch.float64).to(cuda)
    lens = torch.from_numpy(np.random.default_rng(23).integers(64, 129, 8)).to(cuda)

    def run(dtype, scan):
        xi = x.double().requires_grad_()
        params = [p.detach().double().requires_grad_() for p in model.parameters()]
        h = xi.to(dtype)
        for layer in range(2):
            w_ih, w_hh, b_hh = (q.to(dtype) for q in params[3 * layer:3 * layer + 3])
            z = F.linear(h, w_ih.flatten(0, 1)).view(8, 128, 2, 2048)
            h = scan(z, lens, w_hh, b_hh).reshape(8, 128, 1024)
        grads = torch.autograd.grad((h.double() * dy).sum(), (xi, *params))
        return [h.detach().double()] + [t.double() for t in grads]

    assert [n for n, _ in model.named_parameters()][:3] == [
        "layers.0.w_ih", "layers.0.w_hh", "layers.0.b_hh"]
    ref = run(torch.float64, _lstm_plain)
    got, plain = run(torch.bfloat16, lstm_scan), run(torch.bfloat16, _lstm_plain)
    for f, k, p in zip(ref, got, plain):
        assert (k - f).abs().max() <= 1.1 * (p - f).abs().max()
    with torch.no_grad():                          # the module's own path is the operator
        torch.testing.assert_close(model(x, lens).double(), ref[0], rtol=0, atol=1e-4)


def test_bilstm_is_two_launches_forward_and_two_backward(cuda):
    """A BiLSTM forward is 2 K4 launches and its backward 2 more, in the
    launch count and in the recorder's ``lstm_kernel`` counter (the backward's
    from autograd's device thread, under the span the caller waits in)."""
    from multimodal_av_model_tpu_torch import tracing
    from multimodal_av_model_tpu_torch.models.layers import BiLSTM
    from multimodal_av_model_tpu_torch.ops.lstm_scan import lstm_scan
    model = BiLSTM(64, 64, 2, torch.bfloat16).to(cuda)
    for p in model.parameters():
        torch.nn.init.uniform_(p, -0.1, 0.1)
    x = torch.randn(4, 32, 64, device=cuda)
    tracing.enable("cuda")
    try:
        before = lstm_scan.launches
        with tracing.span("fusion.temporal"):
            y = model(x, torch.tensor([32, 20, 5, 1], device=cuda))
        assert lstm_scan.launches == before + 2
        with tracing.span("train.backward"):
            y.float().sum().backward()
        assert lstm_scan.launches == before + 4
        spans = {s["name"]: s for s in tracing.collect()}
    finally:
        tracing.disable()
        tracing.collect()
    assert spans["fusion.temporal"]["counters"]["lstm_kernel"] == 2
    assert spans["train.backward"]["counters"]["lstm_kernel"] == 2


def test_lstm_kernel_rejects_what_it_does_not_take(cuda):
    from multimodal_av_model_tpu_torch.ops.lstm_scan import lstm_scan
    z = torch.zeros(2, 5, 2, 64, device=cuda)
    w = torch.zeros(2, 64, 16, device=cuda)
    b = torch.zeros(2, 64, device=cuda)
    lens = torch.full((2,), 5, device=cuda)
    with pytest.raises(TypeError):
        lstm_scan(z.double(), lens, w.double(), b.double())
    with pytest.raises(ValueError):
        lstm_scan(z, lens.float(), w, b)
    with pytest.raises(ValueError):
        lstm_scan(z, lens, w[:1], b)
    with pytest.raises(ValueError):
        lstm_scan(z, lens, w.bfloat16(), b)
    with pytest.raises(ValueError):
        lstm_scan(torch.zeros(2, 5, 1, 64, device=cuda), lens, w[:1], b[:1])

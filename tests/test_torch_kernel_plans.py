"""Launch plans and arithmetic of the port's two CUDA kernels, checked on the
CPU (the kernels themselves run only on the card: tests/test_torch_kernels.py),
and the one launch path and launch-count reader that all four kernels share.

K1 (``csrc/logmel.cu``) computes the windowed DFT as a 3xTF32 tensor-core
product and the mel projection in f32 over each filter's support.  Here a
torch emulation of that arithmetic, built from the very tables the kernel
reads, is held against the Pallas
kernel in interpret mode at the kernel's bar, rtol = atol = 2e-3
(tests/test_pallas_logmel.py), and plain TF32 is shown to miss that bar.
K2 (``csrc/lip_preprocess.cu``) stages bands of source rows; its band plan
must cover every source row the band's lerps read.
"""

import ctypes
import importlib.util
import os
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from multimodal_av_model_tpu.ops.pallas.logmel_kernel import log_mel_spectrogram_pallas
from multimodal_av_model_tpu_torch.ops import cuda_build, logmel, resize
from multimodal_av_model_tpu_torch.ops.logmel import (
    CLUSTER,
    TILE_M,
    dft_matrix,
    basis_tiles,
    logmel_cta_frames,
    logmel_plan,
    mel_support,
    tf32_round,
)
from multimodal_av_model_tpu_torch.ops.resize import lip_band_plan, resize_matrix


# -- K1: the 3xTF32 arithmetic --------------------------------------------------

def _untile(tiles: np.ndarray) -> np.ndarray:
    """Inverse of ``basis_tiles``: the ``[K, N]`` matrix."""
    ranks, ks, groups = tiles.shape[:3]
    return tiles.transpose(1, 3, 5, 0, 2, 4).reshape(8 * ks, 8 * groups * ranks)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split_tf32 as the tensor core reads it: hi rounded to
    tf32, lo = x - hi truncated to tf32 (its 13 low bits ignored)."""
    hi = torch.from_numpy(tf32_round(x.numpy()))
    lo = np.ascontiguousarray((x - hi).numpy()).view(np.uint32) & np.uint32(0xFFFFE000)
    return hi, torch.from_numpy(lo.view(np.float32))


def _product(a: torch.Tensor, b: torch.Tensor, passes: int):
    """f32 product with tf32 operands, both split as the kernel's split_tf32:
    3 passes (lo*hi + hi*lo + hi*hi, its three wgmma) or 1 (plain TF32)."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    if passes == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mel_dense(n_freqs: int, n_mels: int) -> np.ndarray:
    """The filterbank rebuilt from the supports the kernel reads."""
    lo, w = mel_support(n_freqs, n_mels, 16000)
    fb = np.zeros((n_freqs + w.shape[1], n_mels), np.float32)
    for m in range(n_mels):
        fb[lo[m]:lo[m] + w.shape[1], m] = w[m]
    return fb[:n_freqs]


def emulate_logmel_kernel(x: np.ndarray, passes: int = 3, n_fft: int = 400,
                          hop: int = 160, n_mels: int = 80) -> np.ndarray:
    """K1's arithmetic on the CPU: reflect-padded frames times the split DFT
    basis (``passes`` tf32 products), power from the re/im column pairs, the
    f32 mel projection, then the log; every operand comes from the tables the
    kernel reads."""
    plan = logmel_plan(x.shape[0], x.shape[1], n_fft, hop, n_mels)
    tiles = basis_tiles(dft_matrix(n_fft, plan["bins"], 8 * plan["ksteps"]))
    basis = torch.from_numpy(_untile(tiles)[:n_fft])       # the zero-padded rows add 0
    xpad = F.pad(torch.from_numpy(x)[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = xpad.unfold(-1, n_fft, hop)                       # [B, T, n_fft]
    reim = _product(frames, basis, passes)
    power = reim[..., 0::2] ** 2 + reim[..., 1::2] ** 2         # [B, T, bins]
    mel = power[..., :plan["n_freqs"]] @ torch.from_numpy(_mel_dense(plan["n_freqs"], n_mels))
    return torch.log(mel + 1e-6).numpy()


def _tone_and_noise(batch: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(3)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * rng.standard_normal((batch, n))).astype(np.float32)


def _tone_then_silence(n: int) -> np.ndarray:
    """One serving-length row: a pure tone, then a zero-padded half, as the
    collated batch pads a short utterance."""
    x = (0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / 16000.0)).astype(np.float32)
    x[n // 2:] = 0.0
    return x[None]


@pytest.mark.parametrize("make", [lambda: _tone_and_noise(2, 12345),
                                  lambda: _tone_then_silence(128 * 534)],
                         ids=["2x12345", "1x68352"])
def test_3xtf32_emulation_meets_the_pallas_bar(make):
    x = make()
    ref = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(x), interpret=True))
    got = emulate_logmel_kernel(x, passes=3)
    assert got.shape == ref.shape
    print(f"3xTF32 emulation vs Pallas interpret, {x.shape}: max|err| "
          f"{np.abs(got - ref).max():.3g}")
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_plain_tf32_misses_the_bar():
    """The reason for the split: one TF32 pass misses rtol = atol = 2e-3 on the
    low-power bins of a pure tone by orders of magnitude."""
    x = _tone_then_silence(128 * 534)
    ref = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(x), interpret=True))
    err = np.abs(emulate_logmel_kernel(x, passes=1) - ref)
    print(f"1xTF32 emulation vs Pallas interpret, {x.shape}: max|err| {err.max():.3g}")
    assert not np.all(err <= 2e-3 + 2e-3 * np.abs(ref))
    assert err.max() > 0.1


def test_tf32_round_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1.0, one + ulp / 2, one + ulp / 4, -(one + ulp / 2), 3.0e-3, 0.0],
                 np.float32)
    got = tf32_round(x)
    np.testing.assert_array_equal(got[:4], [1.0, one + ulp, 1.0, -(one + ulp)])
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    assert abs(got[4] - x[4]) <= 2.0 ** -11 * abs(x[4]) and got[5] == 0.0


def test_basis_tiles_round_trip():
    """Every basis entry lands in one slot of the tiles, a core matrix (8 n x
    4 k) is contiguous, and the kernel's split of an entry, as the tensor core
    reads it, is two tf32 values whose sum rebuilds it to 2^-20."""
    rng = np.random.default_rng(0)
    m = rng.standard_normal((24, 2 * 8 * 3)).astype(np.float32)
    tiles = basis_tiles(m, nt_cta=3)
    assert tiles.shape == (2, 3, 3, 2, 8, 4)
    np.testing.assert_array_equal(_untile(tiles), m)
    r, ks, gi, kc = 1, 2, 1, 1
    np.testing.assert_array_equal(tiles[r, ks, gi, kc],
                                  m[8 * ks + 4 * kc:8 * ks + 4 * kc + 4,
                                    24 * r + 8 * gi:24 * r + 8 * gi + 8].T)
    hi, lo = _split(torch.from_numpy(m))
    np.testing.assert_array_equal(hi.numpy(), tf32_round(m))
    np.testing.assert_allclose((hi + lo).numpy(), m, rtol=2.0 ** -20, atol=0)
    assert (lo.numpy().view(np.uint32) & 0x1FFF == 0).all()


def test_kernel_tables_match_the_plain_dft_and_filterbank():
    """Columns 2f, 2f+1 of the DFT basis are the windowed rfft of bin f, the
    padded bins are zero, and the mel supports rebuild the filterbank."""
    plan = logmel_plan(1, 16000)
    dft = dft_matrix(400, plan["bins"])
    x = _tone_and_noise(1, 400)[0].astype(np.float64)
    spec = np.fft.rfft(x * np.hanning(401)[:-1])
    reim = x @ dft.astype(np.float64)
    np.testing.assert_allclose(reim[0:402:2], spec.real, atol=1e-4)
    np.testing.assert_allclose(reim[1:402:2], spec.imag, atol=1e-4)
    assert not dft[:, 402:].any()
    np.testing.assert_array_equal(_mel_dense(201, 80), logmel.mel_filterbank(201, 80, 16000))
    lo, w = mel_support(201, 80, 16000)
    assert w.shape == (80, plan["mel_width"]) and plan["mel_width"] == 16
    assert plan["mel_fits"] and (lo + plan["mel_width"] <= plan["bins"]).all()


@pytest.mark.parametrize("n_fft,n_mels,width", [(400, 80, 16), (400, 40, 32), (400, 26, 48),
                                                (512, 26, 48)])
def test_mel_supports_wider_than_16_bins(n_fft, n_mels, width):
    """Fewer filters are wider: AV-HuBERT's 26 bins make triangles of up to 38
    bins at n_fft 400 (48 at 512).  The supports widen to a multiple of 16
    (the kernel's instances of 16 to 64 bins), rebuild the filterbank, lie
    inside the padded bins, and the shared memory grows by the filterbank's
    rows alone; at n_fft 400 the 3xTF32 emulation with those supports meets
    the plain version's bar."""
    n_freqs = n_fft // 2 + 1
    lo, w = mel_support(n_freqs, n_mels, 16000)
    assert w.shape == (n_mels, width)
    np.testing.assert_array_equal(_mel_dense(n_freqs, n_mels),
                                  logmel.mel_filterbank(n_freqs, n_mels, 16000))
    plan = logmel_plan(16, 256 * 640, n_fft, 160, n_mels, center=False)
    assert plan["mel_width"] == width and plan["mel_fits"]
    assert (lo + width <= plan["bins"]).all()
    base = logmel_plan(16, 256 * 640, n_fft, 160, 80, center=False)
    assert plan["smem_bytes"] - base["smem_bytes"] == 4 * (n_mels * (width + 5)
                                                           - 80 * (base["mel_width"] + 5))
    if n_fft == 400:
        x = _tone_and_noise(2, 12345)
        got = emulate_logmel_kernel(x, passes=3, n_mels=n_mels)
        ref = logmel.log_mel_spectrogram(torch.from_numpy(x), n_mels=n_mels).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


# -- K1: the tile and cluster plan -------------------------------------------

@pytest.mark.parametrize("B,S,center", [(4, 128 * 534, True), (2, 12345, True),
                                        (1, 400, False), (1, 201, True), (1, 16000, True),
                                        (3, 4000, True), (1, 400 + 160 * 16, False)])
def test_logmel_plan_covers_every_frame_once(B, S, center):
    plan = logmel_plan(B, S, center=center)
    T = plan["T"]
    assert T == logmel.num_frames(S, center=center)
    assert plan["ctas"] % CLUSTER == 0 and plan["ctas"] >= plan["n_mtiles"]
    seen = np.zeros((B, T), np.int64)
    for cta in range(plan["ctas"]):
        got = logmel_cta_frames(plan, cta)
        if got is not None:
            b, t0, t1 = got
            assert 0 < t1 - t0 <= TILE_M
            seen[b, t0:t1] += 1
    assert (seen == 1).all()
    # Bins: 4 CTAs x nt_cta n-tiles x 4 bins cover every real bin.
    assert plan["bins"] == CLUSTER * plan["bins_cta"] >= plan["n_freqs"]
    assert plan["supported"] and plan["nt_cta"] == logmel.NT_CTA
    # The basis's k-steps, zero-padded to an even number of pipeline stages.
    assert plan["ksteps"] % (2 * logmel.STAGE_K) == 0
    assert 0 <= 8 * plan["ksteps"] - 400 < 16 * logmel.STAGE_K
    # The staged span of a full m-tile: 15 hops plus one frame.
    assert plan["rows_tile"] * 160 >= (TILE_M - 1) * 160 + 400
    assert plan["smem_bytes"] <= logmel.SMEM_LIMIT


def test_logmel_plan_edge_cases():
    assert logmel_plan(1, 400, center=False)["T"] == 1
    assert logmel_plan(1, 201)["T"] == 2
    assert logmel_plan(4, 128 * 534)["T"] % TILE_M != 0       # a partial last tile
    serving = logmel_plan(4, 128 * 534)
    assert (serving["ctas"], serving["threads"], serving["bins"]) == (108, 256, 224)
    assert 48 * 1024 < serving["smem_bytes"] <= logmel.SMEM_LIMIT


# -- K2: the band plan --------------------------------------------------------

K2_SHAPES = [((512, 128, 128, 3), 96), ((7, 50, 70, 1), 96), ((5, 128, 128, 3), 40),
             ((3, 37, 53, 3), 96), ((3, 37, 53, 4), 96), ((2, 8, 8, 3), 8)]


@pytest.mark.parametrize("elem_bytes", [1, 4])
@pytest.mark.parametrize("shape,out", K2_SHAPES)
def test_lip_band_plan_covers_every_source_row(shape, out, elem_bytes):
    _, H, W, C = shape
    plan = lip_band_plan(H, W, C, out, out, elem_bytes)
    rb, nb = plan["rows_per_band"], plan["n_bands"]
    assert (nb - 1) * rb < out <= nb * rb                      # every output row, once
    rows = 0
    for b in range(nb):
        oy = np.arange(b * rb, min((b + 1) * rb, out))
        first, last = plan["band_first"][b], plan["band_last"][b]
        assert 0 <= first <= last < H
        assert (plan["ylo"][oy] >= first).all() and (plan["yhi"][oy] <= last).all()
        rows = max(rows, last - first + 1)
    assert plan["stage_bytes"] % 16 == 0
    assert plan["stage_bytes"] >= rows * W * C * elem_bytes + 15   # ragged head
    assert plan["smem_bytes"] == plan["stage_bytes"] + 3 * out * 4 + rows * out * 4
    assert plan["smem_bytes"] <= resize.SMEM_LIMIT
    assert (plan["xlo"] >= 0).all() and (plan["xhi"] < W).all()


@pytest.mark.parametrize("shape,out", K2_SHAPES)
def test_lip_band_plan_weights_are_resize_matrix(shape, out):
    """The lerp tables the kernel reads are the half-pixel weights of
    resize_matrix, row by row."""
    _, H, W, _ = shape
    plan = lip_band_plan(H, W, shape[3], out, out)
    for lo, hi, frac, size in ((plan["ylo"], plan["yhi"], plan["yfrac"], H),
                               (plan["xlo"], plan["xhi"], plan["xfrac"], W)):
        m = np.zeros((out, size), np.float32)
        m[np.arange(out), lo] += 1.0 - frac
        m[np.arange(out), hi] += frac
        np.testing.assert_array_equal(m, resize_matrix(out, size))


@pytest.mark.parametrize("shape,out", K2_SHAPES[1:])
def test_lip_band_emulation_matches_plain(shape, out):
    """K2's order of work per band (grey + horizontal lerp of the staged rows,
    then the vertical lerp and /255), emulated with the plan's tables, against
    the plain version at the kernel's bar (rtol 1e-4, atol 1e-3)."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, size=shape).astype(np.uint8)
    plan = lip_band_plan(*shape[1:], out, out)
    got = np.zeros((shape[0], out, out), np.float32)
    gray = frames.astype(np.float32).sum(-1) / np.float32(shape[3])
    for b in range(plan["n_bands"]):
        first, last = plan["band_first"][b], plan["band_last"][b]
        band = gray[:, first:last + 1]
        g0, g1 = band[:, :, plan["xlo"]], band[:, :, plan["xhi"]]
        h = g0 + (g1 - g0) * plan["xfrac"]
        oy = np.arange(b * plan["rows_per_band"], min((b + 1) * plan["rows_per_band"], out))
        top, bot = h[:, plan["ylo"][oy] - first], h[:, plan["yhi"][oy] - first]
        got[:, oy] = (top + (bot - top) * plan["yfrac"][oy, None]) / np.float32(255.0)
    ref = resize.lip_frames_preprocess(torch.from_numpy(frames), out)[:, 0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


# -- the phase-timing tool -----------------------------------------------------

def _phase_tool():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "kernel_phases.py")
    spec = importlib.util.spec_from_file_location("kernel_phases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kernel", sorted(cuda_build.SOURCES))
def test_phase_markers_become_one_stamp_each(kernel):
    """tools/kernel_phases.py turns each ``// PHASE:`` marker line of a kernel
    source into one clock stamp, numbered in source order."""
    tool = _phase_tool()
    names = tool.phases(kernel)
    assert len(names) >= 2 and len(set(names)) == len(names)
    src = tool.instrument(kernel)
    for k in range(len(names)):
        assert src.count(f"kp_stamp({k});") == 1
    assert f"kp_stamp({len(names)});" not in src and not tool.MARKER.search(src)


# -- the one launch path and its counts ------------------------------------------

def test_launch_counts_cover_every_kernel_and_the_cpu_launches_none():
    """``ops.launch_counts`` has one key for each library of
    ``cuda_build.SOURCES`` (each of which has its launchers), and a plain CPU
    call of every operator, K4's backward too, leaves every count as it was."""
    from multimodal_av_model_tpu_torch.ops import launch_counts, lstm_scan, prefix_beam_search

    counts = launch_counts()
    assert list(counts) == ["logmel", "lip_preprocess", "prefix_beam", "lstm_scan"]
    assert len(counts) == len(cuda_build.SOURCES)
    assert {launcher.name for launcher in cuda_build._launchers} == set(cuda_build.SOURCES)
    g = torch.Generator().manual_seed(0)
    mel = logmel.log_mel_op(torch.randn(2, 4000, generator=g), 16000, 400, 160, 400, 80, 0.0,
                            None, 1e-6, True, True)
    lips = resize.lip_preprocess_op(torch.randint(0, 256, (2, 20, 20, 3), dtype=torch.uint8), 8)
    lp = torch.log_softmax(torch.randn(2, 6, 9, generator=g), dim=-1)
    beam = prefix_beam_search.prefix_beam_op(lp, torch.tensor([6, 4]), None, None, None, None,
                                             None, 3, 4, 0, -1, 0.0, 0.0)
    z, w, b = (torch.randn(shape, generator=g, requires_grad=True)
               for shape in ((3, 5, 2, 16), (2, 16, 4), (2, 16)))
    y, _ = lstm_scan.lstm_scan_op(z, torch.tensor([5, 2, 0]), w, b, True)
    y.sum().backward()
    assert mel.shape == (2, 26, 80) and lips.shape == (2, 1, 8, 8) and beam[4].shape == (2, 6)
    assert z.grad is not None and launch_counts(counts) == dict.fromkeys(counts, 0)


def test_launcher_passes_the_stream_checks_the_code_and_counts(monkeypatch):
    """``cuda_build.Launcher`` on a stand-in entry point: the stream goes
    last; a nonzero return raises with the library's error string and counts
    nothing; a zero one adds 1 to the entry's ``launches``; ``rebind`` drops
    the bound entry points of one kernel only."""
    monkeypatch.setattr(cuda_build, "_launchers", list(cuda_build._launchers))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=1234))
    calls, code = [], [0]

    def error_string(c):
        return b"invalid argument"

    def entry():
        pass

    entry.launches = 0
    launcher = cuda_build.Launcher("logmel", "mmav_logmel", [ctypes.c_int])
    assert launcher.symbol == "mmav_logmel_launch" and launcher.argtypes[-1] is ctypes.c_void_p
    launcher.lib = types.SimpleNamespace(mmav_logmel_error_string=error_string)
    launcher.fn = lambda *args: calls.append(args) or code[0]
    launcher(torch.device("cpu"), entry, 7)
    assert calls == [(7, 1234)] and entry.launches == 1
    code[0] = 9
    with pytest.raises(RuntimeError, match=r"mmav_logmel launch failed: CUDA error 9 "
                                           r"\(invalid argument\)"):
        launcher(torch.device("cpu"), entry, 8)
    assert entry.launches == 1
    other = cuda_build.Launcher("lip", "mmav_lip", [])
    other.fn = print
    cuda_build.rebind("logmel")
    assert launcher.fn is None and other.fn is print

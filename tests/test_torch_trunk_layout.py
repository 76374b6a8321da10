"""PyTorch port, the visual trunk's layout: BatchNorm's one pass over a
16-bit input, the channels_last tap stack and trunk, and the
``bn_one_pass`` counter (CPU).

The reference is the path the trunk took before: an NCHW tap stack and
trunk, and every BatchNorm through an f32 copy of its input with the output
cast back (``nchw_f32_cast_path``).  BatchNorm alone: outputs and input
gradients within one ulp of the 16-bit dtype, weight and bias gradients and
running statistics within f32 rounding (``F32_ROUNDING``); f32 and f64
inputs bit for bit.  The whole bf16 encoder: two bf16 paths part by their
own rounding, by as much as each parts from f32 (at ResNet-18's widths on
the CPU its gradients 13 % apart, each 20 % from f32; the split moves with
the thread count), so the one pass is held to the reference's accuracy
against the f32 encoder from the same weights: the relative error of the
output, of all gradients and of all running statistics within
``ACCURACY_MARGIN`` times the reference's (``assert_as_accurate``; over 8
seeds at 1 and 4 threads the worst ratio read 1.11), on the CPU and on the
card.  f32 encoders bit for bit.
"""

import contextlib

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from multimodal_av_model_tpu_torch import tracing
from multimodal_av_model_tpu_torch.config import Config
from multimodal_av_model_tpu_torch.models import VisualEncoder, init_weights, layers, visual
from multimodal_av_model_tpu_torch.models.layers import BatchNorm

HALF = (torch.bfloat16, torch.float16)
F32_ROUNDING = 1e-5
ACCURACY_MARGIN = 1.25


class _CastBatchNorm:
    """``torch.nn.functional`` with ``batch_norm`` run on an f32 copy of the
    input and its output cast back, as BatchNorm did before its one pass."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def batch_norm(x, *args):
        return F.batch_norm(x.to(torch.promote_types(x.dtype, torch.float32)), *args).to(x.dtype)


@contextlib.contextmanager
def nchw_f32_cast_path():
    """The trunk as it ran before: NCHW throughout and BatchNorm in f32."""
    saved = layers.F, visual.memory_format
    layers.F, visual.memory_format = _CastBatchNorm(), lambda dtype: torch.contiguous_format
    try:
        yield
    finally:
        layers.F, visual.memory_format = saved


def ulp(x: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of each element of ``x`` in its dtype."""
    fi = torch.finfo(x.dtype)
    mag = x.float().abs().clamp(min=fi.smallest_normal)
    return torch.exp2(torch.floor(torch.log2(mag))) * fi.eps


def assert_within_one_ulp(got, want):
    assert got.dtype == want.dtype
    d = (got.float() - want.float()).abs()
    bound = torch.maximum(ulp(got), ulp(want))
    assert bool((d <= bound).all()), f"max |d| {d.max().item():.3g}, {int((d > bound).sum())} over"


def assert_f32_rounding(got, want):
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=F32_ROUNDING, atol=F32_ROUNDING * scale)


def trunk_config(norm: str = "batch", remat: str = "none"):
    """ResNet-18's depth (20 norms a pass) at small widths."""
    cfg = Config().model.visual
    cfg.frontend_channels, cfg.resnet_channels, cfg.output_dim = 8, (8, 12, 16, 24), 24
    cfg.norm, cfg.remat = norm, remat
    return cfg


def make_encoder(dtype, norm: str = "batch", remat: str = "none", seed: int = 0):
    enc = init_weights(VisualEncoder(trunk_config(norm, remat), dtype),
                       torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():       # norms away from the identity, statistics away from 0 / 1
        for name, p in enc.named_parameters():
            if p.ndim == 1 and not name.endswith("alpha"):
                p.add_(0.2 * torch.randn(p.shape, generator=g))
        for m in enc.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return enc


def lips_batch(C: int = 1, B: int = 2, T: int = 6, HW: int = 48, seed: int = 2):
    g = torch.Generator().manual_seed(seed)
    lips = torch.rand(B, T, HW, HW, C, generator=g)
    lips[1, T - 2:] = 0.0                           # padded frames past a clip's end
    return lips, torch.randn(B, T, 24, generator=g)


def encoder_step(enc, lips, w, train: bool):
    """Output, parameter gradients of ``sum(out * w)`` (train) and buffers."""
    enc.zero_grad(set_to_none=True)
    with torch.set_grad_enabled(train):
        out = enc(lips, train=train)
    grads = {}
    if train:
        (out.float() * w).sum().backward()
        grads = {n: p.grad.clone() for n, p in enc.named_parameters()}
    return out.detach(), grads, {n: b.clone() for n, b in enc.named_buffers()}


def counted(fn, name: str = "bn_one_pass") -> int:
    """``name``'s count over ``fn()`` run inside one span, recorder on."""
    tracing.enable("cpu")
    try:
        with tracing.span("unit"):
            fn()
        return sum(s["counters"].get(name, 0) for s in tracing.collect())
    finally:
        tracing.disable()


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo group of this process alone, for BatchNorm's ``group`` path."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv", rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _bn_pair(dtype, C=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(C, dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(C, generator=g))
        bn.running_mean.copy_(torch.randn(C, generator=g))
        bn.running_var.copy_(torch.rand(C, generator=g) + 0.5)
    ref = BatchNorm(C, dtype)
    ref.load_state_dict(bn.state_dict())
    x = (torch.randn(5, C, 9, 7, generator=g) * 2 + 1).to(dtype)
    return bn, ref, x, torch.randn(5, C, 9, 7, generator=g).to(dtype)


def _bn_run(bn, x, dy, train, update_stats):
    bn.zero_grad(set_to_none=True)
    bn.update_stats = update_stats
    x = x.clone().requires_grad_(True)
    y = bn(x, train=train)
    y.backward(dy)
    return y, x.grad


@pytest.mark.parametrize("update_stats", [True, False])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", HALF, ids=str)
def test_batchnorm_one_pass_matches_the_f32_cast_path(dtype, train, layout, update_stats):
    bn, ref, x, dy = _bn_pair(dtype)
    if layout == "channels_last":       # the gradient comes back in the output's layout
        x, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
    n = counted(lambda: _bn_run(bn, x, dy, train, update_stats))
    assert n == 1
    bn.load_state_dict(ref.state_dict())
    y, dx = _bn_run(bn, x, dy, train, update_stats)
    with nchw_f32_cast_path():
        y_ref, dx_ref = _bn_run(ref, x, dy, train, update_stats)
    assert y.dtype == dx.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last) == (layout == "channels_last")
    assert_within_one_ulp(y, y_ref)
    assert_within_one_ulp(dx, dx_ref)
    for name in ("weight", "bias"):
        assert_f32_rounding(getattr(bn, name).grad, getattr(ref, name).grad)
    for name in ("running_mean", "running_var"):
        assert_f32_rounding(getattr(bn, name), getattr(ref, name))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_batchnorm_f32_and_f64_are_unchanged(dtype, train):
    """Bit for bit the path before, and not counted."""
    bn, ref, x, dy = _bn_pair(dtype)
    if dtype == torch.float64:
        bn, ref = bn.double(), ref.double()
    assert counted(lambda: _bn_run(bn, x, dy, train, True)) == 0
    bn.load_state_dict(ref.state_dict())
    y, dx = _bn_run(bn, x, dy, train, True)
    with nchw_f32_cast_path():
        y_ref, dx_ref = _bn_run(ref, x, dy, train, True)
    for a, b in ((y, y_ref), (dx, dx_ref), (bn.weight.grad, ref.weight.grad),
                 (bn.bias.grad, ref.bias.grad), (bn.running_mean, ref.running_mean),
                 (bn.running_var, ref.running_var)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_batchnorm_group_path_takes_channels_last(one_rank_group, dtype):
    """The all-reduced statistics give the same numbers on an NHWC input as
    on an NCHW one (within the rounding of another summation order), keep
    the layout, and are not counted."""
    bn, ref, x, dy = _bn_pair(dtype)
    bn.group = ref.group = one_rank_group
    xl, dyl = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
    assert counted(lambda: _bn_run(bn, xl, dyl, True, True)) == 0
    bn.load_state_dict(ref.state_dict())
    y, dx = _bn_run(bn, xl, dyl, True, True)
    y_ref, dx_ref = _bn_run(ref, x, dy, True, True)
    assert y.is_contiguous(memory_format=torch.channels_last)
    if dtype == torch.bfloat16:
        assert_within_one_ulp(y, y_ref)
        assert_within_one_ulp(dx, dx_ref)
    else:
        assert_f32_rounding(y, y_ref)
        assert_f32_rounding(dx, dx_ref)
    for name in ("running_mean", "running_var"):
        assert_f32_rounding(getattr(bn, name), getattr(ref, name))
    assert_f32_rounding(bn.weight.grad, ref.weight.grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=str)
@pytest.mark.parametrize("C", [1, 3])
def test_tap_stack_equals_the_nchw_stack(C, dtype):
    """Bit for bit the stack built before on ``[B, T, C, H, W]``; 16-bit
    stacks channels_last, f32 ones NCHW."""
    lips, _ = lips_batch(C, B=2, T=7, HW=10)
    B, T, H, W, _ = lips.shape
    K, pad = 5, 2
    x = lips.to(dtype).permute(0, 1, 4, 2, 3)
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, pad, pad))
    want = torch.cat([xp[:, k:k + T] for k in range(K)], dim=2).reshape(B * T, K * C, H, W)
    got = visual.tap_stack(lips, K, dtype)
    assert got.shape == want.shape and torch.equal(got, want)
    if dtype in HALF:
        assert got.is_contiguous(memory_format=torch.channels_last) and not got.is_contiguous()
    else:
        assert got.is_contiguous()
    # Channel k*C + c reads frame t + k - 2: frame 0's first taps are padding.
    assert torch.equal(got[0, :2 * C], torch.zeros(2 * C, H, W, dtype=dtype))
    assert torch.equal(got[0, 2 * C:3 * C], lips[0, 0].to(dtype).permute(2, 0, 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_every_batchnorm_sees_the_trunks_layout(dtype):
    """Forward hooks on the 20 BatchNorms: channels_last inputs in bf16, NCHW
    ones in f32 (every map is at least 2x2, so the two are told apart)."""
    enc = make_encoder(dtype)
    seen = []
    hooks = [m.register_forward_hook(lambda m, args, out: seen.append((args[0], out)))
             for m in enc.modules() if isinstance(m, BatchNorm)]
    lips, w = lips_batch()
    encoder_step(enc, lips, w, train=True)
    for h in hooks:
        h.remove()
    assert len(seen) == 20
    for x, y in seen:
        assert x.shape[-1] >= 2 and x.shape[1] >= 2
        for t in (x, y):
            assert t.is_contiguous(memory_format=torch.channels_last) == (dtype != torch.float32)
            assert t.is_contiguous() == (dtype == torch.float32)


@pytest.mark.parametrize("case,want", [
    ("eval", 20), ("train", 20), ("train-f16", 20), ("remat-frontend", 21), ("remat-stage1", 25),
    ("remat-full", 40), ("f32", 0), ("groupnorm", 0)])
def test_bn_one_pass_counts_a_trunk_pass(case, want):
    """20 a pass (1 frontend, 16 in the blocks, 3 downsample), and each
    BatchNorm a checkpointed region recomputes once more; none in f32 or
    with GroupNorm."""
    dtype = {"train-f16": torch.float16, "f32": torch.float32}.get(case, torch.bfloat16)
    remat = case.split("-", 1)[1] if case.startswith("remat") else "none"
    enc = make_encoder(dtype, "group" if case == "groupnorm" else "batch", remat)
    lips, w = lips_batch()
    assert counted(lambda: encoder_step(enc, lips, w, train=case != "eval")) == want


def test_bn_one_pass_counts_none_on_the_group_path(one_rank_group):
    enc = make_encoder(torch.bfloat16)
    for m in enc.modules():
        if isinstance(m, BatchNorm):
            m.group = one_rank_group
    lips, w = lips_batch()
    assert counted(lambda: encoder_step(enc, lips, w, train=True)) == 0


def _rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30)).item()


def _flat(tensors: dict, names) -> torch.Tensor:
    return torch.cat([tensors[n].double().flatten() for n in names])


def encoder_errors(got, truth) -> dict[str, float]:
    """An ``encoder_step``'s distance from ``truth``'s, each relative to the
    norm of the whole: the output, every gradient, every running statistic."""
    (out, grads, bufs), (t_out, t_grads, t_bufs) = got, truth
    stats = [n for n in bufs if n.endswith(("running_mean", "running_var"))]
    errs = {"out": _rel(out, t_out), "stats": _rel(_flat(bufs, stats), _flat(t_bufs, stats))}
    if grads:
        errs["grad"] = _rel(_flat(grads, grads), _flat(t_grads, grads))
    return errs


def assert_as_accurate(got, ref, truth):
    """``got`` as close to ``truth`` as ``ref`` is, within ``ACCURACY_MARGIN``."""
    e, e_ref = encoder_errors(got, truth), encoder_errors(ref, truth)
    for k, v in e.items():
        assert v <= ACCURACY_MARGIN * e_ref[k] + 1e-6, (k, v, e_ref[k])
    return e, e_ref


def bf16_steps(enc, lips, w, train: bool):
    """The bf16 encoder ``enc``'s step on the one pass and on the NCHW f32
    cast path, and an f32 encoder's from the same weights; ``enc`` is left
    with its weights and statistics as they came."""
    state = {k: v.clone() for k, v in enc.state_dict().items()}
    got = encoder_step(enc, lips, w, train)
    enc.load_state_dict(state)
    with nchw_f32_cast_path():
        ref = encoder_step(enc, lips, w, train)
    enc.load_state_dict(state)
    f32 = VisualEncoder(enc.config, torch.float32).to(lips.device)
    f32.load_state_dict(state)
    return got, ref, encoder_step(f32, lips, w, train)


@pytest.mark.parametrize("remat", ["none", "frontend"])
@pytest.mark.parametrize("train", [True, False])
def test_bf16_encoder_is_as_accurate_as_the_nchw_f32_cast_path(train, remat):
    lips, w = lips_batch()
    assert_as_accurate(*bf16_steps(make_encoder(torch.bfloat16, remat=remat), lips, w, train))


def test_bf16_full_width_encoder_is_as_accurate_as_the_nchw_f32_cast_path():
    g = torch.Generator().manual_seed(1)
    lips = torch.rand(2, 8, 48, 48, 1, generator=g)
    enc = init_weights(VisualEncoder(Config().model.visual, torch.bfloat16),
                       torch.Generator().manual_seed(0))
    assert_as_accurate(*bf16_steps(enc, lips, torch.randn(2, 8, 512, generator=g), True))


@pytest.mark.parametrize("remat", ["none", "frontend"])
@pytest.mark.parametrize("train", [True, False])
def test_f32_encoder_is_unchanged(train, remat):
    """f32 outputs, gradients and statistics bit for bit the path before."""
    enc = make_encoder(torch.float32, remat=remat)
    state = {k: v.clone() for k, v in enc.state_dict().items()}
    lips, w = lips_batch()
    got = encoder_step(enc, lips, w, train)
    enc.load_state_dict(state)
    with nchw_f32_cast_path():
        want = encoder_step(enc, lips, w, train)
    for a, b in zip(got, want):
        if isinstance(a, dict):
            assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trunk's layouts are cuDNN's")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kernels(step) -> dict[str, float]:
    """Device ms by kernel name over one ``step()``, profiled."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0.0) + ev.device_time_total / 1e3
    return out


@pytest.mark.gpu
def test_bf16_trunk_on_the_card(cuda):
    """The full-width bf16 trunk in training on 512 frames of 96x96 (4 clips
    of 128): as accurate against the f32 encoder as the NCHW f32-cast path,
    as the CPU test holds it; no cuDNN layout conversion in a profiled
    forward and backward; ``bn_one_pass`` 20 a pass and 21 with the
    frontend recomputed, autograd's device thread counting for the caller."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    lips = torch.rand(4, 128, 96, 96, 1, generator=g).to(cuda)
    w = torch.randn(4, 128, 512, generator=g).to(cuda)
    enc = init_weights(VisualEncoder(Config().model.visual, torch.bfloat16),
                       torch.Generator().manual_seed(0)).to(cuda)
    got, ref, truth = ([_to_cpu(x) for x in step] for step in bf16_steps(enc, lips, w, True))
    direct = encoder_errors(got, ref)
    print("bf16 trunk, one pass vs NCHW f32 cast:", {k: f"{v:.3g}" for k, v in direct.items()})
    e, e_ref = assert_as_accurate(got, ref, truth)
    print("against f32, one pass:", {k: f"{v:.3g}" for k, v in e.items()},
          "cast:", {k: f"{v:.3g}" for k, v in e_ref.items()})

    def step():
        encoder_step(enc, lips, w, True)

    step()
    new = _kernels(step)
    with nchw_f32_cast_path():
        step()
        old = _kernels(step)
    kinds = {"batchnorm": ("batch_norm", "cudnn::bn_"), "layout": ("nchwToNhwc", "nhwcToNchw"),
             "copy": ("copy_kernel",)}
    for name, ms in (("channels_last", new), ("nchw", old)):
        top = sorted(ms.items(), key=lambda kv: -kv[1])[:10]
        sums = {k: sum(v for op, v in ms.items() if any(m in op for m in marks))
                for k, marks in kinds.items()}
        print(name, f"{sum(ms.values()):.2f} ms,", {k: f"{v:.2f}" for k, v in sums.items()}, "top:",
              "; ".join(f"{k[:80]} {v:.2f}" for k, v in top))
    assert new, "the profiler saw no device kernel"
    assert not [k for k in new if "nchwToNhwc" in k or "nhwcToNchw" in k]

    for remat, want_count in (("none", 20), ("frontend", 21)):
        enc.config.remat = remat
        tracing.enable("cuda")
        try:
            with tracing.span("unit"):
                step()
            n = sum(s["counters"].get("bn_one_pass", 0) for s in tracing.collect())
        finally:
            tracing.disable()
        assert n == want_count, (remat, n)


def _to_cpu(x):
    return {k: v.cpu() for k, v in x.items()} if isinstance(x, dict) else x.cpu()

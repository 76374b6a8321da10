"""``mmav::lstm_scan`` on the CPU (``ops/lstm_scan.py``): the operator's plain
path against ``_lstm_scan`` over the padded flip that ``FusedBiLSTMLayer``
ran before it, forward and gradient; its registered autograd by
``gradcheck`` in f64; the CPU backward, autograd of the loop run again; one
node per layer in an exported BiLSTM; and the launch plan of the card's
kernel (``csrc/bilstm.cu``, K4), which the CPU can check for every shape."""

import pytest
import torch
import torch.nn.functional as F

from multimodal_av_model_tpu_torch.models.layers import BiLSTM
from multimodal_av_model_tpu_torch.ops import lstm_scan as ls
from multimodal_av_model_tpu_torch.ops.lstm_scan import _lstm_scan, length_mask

LENGTHS = {"ones": [1, 1, 1], "full": [7, 7, 7, 7], "equal": [4, 4, 4],
           "different": [7, 1, 4, 6, 2], "with_zero": [0, 7, 3]}


def _inputs(R, T=7, H=5, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(R, T, 2, 4 * H, generator=g, dtype=dtype)
    w = 0.5 * torch.randn(2, 4 * H, H, generator=g, dtype=dtype)
    b = torch.randn(2, 4 * H, generator=g, dtype=dtype)
    return z, w, b


def _flipped_reference(z, lengths, w, b):
    """The layer's old path: directions stacked in time order, the backward
    one over the flipped padded sequence, through ``_lstm_scan``."""
    T = z.shape[1]
    v = length_mask(lengths, T).transpose(0, 1)
    zs = [z[:, :, 0].transpose(0, 1), z[:, :, 1].transpose(0, 1).flip(0)]
    keep = torch.stack([v, v.flip(0)], dim=1)[..., None]
    y = _lstm_scan(torch.stack(zs, dim=1), keep, w.transpose(1, 2), b[:, None, :])
    return torch.stack([y[:, 0], y[:, 1].flip(0)], dim=2).transpose(0, 1)


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_operator_equals_the_plain_loop_forward_and_gradient(case):
    lengths = torch.tensor(LENGTHS[case])
    z, w, b = (x.requires_grad_() for x in _inputs(len(lengths)))
    got = ls.lstm_scan(z, lengths, w, b)
    want = _flipped_reference(z, lengths, w, b)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for r, n in enumerate(lengths.tolist()):
        assert not got[r, n:].any()
    dy = torch.randn_like(got)
    g_got = torch.autograd.grad((got * dy).sum(), (z, w, b))
    g_want = torch.autograd.grad((want * dy).sum(), (z, w, b))
    for a, e in zip(g_got, g_want):
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("lengths", [[5, 1, 3], [0, 5, 2]])
def test_registered_autograd_passes_gradcheck(lengths):
    lengths = torch.tensor(lengths)
    z, w, b = (x.requires_grad_() for x in _inputs(len(lengths), T=5, H=3, seed=1))
    assert torch.autograd.gradcheck(
        lambda z, w, b: ls.lstm_scan_op(z, lengths, w, b, True)[0], (z, w, b))


def test_plain_backward_in_f32_matches_autograd_of_the_loop():
    """On the CPU the forward saves nothing, and the registered backward is
    autograd of the plain loop run again, in the inputs' precision."""
    lengths = torch.tensor([9, 3, 6, 1])
    z, w, b = (x.float().requires_grad_() for x in _inputs(4, T=9, H=8, seed=2))
    y, saved = ls.lstm_scan_op(z, lengths, w, b, True)
    assert saved.numel() == 0 and saved.dtype == torch.float32
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, (z, w, b), dy)
    want = torch.autograd.grad(_flipped_reference(z, lengths, w, b), (z, w, b), dy)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6)


def test_saves_only_where_a_gradient_is_wanted(monkeypatch):
    seen = []
    real = ls.lstm_scan_op
    monkeypatch.setattr(ls, "lstm_scan_op", lambda *a: seen.append(a[4]) or real(*a))
    lengths = torch.tensor([3, 2])
    z, w, b = _inputs(2, T=3, H=2, dtype=torch.float32)
    ls.lstm_scan(z, lengths, w, b)
    ls.lstm_scan(z, lengths, w.requires_grad_(), b)
    with torch.no_grad():
        ls.lstm_scan(z, lengths, w, b)
    assert seen == [False, True, False]


def test_exported_bilstm_holds_one_operator_node_a_layer():
    model = BiLSTM(6, 4, 3).eval()
    g = torch.Generator().manual_seed(3)
    for p in model.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.3
    x = torch.randn(2, 5, 6, generator=g)
    lengths = torch.tensor([5, 3])
    with torch.no_grad():
        exported = torch.export.export(model, (x, lengths), strict=False)
        out = exported.module()(x, lengths)
        torch.testing.assert_close(out, model(x, lengths))
    ops = [n.target for n in exported.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.mmav.lstm_scan.default) == 3
    assert not any("sigmoid" in str(t) or "tanh" in str(t) for t in ops)


def test_fused_layer_is_one_input_product_and_the_operator():
    """The layer's output is the operator's over ``x W_ih^T`` of both
    directions, viewed as ``[B, T, 2H]``."""
    layer = BiLSTM(6, 4, 1).layers[0]
    g = torch.Generator().manual_seed(4)
    for p in layer.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.3
    x = torch.randn(3, 5, 6, generator=g)
    lengths = torch.tensor([5, 2, 4])
    with torch.no_grad():
        z = F.linear(x, layer.w_ih.flatten(0, 1)).view(3, 5, 2, 16)
        want = _flipped_reference(z, lengths, layer.w_hh, layer.b_hh).reshape(3, 5, 8)
        torch.testing.assert_close(layer(x, lengths), want)


@pytest.mark.parametrize("kind", ["forward", "backward"])
@pytest.mark.parametrize("R,H,elem,cs,in_smem", [
    (8, 512, 2, 16, True),       # a request's rows at the flagship's width, bf16
    (16, 512, 2, 16, True),      # a train_b8 step's
    (8, 512, 4, 16, False),      # f32: W_hh from L2
    (4, 16, 4, 1, False),
    (4, 16, 2, 1, True),         # small widths in bf16: one CTA
    (5, 96, 2, 1, True),
    (3, 1024, 2, 16, False),
])
def test_plan_fits_shared_memory_and_covers_every_unit(kind, R, H, elem, cs, in_smem):
    plan = ls.lstm_scan_plan(kind, R, H, elem)
    assert (plan["cs"], plan["w_in_smem"]) == (cs, in_smem)
    assert plan["smem_bytes"] <= ls.SMEM_LIMIT and plan["U"] % 16 == 0
    assert (plan["cs"] - 1) * plan["U"] < H <= plan["cs"] * plan["U"]
    assert plan["rows"] in (8, 16) and plan["groups"] * plan["rows"] >= R
    assert plan["scratch"] == 0 if in_smem else plan["scratch"] > 0


def test_plan_spreads_rows_over_clusters_within_64_ctas():
    """The flagship's rows go 8 a cluster while the clusters stay within 64
    CTAs (a train_b8 step's 16 rows: 2 groups a direction), and 16 a cluster
    past that."""
    assert ls.lstm_scan_plan("forward", 16, 512, 2)["groups"] == 2
    assert ls.lstm_scan_plan("forward", 32, 512, 2)["rows"] == 16
    big = ls.lstm_scan_plan("forward", 128, 512, 2)
    assert big["rows"] == 16 and big["groups"] == 8


def test_plan_refuses_a_width_no_cluster_holds():
    with pytest.raises(ValueError):
        ls.lstm_scan_plan("backward", 8, 1 << 16, 4)
    with pytest.raises(ValueError):
        ls.lstm_scan_plan("sideways", 8, 16, 4)

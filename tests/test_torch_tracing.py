"""The port's recorder (``tracing``): off, a span is the shared no-op and
nothing is recorded; on, the spans of a request and of a training step form
the tree of ``tracing``'s table under one unit id, counters go to the
innermost span of their thread, the spans are ranges of a profile, and the
serving export's graph is the same either way.  Then the benchmark's
reduction of a profiled stretch under the spans (``avbench/program.py``) and
the readers of the program's metrics, on hand-made events and records (CPU,
tiny widths)."""

import os
import threading

import numpy as np
import pytest
import torch

from avbench import harness, program, trace
from multimodal_av_model_tpu_torch import tracing
from multimodal_av_model_tpu_torch.config import Config
from multimodal_av_model_tpu_torch.data.collate import collate_pairs_raw, make_bucket_specs
from multimodal_av_model_tpu_torch.data.device_pipeline import device_preprocessed_batches
from multimodal_av_model_tpu_torch.infer import Transcriber, export_transcriber
from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel, init_weights
from multimodal_av_model_tpu_torch.text import CharTokenizer
from multimodal_av_model_tpu_torch.train.trainer import MultiSpeakerTrainer

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
MODEL = {"encoders.visual": "{fwd}", "encoders.audio": "{fwd}", "fusion": "{fwd}",
         "fusion.temporal": "fusion", "decoder": "{fwd}"}
PREPROCESS = {"preprocess": None, "preprocess.h2d": "preprocess",
              "preprocess.mix": "preprocess", "preprocess.lips": "preprocess"}


def _tiny_config() -> Config:
    cfg = Config()
    m = cfg.model
    m.audio.d_model, m.audio.num_layers, m.audio.num_heads = 32, 2, 2
    m.audio.ffn_dim, m.audio.conv_kernel_size, m.audio.middle_layers = 64, 7, (0, 1)
    m.audio.output_dim = 48
    m.visual.frontend_channels, m.visual.resnet_layers = 8, (1, 1, 1, 1)
    m.visual.resnet_channels, m.visual.output_dim, m.visual.norm = (8, 12, 16, 24), 24, "group"
    m.fusion.fused_dim, m.fusion.num_heads = 16, 2
    m.decoder.vocab_size, m.contrastive.projection_dim, m.dtype = 20, 8, "float32"
    return cfg


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    rng = np.random.default_rng(13)
    spec = make_bucket_specs((8,), 534, 6)[0]
    samples = [{
        "lip1_raw": rng.integers(0, 256, size=(t, 32, 32, 3), dtype=np.uint8),
        "lip2_raw": rng.integers(0, 256, size=(t, 32, 32, 3), dtype=np.uint8),
        "audio1": rng.standard_normal(t * 534).astype(np.float32),
        "audio2": rng.standard_normal(t * 400).astype(np.float32),
        "label1": [5, 6], "label2": [7],
    } for t in (8, 5)]
    cfg = _tiny_config()
    model = init_weights(MultiSpeakerAVModel(cfg.model), torch.Generator().manual_seed(0))
    t = Transcriber(cfg, CharTokenizer(VOCAB), model, device="cpu")
    return cfg, t, collate_pairs_raw(samples, spec)


@pytest.fixture
def recorder():
    tracing.enable("cpu")
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.collect()


def _preprocess(raw):
    (batch,) = device_preprocessed_batches([raw], out_size=24, device="cpu")
    return batch


def _tree(spans):
    """``{name: parent's name}`` and the count of each name."""
    by_id = {s["id"]: s for s in spans}
    parents = {s["name"]: by_id[s["parent"]]["name"] if s["parent"] is not None else None
               for s in spans}
    counts = {}
    for s in spans:
        counts[s["name"]] = counts.get(s["name"], 0) + 1
    return parents, counts


def test_off_spans_are_the_shared_no_op(tiny):
    _, t, raw = tiny
    assert not tracing.enabled()
    assert tracing.span("transcribe") is tracing.OFF and tracing.unit(3) is tracing.OFF
    tracing.count("host_syncs")
    assert len(t.transcribe(_preprocess(raw))) == 2
    assert tracing.collect() == []


def test_request_spans_form_the_tree_under_one_unit(tiny, recorder):
    _, t, raw = tiny
    with tracing.unit(5):
        texts = t.transcribe(_preprocess(raw))
    spans = tracing.collect()
    assert len(texts) == 2 and {s["unit"] for s in spans} == {5}
    parents, counts = _tree(spans)
    want = {**PREPROCESS, "transcribe": None, "transcribe.forward": "transcribe",
            "transcribe.decode": "transcribe", "transcribe.readback": "transcribe",
            **{k: v.format(fwd="transcribe.forward") for k, v in MODEL.items()}}
    assert parents == want
    assert counts["preprocess.h2d"] == 6 and counts["preprocess.lips"] == 2
    assert len(spans) == 19
    assert all(s["end_ns"] >= s["start_ns"] and s["device_ms"] is None for s in spans)


def test_step_spans_form_the_tree_under_one_unit(tiny, recorder):
    cfg, t, raw = tiny
    trainer = MultiSpeakerTrainer(cfg, t.model, None, device="cpu")
    state = trainer.init_state(0)
    with tracing.unit(0):
        _, metrics = trainer.train_step(state, _preprocess(raw))
    spans = tracing.collect()
    assert torch.isfinite(metrics["loss"]) and {s["unit"] for s in spans} == {0}
    parents, counts = _tree(spans)
    want = {**PREPROCESS, "train.step": None, "train.forward": "train.step",
            "train.losses": "train.step", "train.backward": "train.step",
            "train.optimizer": "train.step",
            **{k: v.format(fwd="train.forward") for k, v in MODEL.items()}}
    assert parents == want and len(spans) == 20
    step = next(s for s in spans if s["name"] == "train.step")
    phases = [s for s in spans if s["parent"] == step["id"]]
    assert [s["name"] for s in phases] == ["train.forward", "train.losses", "train.backward",
                                           "train.optimizer"]
    assert all(step["start_ns"] <= s["start_ns"] <= s["end_ns"] <= step["end_ns"]
               for s in phases)


def test_avhubert_step_spans_form_the_tree_under_one_unit(recorder):
    """AV-HuBERT keeps the shared names of the shared roles and adds
    ``encoders.layers`` around its transformer layers."""
    from test_torch_avhubert import LIP, MIX, tiny_config

    from avbench import traffic
    from multimodal_av_model_tpu_torch.models import build_av_model

    cfg = tiny_config()
    model = init_weights(build_av_model(cfg.model), torch.Generator().manual_seed(0))
    trainer = MultiSpeakerTrainer(cfg, model, None, device="cpu")
    state = trainer.init_state(0)
    raw = traffic.raw_batches(MIX, 3)[0]
    with tracing.unit(1):
        (batch,) = device_preprocessed_batches([raw], out_size=LIP, device="cpu")
        _, metrics = trainer.train_step(state, batch)
    spans = tracing.collect()
    assert torch.isfinite(metrics["loss"]) and {s["unit"] for s in spans} == {1}
    parents, _ = _tree(spans)
    model_spans = {"encoders.visual", "encoders.audio", "fusion", "encoders.layers", "decoder"}
    assert parents == {**PREPROCESS, "train.step": None, "train.forward": "train.step",
                       "train.losses": "train.step", "train.backward": "train.step",
                       "train.optimizer": "train.step",
                       **{k: "train.forward" for k in model_spans}}


def test_allreduce_span_wraps_the_gradient_average(recorder, monkeypatch):
    """``train.allreduce`` (``_average_grads``, a meshed step without FSDP):
    the flattening, the all-reduce and the copy back, once a call; here over
    a stand-in group of 2 whose all-reduce leaves the sum as it is."""
    calls = []
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, group=None: calls.append(t.numel()))
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    params = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2, 2))]
    for p in params:
        p.grad = torch.full_like(p, 4.0)
    with tracing.unit(2):
        MultiSpeakerTrainer._average_grads(params, group=None)
    spans = tracing.collect()
    assert [s["name"] for s in spans] == ["train.allreduce"] and calls == [7]
    assert all((p.grad == 2.0).all() for p in params)


def test_counters_go_to_the_innermost_span_of_their_thread(recorder):
    tracing.count("host_syncs")                       # outside every span: dropped
    seen = {}

    def worker():
        with tracing.span("worker"):
            tracing.count("host_syncs", 4)
            seen["parent"] = True

    with tracing.span("outer"):
        tracing.count("host_syncs")
        with tracing.span("inner"):
            tracing.count("host_syncs", 2)
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
        tracing.count("launches", 3)
    assert not th.is_alive() and seen
    spans = {s["name"]: s for s in tracing.collect()}
    assert spans["outer"]["counters"] == {"host_syncs": 1, "launches": 3}
    assert spans["inner"]["counters"] == {"host_syncs": 2}
    assert spans["worker"]["counters"] == {"host_syncs": 4}
    assert spans["worker"]["parent"] is None and spans["inner"]["parent"] == spans["outer"]["id"]
    rows = tracing.summary(list(spans.values()), units=2)
    assert rows["inner"]["host_syncs"] == 1 and rows["outer"]["n"] == 0.5


def test_a_count_for_another_thread_lands_in_its_innermost_span(recorder):
    """Autograd's device thread runs a CUDA backward, with no span of its own,
    while the caller waits inside ``train.backward``: a count made there for
    the caller's thread lands in that span.  A count from a thread with no
    open span, and one for a thread whose spans have closed, is dropped."""
    caller = threading.get_ident()

    def worker():
        tracing.count("lstm_kernel", 2, thread=caller)
        tracing.count("host_syncs", 1)

    with tracing.span("train.backward"):
        with tracing.span("inner"):
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=30)
    rows = {s["name"]: s["counters"] for s in tracing.collect()}
    assert rows == {"inner": {"lstm_kernel": 2}, "train.backward": {}}
    assert not tracing._open


def test_lstm_kernel_counts_under_the_temporal_span(tiny, recorder):
    """Each ``mmav::lstm_scan`` call counts 1 as ``lstm_kernel`` of the
    innermost span: a request's 2 BiLSTM layers under ``fusion.temporal``; a
    training step's 2 there and their 2 backward calls under
    ``train.backward``."""
    cfg, t, raw = tiny
    with tracing.unit(1):
        t.transcribe(_preprocess(raw))
    trainer = MultiSpeakerTrainer(cfg, t.model, None, device="cpu")
    state = trainer.init_state(0)
    with tracing.unit(2):
        trainer.train_step(state, _preprocess(raw))
    counted = {}
    for sp in tracing.collect():
        n = sp["counters"].get("lstm_kernel")
        if n:
            key = (sp["unit"], sp["name"])
            counted[key] = counted.get(key, 0) + n
    assert counted == {(1, "fusion.temporal"): 2, (2, "fusion.temporal"): 2,
                       (2, "train.backward"): 2}


def test_spans_are_ranges_of_a_profile(recorder):
    def run(i):
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)

    reduced, events = program.profile(run, 2, "cpu")
    ranges = [(n, s, e) for k, n, s, e in events if k == "span"]
    assert sorted(n for n, _, _ in ranges) == ["inner", "inner", "outer", "outer"]
    assert reduced["busy_s"] == 0 and "device_ops" in reduced
    rows = program.by_span(events, {"outer", "inner"})["spans"]
    assert rows["outer"]["n"] == 2 and rows["inner"]["ms"] <= rows["outer"]["ms"]
    assert len(tracing.collect()) == 4


def test_export_graph_is_the_same_with_the_recorder_on(tiny, tmp_path):
    _, t, raw = tiny
    batch = _preprocess(raw)
    off = export_transcriber(t, str(tmp_path / "off"), batch, use_beam=False)
    tracing.enable("cpu")
    try:
        on = export_transcriber(t, str(tmp_path / "on"), batch, use_beam=False)
        assert tracing.collect() == []
    finally:
        tracing.disable()
    assert on["nodes"] == off["nodes"]


def test_launches_and_idle_fall_under_their_spans():
    events = [("span", "train.step", 0.0, 100.0), ("span", "train.forward", 10.0, 45.0),
              ("span", "Optimizer.step#Adam.step", 0.0, 200.0),    # not the program's
              ("device", "k1", 20.0, 30.0), ("device", "k2", 25.0, 40.0),   # 20 busy
              ("device", "k3", 60.0, 70.0), ("device", "k4", 150.0, 160.0),
              ("host", "cudaLaunchKernel", 15.0, 16.0), ("host", "cuLaunchKernel", 55.0, 56.0),
              ("host", "cudaLaunchKernelExC", 120.0, 121.0), ("host", "aten::mm", 0.0, 5.0)]
    r = program.by_span(events, {"train.step", "train.forward"})
    assert r["launches"] == 3
    step, fwd = r["spans"]["train.step"], r["spans"]["train.forward"]
    assert step["launches"] == 2 and fwd["launches"] == 1
    assert step["idle_ms"] == pytest.approx((100 - 30) / 1e3)
    assert fwd["idle_ms"] == pytest.approx((35 - 20) / 1e3) and fwd["ms"] == pytest.approx(0.035)
    assert set(r["spans"]) == {"train.step", "train.forward"}
    # The gaps of reduce_profile, in its order, each under its innermost span.
    plain = trace.reduce_profile([e for e in events if e[0] != "span"], wall_s=200e-6)
    assert [g[1] for g in r["idle_gaps"]] == [g[1] for g in plain["idle_gaps"]]
    assert r["idle_gaps"] == [[program.OUTSIDE, pytest.approx(80e-6)],
                              ["train.step", pytest.approx(20e-6)]]


def _span(i, name, parent, device_ms, host_ms=1.0, counters=None):
    return {"id": i, "name": name, "parent": parent, "unit": 0, "start_ns": 0,
            "end_ns": int(host_ms * 1e6), "host_ms": host_ms, "device_ms": device_ms,
            "counters": counters or {}}


def test_program_readers_on_hand_made_records():
    window = [_span(0, "preprocess", None, 9.0, counters={}),
              _span(1, "preprocess.h2d", 0, 1.0, host_ms=3.0, counters={"host_syncs": 1}),
              _span(2, "preprocess.h2d", 0, 1.0, host_ms=5.0, counters={"host_syncs": 1}),
              _span(3, "train.step", None, 100.0),
              _span(4, "train.forward", 3, 30.0), _span(5, "train.losses", 3, 4.0,
                                                        counters={"host_syncs": 4}),
              _span(6, "train.backward", 3, 50.0), _span(7, "train.optimizer", 3, 12.0)]
    prog = {"window": window, "profiled": [], "profiled_units": 2, "launches": 35000,
            "spans": {"transcribe.decode": {"n": 2, "ms": 400.0, "launches": 9000,
                                            "idle_ms": 340.0}}, "idle_gaps": []}
    rec = {"kind": "train", "units": 2, "program": prog}
    read = harness.read_metric
    assert read({"name": "forward_ms.train"}, rec) == pytest.approx(15.0)
    assert read({"name": "losses_ms.train"}, rec) == pytest.approx(2.0)
    assert read({"name": "backward_ms.train"}, rec) == pytest.approx(25.0)
    assert read({"name": "optimizer_ms.train"}, rec) == pytest.approx(6.0)
    assert read({"name": "h2d_ms.train"}, rec) == pytest.approx(4.0)
    assert read({"name": "host_syncs.train"}, rec) == pytest.approx(3.0)
    assert read({"name": "kernel_launches.train"}, rec) == pytest.approx(17500.0)
    assert read({"name": "h2d_ms.transcribe"}, rec) is None              # another kind
    assert read({"name": "decode_idle.transcribe"}, dict(rec, kind="transcribe")) == \
        pytest.approx(85.0)
    assert read({"name": "decode_idle.transcribe"}, rec) is None
    # Without CUDA events (the CPU) a device time reads nothing.
    cpu = dict(rec, program=dict(prog, window=[dict(s, device_ms=None) for s in window]))
    assert read({"name": "forward_ms.train"}, cpu) is None
    assert read({"name": "h2d_ms.train"}, cpu) == pytest.approx(4.0)
    # A run whose program has no recorder (the parent's) reads nothing, and raises nothing.
    bare = {"kind": "train", "units": 2, "spans": {}, "window_s": 1.0}
    for name, _ in program.METRICS["train"]:
        assert read({"name": name}, bare) is None

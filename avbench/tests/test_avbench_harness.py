"""The harness: cells, configurations, mixes, runners, limits and metric
readers found by name; the manifest within the benchmark's contract; the
end-to-end and per-layer arithmetic on synthetic records."""

from __future__ import annotations

import importlib
import json
import os
import re
import statistics

import pytest
import torch

from avbench import harness, trace, traffic
from avbench.runners import transcribe

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["avbench"] and 1 <= MAN["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MAN[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("avbench/") and os.path.isfile(
            os.path.join(harness.ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_cell_found_by_name(workload):
    cell = harness.Cell.find(workload)
    assert cell.config["name"] == cell.entry["config"]
    runner = importlib.import_module(f"avbench.runners.{cell.mix['runner']}")
    assert runner.KIND == cell.mix["runner"]
    assert set(cell.limits["limits"]) and all(v >= 0 for v in cell.limits["limits"].values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        family = m["name"].split(".")[0]
        assert hasattr(importlib.import_module(f"avbench.metrics.{family}"), "read")
    cfg = harness.program_config(cell.config, cell.mix)
    assert cfg.model.fusion.temporal_model == cell.config["model"]["fusion"]["temporal_model"]
    assert cfg.model.visual.remat == cell.mix["settings"]["model.visual.remat"] \
        if "model.visual.remat" in cell.mix["settings"] else True


@pytest.mark.parametrize("mix", ["train_b8", "transcribe_b4"])
def test_traffic_same_sizes_for_every_seed(mix):
    m = dict(traffic.load(mix), pool=2, crop=8)
    a, b = traffic.raw_batches(m, 1), traffic.raw_batches(m, 2**31 + 5)
    for key in ("lip1_lengths", "lip2_lengths", "audio1_len", "audio2_len", "text1_lengths"):
        assert sorted(x for r in a for x in r[key]) == sorted(x for r in b for x in r[key])
    again = traffic.raw_batches(m, 1)
    assert all((x["audio1"] == y["audio1"]).all() and (x["lip2_raw"] == y["lip2_raw"]).all()
               for x, y in zip(a, again))


def test_percentile_and_rates():
    lat = [0.1 * (i + 1) for i in range(10)]
    assert transcribe.percentile(lat, 90) == pytest.approx(statistics.quantiles(
        lat, n=10, method="inclusive")[-1])

    class Fake:
        mix = {"batch": 4}
    e2e = transcribe.Job.end_to_end(Fake(), lat, 5.5)
    assert e2e["transcribe_utt_per_s"] == pytest.approx(40 / 5.5)
    assert e2e["transcribe_p90_ms"] == pytest.approx(1e3 * transcribe.percentile(lat, 90))


def test_lp_bias_keeps_a_shift_of_a_token_and_averages_noise_out():
    g = torch.Generator().manual_seed(0)
    ref = {0: {"lp": torch.randn(4, 500, 6, generator=g), "len": torch.tensor([500, 400, 0, 9])}}
    noise = {0: {**ref[0], "lp": ref[0]["lp"] + 0.01 * torch.randn(4, 500, 6, generator=g)}}
    shift = {0: {**ref[0], "lp": ref[0]["lp"] + torch.tensor([0.01, 0, 0, 0, 0, 0])}}
    n, s = transcribe.lp_stats(noise, ref), transcribe.lp_stats(shift, ref)
    assert n["lp_rms"] == pytest.approx(0.01, rel=0.05) and n["lp_bias"] < 0.001
    assert s["lp_err"] == pytest.approx(0.01, rel=1e-4)
    assert s["lp_bias"] == pytest.approx(0.01 / 6 ** 0.5, rel=1e-3)


def test_idle_share_is_a_union_of_intervals():
    events = [("device", "a", 0.0, 100.0), ("device", "b", 50.0, 150.0),   # overlap: 150 busy
              ("device", "logmel_kernel", 300.0, 320.0),
              ("host", "aten::big", 0.0, 400.0), ("host", "aten::sync", 160.0, 290.0)]
    r = trace.reduce_profile(events, wall_s=400e-6)
    assert r["busy_s"] == pytest.approx(170e-6)
    assert r["idle_gaps"] == [["aten::sync", pytest.approx(150e-6)]]
    assert r["device_ops"][0] == ["a", pytest.approx(100e-6)]
    assert r["kernels"]["logmel_kernel"] == [pytest.approx(20e-6)]
    records = {"kind": "train", "units": 2, "window_s": 1.0, "spans": {"preprocess": [0.01, 0.03]},
               "flops_per_unit": 989e9, "trace": r,
               "kernel_work": {"logmel_kernel": (0.0, 3.35e12 * 10e-6)}}
    read = harness.read_metric
    assert read({"name": "device_idle.train"}, records) == pytest.approx(100 * (1 - 170 / 400))
    assert read({"name": "device_idle.transcribe"}, records) is None
    assert read({"name": "preprocess_ms.train"}, records) == pytest.approx(20.0)
    assert read({"name": "mfu.train"}, records) == pytest.approx(0.2)
    assert read({"name": "k1_roofline.train"}, records) == pytest.approx(50.0)
    assert read({"name": "k2_launch_us.train"}, records) is None         # no launch seen
    assert read({"name": "decode_ms.train"}, records) is None

"""One run of one cell: set-up, the measured window, the traced stretch, the check.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration file (``file``), its traffic file
(``avbench/traffic/<traffic>.json``), whose ``runner`` names a module of
``avbench/runners``, its limits (``avbench/limits/<cell>.json``), and for
each per-layer metric a reader, ``avbench/metrics/<name before the dot>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
import time

import numpy as np

from . import traffic as traffic_mod
from . import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "avbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_av_model_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """A cell resolved from the manifest: its entries and files."""

    name: str
    entry: dict
    config: dict          # the configuration file
    mix: dict             # the traffic file
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def find(cls, name: str, man: dict | None = None) -> "Cell":
        man = man or manifest()
        cells = {w["name"]: w for w in man["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
        entry = cells[name]
        cfg_entry = {c["name"]: c for c in man["configs"]}[entry["config"]]
        e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in man["per_layer"]
                     if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        return cls(name, entry, load_json(os.path.join(ROOT, cfg_entry["file"])),
                   traffic_mod.load(entry["traffic"]),
                   load_json(os.path.join(HERE, "limits", name + ".json")), e2e, per_layer)


def program_config(config: dict, mix: dict):
    """The system's ``Config`` as the configuration file and the traffic's
    settings state it."""
    from multimodal_av_model_tpu_torch.config import Config

    cfg = Config()

    def put(obj, path, value):
        *parents, leaf = path.split(".")
        for p in parents:
            obj = getattr(obj, p)
        if not hasattr(obj, leaf):
            raise KeyError(f"unknown configuration field {path}")
        if isinstance(getattr(obj, leaf), tuple) and isinstance(value, list):
            value = tuple(value)
        setattr(obj, leaf, value)

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            else:
                put(cfg, prefix + k, v)

    for part in ("model", "train", "decode", "data"):
        walk(part + ".", config.get(part, {}))
    for path, value in mix.get("settings", {}).items():
        put(cfg, path, value)
    return cfg


def model_dict(config: dict, mix: dict) -> dict:
    """The configuration file's model tree with the traffic's model settings."""
    tree = json.loads(json.dumps(config["model"]))
    for path, value in mix.get("settings", {}).items():
        parts = path.split(".")
        if parts[0] == "model":
            node = tree
            for p in parts[1:-1]:
                node = node[p]
            node[parts[-1]] = value
    return tree


@dataclasses.dataclass
class Context:
    """What a runner gets."""

    cell: Cell
    seed: int
    device: str
    config: object            # the system's Config
    model: dict               # the configuration's model tree (for the reference)
    train: dict
    decode: dict
    vocab_path: str

    @property
    def mix(self) -> dict:
        return self.cell.mix

    @property
    def dropout_seed(self) -> int:
        return self.seed ^ 0xD20F


def process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def make_context(cell: Cell, seed: int, device: str) -> Context:
    cfg = program_config(cell.config, cell.mix)
    return Context(cell, seed, device, cfg, model_dict(cell.config, cell.mix),
                   cell.config["train"], cell.config["decode"],
                   os.path.join(ROOT, cell.config["data"]["vocab_path"]))


def read_metric(metric: dict, records: dict):
    family, _, kind = metric["name"].partition(".")
    reader = importlib.import_module(f"avbench.metrics.{family}")
    return reader.read(records, kind or None)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
        t_start: float | None = None) -> dict:
    """One run -> the result line's dict (without ``device``)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    phases = {"start": time.perf_counter() - t_start}
    ctx = make_context(cell, seed, device)
    runner = importlib.import_module(f"avbench.runners.{cell.mix['runner']}")
    job = runner.Job(ctx)
    phases["build"] = time.perf_counter() - t_start - sum(phases.values())
    job.warm_up()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    phases["warm_up"] = setup_s - sum(phases.values())

    spans = trace.Spans(device) if traced else None
    if traced:
        job.attach(spans)
    lat, i = [], job.next_unit
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        u0 = time.perf_counter()
        job.unit(i, spans)
        lat.append(time.perf_counter() - u0)
        i += 1
    job.sync()
    window_s = time.perf_counter() - t0
    records = {"kind": runner.KIND, "units": len(lat), "window_s": window_s,
               "spans": {}, "flops_per_unit": job.flops_per_unit(),
               "kernel_work": job.kernel_work()}
    if traced:
        spans.close()
        records["spans"] = dict(spans.seconds)
        prof = trace.profile(lambda k: job.unit(i + k, None), cell.mix["profiled_units"], device)
        records["trace"] = prof
    launches = job.launches()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {found}")

    e2e_values = job.end_to_end(lat, window_s)
    e2e_values["setup_s"] = setup_s
    checks = job.check()
    metrics = {}
    wanted = cell.per_layer if traced else cell.end_to_end
    for m in wanted:
        value = read_metric(m, records) if traced else e2e_values.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cell.limits["limits"]
    correct = set(limits) <= set(checks) and all(checks[k] <= limits[k] for k in limits)
    failed = job.failed_units
    out = {"correct": bool(correct and failed == 0), "attempted": len(lat),
           "failed": failed, "metrics": metrics, "peak": peak, "launches": launches,
           "units": len(lat), "window_s": window_s, "setup_phases_s": phases,
           "unit_ms": {q: 1e3 * float(np.percentile(lat, q)) for q in (10, 50, 90)} if lat else {}}
    if traced:
        out["trace"] = {k: records["trace"][k] for k in ("busy_s", "window_s")}
        out["breakdown"] = {k: records["trace"][k] for k in ("device_ops", "idle_gaps")}
    out["detail"] = getattr(job, "detail", None)
    out["checks"] = {k: {"value": checks[k], "limit": limits.get(k)} for k in checks}
    return out


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None

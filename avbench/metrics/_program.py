"""Shared by the readers of the program's own spans (``avbench/program.py``,
``multimodal_av_model_tpu_torch/tracing.py``): ``records["program"]`` holds
the window's spans (``window``, over ``records["units"]``) and the profiled
stretch's spans and reduction (``profiled``, ``profiled_units``,
``launches``, ``spans`` by name, ``idle_gaps``).  Each reader returns None
where the run is of another kind or the program recorded nothing."""


def program(records: dict, kind: str | None):
    prog = records.get("program")
    return prog if prog and kind == records["kind"] and records["units"] else None


def window_per_unit(records: dict, kind: str | None, name: str, field: str):
    """Sum of ``field`` (``host_ms``, ``device_ms``) of the window's spans
    named ``name``, per unit."""
    prog = program(records, kind)
    values = [s[field] for s in prog["window"] if s["name"] == name] if prog else []
    if not values or any(v is None for v in values):
        return None
    return sum(values) / records["units"]


def counter_per_unit(records: dict, kind: str | None, counter: str):
    """A counter summed over every span of the window, per unit."""
    prog = program(records, kind)
    if not prog or not prog["window"]:
        return None
    return sum(s["counters"].get(counter, 0) for s in prog["window"]) / records["units"]

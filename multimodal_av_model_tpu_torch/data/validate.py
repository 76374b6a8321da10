"""Up-front manifest validation with structured skip-lists.

Own copy of ``multimodal_av_model_tpu/data/validate.py``: every manifest
entry gets a verdict and a reason once, before training, so bad data is
visible and the steady-state sampler never throws.  Reasons (the part before
``:`` is the kind ``summary`` counts): ``bad_times``, ``too_long``,
``missing_text``, ``missing_lip``, ``missing_audio`` and, with
``check_lip_contents``, ``unreadable_lip`` and ``bad_lip_shape``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ValidationReport:
    ok: list = field(default_factory=list)
    skipped: list = field(default_factory=list)        # (entry, reason)

    @property
    def num_ok(self) -> int:
        return len(self.ok)

    def summary(self) -> str:
        reasons: dict[str, int] = {}
        for _, reason in self.skipped:
            kind = reason.split(":")[0]
            reasons[kind] = reasons.get(kind, 0) + 1
        return (f"{self.num_ok} usable / {len(self.skipped)} skipped"
                + (f" ({reasons})" if reasons else ""))


def validate_entry(entry, check_lip_contents: bool = False,
                   max_duration_s: float = 30.0) -> str | None:
    """A reason string if the entry should be skipped, else None
    (``validate.py:39-60``)."""
    if entry.duration <= 0:
        return f"bad_times: start={entry.start_time} end={entry.end_time}"
    if entry.duration > max_duration_s:
        return f"too_long: {entry.duration:.1f}s"
    if not os.path.exists(entry.text_path):
        return f"missing_text: {entry.text_path}"
    if not os.path.exists(entry.lip_path):
        return f"missing_lip: {entry.lip_path}"
    if not os.path.exists(entry.audio_path):
        return f"missing_audio: {entry.audio_path}"
    if check_lip_contents:
        try:
            lip = np.load(entry.lip_path, mmap_mode="r")
        except Exception as e:
            return f"unreadable_lip: {type(e).__name__}"
        if lip.ndim not in (3, 4) or lip.shape[0] == 0:
            return f"bad_lip_shape: {lip.shape}"
    return None


def validate_manifest(entries, check_lip_contents: bool = False) -> ValidationReport:
    report = ValidationReport()
    for entry in entries:
        reason = validate_entry(entry, check_lip_contents)
        if reason is None:
            report.ok.append(entry)
        else:
            report.skipped.append((entry, reason))
    return report

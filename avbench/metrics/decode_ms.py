"""The decode (infer.py:decode_ids, ops/prefix_beam_search.py, the readback and
the texts): host clock from the synchronised end of the model's forward to the
texts, ms per request."""

from ._spans import per_unit_ms


def read(records: dict, kind: str | None):
    return per_unit_ms(records, "decode", kind)

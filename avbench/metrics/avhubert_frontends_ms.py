"""AV-HuBERT's front ends, forward: the visual encoder (models/visual.py, the
ResNet-18 trunk and its projection), the audio front end (K1 at 26 bins,
stacking, normalisation, projection) and the fusion with the positional
convolution (models/avhubert.py).  Device-stream time between CUDA events
from forward hooks on the three modules, summed, ms per training step."""

from ._spans import per_unit_ms


def read(records: dict, kind: str | None):
    return per_unit_ms(records, "avhubert_frontends", kind)

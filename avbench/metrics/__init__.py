"""Per-layer metric readers: ``read(records, kind)`` -> a number or None."""

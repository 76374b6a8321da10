"""Serving-side data path: bucketed raw collation and on-device preprocessing."""

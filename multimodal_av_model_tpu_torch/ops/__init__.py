"""Compute primitives: the log-mel (K1) and lip-preprocess (K2) kernels with
their plain versions, CTC collapse/greedy decode and prefix beam search."""

"""Synthetic workloads of the paper's experiments and the LM token
pipeline (mirrors ``repro.data``)."""

"""Synthetic workloads of the paper's experiments (mirrors ``repro.data``)."""

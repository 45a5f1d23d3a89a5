"""Quickstart: communication-efficient distributed PCA in ~40 lines (port
of ``examples/quickstart.py``).

Reproduces the paper's headline result on a synthetic problem: Algorithm 1
(Procrustes fixing) matches the centralized estimator, while naive
averaging collapses.  The m = 8 machines are stacked in one process.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``REPRO_QUICKSTART_SCALE=tiny`` runs a seconds-scale version of the same
script.
"""

import argparse
import os

import torch

from repro_torch.core import (
    central_estimate,
    dist_2,
    distributed_pca,
    empirical_covariance,
    local_bases,
    naive_average,
)
from repro_torch.data import synthetic as syn
from repro_torch.interop import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).device)
    if os.environ.get("REPRO_QUICKSTART_SCALE") == "tiny":
        d, r, n_per_machine = 64, 4, 128
    else:
        d, r, n_per_machine = 300, 8, 400  # the paper's Section 3.1 scale
    m = 8
    print(f"machines: {m} x {n_per_machine} samples, d={d}, r={r}, device={dev}")

    gen = torch.Generator(device=dev).manual_seed(0)
    tau = syn.spectrum_m1(d, r, delta=0.2, device=dev)  # eigengap exactly 0.2 (M1)
    _, u, factor = syn.covariance_from_spectrum(tau, generator=gen)
    v_true = u[:, :r]
    samples = syn.sample_shards(factor, n_per_machine, seed=0, shards=m)

    # The paper's algorithm; plan="auto" lets the cost-model planner
    # (repro_torch.plan) pick the backend/polar/orth cell for this (m, d, r).
    v_aligned = distributed_pca(samples, r, shards=m, device=dev, n_iter=1, plan="auto")
    v_refined = distributed_pca(samples, r, shards=m, device=dev, n_iter=5, plan="auto")

    covs = torch.stack([empirical_covariance(x)
                        for x in samples.reshape(m, n_per_machine, d)])
    v_central, _ = central_estimate(covs, r)
    v_naive = naive_average(local_bases(covs, r))

    print(f"dist(central, truth)   = {float(dist_2(v_central, v_true)):.4f}")
    print(f"dist(Alg 1,   truth)   = {float(dist_2(v_aligned, v_true)):.4f}")
    print(f"dist(Alg 2,   truth)   = {float(dist_2(v_refined, v_true)):.4f}")
    print(f"dist(naive,   truth)   = {float(dist_2(v_naive, v_true)):.4f}   <- collapses")


if __name__ == "__main__":
    main()

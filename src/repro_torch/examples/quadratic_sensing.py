"""Paper §3.7: distributed spectral initialization for quadratic sensing
(port of ``examples/quadratic_sensing.py``).

Measurements y_i = ||X#^T a_i||^2 are split over m = 8 machines (stacked
in one process); each forms the truncated second-moment matrix D_N and
Algorithm 2 combines the local eigenspaces (n_iter=10, as in Fig. 10).

Run:  PYTHONPATH=src python -m repro_torch.examples.quadratic_sensing [--device cpu]
"""

import argparse

import torch

from repro_torch.data import synthetic as syn
from repro_torch.interop import resolve_device
from repro_torch.optim.spectral_init import distributed_spectral_init


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).device)
    d, r, m = 100, 5, 8
    gen = torch.Generator(device=dev).manual_seed(0)

    # ground truth X# with orthonormal columns
    x_sharp = torch.linalg.qr(torch.randn((d, r), generator=gen, device=dev))[0]

    for i in (1, 2, 4, 8):
        n = i * r * d  # per-machine samples, as in Fig. 10's x-axis
        a, y = syn.quadratic_sensing_measurements(x_sharp, m * n, generator=gen)
        x0 = distributed_spectral_init(a, y, r, shards=m, device=dev, n_iter=10)
        # distance used in the paper: ||(I - X# X#^T) X0||_2
        resid = x0 - x_sharp @ (x_sharp.T @ x0)
        err = float(torch.linalg.matrix_norm(resid, ord=2))
        print(f"n = {i}·r·d = {n:6d} per machine ({m} machines): "
              f"||(I-P)X0||_2 = {err:.4f}")


if __name__ == "__main__":
    main()

"""Distributed-PCA launcher of the port (counterpart of
``repro/launch/eigen.py``).

``python -m repro_torch.launch.eigen --d 512 --r 16 --n-per-shard 2048``

Draws (M1) Gaussian data from a seed, runs Procrustes-fixed distributed
PCA over ``--shards`` machines stacked on one device, and prints the same
keys as the reference: the resolved knobs and the subspace distances of
the distributed, centralized, naive and first-local estimates to the
truth, plus the wall time of the distributed estimate.  ``--device``
defaults to the card; ``--backend auto`` runs the CUDA kernels there.

Flags of later slices of the port are refused and name their ROADMAP
item (the planner, quantized wires, pods, the elastic runtime, streaming).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import (
    central_estimate,
    dist_2,
    distributed_pca,
    empirical_covariance,
    local_bases,
    naive_average,
)
from repro_torch.core.distributed import TOPOLOGY_CHOICES, resolve_topology
from repro_torch.core.orthonorm import ORTH_METHODS
from repro_torch.core.procrustes import POLAR_METHODS
from repro_torch.data import synthetic as syn
from repro_torch.interop import resolve_device, strict_fp32
from repro_torch.kernels.ops import BACKENDS, resolve_backend

# Reference flags that belong to later slices, with their ROADMAP item.
_LATER_FLAGS = {
    "--plan": ("A7", 1),
    "--explain": ("A7", 0),
    "--calibrate": ("A7", 1),
    "--comm-bits": ("A5", 1),
    "--pods": ("A5", 1),
    "--fail-at": ("A8", 1),
    "--stream": ("A9", 1),
    "--cadence": ("A9", 1),
}


def run(
    d: int = 256,
    r: int = 8,
    n_per_shard: int = 1024,
    *,
    shards: int = 8,
    delta: float = 0.2,
    n_iter: int = 2,
    solver: str = "subspace",
    iters: int = 40,
    seed: int = 0,
    device: str | torch.device = "cuda",
    backend: str | None = None,
    polar: str | None = None,
    orth: str | None = None,
    topology: str | None = None,
):
    """Draw the data, run the estimate, and return (v_dist, stats)."""
    dev = resolve_device(device)
    strict_fp32()
    gen = torch.Generator(device=dev).manual_seed(seed)
    tau = syn.spectrum_m1(d, r, delta=delta, device=dev)
    _, u, factor = syn.covariance_from_spectrum(tau, generator=gen)
    v1 = u[:, :r]
    samples = syn.sample_gaussian(factor, shards * n_per_shard, generator=gen)

    backend = resolve_backend(backend or "torch", dev)
    t0 = time.perf_counter()
    v_dist = distributed_pca(
        samples, r, shards=shards, device=dev, n_iter=n_iter, solver=solver,
        iters=iters, backend=backend, polar=polar, orth=orth,
        topology=topology,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_dist = time.perf_counter() - t0

    xs = samples.reshape(shards, n_per_shard, d)
    covs = torch.stack([empirical_covariance(x) for x in xs])
    v_cent, _ = central_estimate(covs, r)
    vs = local_bases(covs, r)
    stats = {
        "m": shards,
        "n": n_per_shard,
        "d": d,
        "r": r,
        "backend": backend,
        "polar": polar or "svd",
        "orth": orth or "qr",
        "topology": resolve_topology(topology),
        "dist_aligned": float(dist_2(v_dist, v1)),
        "dist_central": float(dist_2(v_cent, v1)),
        "dist_naive": float(dist_2(naive_average(vs), v1)),
        "dist_local0": float(dist_2(vs[0], v1)),
        "wall_s": t_dist,
    }
    return v_dist, stats


class _Later(argparse.Action):
    """Refuse a flag that belongs to a later slice of the port."""

    def __call__(self, parser, namespace, values, option_string=None):
        item = _LATER_FLAGS[option_string][0]
        parser.error(
            f"{option_string} is not ported yet (ROADMAP {item}); this "
            "slice runs the stacked gather path with explicit knobs"
        )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.eigen")
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--r", type=int, default=8)
    ap.add_argument("--n-per-shard", type=int, default=1024)
    ap.add_argument("--n-iter", type=int, default=2)
    ap.add_argument("--solver", default="subspace", choices=["subspace", "eigh"])
    ap.add_argument("--backend", default="auto", choices=BACKENDS,
                    help="plain PyTorch, the hand-written CUDA kernels, or "
                         "auto (the kernels on a CUDA device)")
    ap.add_argument("--polar", default=None, choices=POLAR_METHODS,
                    help="r x r polar factor: SVD (default) or Newton-Schulz "
                         "(fused into the Gram kernel under cuda)")
    ap.add_argument("--orth", default=None, choices=ORTH_METHODS,
                    help="per-round orthonormalization (default qr); "
                         "cuda + newton-schulz + cholesky-qr2 is ROADMAP B5")
    ap.add_argument("--topology", default="auto", choices=TOPOLOGY_CHOICES,
                    help="gather (auto) stacks the m bases on one device; "
                         "psum, ring and hier are ROADMAP A5")
    ap.add_argument("--shards", type=int, default=8,
                    help="machines m: equal row blocks of the samples")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    for flag, (_, nargs) in _LATER_FLAGS.items():
        ap.add_argument(flag, nargs=nargs, action=_Later, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    try:
        resolve_topology(args.topology)
    except NotImplementedError as exc:
        ap.error(str(exc))
    _, stats = run(
        args.d, args.r, args.n_per_shard, shards=args.shards,
        n_iter=args.n_iter, solver=args.solver, device=args.device,
        backend=args.backend, polar=args.polar, orth=args.orth,
        topology=args.topology,
    )
    for k, v in stats.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()

"""Distributed-PCA launcher of the port (counterpart of
``repro/launch/eigen.py``).

One process, the m shards stacked on one device (gather schedule)::

    python -m repro_torch.launch.eigen --d 512 --r 16 --n-per-shard 2048

One shard per rank, any topology, under ``torchrun``::

    torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.eigen \\
        --device cuda --topology ring --polar newton-schulz --orth cholesky-qr2 \\
        --dim 512 --subspace-rank 16

(``--dim``/``--subspace-rank`` are ``--d``/``--r`` in a spelling that
``torchrun``'s parser leaves to the script.)

Draws (M1) Gaussian data from a seed, runs Procrustes-fixed distributed
PCA, and prints the reference's keys: the resolved knobs and the subspace
distances of the distributed, centralized, naive and first-local
estimates to the truth, plus the wall time of the distributed estimate.
Shard k's rows come from a generator seeded from (seed, k)
(``synthetic.sample_shard``), so both forms estimate from the same data.
Under ``torchrun`` rank 0 prints, adding the rank count, the transport
rule (``launch.mesh.transport_rule``) and the bytes staged through host
memory.  ``--device`` defaults to the card; ``--backend auto`` runs the
CUDA kernels there.

Flags of later slices of the port are refused and name their ROADMAP
item (the planner, pods and the hier topology, the elastic runtime,
streaming).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.comm import transport
from repro_torch.comm.quantize import resolve_comm_bits
from repro_torch.comm.topology import TOPOLOGY_CHOICES, resolve_topology
from repro_torch.core import (
    central_estimate,
    dist_2,
    distributed_pca,
    distributed_pca_collective,
    empirical_covariance,
    local_bases,
    naive_average,
)
from repro_torch.core.distributed import resolve_stacked_topology
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
    "--pods": ("A5-hier", 1),
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
    comm_bits=None,
    agg=None,
):
    """Draw the data, run the estimate, and return (v_dist, stats).

    ``agg`` (a ``launch.mesh.AggregationGroup``) runs the collective form,
    this rank on shard ``agg.rank`` of ``agg.world``; without it the
    ``shards`` shards are stacked in this process.  Under ``agg`` only
    rank 0 returns stats (None elsewhere): it regenerates every shard
    from the data rule for the centralized, naive and local baselines."""
    dev = agg.device if agg is not None else resolve_device(device)
    strict_fp32()
    gen = torch.Generator(device=dev).manual_seed(seed)
    tau = syn.spectrum_m1(d, r, delta=delta, device=dev)
    _, u, factor = syn.covariance_from_spectrum(tau, generator=gen)
    v1 = u[:, :r]
    backend = resolve_backend(backend or "torch", dev)
    bits = resolve_comm_bits(comm_bits)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if agg is None:
        topo = resolve_stacked_topology(topology)
        if bits != 32:
            raise ValueError(
                "comm_bits below 32 quantizes a wire, and the stacked form has "
                "none: run the launcher under torchrun"
            )
        samples = syn.sample_shards(factor, n_per_shard, seed=seed, shards=shards)
        t0 = time.perf_counter()
        v_dist = distributed_pca(
            samples, r, shards=shards, device=dev, n_iter=n_iter,
            solver=solver, iters=iters, backend=backend, polar=polar,
            orth=orth, topology=topo,
        )
        sync()
        t_dist = time.perf_counter() - t0
    else:
        topo = resolve_topology(topology, backend)
        shards = agg.world
        x = syn.sample_shard(factor, n_per_shard, seed=seed, shard=agg.rank)
        transport.reset_staged_bytes()
        sync()
        t0 = time.perf_counter()
        v_dist = distributed_pca_collective(
            x, r, group=agg.group, device=dev, n_iter=n_iter, solver=solver,
            iters=iters, backend=backend, polar=polar, orth=orth,
            topology=topo, comm_bits=bits,
        )
        sync()
        t_dist = time.perf_counter() - t0
        if agg.rank != 0:
            return v_dist, None
        samples = syn.sample_shards(factor, n_per_shard, seed=seed, shards=shards)

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
        "topology": topo,
        "comm_bits": bits,
        "dist_aligned": float(dist_2(v_dist, v1)),
        "dist_central": float(dist_2(v_cent, v1)),
        "dist_naive": float(dist_2(naive_average(vs), v1)),
        "dist_local0": float(dist_2(vs[0], v1)),
        "wall_s": t_dist,
    }
    if agg is not None:
        stats["ranks"] = agg.world
        stats["transport"] = agg.rule
        stats["staged_bytes"] = transport.staged_bytes()
    return v_dist, stats


class _Later(argparse.Action):
    """Refuse a flag that belongs to a later slice of the port."""

    def __call__(self, parser, namespace, values, option_string=None):
        item = _LATER_FLAGS[option_string][0]
        parser.error(f"{option_string} is not ported yet (ROADMAP {item})")


def _under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def build_parser() -> argparse.ArgumentParser:
    """The launcher's flags.  ``--dim`` and ``--subspace-rank`` spell
    ``--d`` and ``--r`` in a form that ``torchrun``'s own parser cannot
    take for an abbreviation of one of its options (some torchrun
    versions read "--d" and "--r" as ambiguous prefixes and exit)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.eigen")
    ap.add_argument("--d", "--dim", dest="d", type=int, default=256,
                    help="ambient dimension d (under torchrun spell it --dim)")
    ap.add_argument("--r", "--subspace-rank", dest="r", type=int, default=8,
                    help="subspace rank r (under torchrun spell it "
                         "--subspace-rank)")
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
                    help="per-round orthonormalization (default qr); with "
                         "cuda and newton-schulz, cholesky-qr2 runs each "
                         "round as one fused kernel launch")
    ap.add_argument("--topology", default="auto", choices=TOPOLOGY_CHOICES,
                    help="psum, gather or ring across the ranks (under "
                         "torchrun); one process stacks the shards (gather); "
                         "auto: gather under cuda, else psum; hier is "
                         "ROADMAP A5-hier")
    ap.add_argument("--comm-bits", default=None, choices=("32", "16", "8", "auto"),
                    help="wire precision of the collectives under torchrun: "
                         "32 exact, 16 bf16, 8 stochastic int8 with error "
                         "feedback (auto needs the planner, ROADMAP A7)")
    ap.add_argument("--shards", type=int, default=None,
                    help="machines m in one process (default 8); under "
                         "torchrun the world size")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    for flag, (_, nargs) in _LATER_FLAGS.items():
        ap.add_argument(flag, nargs=nargs, action=_Later, help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        resolve_comm_bits(args.comm_bits)
        if args.topology == "hier":
            resolve_topology("hier")
    except NotImplementedError as exc:
        ap.error(str(exc))
    agg = None
    if _under_torchrun():
        from repro_torch.launch.mesh import make_aggregation_mesh

        agg = make_aggregation_mesh(device=args.device)
        if args.shards not in (None, agg.world):
            ap.error(f"--shards {args.shards} under torchrun with {agg.world} ranks")
    elif args.topology in ("psum", "ring"):
        ap.error(f"--topology {args.topology} runs across ranks: start the "
                 "launcher under torchrun")
    elif args.comm_bits not in (None, "32"):
        ap.error("--comm-bits below 32 quantizes a wire: start the launcher "
                 "under torchrun")
    try:
        _, stats = run(
            args.d, args.r, args.n_per_shard, shards=args.shards or 8,
            n_iter=args.n_iter, solver=args.solver, device=args.device,
            backend=args.backend, polar=args.polar, orth=args.orth,
            topology=args.topology, comm_bits=args.comm_bits, agg=agg,
        )
    finally:
        if agg is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    for k, v in (stats or {}).items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()

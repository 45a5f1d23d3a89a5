"""Distributed-PCA launcher of the port (counterpart of
``repro/launch/eigen.py``).

One process, the m shards stacked on one device (gather schedule)::

    python -m repro_torch.launch.eigen --d 512 --r 16 --n-per-shard 2048

One shard per rank, any topology, under ``torchrun``::

    torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.eigen \\
        --device cuda --topology ring --polar newton-schulz --orth cholesky-qr2 \\
        --dim 512 --subspace-rank 16

(``--dim``/``--subspace-rank`` are ``--d``/``--r`` in a spelling that
``torchrun``'s parser leaves to the script.)  ``--topology hier --pods p``
(the two go together) splits the ranks into p pods, pod-major.

Draws (M1) Gaussian data from a seed, runs Procrustes-fixed distributed
PCA, and prints the reference's keys: the resolved plan (knobs, its
source and its predicted words and bits) and the subspace distances of
the distributed, centralized, naive and first-local estimates to the
truth, plus the wall time of the distributed estimate.

``--plan auto`` hands the free knobs to the cost-model planner
(``repro_torch.plan``; flags passed explicitly are pins, and the wire
precision is planned only under ``--comm-bits auto``), in the stacked
context in one process and the collective context under ``torchrun``;
``--explain`` prints the scored table first; ``--calibrate FILE``
refines the planner's constants from a recorded ``bench_aggregate``
sweep.  ``--fail-at "k:t[,k:t]"`` kills shard k before round t and runs
the elastic runtime (``repro_torch.runtime.elastic``), which re-plans at
the survivor count and adds ``replans``, ``final_m_active`` and
``events`` to the report.
Shard k's rows come from a generator seeded from (seed, k)
(``synthetic.sample_shard``), so both forms estimate from the same data.
Under ``torchrun`` rank 0 prints, adding the rank count, the transport
rule (``launch.mesh.transport_rule``) and the bytes staged through host
memory.  ``--device`` defaults to the card; ``--backend auto`` runs the
CUDA kernels there.

``--stream STEPS`` runs the same estimation as a streaming job
(``repro_torch.stream.SubspaceService``): each shard's rows arrive in
STEPS chunks (STEPS must divide ``--n-per-shard``), the service refreshes
every ``--cadence`` steps (default STEPS // 4) with the previously served
basis as the Procrustes reference, serves the full-data basis at the end,
and the report gains the ``stream_*`` stats.  One process stacks the
shards; under ``torchrun`` each rank streams its own.  With
``--fail-at k:t`` the service adopts the injector's membership before
each step t (a failure re-plans and refreshes at once).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.comm import transport
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
from repro_torch.data import synthetic as syn
from repro_torch.interop import resolve_device, strict_fp32
from repro_torch.launch.mesh import under_torchrun
from repro_torch.plan import (
    BACKEND_CHOICES,
    COMM_BITS_CHOICES,
    ORTH_CHOICES,
    PLAN_CHOICES,
    POLAR_CHOICES,
    TOPOLOGY_CHOICES,
    explain as explain_plan,
    load_calibration,
    resolve_plan,
)

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
    plan=None,
    explain: bool = False,
    calibration=None,
    fail_at: str | None = None,
    stream: int | None = None,
    cadence: int | None = None,
    agg=None,
):
    """Draw the data, run the estimate, and return (v_dist, stats).

    ``agg`` (a ``launch.mesh.AggregationGroup``) runs the collective form,
    this rank on shard ``agg.rank`` of ``agg.world``; without it the
    ``shards`` shards are stacked in this process.  ``topology="hier"``
    and an ``agg`` made with ``pods=`` go together.  The plan is resolved
    once here (``plan``, ``calibration``; ``explain`` prints its table on
    rank 0), ``fail_at`` runs the elastic runtime, and ``stream`` (with
``cadence``) the streaming service over the same rows.  Under ``agg`` only
    rank 0 returns stats (None elsewhere): it regenerates every shard
    from the data rule for the centralized, naive and local baselines."""
    from repro_torch.runtime.elastic import elastic_pca, elastic_pca_collective
    from repro_torch.runtime.fault import FailureInjector

    pods = None if agg is None else agg.pods
    if (topology == "hier") != (pods is not None):
        raise ValueError(
            "--topology hier and --pods go together (the two-level schedule "
            f"needs the (pod, local) groups; got topology={topology!r}, "
            f"pods={pods!r})"
        )
    if fail_at and pods is not None:
        raise ValueError(
            "--fail-at composes with the flat topologies only (the elastic "
            "runtime re-plans at the survivor count, which need not tile "
            "into pods)"
        )
    if stream and n_per_shard % stream:
        raise ValueError(
            f"--stream {stream} must divide --n-per-shard {n_per_shard} (every "
            "step feeds each shard the same number of rows)"
        )
    dev = agg.device if agg is not None else resolve_device(device)
    strict_fp32()
    shards = shards if agg is None else agg.world
    knobs = dict(backend=backend, polar=polar, orth=orth, comm_bits=comm_bits)
    if agg is None:
        resolve_stacked_topology(topology)
        where = dict(context="stacked")
    else:
        where = dict(topology=topology, pods=pods)
    pl = resolve_plan(plan, m=shards, d=d, r=r, n_iter=n_iter, calibration=calibration,
                      tensor_device=dev, **knobs, **where)
    kind = pl.device_kind  # the kind planned for: where the tensors live
    if explain and (agg is None or agg.rank == 0):
        print(explain_plan(m=shards, d=d, r=r, n_iter=n_iter, device_kind=kind,
                           calibration=calibration, plan=pl, **knobs, **where)[1])
    injector = (FailureInjector(fail_at=FailureInjector.parse_fail_spec(fail_at))
                if fail_at else None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tau = syn.spectrum_m1(d, r, delta=delta, device=dev)
    _, u, factor = syn.covariance_from_spectrum(tau, generator=gen)
    v1 = u[:, :r]
    est = dict(n_iter=n_iter, solver=solver, iters=iters, plan=pl)
    elastic = dict(injector=injector, calibration=calibration, device_kind=kind)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    report = svc = None
    if stream:
        from repro_torch.stream import SubspaceService

        place = (dict(shards=shards) if agg is None else
                 dict(group=agg.local_group if pods else agg.group,
                      pod_group=agg.pod_group))
        svc = SubspaceService(d, r, device=dev, cadence=cadence or max(stream // 4, 1),
                              calibration=calibration, device_kind=kind, **est, **place)
        if agg is None:
            samples = syn.sample_shards(factor, n_per_shard, seed=seed, shards=shards)
            rows = samples.reshape(shards, n_per_shard, d)
        else:
            rows = syn.sample_shard(factor, n_per_shard, seed=seed, shard=agg.rank)
        chunk = n_per_shard // stream
        sync()
        t0 = time.perf_counter()
        for t in range(stream):
            if injector is not None:
                svc.set_membership(injector.membership_at(t, shards))
            svc.observe(rows[..., t * chunk:(t + 1) * chunk, :])
        if svc.stats["staleness"]:
            svc.refresh()  # serve the full-data basis before reporting
        v_dist = svc.basis
        sync()
        t_dist = time.perf_counter() - t0
        s = svc.stats
        stream_stats = {
            "stream_steps": s["step"],
            "stream_rows_seen": s["rows_seen"],
            "stream_refreshes": s["refreshes"],
            "stream_cadence": s["cadence"],
            "stream_staleness": s["staleness"],
            "stream_last_jump": s["last_jump"],
            "stream_drift": svc.drift(),
            "replans": s["replans"],
        }
        if s["events"]:
            stream_stats["events"] = s["events"]
        if agg is not None:
            if agg.rank != 0:
                return v_dist, None
            samples = syn.sample_shards(factor, n_per_shard, seed=seed, shards=shards)
    elif agg is None:
        samples = syn.sample_shards(factor, n_per_shard, seed=seed, shards=shards)
        t0 = time.perf_counter()
        if injector is not None:
            report = elastic_pca(samples, r, shards=shards, device=dev, **est,
                                 **elastic)
            v_dist = report.basis
        else:
            v_dist = distributed_pca(samples, r, shards=shards, device=dev, **est)
        sync()
        t_dist = time.perf_counter() - t0
    else:
        x = syn.sample_shard(factor, n_per_shard, seed=seed, shard=agg.rank)
        transport.reset_staged_bytes()
        sync()
        t0 = time.perf_counter()
        if injector is not None:
            report = elastic_pca_collective(x, r, group=agg.group, device=dev,
                                            **est, **elastic)
            v_dist = report.basis
        else:
            v_dist = distributed_pca_collective(
                x, r, group=agg.local_group if pods else agg.group, device=dev,
                pod_group=agg.pod_group, **est)
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
        # The resolved plan (what ran).
        "backend": pl.backend,
        "polar": pl.polar,
        "orth": pl.orth,
        "topology": pl.topology,
        "pods": pl.pods,
        "ring_chunk": pl.ring_chunk,
        "comm_bits": pl.comm_bits,
        "plan_source": pl.source,
        "predicted_words": pl.words,
        "predicted_bits": pl.bits,
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
    if svc is not None:
        stats.update(stream_stats)
    if report is not None:
        stats["replans"] = report.replans
        stats["final_m_active"] = report.final_membership.m_active
        stats["events"] = [
            f"round {e.round_index}: {e.reason} "
            f"(m'={e.membership.m_active}, dead={list(e.membership.dead)}, "
            f"plan={e.plan.backend}/{e.plan.topology}/{e.plan.polar}/"
            f"{e.plan.orth}/{e.plan.comm_bits})"
            for e in report.events
        ]
    return v_dist, stats


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
    ap.add_argument("--backend", default="auto", choices=BACKEND_CHOICES,
                    help="plain PyTorch, the hand-written CUDA kernels, or "
                         "auto (the kernels on a CUDA device; planned under "
                         "--plan auto)")
    ap.add_argument("--polar", default=None, choices=POLAR_CHOICES,
                    help="r x r polar factor: SVD (default) or Newton-Schulz "
                         "(fused into the Gram kernel under cuda); auto: "
                         "the planner's")
    ap.add_argument("--orth", default=None, choices=ORTH_CHOICES,
                    help="per-round orthonormalization (default qr); with "
                         "cuda and newton-schulz, cholesky-qr2 runs each "
                         "round as one fused kernel launch; auto: the "
                         "planner's")
    ap.add_argument("--topology", default="auto", choices=TOPOLOGY_CHOICES,
                    help="psum, gather, ring or hier (with --pods) across "
                         "the ranks (under torchrun); one process stacks the "
                         "shards (gather); auto: gather under cuda, else psum "
                         "(planned under --plan auto)")
    ap.add_argument("--comm-bits", default=None, choices=COMM_BITS_CHOICES,
                    help="wire precision: 32 exact, 16 bf16, 8 stochastic "
                         "int8 (with error feedback across ranks; in one "
                         "process each basis passes the gather wire's "
                         "codec); auto: the planner trades it")
    ap.add_argument("--shards", type=int, default=None,
                    help="machines m in one process (default 8); under "
                         "torchrun the world size")
    ap.add_argument("--pods", type=int, default=None,
                    help="pods of the hier topology (under torchrun; must "
                         "tile the ranks; goes with --topology hier)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    ap.add_argument("--plan", default="none", choices=PLAN_CHOICES,
                    help="auto: the cost-model planner (repro_torch.plan) "
                         "picks every knob not passed (comm bits stay 32 "
                         "unless --comm-bits auto); none: the per-knob "
                         "defaults")
    ap.add_argument("--explain", action="store_true",
                    help="print the planner's scored table (predicted words, "
                         "bits, flops and roofline terms per cell, the chosen "
                         "cell marked) before running")
    ap.add_argument("--calibrate", default=None, metavar="BENCH_JSON",
                    help="refine the planner's constants from a recorded "
                         "bench_aggregate sweep of this device kind")
    ap.add_argument("--fail-at", default=None, metavar="SHARD:ROUND[,..]",
                    help="kill shard k before refinement round t ('2:1', "
                         "'2:1,5:3'): the elastic runtime finishes over the "
                         "survivors and re-plans at their count")
    ap.add_argument("--stream", type=int, default=None, metavar="STEPS",
                    help="streaming lane (repro_torch.stream): feed the same "
                         "rows in STEPS per-shard chunks through a "
                         "SubspaceService, refreshing on the cadence with the "
                         "previous basis as reference; with --fail-at, t "
                         "counts steps")
    ap.add_argument("--cadence", type=int, default=None,
                    help="refresh every CADENCE steps of the --stream lane "
                         "(default: STEPS // 4)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.topology == "hier") != (args.pods is not None):
        ap.error("--topology hier and --pods go together")
    if args.cadence is not None and not args.stream:
        ap.error("--cadence goes with --stream")
    agg = None
    if under_torchrun():
        from repro_torch.launch.mesh import make_aggregation_mesh

        try:
            agg = make_aggregation_mesh(device=args.device, pods=args.pods)
        except ValueError as exc:
            ap.error(str(exc))
        if args.shards not in (None, agg.world):
            ap.error(f"--shards {args.shards} under torchrun with {agg.world} ranks")
    elif args.topology in ("psum", "ring", "hier"):
        ap.error(f"--topology {args.topology} runs across ranks: start the "
                 "launcher under torchrun")
    calibration = load_calibration(args.calibrate) if args.calibrate else None
    try:
        _, stats = run(
            args.d, args.r, args.n_per_shard, shards=args.shards or 8,
            n_iter=args.n_iter, solver=args.solver, device=args.device,
            backend=args.backend, polar=args.polar, orth=args.orth,
            topology=args.topology, comm_bits=args.comm_bits,
            plan="auto" if args.plan == "auto" else None, explain=args.explain,
            calibration=calibration, fail_at=args.fail_at, stream=args.stream,
            cadence=args.cadence, agg=agg,
        )
    except ValueError as exc:
        ap.error(str(exc))
    finally:
        if agg is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    for k, v in (stats or {}).items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()

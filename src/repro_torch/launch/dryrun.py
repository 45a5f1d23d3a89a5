"""Dry run of the port at the production mesh (counterpart of
``repro/launch/dryrun.py``): every (architecture x input shape) cell and
the paper's own workload, counted on rank 0 of a fake process group of
256 ranks (the (16, 16) ``(data, model)`` mesh) or 512 (``--multi-pod``,
(2, 16, 16) with ``pod`` first), with every tensor a fake one
(``FakeTensorMode``): nothing is allocated and nothing runs on a card.

The reference lowers and compiles each cell on 512 placeholder devices
and reads XLA's analyses; the port runs each cell's program on fake
tensors and counts what rank 0 does (``launch/counting.py``): FLOPs of
the local ops (the kernels' custom ops by their own formulas), its blocks
of the parameters, optimizer state and batch, MemTracker's peak, and the
collectives' bytes by kind.  The roofline terms are priced by
``plan.roofline.roofline_terms`` against the ``H100`` model (bf16 peak
for the LM cells).  These are reckoned numbers, not card times.

  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --paper-pca --out /tmp/dr
  python -m repro_torch.launch.dryrun --paper-pca --multi-pod --topology hier
  python -m repro_torch.launch.dryrun --paper-pca --topology ring --stream-steps 4

Cells:

  * ``dryrun_cell``: the train cell is one AdamW step
    (``launch/steps.make_train_step``) of the model sharded by
    ``launch/sharding`` (f32 masters), prefill one ``LM.prefill`` through
    B8 (bf16 weights, the reference's serving convention), decode one
    ``decode_step`` against a full cache of ``seq_len`` slots (an
    encoder-decoder's cross K/V over ``seq_len`` encoder positions, a
    recurrent block's state, a local-attention block's ring).  Every
    family, ``long_500k`` for the sub-quadratic archs alone
    (``supports_shape``); the port has no scan, so the whole depth runs
    and ``--accounting`` is ``unrolled`` (``extrapolate`` and
    ``scan-only`` are refused by name).
  * ``dryrun_paper_pca``: ``core/distributed.distributed_pca_collective``
    over the data axis's group (``--topology hier``: pod x data), every
    knob of the reference (``--backend``, ``--polar``, ``--orth``,
    ``--comm-bits``, ``--plan auto --explain``, ``--drop-shards``,
    ``--pods``); ``--stream-steps N`` counts the streaming service's
    steady-state refresh (the rounds with the served basis as the
    reference) and its query path, whose collective bytes must be 0.
    Its collective bytes a device are the payloads rank 0 hands to
    ``torch.distributed`` (``comm/transport.py``'s tally) and equal
    ``comm_cost(...).bits / 8``.

  * ``--eigen``: the train cell is the eigen-compressed train step
    (``launch/steps.make_eigen_train_step`` on the mesh, not the
    refresh, as the reference's ``_lower_cell``), at the reference's
    ``EigenCompressConfig()`` (rank 128, min_dim 1024): parameters on the
    model submesh with FSDP off, the eigen state replicated, ``err`` this
    data rank's own.  Its data-axis collectives are the payloads rank 0
    hands to ``torch.distributed`` (``comm/transport.py``'s tally, as the
    paper-pca cells count theirs); the record's ``data_axis_bytes``
    holds them beside the compressed and full words of one step.  A
    baseline train cell's ``data_axis_bytes`` are DTensor's collectives
    over the data axes (``counting.LocalComms``, by group).

Refused, each by name with exit 2 from the CLI (``RefusedCell``): the
``extrapolate`` and ``scan-only`` accountings; the reference's HLO-only
record fields are listed in the record's ``refused``.  The fake group is torn down in a ``finally``, so
no global process group outlives a dry run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from collections import Counter
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import counting as C
from repro_torch.launch.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    POD_AXIS,
    data_axes,
    make_mesh,
    make_production_mesh,
)
from repro_torch.models.config import SHAPES, active_param_count, supports_shape
from repro_torch.plan.roofline import H100, H100_BF16, model_flops, roofline_terms

__all__ = ["RefusedCell", "fake_world", "dryrun_cell", "dryrun_paper_pca", "main",
           "ACCOUNTING_REFUSED"]

ACCOUNTING_REFUSED = {
    "extrapolate": "the port has no scanned graph to extrapolate from: it runs and "
                   "counts the whole depth (--accounting unrolled)",
    "scan-only": "the port has no scan whose body a cost analysis counts once: it "
                 "runs and counts the whole depth (--accounting unrolled)",
}
HLO_REFUSED = {
    "generated_code_size_bytes": "no HLO: the port compiles no program",
    "lower_s": "no lowering: the port runs the step on fake tensors",
    "compile_s": "no compilation: the port runs the step on fake tensors",
}


# ``comm/transport.py``'s tally keys, as the reference's collective kinds.
HANDED_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                "broadcast": "broadcast", "send": "collective-permute"}


class RefusedCell(ValueError):
    """A cell this slice of the port does not dry-run (named, with why)."""


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, torn
    down on exit (it refuses to start over a group already up)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run starts its own fake process group; one is up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _world(multi_pod: bool, device_count: Optional[int]) -> int:
    return int(device_count or (512 if multi_pod else 256))


def _mesh_for(multi_pod: bool, mesh_shape: Optional[tuple] = None):
    """The reference's ``_mesh_for`` over the fake group's ranks."""
    n = dist.get_world_size()
    if mesh_shape is not None:
        axes = (POD_AXIS, DATA_AXIS, MODEL_AXIS) if len(mesh_shape) == 3 \
            else (DATA_AXIS, MODEL_AXIS)
        return make_mesh(tuple(mesh_shape), axes, device="cpu")
    if n != 512 and not (n == 256 and not multi_pod):
        # reduced meshes (same axis structure) below the production count
        if multi_pod:
            if n < 8:
                raise ValueError("multi-pod dry run needs >= 8 ranks")
            return make_mesh((2, 2, n // 4), (POD_AXIS, DATA_AXIS, MODEL_AXIS), device="cpu")
        return make_mesh((2, n // 2), (DATA_AXIS, MODEL_AXIS), device="cpu")
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


def _mesh_record(mesh) -> dict:
    return {"shape": list(mesh.shape), "axes": list(mesh.mesh_dim_names)}


def _price(record: dict, flops: float, hbm: float, coll: Dict[str, int], chips: int,
           device) -> None:
    t = roofline_terms(flops, hbm, dict(coll), chips, device=device)
    record.update({
        "flops_per_device": float(flops),
        "hbm_bytes_per_device": float(hbm),
        "collective_bytes_per_device": t.coll_bytes,
        "collective_breakdown": dict(coll),
        "compute_s": t.compute_s,
        "memory_s": t.memory_s,
        "collective_s": t.collective_s,
        "bottleneck": t.bottleneck,
        "roofline_device": device.kind + (" bf16" if device is H100_BF16 else ""),
        "refused": dict(HLO_REFUSED),
    })


def refuse(accounting: str = "unrolled") -> None:
    """Raise ``RefusedCell`` for an accounting the port does not count."""
    if accounting in ACCOUNTING_REFUSED:
        raise RefusedCell(f"--accounting {accounting}: {ACCOUNTING_REFUSED[accounting]}")
    if accounting != "unrolled":
        raise RefusedCell(f"--accounting {accounting!r}: the port counts 'unrolled'")


def dryrun_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    eigen: bool = False,
    device_count: Optional[int] = None,
    verbose: bool = True,
    accounting: str = "unrolled",
    overrides: Optional[Dict[str, Any]] = None,
    mesh_shape: Optional[tuple] = None,
) -> Dict[str, Any]:
    """One (arch x shape) cell's record (see the module docstring)."""
    refuse(accounting)
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    ok, why = supports_shape(cfg, shape)
    record: Dict[str, Any] = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                              "eigen": eigen, "kind": shape.kind,
                              "overrides": overrides or {}}
    if not ok:
        record["skipped"] = why
        if verbose:
            print(f"[dryrun] {arch} x {shape_name}: SKIP ({why})")
        return record
    t0 = time.perf_counter()
    with fake_world(_world(multi_pod, device_count)):
        mesh = _mesh_for(multi_pod, mesh_shape)
        record["mesh"] = _mesh_record(mesh)
        record.update(_count_cell(cfg, shape, mesh, eigen=eigen and shape.kind == "train"))
    record["count_s"] = time.perf_counter() - t0
    chips = mesh.size()
    kind = shape.kind
    tokens = shape.global_batch if kind == "decode" else shape.tokens
    mf = model_flops(active_param_count(cfg), tokens, kind)
    record["model_flops_global"] = mf
    record["model_flops_per_device"] = mf / chips
    record["useful_flops_ratio"] = mf / chips / max(record["flops_per_device"], 1.0)
    record["accounting"] = "unrolled"
    if verbose:
        _print_cell(record, chips)
    return record


def _count_cell(cfg, shape, mesh, *, eigen: bool = False) -> Dict[str, Any]:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.comm import transport
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import data_group, data_rank, data_size
    from repro_torch.launch.specs import decode_state_specs, train_input_specs
    from repro_torch.launch.steps import (
        compressed_paths,
        eigen_opt_init,
        make_eigen_train_step,
        make_train_step,
        shard_rows,
    )
    from repro_torch.models.registry import model_class
    from repro_torch.models.sharding_ctx import activation_sharding
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.eigen_compress import EigenCompressConfig
    from repro_torch.optim.schedule import warmup_cosine

    def fake(spec):
        return torch.zeros(spec.shape, dtype=spec.dtype)

    kind = shape.kind
    ecfg = EigenCompressConfig()
    dax_names = {data_group(mesh).group_name: "data"}
    transport.reset_handed_bytes()
    with FakeTensorMode():
        # Train: f32 masters; serving: the config's dtype (bf16 weights,
        # the reference's serving convention).
        dtype = torch.float32 if kind == "train" else None
        model = model_class(cfg)(cfg, device="cpu", param_dtype=dtype)
        S.shard_model(model, cfg, mesh, eigen=eigen)
        params = dict(model.named_parameters())
        opt, batch, extra, opt_t = None, {}, [], []
        if kind == "train":
            batch = {k: fake(v) for k, v in train_input_specs(cfg, shape).items()}
            if eigen:
                opt = eigen_opt_init(model, ecfg, data_size(mesh), mesh=mesh)
                # ``initialized`` is a host flag, not a device argument.
                opt_t = [*opt["full_m"].values(), *opt["full_v"].values(),
                         *(st[f] for st in opt["eigen"].values()
                           for f in ("basis", "m", "v", "err"))]
            else:
                opt = adamw_init(params)
                opt_t = [*opt["m"].values(), *opt["v"].values()]
        elif kind == "prefill":
            batch = {k: fake(v) for k, v in train_input_specs(cfg, shape).items()
                     if k != "labels"}
        else:
            tok, _, _ = decode_state_specs(cfg, shape)
            batch = {"tokens": fake(tok)}
        with activation_sharding(mesh, data_axes(mesh)), implicit_replication():
            if eigen:  # each data rank's rows, by hand
                placed = shard_rows(batch, data_rank(mesh), data_size(mesh))
            else:
                placed = batch = S.shard_batch(batch, mesh)
            if kind == "decode":
                extra = _cache_leaves(_decode_cache(model, cfg, shape))
            param_b = S.local_bytes(params.values())
            opt_b = S.local_bytes(opt_t)
            batch_b = S.local_bytes([*placed.values(), *extra])
        flops, comms = C.LocalFlops(), C.LocalComms(axes=dax_names)
        with C.unseen_shadow_ops(), C.peak_bytes(model) as peak, CommDebugMode() as cdm, \
                comms, flops:
            if kind == "train":
                sched = warmup_cosine(3e-4, 100, 10000)
                if eigen:
                    make_eigen_train_step(model, adamw_cfg=AdamWConfig(), schedule=sched,
                                          mesh=mesh)(opt, batch)
                else:
                    with activation_sharding(mesh, data_axes(mesh)), implicit_replication():
                        make_train_step(model, adamw_cfg=AdamWConfig(),
                                        schedule=sched)(opt, batch)
            else:
                with activation_sharding(mesh, data_axes(mesh)), implicit_replication():
                    if kind == "prefill":
                        tokens = batch.pop("tokens")
                        lead = (batch.pop("frames"),) if "frames" in batch else ()
                        model.prefill(*lead, tokens, cache_len=shape.seq_len,
                                      use_kernel=True, **batch)
                    else:
                        cache = _decode_cache(model, cfg, shape)
                        model.decode_step(batch["tokens"], cache, shape.seq_len - 1)
    handed = transport.handed_bytes()
    transport.reset_handed_bytes()
    coll = Counter(comms.by_kind)
    coll.update({HANDED_KINDS[k]: v for k, v in handed.items()})
    data_b = sum(handed.values()) + comms.by_axis.get("data", 0)
    rec: Dict[str, Any] = {
        "memory": {"argument_bytes": param_b + opt_b + batch_b, "param_bytes": param_b,
                   "opt_state_bytes": opt_b, "batch_bytes": batch_b,
                   "peak_bytes": peak["peak"]},
        "collective_counts": {str(k): int(v) for k, v in cdm.get_comm_counts().items()},
        "flops_by_op": dict(flops.by_op.most_common(8)),
        "data_axis_bytes": data_b,
    }
    if kind == "train":
        comp = compressed_paths(cfg, ecfg)
        rec["data_axis_words"] = {
            "compressed": sum(min(ecfg.rank, d, n) * n for d, n in comp.values()),
            "full": sum(d * n for d, n in comp.values())} if eigen else None
        if eigen:
            rec["data_axis_handed"] = handed
    _price(rec, flops.total, param_b + opt_b + batch_b, dict(coll), mesh.size(), H100_BF16)
    return rec


def _decode_cache(model, cfg, shape):
    """A decode step's cache at ``shape`` (``specs.decode_state_specs``'s):
    a full cache of ``seq_len`` slots, and an encoder-decoder's cross K/V
    over ``seq_len`` encoder positions."""
    kw = dict(cross_len=shape.seq_len) if cfg.is_encoder_decoder else {}
    return model.init_cache(shape.global_batch, shape.seq_len, **kw)


def _cache_leaves(cache) -> list:
    if isinstance(cache, dict):
        return [t for v in cache.values() for t in _cache_leaves(v)]
    if isinstance(cache, list):
        return [t for v in cache for t in _cache_leaves(v)]
    return [] if cache is None else [cache]


def _print_cell(r: dict, chips: int) -> None:
    m = r["memory"]
    print(f"[dryrun] {r['arch']} x {r['shape']} (multi_pod={r['multi_pod']}): OK "
          f"chips={chips} mesh={r['mesh']['shape']} count={r['count_s']:.1f}s (reckoned)")
    print(f"  memory: args={m['argument_bytes'] / 2**30:.2f}GiB "
          f"(params {m['param_bytes'] / 2**30:.2f}, opt {m['opt_state_bytes'] / 2**30:.2f}, "
          f"batch {m['batch_bytes'] / 2**30:.2f}) peak={m['peak_bytes'] / 2**30:.2f}GiB")
    print(f"  per-device: flops={r['flops_per_device']:.3e} "
          f"hbm={r['hbm_bytes_per_device']:.3e}B coll={r['collective_bytes_per_device']:.3e}B "
          f"{r['collective_breakdown']}")
    if r.get("data_axis_words"):
        w = r["data_axis_words"]
        print(f"  eigen: data-axis bytes {r['data_axis_bytes']:.6e}B; compressed words "
              f"{w['compressed']} against the full gradients' {w['full']} "
              f"({w['full'] / max(w['compressed'], 1):.1f}x)")
    print(f"  roofline ({r['roofline_device']}): compute={r['compute_s'] * 1e3:.2f}ms "
          f"memory={r['memory_s'] * 1e3:.2f}ms collective={r['collective_s'] * 1e3:.2f}ms "
          f"-> {r['bottleneck']}-bound; useful={r['useful_flops_ratio']:.2%}")


def dryrun_paper_pca(
    *, multi_pod: bool = False, device_count=None, verbose=True,
    backend: Optional[str] = None, polar: Optional[str] = None,
    orth: Optional[str] = None, topology: Optional[str] = None,
    comm_bits=None, plan=None, explain: bool = False, calibration=None,
    plan_device: Optional[str] = None, drop_shards: Optional[str] = None,
    pods: Optional[int] = None, stream_steps: Optional[int] = None,
) -> Dict[str, Any]:
    """The paper's workload (distributed PCA, Algorithm 2) at the
    production width (``configs/paper_pca.py``), one shard a rank of the
    data axis (see the module docstring).  ``plan_device`` is the model
    the planner scores ("cpu" or "h100"; default "h100", the target)."""
    t0 = time.perf_counter()
    with fake_world(_world(multi_pod, device_count)):
        rec = _count_pca(multi_pod=multi_pod, backend=backend, polar=polar, orth=orth,
                         topology=topology, comm_bits=comm_bits, plan=plan,
                         explain=explain, calibration=calibration,
                         plan_device=plan_device, drop_shards=drop_shards, pods=pods,
                         stream_steps=stream_steps)
    rec["count_s"] = time.perf_counter() - t0
    if verbose:
        tag = f"paper-pca-stream (steps={stream_steps})" if stream_steps else "paper-pca"
        q = (f" query_coll={rec['query_collective_bytes_per_device']:.0f}B"
             if stream_steps else "")
        print(f"[dryrun] {tag} (multi_pod={multi_pod}): OK chips={rec['chips']} "
              f"topology={rec['topology']} backend={rec['backend']} "
              f"coll={rec['collective_bytes_per_device']:.6e}B "
              f"comm_cost={rec['predicted_collective_bits'] / 8:.6e}B{q} "
              f"flops={rec['flops_per_device']:.3e} bottleneck={rec['bottleneck']} "
              f"(reckoned)")
    return rec


def _count_pca(*, multi_pod, backend, polar, orth, topology, comm_bits, plan, explain,
               calibration, plan_device, drop_shards, pods, stream_steps):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import plan as planlib
    from repro_torch.comm import Membership, comm_cost, transport
    from repro_torch.configs.paper_pca import CONFIG as pcfg
    from repro_torch.core.distributed import (
        distributed_pca_collective,
        procrustes_average_collective,
    )
    from repro_torch.core.subspace import local_eigenbasis
    from repro_torch.stream.service import project

    if pods:
        n = dist.get_world_size()
        if n % int(pods):
            raise ValueError(f"--pods {pods} does not tile {n} ranks")
        mesh = make_mesh((int(pods), n // int(pods)), (POD_AXIS, DATA_AXIS), device="cpu")
    else:
        mesh = _mesh_for(multi_pod)
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    n_data = sizes[DATA_AXIS] * sizes.get(POD_AXIS, 1)
    hier = topology == "hier" or (isinstance(plan, planlib.Plan) and plan.topology == "hier")
    if hier and POD_AXIS not in names:
        raise ValueError(f"--topology hier needs --multi-pod (a mesh with a {POD_AXIS!r} axis)")
    agg_pods = sizes[POD_AXIS] if hier else None
    m_agg = sizes[DATA_AXIS] * (agg_pods or 1)
    group = mesh.get_group(DATA_AXIS)
    pod_group = mesh.get_group(POD_AXIS) if hier else None
    mem = None
    if drop_shards:
        mem = Membership.from_dead(m_agg, (int(s) for s in drop_shards.split(",") if s.strip()))
    kind = plan_device or "h100"
    pl = planlib.resolve_plan(
        plan, m=m_agg, d=pcfg.d, r=pcfg.r, n_iter=pcfg.n_iter, backend=backend,
        topology=topology, polar=polar, orth=orth, comm_bits=comm_bits,
        calibration=calibration, device_kind=kind, membership=mem, pods=agg_pods,
        ref_broadcast=not stream_steps, tensor_device=torch.device("cuda"))
    if explain:
        _, table = planlib.explain(
            m=m_agg, d=pcfg.d, r=pcfg.r, n_iter=pcfg.n_iter, backend=backend,
            topology=topology, polar=polar, orth=orth, comm_bits=comm_bits,
            calibration=calibration, plan=pl, device_kind=kind, pods=agg_pods,
            ref_broadcast=not stream_steps)
        print(table)
    topo = pl.topology
    cost = comm_cost(topo, m=m_agg, d=pcfg.d, r=pcfg.r, n_iter=pcfg.n_iter,
                     comm_bits=pl.comm_bits, membership=mem,
                     ref_broadcast=not stream_steps,
                     pods=agg_pods if topo == "hier" else None)
    rec: Dict[str, Any] = {
        "arch": "paper-pca", "shape": f"d{pcfg.d}_r{pcfg.r}_n{pcfg.n_per_shard}",
        "multi_pod": multi_pod, "kind": "eigen-stream" if stream_steps else "eigen",
        "backend": pl.backend, "polar": pl.polar, "orth": pl.orth, "topology": topo,
        "pods": pl.pods, "comm_bits": pl.comm_bits, "plan_source": pl.source,
        "plan_device": kind,
        "membership": "full" if mem is None else f"dead={list(mem.dead)}",
        "m_active": m_agg if mem is None else mem.m_active,
        "predicted_collective_words": cost.words,
        "predicted_collective_bits": cost.bits,
        "predicted_collective_bytes": {k: v // 8 for k, v in cost.kind_bits.items() if v},
        "mesh": _mesh_record(mesh), "chips": mesh.size(),
    }
    if cost.levels is not None:
        rec["predicted_collective_bytes_by_level"] = {
            lv: {k: v // 8 for k, v in kinds.items() if v}
            for lv, kinds in cost.levels.items()}
    if stream_steps:
        rec["stream_steps"] = stream_steps
        rec["predicted_refresh_bits_per_step"] = cost.bits / stream_steps
    knobs = dict(group=group, n_iter=pcfg.n_iter, plan=pl, membership=mem,
                 pod_group=pod_group)
    transport.reset_handed_bytes()
    flops = C.LocalFlops()
    with FakeTensorMode():
        if stream_steps:
            # The steady-state refresh: this rank's local basis of its
            # accumulated covariance, then the rounds with the served
            # basis as the reference (no reference broadcast).
            cov = torch.zeros(pcfg.d, pcfg.d)
            served = torch.zeros(pcfg.d, pcfg.r)
            args = [cov, served]
            with C.peak_bytes() as peak, flops:
                v = local_eigenbasis(cov, pcfg.r, method=pcfg.solver,
                                     iters=pcfg.solver_iters)[0]
                procrustes_average_collective(v, ref=served, **knobs)
            handed = transport.handed_bytes()
            transport.reset_handed_bytes()
            project(torch.zeros(1024, pcfg.d), served)
            q = transport.handed_bytes()
            rec["query_collective_breakdown"] = {k: v for k, v in q.items() if v}
            rec["query_collective_bytes_per_device"] = float(sum(q.values()))
        else:
            x = torch.zeros(pcfg.n_per_shard, pcfg.d)
            args = [x]
            with C.peak_bytes() as peak, flops:
                distributed_pca_collective(
                    x, pcfg.r, device="cpu", solver=pcfg.solver, iters=pcfg.solver_iters,
                    **knobs)
            handed = transport.handed_bytes()
    transport.reset_handed_bytes()
    arg_b = sum(t.numel() * t.element_size() for t in args)
    rec["memory"] = {"argument_bytes": arg_b, "peak_bytes": peak["peak"]}
    _price(rec, flops.total, arg_b, handed, mesh.size(), H100)
    rec["flops_by_op"] = dict(flops.by_op.most_common(8))
    # Useful flops: the covariance (2 n d^2) a shard, as the reference's.
    mf = 2.0 * pcfg.n_per_shard * pcfg.d * pcfg.d
    rec["model_flops_global"] = mf * n_data
    rec["model_flops_per_device"] = mf
    rec["useful_flops_ratio"] = mf / max(rec["flops_per_device"], 1.0)
    return rec


def main(argv=None) -> int:
    from repro_torch.plan import (
        BACKEND_CHOICES,
        COMM_BITS_CHOICES,
        ORTH_CHOICES,
        PLAN_CHOICES,
        POLAR_CHOICES,
        TOPOLOGY_CHOICES,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--eigen", action="store_true",
                    help="train cells: the eigen-compressed train step (the paper's technique)")
    ap.add_argument("--paper-pca", action="store_true")
    ap.add_argument("--backend", default=None, choices=BACKEND_CHOICES)
    ap.add_argument("--polar", default=None, choices=POLAR_CHOICES)
    ap.add_argument("--orth", default=None, choices=ORTH_CHOICES)
    ap.add_argument("--topology", default="auto", choices=TOPOLOGY_CHOICES,
                    help="'hier' needs a pod axis (--multi-pod or --pods)")
    ap.add_argument("--pods", type=int, default=None,
                    help="with --paper-pca --topology hier: a bare (pods, n/pods) mesh")
    ap.add_argument("--comm-bits", default=None, choices=COMM_BITS_CHOICES)
    ap.add_argument("--plan", default="none", choices=PLAN_CHOICES)
    ap.add_argument("--explain", action="store_true")
    ap.add_argument("--calibrate", default=None, metavar="BENCH_JSON")
    ap.add_argument("--plan-device", default=None, choices=["cpu", "h100"],
                    help="device model the planner scores against (default h100)")
    ap.add_argument("--stream-steps", type=int, default=None, metavar="N")
    ap.add_argument("--drop-shards", default=None, metavar="K[,K..]")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--device-count", type=int, default=None,
                    help="fake ranks (default 256, or 512 with --multi-pod)")
    ap.add_argument("--accounting", default="unrolled",
                    choices=["extrapolate", "unrolled", "scan-only"])
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="config override key=value (bool/int/float/str)")
    ap.add_argument("--mesh-shape", default=None, help="alternate factorisation, e.g. 32,8")
    ap.add_argument("--tag", default="", help="suffix for record filenames")
    args = ap.parse_args(argv)

    mesh_shape = tuple(int(x) for x in args.mesh_shape.split(",")) if args.mesh_shape else None
    overrides = {}
    for kv in args.overrides:
        k, v = kv.split("=", 1)
        for conv in (lambda s: {"true": True, "false": False}[s.lower()], int, float):
            try:
                v = conv(v)
                break
            except (KeyError, ValueError):
                pass
        overrides[k] = v
    pods = []
    if args.single_pod or not args.multi_pod:
        pods.append(False)
    if args.multi_pod or (not args.single_pod and args.all):
        pods.append(True)
    cells = []
    if args.paper_pca:
        cells = [("paper-pca", None, mp) for mp in pods]
    else:
        archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
        shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
        cells = [(a, s, mp) for a in archs for s in shapes for mp in pods]
        if not args.all:
            try:
                refuse(args.accounting)
            except RefusedCell as e:
                print(f"[dryrun] refused: {e}", file=sys.stderr)
                return 2
    os.makedirs(args.out, exist_ok=True)
    failures = refused = 0
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape or 'pca'}__{'multipod' if mp else 'singlepod'}"
        tag += "__eigen" if args.eigen else ""
        tag += f"__{args.tag}" if args.tag else ""
        try:
            if arch == "paper-pca":
                cal = None
                if args.calibrate:
                    from repro_torch.plan import load_calibration

                    cal = load_calibration(args.calibrate)
                rec = dryrun_paper_pca(
                    multi_pod=mp, device_count=args.device_count, backend=args.backend,
                    polar=args.polar, orth=args.orth, topology=args.topology,
                    comm_bits=args.comm_bits,
                    plan="auto" if args.plan == "auto" else None, explain=args.explain,
                    calibration=cal, plan_device=args.plan_device,
                    drop_shards=args.drop_shards, pods=args.pods,
                    stream_steps=args.stream_steps)
            else:
                rec = dryrun_cell(arch, shape, multi_pod=mp, eigen=args.eigen,
                                  device_count=args.device_count,
                                  accounting=args.accounting,
                                  overrides=overrides or None, mesh_shape=mesh_shape)
        except RefusedCell as e:
            refused += 1
            rec = {"arch": arch, "shape": shape, "multi_pod": mp, "refused_cell": str(e)}
            print(f"[dryrun] {tag}: REFUSED {e}")
        except Exception as e:
            failures += 1
            rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                   "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()}
            print(f"[dryrun] {tag}: FAIL {type(e).__name__}: {e}")
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=2, default=str)
    print(f"[dryrun] wrote {len(cells)} records to {args.out}; failures={failures} "
          f"refused={refused}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

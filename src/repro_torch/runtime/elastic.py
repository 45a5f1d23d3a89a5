"""Elastic aggregation: membership-masked rounds, re-planned on every change
(port of ``repro/runtime/elastic.py``).

Production rounds race preemptions and stragglers.  Here:

  * a per-round ``Membership`` comes from the injector's (shard, round)
    schedule (``runtime.fault.FailureInjector``): a dead shard is masked
    out of the collectives, not crashed;
  * consecutive rounds under the same membership run as one aggregation
    call, so the lossy wires' error-feedback residual telescopes within
    the group and starts from zero when membership changes (a residual
    owed to a set of shards that no longer exists would smear a dead
    shard's encoding error into the survivors' average);
  * every membership change, and every ``StragglerMonitor`` escalation,
    goes through ``replan``: the cube re-priced at the survivor count m'
    (the fresh m'-shard job the masked round equals; it re-checks the
    int8 psum's headroom at m');
  * a recovered shard rejoins by alignment: every group after the first
    takes the running estimate as ``ref``, so a rejoining shard's basis is
    rotated into the survivors' frame before it is averaged.

Two forms, as the estimator has: ``elastic_pca_collective`` (one shard a
rank of a process group; each group one ``procrustes_average_collective``
call) and ``elastic_pca`` (stacked, one process; each group one
``refinement_rounds`` call over ``distributed_pca``'s masked stack).
Both compute the local bases once.  The contract (``tests/
test_torch_elastic.py``): a run with shard k killed before round t
equals t full rounds, then n - t rounds over the survivors with the
round-t basis as reference, within ``PARITY_TOL[comm_bits]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.comm.membership import Membership
from repro_torch.plan.planner import Plan, _default_device_kind, plan_aggregation, resolve_plan
from repro_torch.runtime.straggler import StepTimer

__all__ = [
    "RoundEvent",
    "ElasticReport",
    "replan",
    "transition_reason",
    "elastic_pca",
    "elastic_pca_collective",
]


def replan(
    membership: Membership,
    *,
    d: int,
    r: int,
    n_iter: int = 1,
    device_kind: Optional[str] = None,
    backend: Optional[str] = None,
    topology: Optional[str] = None,
    polar: Optional[str] = None,
    orth: Optional[str] = None,
    ring_chunk: Optional[int] = None,
    comm_bits=None,
    ref_broadcast: bool = True,
    calibration=None,
    pods: Optional[int] = None,
    context: str = "collective",
) -> Plan:
    """The re-plan hook: ``plan_aggregation`` at ``m = membership.m_active``
    (the physical m under ``pods``: the hier schedule keeps its pod
    tiling, the dead shard masked inside its pod).  Knobs are pins, as in
    ``plan_aggregation``; ``context="stacked"`` prices the one-process
    form."""
    return plan_aggregation(
        m=membership.m if pods else membership.m_active, d=d, r=r,
        n_iter=n_iter, device_kind=device_kind, backend=backend,
        topology=topology, polar=polar, orth=orth, ring_chunk=ring_chunk,
        comm_bits=comm_bits, ref_broadcast=ref_broadcast,
        context=context, calibration=calibration, pods=pods,
    )


def transition_reason(prev: Optional[Membership], new: Membership) -> Optional[str]:
    """Classify a membership edge: "failure" if any shard newly died (even
    if others recovered in the same step), "recovery" for a pure rejoin,
    None for no change or no previous membership."""
    if prev is None or new == prev:
        return None
    return "failure" if set(new.dead) - set(prev.dead) else "recovery"


@dataclasses.dataclass(frozen=True)
class RoundEvent:
    """One (re-)planning decision: the rounds it covers and why."""

    round_index: int  # first round the decision applies to
    rounds: int       # length of the first group run under it
    reason: str       # "initial" | "failure" | "recovery" | "straggler"
    membership: Membership
    plan: Plan


@dataclasses.dataclass
class ElasticReport:
    """What an elastic run did: the estimate and its decision log."""

    basis: torch.Tensor   # (d, r) final estimate
    events: List[RoundEvent]
    rounds: int           # refinement rounds run
    replans: int          # re-plan hook calls
    final_membership: Membership


def _pins(plan, **knobs) -> dict:
    """The knobs every re-plan keeps: a given ``Plan``'s, else the caller's."""
    if isinstance(plan, Plan):
        return dict(backend=plan.backend, topology=plan.topology,
                    polar=plan.polar, orth=plan.orth,
                    ring_chunk=plan.ring_chunk, comm_bits=plan.comm_bits)
    return knobs


def _run(
    *,
    m: int,
    n_iter: int,
    first_plan: Plan,
    replan_at: Callable[[Membership, int], Plan],
    run_group: Callable[[Optional[torch.Tensor], Membership, int, Plan], torch.Tensor],
    injector,
    monitor,
    timer,
    max_group: Optional[int],
) -> ElasticReport:
    """The group loop both forms share.  ``replan_at(mem, rounds_left)``
    re-plans; ``run_group(ref, mem, g, plan)`` runs g rounds (``ref``
    None for the first group: the default reference, one broadcast)."""

    def membership_at(t: int) -> Membership:
        return Membership.full(m) if injector is None else injector.membership_at(t, m)

    pending = {"replan": False}
    if monitor is not None:
        user_cb = monitor.on_escalate

        def _escalate(step: int, dt: float):
            pending["replan"] = True
            if user_cb is not None:
                user_cb(step, dt)

        monitor.on_escalate = _escalate

    pl = first_plan
    events: List[RoundEvent] = []
    replans = 0
    ref = None
    cur: Optional[Membership] = None
    t = 0
    while t < n_iter:
        mem = membership_at(t)
        if cur is None:
            reason = "initial"
        else:
            reason = transition_reason(cur, mem) or (
                "straggler" if pending["replan"] else None)
        if reason is not None and reason != "initial":
            pl = replan_at(mem, n_iter - t)
            replans += 1
        pending["replan"] = False
        cur = mem
        # Group extent: same membership, capped so the monitor is heard.
        cap = n_iter - t if max_group is None else min(max_group, n_iter - t)
        g = 1
        while g < cap and membership_at(t + g) == mem:
            g += 1
        if reason is not None:
            events.append(RoundEvent(round_index=t, rounds=g, reason=reason,
                                     membership=mem, plan=pl))
        ref = run_group(ref, mem, g, pl)
        t += g
        if monitor is not None:
            monitor.record(t, timer.lap())
    return ElasticReport(basis=ref, events=events, rounds=n_iter,
                         replans=replans, final_membership=cur)


def elastic_pca_collective(
    x_local: torch.Tensor,
    r: int,
    *,
    group,
    device: str | torch.device = "cuda",
    n_iter: int = 1,
    solver: str = "eigh",
    iters: int = 30,
    injector: Optional[Any] = None,
    monitor: Optional[Any] = None,
    timer: Optional[Any] = None,
    max_group: Optional[int] = None,
    backend: Optional[str] = None,
    polar: Optional[str] = None,
    orth: Optional[str] = None,
    topology: Optional[str] = None,
    ring_chunk: Optional[int] = None,
    comm_bits=None,
    plan=None,
    device_kind: Optional[str] = None,
    calibration=None,
) -> ElasticReport:
    """``distributed_pca_collective`` that survives shard deaths, rejoins
    and stragglers: one shard a rank of ``group``.

    This rank's covariance and local basis are formed once; the rounds
    then run in groups of consecutive rounds sharing one membership, each
    group one ``procrustes_average_collective(..., membership=, ref=)``
    call.  ``injector`` (``FailureInjector``) gives the kill/recover
    schedule (``None``: all up); ``monitor`` (``StragglerMonitor``) is fed
    each group's wall time from ``timer`` (default a ``StepTimer`` that
    waits for the card), and an escalation re-plans at the next group;
    ``max_group`` caps the rounds a group fuses.  The knobs and ``plan``
    resolve the first plan as ``distributed_pca_collective`` does (at the
    round-0 membership); every later change or escalation calls
    ``replan`` with the same knobs as pins, at the rounds left.  The
    first group uses the first survivor's basis as reference; later groups
    the running estimate.  Returns an ``ElasticReport`` (the same basis
    on every rank).
    """
    from repro_torch.core.distributed import _local_basis, procrustes_average_collective
    from repro_torch.interop import resolve_device, strict_fp32

    dev = resolve_device(device)
    strict_fp32()
    m = dist.get_world_size(group)
    d = x_local.shape[-1]
    n_iter = max(n_iter, 1)
    kind = device_kind or _default_device_kind(dev)
    pins = _pins(plan, backend=backend, topology=topology, polar=polar,
                 orth=orth, ring_chunk=ring_chunk, comm_bits=comm_bits)
    mem0 = injector.membership_at(0, m) if injector is not None else None
    pl = resolve_plan(plan, m=m, d=d, r=r, n_iter=n_iter, device_kind=kind,
                      calibration=calibration, membership=mem0,
                      tensor_device=dev, **pins)
    v = _local_basis(x_local.to(dev), r, backend=pl.backend, solver=solver,
                     iters=iters)

    def run_group(ref, mem, g, group_plan):
        return procrustes_average_collective(
            v, group=group, n_iter=g, ref=ref, plan=group_plan, membership=mem)

    return _run(
        m=m, n_iter=n_iter, first_plan=pl,
        replan_at=lambda mem, left: replan(
            mem, d=d, r=r, n_iter=left, ref_broadcast=False, device_kind=kind,
            calibration=calibration, **pins),
        run_group=run_group, injector=injector, monitor=monitor,
        timer=timer or StepTimer(dev), max_group=max_group,
    )


def elastic_pca(
    samples: torch.Tensor,
    r: int,
    *,
    shards: int,
    device: str | torch.device = "cuda",
    n_iter: int = 1,
    solver: str = "eigh",
    iters: int = 30,
    injector: Optional[Any] = None,
    monitor: Optional[Any] = None,
    timer: Optional[Any] = None,
    max_group: Optional[int] = None,
    backend: Optional[str] = None,
    polar: Optional[str] = None,
    orth: Optional[str] = None,
    comm_bits=None,
    plan=None,
    device_kind: Optional[str] = None,
    calibration=None,
) -> ElasticReport:
    """The stacked (one-process) form of ``elastic_pca_collective``:
    ``samples`` (N, d) split into ``shards`` row blocks as in
    ``distributed_pca``.  Every shard's local basis is formed once and
    passed through the gather wire's codec at ``comm_bits``; each group
    runs ``refinement_rounds`` over the stack of its live shards, priced
    and re-planned in the stacked context.  Arguments otherwise as
    ``elastic_pca_collective``."""
    from repro_torch.comm.quantize import get_codec
    from repro_torch.core.distributed import _gather_codec, _local_basis
    from repro_torch.core.eigenspace import refinement_rounds
    from repro_torch.interop import resolve_device, strict_fp32

    dev = resolve_device(device)
    strict_fp32()
    n_total, d = samples.shape
    if shards < 1 or n_total % shards:
        raise ValueError(f"{n_total} samples do not split into {shards} equal shards")
    n_iter = max(n_iter, 1)
    kind = device_kind or _default_device_kind(dev)
    # The stacked form has one schedule (gather) and no ring.
    pins = {k: v for k, v in _pins(plan, backend=backend, polar=polar, orth=orth,
                                   comm_bits=comm_bits).items()
            if k in ("backend", "polar", "orth", "comm_bits")}
    mem0 = injector.membership_at(0, shards) if injector is not None else None
    pl = resolve_plan(plan, m=shards, d=d, r=r, n_iter=n_iter, device_kind=kind,
                      calibration=calibration, membership=mem0,
                      context="stacked", tensor_device=dev, **pins)
    codec = get_codec(pl.comm_bits)
    xs = samples.to(dev).reshape(shards, n_total // shards, d)
    vs = torch.stack([
        _gather_codec(_local_basis(x, r, backend=pl.backend, solver=solver,
                                   iters=iters), codec, i)
        for i, x in enumerate(xs)
    ])

    def run_group(ref, mem, g, group_plan):
        live = vs if mem.is_full else vs[list(mem.indices)]
        return refinement_rounds(live.contiguous(), ref, n_iter=g, plan=group_plan)

    return _run(
        m=shards, n_iter=n_iter, first_plan=pl,
        replan_at=lambda mem, left: replan(
            mem, d=d, r=r, n_iter=left, ref_broadcast=False, device_kind=kind,
            calibration=calibration, context="stacked", **pins),
        run_group=run_group, injector=injector, monitor=monitor,
        timer=timer or StepTimer(dev), max_group=max_group,
    )

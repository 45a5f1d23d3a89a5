"""Distributed PCA, in one process or across the ranks of a process group
(port of ``repro/core/distributed.py``).

Two forms of the same estimator:

  * ``distributed_pca`` (stacked, one process): the m machines are the
    leading axis of an (m, d, r) stack on one device; each shard forms its
    covariance and local basis and the stacked rounds follow
    (``refinement_rounds``).  This is the reference's gather topology after
    its all-gather, so "gather" (and "auto") is its only schedule; with
    ``comm_bits`` each basis passes the gather wire's codec, and
    ``membership`` drops dead shards, as the collective gather does.
  * ``distributed_pca_collective`` (one shard per rank, e.g. under
    ``torchrun``): each rank passes its own (n_local, d) shard, forms its
    basis, and ``procrustes_average_collective`` aggregates over the
    process group by the chosen topology.

``procrustes_average_collective`` routes as the reference does:

  * ring + cuda + newton-schulz + cholesky-qr2 -> ``fused_ring_rounds``
    (one B6 launch per round); other ring cells -> ``ring_rounds``;
  * gather -> all-gather at wire precision, then the stacked
    ``refinement_rounds`` (where B5 serves its cell);
  * psum -> ``kops.align_one`` on the local basis and a wire-precision
    all-reduce per round;
  * hier -> ``comm.hier.hier_rounds`` over the (pod, local) groups: the
    psum body, an exact all-reduce over the pod's local group and a ring
    of the pod sums over the pod group.

``topology="auto"`` pairs with the backend as in the reference: "gather"
under "cuda" (the reference's "pallas"), "psum" otherwise.  Every function
takes its ``ProcessGroup`` explicitly; the hier topology takes two, the
local group as ``group`` and the pod group as ``pod_group``
(``launch.mesh.make_aggregation_mesh(pods=)`` builds both).

``distributed_pca_from_covs`` starts from each rank's pre-formed local
matrix instead of its samples (the paper's abstract setting), with an
optional ``ref``.

Every entry point takes ``plan=None|"auto"|Plan`` and resolves the knobs
once through ``repro_torch.plan.resolve_plan`` (``None``: the per-knob
defaults above; ``"auto"``: the cost-model planner decides the free
knobs, priced at the survivor count of ``membership``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.comm import transport
from repro_torch.comm.membership import Membership, resolve_membership
from repro_torch.comm.quantize import (
    get_codec,
    shard_generator,
    wire_broadcast,
    wire_psum_mean,
)
from repro_torch.comm.hier import hier_rounds
from repro_torch.comm.ring import fused_ring_rounds, ring_rounds
from repro_torch.comm.topology import (
    TOPOLOGY_CHOICES,
    broadcast_from,
    resolve_topology,
)
from repro_torch.core import procrustes
from repro_torch.core.covariance import empirical_covariance
from repro_torch.core.eigenspace import refinement_rounds
from repro_torch.core.orthonorm import orthonormalize, resolve_orth
from repro_torch.core.subspace import local_eigenbasis
from repro_torch.interop import resolve_device, strict_fp32

__all__ = [
    "TOPOLOGY_CHOICES",
    "resolve_stacked_topology",
    "procrustes_average_collective",
    "sign_average_collective",
    "distributed_pca",
    "distributed_pca_collective",
    "distributed_pca_from_covs",
]

# Stochastic-rounding stream salts of the psum and gather sites.
_PSUM_SALT = 0x5053554D
_GATHER_SALT = 0x47415452


def resolve_stacked_topology(topology: str | None) -> str:
    """The one-process form's schedule: "gather" for None/"auto"/"gather";
    psum, ring and hier run across ranks (``distributed_pca_collective``)."""
    topology = topology or "auto"
    if topology in ("auto", "gather"):
        return "gather"
    if topology in ("psum", "ring", "hier"):
        raise ValueError(
            f"topology={topology!r} runs across the ranks of a process group: "
            "use distributed_pca_collective (e.g. under torchrun); the "
            "stacked one-process form has only the 'gather' schedule"
        )
    raise ValueError(f"topology must be one of {TOPOLOGY_CHOICES}, got {topology!r}")


def _machines(group, pod_group, topology) -> tuple[int, int | None]:
    """(machines, pods) of an aggregation over ``group`` and, under the
    hier topology, ``pod_group`` (pods x local ranks)."""
    if topology == "hier" and pod_group is None:
        raise ValueError(
            "topology='hier' and pod_group= go together: the two-level "
            "schedule needs the (pod, local) groups (got pod_group=None)"
        )
    local = dist.get_world_size(group)
    if pod_group is None:
        return local, None
    pods = dist.get_world_size(pod_group)
    return pods * local, pods


def procrustes_average_collective(
    v_local: torch.Tensor,
    *,
    group,
    n_iter: int = 1,
    ref: torch.Tensor | None = None,
    backend: str | None = None,
    polar: str | None = None,
    orth: str | None = None,
    topology: str | None = None,
    ring_chunk: int | None = None,
    comm_bits=None,
    plan=None,
    membership: Membership | None = None,
    pod_group=None,
) -> torch.Tensor:
    """Algorithm 1 (``n_iter=1``) / Algorithm 2 over the ranks of ``group``.

    ``v_local``: this rank's (d, r) local basis.  ``ref`` defaults to the
    first surviving rank's basis.  ``backend`` "torch" | "cuda" | "auto"
    (default "torch"), ``polar`` (default "svd"), ``orth`` (default
    "qr"), ``topology`` "psum" | "gather" | "ring" | "hier" | "auto",
    ``ring_chunk`` rows per ring message (default ``DEFAULT_RING_CHUNK``),
    ``comm_bits`` 32 | 16 | 8 | "auto" (default 32), ``membership`` the
    active-rank mask (``None``: all alive).  ``topology="hier"`` and
    ``pod_group`` go together: ``group`` is then this rank's pod-local
    group and ``pod_group`` its slot's group across pods, the machines are
    all pods x local ranks (pod-major), and ``membership`` is over them.
    ``plan`` ``None`` | ``"auto"`` | a ``repro_torch.plan.Plan`` resolves
    the knobs (``repro_torch.plan.resolve_plan``; "auto" plans the free
    ones, concrete knobs are pins, priced at the survivor count).  Returns
    the (d, r) estimate, the same on every rank.
    """
    from repro_torch.kernels import ops as kops
    from repro_torch.plan.planner import resolve_plan  # the planner sits above

    d, r = v_local.shape
    m, pods = _machines(group, pod_group, topology)
    mem = resolve_membership(membership, m)
    pl = resolve_plan(
        plan, m=m, d=d, r=r, n_iter=n_iter, backend=backend, topology=topology,
        polar=polar, orth=orth, ring_chunk=ring_chunk, comm_bits=comm_bits,
        ref_broadcast=ref is None, membership=mem, pods=pods,
        tensor_device=v_local.device,
    )
    backend = pl.backend
    polar = procrustes.resolve_polar(pl.polar)
    orth = resolve_orth(pl.orth)
    topo = resolve_topology(pl.topology, backend)
    if (topo == "hier") != (pod_group is not None):
        raise ValueError(
            "topology='hier' and pod_group= go together: the two-level "
            "schedule needs the (pod, local) groups, and no flat topology "
            f"spans two (got topology={topo!r}, pod_group="
            f"{'set' if pod_group is not None else None})"
        )
    chunk, bits = pl.ring_chunk, pl.comm_bits
    if topo == "hier":
        return hier_rounds(
            v_local, ref, local_group=group, pod_group=pod_group,
            n_iter=n_iter, backend=backend, polar=polar, orth=orth,
            chunk=chunk, comm_bits=bits, membership=mem,
        )
    rank = dist.get_rank(group)
    codec = get_codec(bits)
    dev = v_local.device
    if topo == "gather":
        if codec.lossy:
            gen = (shard_generator(_GATHER_SALT, rank, 0, dev)
                   if codec.stochastic else None)
            data, scale = codec.encode(v_local.to(torch.float32), gen)
            g = transport.all_gather(data, group=group)
            gs = (None if scale is None
                  else transport.all_gather(scale, group=group)[:, None, :])
            # The stacked rounds run at the payload's dtype.
            vs = codec.decode(g, gs).to(v_local.dtype)
        else:
            vs = transport.all_gather(v_local, group=group)
        if not mem.is_full:
            vs = vs[list(mem.indices)]
        return refinement_rounds(
            vs.contiguous(), ref, n_iter=n_iter, backend=backend, polar=polar,
            orth=orth,
        )
    if topo == "ring":
        if backend == "cuda" and polar == "newton-schulz" and orth == "cholesky-qr2":
            return fused_ring_rounds(
                v_local, ref, group=group, n_iter=n_iter, chunk=chunk,
                comm_bits=bits, membership=mem,
            )
        return ring_rounds(
            v_local, ref, group=group, n_iter=n_iter, polar=polar, orth=orth,
            chunk=chunk, comm_bits=bits, membership=mem, backend=backend,
        )
    m = mem.m_active
    if ref is None:
        gen = shard_generator(_PSUM_SALT, rank, 0, dev) if codec.stochastic else None
        ref = wire_broadcast(v_local, codec, src=mem.first_active, group=group,
                             generator=gen).to(v_local.dtype)
    alive = mem.active[rank]
    err = (torch.zeros(v_local.shape, dtype=torch.float32, device=dev)
           if codec.lossy else None)
    for k in range(max(n_iter, 1)):
        aligned = kops.align_for_backend(v_local, ref, polar=polar, backend=backend)
        if codec.lossy:
            gen = (shard_generator(_PSUM_SALT, rank, k + 1, dev)
                   if codec.stochastic else None)
            send = aligned.to(torch.float32) + err
            if not alive:
                send = torch.zeros_like(send)
            vbar, err = wire_psum_mean(send, m, codec, group=group, generator=gen)
            vbar = vbar.to(v_local.dtype)
        else:
            contrib = aligned.to(v_local.dtype)
            if not alive:
                contrib = torch.zeros_like(contrib)
            vbar = transport.all_reduce(contrib, group=group) / m
        ref = orthonormalize(vbar, orth=orth)
    return ref


def sign_average_collective(v_local: torch.Tensor, *, group) -> torch.Tensor:
    """Rank-1 sign fixing (Garber et al.) across the group."""
    m = dist.get_world_size(group)
    ref = broadcast_from(v_local, src=0, group=group)
    fixed = procrustes.sign_fix(v_local, ref).contiguous()
    vbar = transport.all_reduce(fixed, group=group) / m
    return vbar / torch.linalg.norm(vbar)


def _local_basis(x, r, *, backend, solver, iters):
    return local_eigenbasis(
        empirical_covariance(x, backend=backend), r, method=solver, iters=iters
    )[0]


def _gather_codec(v: torch.Tensor, codec, shard: int) -> torch.Tensor:
    """Shard ``shard``'s basis as the gather topology's wire delivers it:
    encoded with the collective gather's generator (``_GATHER_SALT``, the
    shard, round 0), decoded, in ``v``'s dtype."""
    if not codec.lossy:
        return v
    gen = (shard_generator(_GATHER_SALT, shard, 0, v.device)
           if codec.stochastic else None)
    data, scale = codec.encode(v.to(torch.float32), gen)
    return codec.decode(data, scale).to(v.dtype)


def distributed_pca(
    samples: torch.Tensor,
    r: int,
    *,
    shards: int,
    device: str | torch.device = "cuda",
    n_iter: int = 1,
    solver: str = "eigh",
    iters: int = 30,
    backend: str | None = None,
    polar: str | None = None,
    orth: str | None = None,
    topology: str | None = None,
    comm_bits=None,
    plan=None,
    membership: Membership | None = None,
) -> torch.Tensor:
    """One-process (stacked) distributed PCA.

    ``samples`` (N, d) split into ``shards`` equal row blocks (the
    machines); each live one forms its covariance and top-r basis
    (``solver`` "eigh" or "subspace" with ``iters`` steps), then ``n_iter``
    rounds align, average and orthonormalize the stack.  ``backend``
    ("torch" | "cuda" | "auto", default "torch") routes both the
    covariance and the rounds; ``polar``/``orth`` as in
    ``refinement_rounds``; ``topology`` "gather"/"auto" only.
    ``comm_bits`` (32 | 16 | 8) passes each basis through the gather
    topology's wire codec, with the collective gather's generators, so
    the stack is the one ``distributed_pca_collective`` gathers;
    ``membership`` drops the dead shards from the stack (the first
    survivor's basis is the reference).  ``plan`` (``None`` | ``"auto"`` |
    a ``Plan``) resolves the knobs once here, in the stacked context, and
    routes the covariance stage too.  Runs on ``device`` (default the
    card; raises if there is none).  Returns the (d, r) estimate.
    """
    from repro_torch.plan.planner import resolve_plan

    dev = resolve_device(device)
    strict_fp32()
    n_total, d = samples.shape
    if shards < 1 or n_total % shards:
        raise ValueError(
            f"{n_total} samples do not split into {shards} equal shards"
        )
    resolve_stacked_topology(getattr(plan, "topology", topology))
    mem = resolve_membership(membership, shards)
    pl = resolve_plan(
        plan, m=shards, d=d, r=r, n_iter=n_iter, backend=backend, polar=polar,
        orth=orth, comm_bits=comm_bits, context="stacked", membership=mem,
        tensor_device=dev,
    )
    codec = get_codec(pl.comm_bits)
    xs = samples.to(dev).reshape(shards, n_total // shards, d)
    vs = torch.stack([
        _gather_codec(_local_basis(xs[i], r, backend=pl.backend, solver=solver,
                                   iters=iters), codec, i)
        for i in mem.indices
    ])
    return refinement_rounds(vs, n_iter=n_iter, plan=pl)


def distributed_pca_collective(
    x_local: torch.Tensor,
    r: int,
    *,
    group,
    device: str | torch.device = "cuda",
    n_iter: int = 1,
    solver: str = "eigh",
    iters: int = 30,
    backend: str | None = None,
    polar: str | None = None,
    orth: str | None = None,
    topology: str | None = None,
    ring_chunk: int | None = None,
    comm_bits=None,
    plan=None,
    membership: Membership | None = None,
    pod_group=None,
) -> torch.Tensor:
    """Distributed PCA with one shard per rank of ``group``: this rank's
    (n_local, d) ``x_local`` gives its covariance and top-r basis on
    ``device``, and ``procrustes_average_collective`` aggregates (knobs,
    and ``pod_group`` with ``topology="hier"``, as there).  ``plan`` is
    resolved once here, so a planned backend also routes the covariance.
    Returns the (d, r) estimate on every rank."""
    from repro_torch.plan.planner import resolve_plan

    dev = resolve_device(device)
    strict_fp32()
    m, pods = _machines(group, pod_group, topology)
    mem = resolve_membership(membership, m)
    pl = resolve_plan(
        plan, m=m, d=x_local.shape[-1], r=r, n_iter=n_iter, backend=backend,
        topology=topology, polar=polar, orth=orth, ring_chunk=ring_chunk,
        comm_bits=comm_bits, membership=mem, pods=pods, tensor_device=dev,
    )
    v = _local_basis(x_local.to(dev), r, backend=pl.backend, solver=solver,
                     iters=iters)
    return procrustes_average_collective(
        v, group=group, n_iter=n_iter, plan=pl, membership=mem,
        pod_group=pod_group,
    )


def distributed_pca_from_covs(
    cov_local: torch.Tensor,
    r: int,
    *,
    group,
    device: str | torch.device = "cuda",
    n_iter: int = 1,
    solver: str = "eigh",
    iters: int = 30,
    backend: str | None = None,
    polar: str | None = None,
    orth: str | None = None,
    topology: str | None = None,
    ring_chunk: int | None = None,
    comm_bits=None,
    plan=None,
    membership: Membership | None = None,
    pod_group=None,
    ref: torch.Tensor | None = None,
) -> torch.Tensor:
    """Distributed PCA from pre-formed local matrices (the paper's abstract
    setting: each machine holds a noisy X^i, e.g. quadratic sensing's D_N)
    with one machine per rank of ``group``: ``cov_local`` is this rank's
    (d, d) matrix, or a (k, d, d) block whose mean it takes.  Its top-r
    basis on ``device`` goes to ``procrustes_average_collective`` (knobs,
    ``plan`` and ``pod_group`` with ``topology="hier"``, as there; the
    plan is resolved once here).  ``ref`` optionally supplies the (d, r)
    alignment reference, the same on every rank, in place of the first
    live rank's basis (no reference broadcast then).  Returns the (d, r)
    estimate on every rank."""
    from repro_torch.plan.planner import resolve_plan

    dev = resolve_device(device)
    strict_fp32()
    cov = cov_local.to(dev)
    if cov.dim() == 3:
        cov = cov.mean(dim=0)
    m, pods = _machines(group, pod_group, topology)
    mem = resolve_membership(membership, m)
    pl = resolve_plan(
        plan, m=m, d=cov.shape[-1], r=r, n_iter=n_iter, backend=backend,
        topology=topology, polar=polar, orth=orth, ring_chunk=ring_chunk,
        comm_bits=comm_bits, ref_broadcast=ref is None, membership=mem,
        pods=pods, tensor_device=dev,
    )
    v, _ = local_eigenbasis(cov, r, method=solver, iters=iters)
    return procrustes_average_collective(
        v, group=group, n_iter=n_iter, ref=None if ref is None else ref.to(dev),
        plan=pl, membership=mem, pod_group=pod_group,
    )

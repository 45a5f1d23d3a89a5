"""Distributed PCA, in one process or across the ranks of a process group
(port of ``repro/core/distributed.py``).

Two forms of the same estimator:

  * ``distributed_pca`` (stacked, one process): the m machines are the
    leading axis of an (m, d, r) stack on one device; each shard forms its
    covariance and local basis and the stacked rounds follow
    (``refinement_rounds``).  This is the reference's gather topology after
    its all-gather, so "gather" (and "auto") is its only schedule.
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
    all-reduce per round.

``topology="auto"`` pairs with the backend as in the reference: "gather"
under "cuda" (the reference's "pallas"), "psum" otherwise.  Every function
takes its ``ProcessGroup`` explicitly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.comm import transport
from repro_torch.comm.membership import Membership, resolve_membership
from repro_torch.comm.quantize import (
    get_codec,
    resolve_comm_bits,
    shard_generator,
    wire_broadcast,
    wire_psum_mean,
)
from repro_torch.comm.ring import DEFAULT_RING_CHUNK, fused_ring_rounds, ring_rounds
from repro_torch.comm.topology import (
    HIER_LATER,
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
]

# Stochastic-rounding stream salts of the psum and gather sites.
_PSUM_SALT = 0x5053554D
_GATHER_SALT = 0x47415452


def resolve_stacked_topology(topology: str | None) -> str:
    """The one-process form's schedule: "gather" for None/"auto"/"gather";
    psum and ring run across ranks (``distributed_pca_collective``)."""
    topology = topology or "auto"
    if topology in ("auto", "gather"):
        return "gather"
    if topology == "hier":
        raise NotImplementedError(HIER_LATER)
    if topology in ("psum", "ring"):
        raise ValueError(
            f"topology={topology!r} runs across the ranks of a process group: "
            "use distributed_pca_collective (e.g. under torchrun); the "
            "stacked one-process form has only the 'gather' schedule"
        )
    raise ValueError(f"topology must be one of {TOPOLOGY_CHOICES}, got {topology!r}")


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
) -> torch.Tensor:
    """Algorithm 1 (``n_iter=1``) / Algorithm 2 over the ranks of ``group``.

    ``v_local``: this rank's (d, r) local basis.  ``ref`` defaults to the
    first surviving rank's basis.  ``backend`` "torch" | "cuda" | "auto"
    (default "torch"), ``polar`` (default "svd"), ``orth`` (default
    "qr"), ``topology`` "psum" | "gather" | "ring" | "auto", ``ring_chunk``
    rows per ring message (default ``DEFAULT_RING_CHUNK``), ``comm_bits``
    32 | 16 | 8 (default 32), ``membership`` the active-rank mask
    (``None``: all alive).  ``plan`` takes only ``None``: the planner is
    ROADMAP A7.  Returns the (d, r) estimate, the same on every rank.
    """
    from repro_torch.kernels import ops as kops

    if plan is not None:
        raise NotImplementedError(
            "plan= needs the cost-model planner, not ported yet (ROADMAP A7)"
        )
    rank = dist.get_rank(group)
    mem = resolve_membership(membership, dist.get_world_size(group))
    backend = kops.resolve_backend(backend or "torch", v_local.device)
    polar = procrustes.resolve_polar(polar or "svd")
    orth = resolve_orth(orth or "qr")
    topo = resolve_topology(topology, backend)
    chunk = DEFAULT_RING_CHUNK if ring_chunk is None else ring_chunk
    bits = resolve_comm_bits(comm_bits)
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
) -> torch.Tensor:
    """One-process (stacked) distributed PCA.

    ``samples`` (N, d) split into ``shards`` equal row blocks (the
    machines); each forms its covariance and top-r basis (``solver``
    "eigh" or "subspace" with ``iters`` steps), then ``n_iter`` rounds
    align, average and orthonormalize the (shards, d, r) stack.
    ``backend`` ("torch" | "cuda" | "auto", default "torch") routes both
    the covariance and the rounds; ``polar``/``orth`` as in
    ``refinement_rounds``; ``topology`` "gather"/"auto" only.  Runs on
    ``device`` (default the card; raises if there is none).  Returns the
    (d, r) estimate.
    """
    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)
    strict_fp32()
    resolve_stacked_topology(topology)
    n_total, d = samples.shape
    if shards < 1 or n_total % shards:
        raise ValueError(
            f"{n_total} samples do not split into {shards} equal shards"
        )
    backend = kops.resolve_backend(backend or "torch", dev)
    xs = samples.to(dev).reshape(shards, n_total // shards, d)
    vs = torch.stack([
        _local_basis(x, r, backend=backend, solver=solver, iters=iters)
        for x in xs
    ])
    return refinement_rounds(
        vs, n_iter=n_iter, backend=backend, polar=polar, orth=orth
    )


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
    membership: Membership | None = None,
) -> torch.Tensor:
    """Distributed PCA with one shard per rank of ``group``: this rank's
    (n_local, d) ``x_local`` gives its covariance and top-r basis on
    ``device``, and ``procrustes_average_collective`` aggregates (knobs as
    there).  Returns the (d, r) estimate on every rank."""
    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)
    strict_fp32()
    backend = kops.resolve_backend(backend or "torch", dev)
    v = _local_basis(x_local.to(dev), r, backend=backend, solver=solver,
                     iters=iters)
    return procrustes_average_collective(
        v, group=group, n_iter=n_iter, backend=backend, polar=polar, orth=orth,
        topology=topology, ring_chunk=ring_chunk, comm_bits=comm_bits,
        membership=membership,
    )

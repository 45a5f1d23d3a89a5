"""Topology registry, broadcast, and the bits-per-estimation cost model
(port of ``repro/comm/topology.py``).

A topology is the communication schedule a refinement round runs over a
process group, independent of ``backend=`` (the compute path):

  * ``"psum"``   - broadcast the first rank's basis as the reference, align
                   locally on every rank, one d·r all-reduce per round.
  * ``"gather"`` - one all-gather of the m local bases, then the stacked
                   rounds (``repro_torch.core.eigenspace``) on every rank.
  * ``"ring"``   - the bases circulate the ring of ranks, each consumed the
                   hop it arrives (``repro_torch.comm.ring``); under the
                   cuda backend's (newton-schulz, cholesky-qr2) cell every
                   round is one launch of the fused ring-round kernel.
  * ``"hier"``   - the two-level schedule over (pod, local) process groups
                   (``repro_torch.comm.hier``): align locally, one exact
                   f32 all-reduce over the pod's local group, then a ring
                   of the p pod sums over the pod group at ``comm_bits``.

``"auto"`` keeps the reference's backend pairing: "gather" under the
kernels ("cuda", the reference's "pallas"), "psum" otherwise.

Cost model (as formulas, identical to the reference's): ``CommCost.bits``
is the wire bits of one estimation at ``comm_bits``; one (d, r) message
costs ``quantize.message_bits(d, r, comm_bits)``.  ``CommCost.words`` is
the precision-independent logical payload (the paper's accounting), and
``kind_bits`` splits ``bits`` per device by collective kind, under the
reference's ``hlo_bits`` keys; for "hier" ``levels`` splits it again by
link, ``{"intra": {kind: bits}, "inter": {kind: bits}}``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.comm import transport
from repro_torch.comm.membership import (
    Membership,
    pod_membership,
    resolve_membership,
)
from repro_torch.comm.quantize import message_bits, resolve_comm_bits

__all__ = [
    "TOPOLOGIES",
    "TOPOLOGY_CHOICES",
    "resolve_topology",
    "axis_size",
    "broadcast_from",
    "CommCost",
    "comm_cost",
    "paper_coordinator_words",
    "fan_projector_words",
]

TOPOLOGIES = ("psum", "gather", "ring", "hier")

# Accepted spellings: the registry plus "auto", resolved against the backend.
TOPOLOGY_CHOICES = TOPOLOGIES + ("auto",)


def resolve_topology(topology: str | None, backend: str = "torch") -> str:
    """Resolve a ``topology=`` switch against the resolved backend
    ("torch" | "cuda"): "auto" is "gather" under "cuda", else "psum"."""
    topology = topology or "auto"
    if topology == "auto":
        return "gather" if backend == "cuda" else "psum"
    if topology not in TOPOLOGIES:
        raise ValueError(
            f"topology must be one of {TOPOLOGY_CHOICES}, got {topology!r}"
        )
    return topology


def axis_size(group) -> int:
    """Number of ranks in the process group (no collective)."""
    return dist.get_world_size(group)


def broadcast_from(x: torch.Tensor, *, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank (one x.numel() broadcast)."""
    return transport.broadcast(x.clone().contiguous(), src=src, group=group)


@dataclasses.dataclass(frozen=True)
class CommCost:
    """Communication bill of one estimation (n_iter rounds).  ``levels``
    (two-level "hier" only, else None) splits ``kind_bits`` by link:
    {"intra": {kind: bits}, "inter": {kind: bits}}."""

    topology: str
    comm_bits: int
    words: int
    bits: int
    kind_bits: Dict[str, int]
    levels: Dict[str, Dict[str, int]] | None = None


def comm_cost(
    topology: str,
    *,
    m: int,
    d: int,
    r: int,
    n_iter: int = 1,
    ref_broadcast: bool = True,
    comm_bits=32,
    membership: Membership | None = None,
    pods: int | None = None,
) -> CommCost:
    """Bits a topology moves for ``n_iter`` refinement rounds.

    ``ref_broadcast=False`` drops the initial reference broadcast
    (psum/ring/hier; gather never broadcasts).  Under a degraded
    ``membership`` psum and gather are unchanged (the collectives still
    span all m ranks), while the ring shrinks to n·(m'-1) hop messages and
    adds one exact f32 d·r broadcast that hands the survivors' answer to
    every rank.

    ``topology="hier"`` needs ``pods=p`` (m = p * local, pod-major ranks)
    and bills two levels (``CommCost.levels``): **intra**, always exact
    f32 over each pod's local group and skipped when local == 1, one d·r
    broadcast stage of the reference plus one d·r all-reduce a round;
    **inter**, over the pod group at ``comm_bits``, one wire-precision
    broadcast stage of the reference, n·(p'-1) ring-hop messages (p' the
    live pods) and, only when a whole pod is dead, one exact f32 d·r
    broadcast that re-replicates the answer on the dead pod's ranks."""
    t = resolve_topology(topology)
    bits_per = resolve_comm_bits(comm_bits)
    mem = resolve_membership(membership, m)
    n = max(n_iter, 1)
    basis = d * r
    msg = message_bits(d, r, bits_per)
    bcast_w = basis if ref_broadcast else 0
    bcast_b = msg if ref_broadcast else 0
    if t == "hier":
        if pods is None:
            raise ValueError("topology='hier' needs pods= (m = pods * local)")
        p = int(pods)
        if p < 1 or m % p:
            raise ValueError(f"pods={pods} does not tile m={m} into equal pods")
        local = m // p
        pmem = pod_membership(mem, p)
        hops = pmem.m_active - 1 if p > 1 else 0
        intra_ar = (bcast_w + n * basis) * 32 if local > 1 else 0
        hop_bits = n * hops * msg
        sync_w = 0 if (pmem.is_full or p == 1) else basis
        inter_ar = (bcast_b if p > 1 else 0) + sync_w * 32
        words = ((bcast_w if local > 1 else 0) + (bcast_w if p > 1 else 0)
                 + n * ((basis if local > 1 else 0) + hops * basis) + sync_w)
        return CommCost(
            "hier", bits_per, words, intra_ar + inter_ar + hop_bits,
            {"all-reduce": intra_ar + inter_ar, "collective-permute": hop_bits},
            levels={"intra": {"all-reduce": intra_ar},
                    "inter": {"all-reduce": inter_ar,
                              "collective-permute": hop_bits}},
        )
    if t == "psum":
        bits = bcast_b + n * msg
        return CommCost("psum", bits_per, bcast_w + n * basis, bits,
                        {"all-reduce": bits})
    if t == "gather":
        return CommCost("gather", bits_per, m * basis, m * msg,
                        {"all-gather": msg})
    hops = mem.m_active - 1
    hop_bits = n * hops * msg
    sync_w = 0 if mem.is_full else basis
    return CommCost(
        "ring", bits_per,
        bcast_w + n * hops * basis + sync_w,
        bcast_b + hop_bits + sync_w * 32,
        {"all-reduce": bcast_b + sync_w * 32, "collective-permute": hop_bits},
    )


def paper_coordinator_words(m: int, d: int, r: int) -> int:
    """The paper's hub-and-spoke presentation: m bases up, one back."""
    return m * d * r + d * r


def fan_projector_words(d: int) -> int:
    """Fan et al. 2019 baseline: one d x d spectral-projector all-reduce."""
    return d * d

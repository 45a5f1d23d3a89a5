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

``"hier"`` (the two-level (pod, local) schedule over two process groups)
is the next slice of the port and raises.  ``"auto"`` keeps the
reference's backend pairing: "gather" under the kernels ("cuda", the
reference's "pallas"), "psum" otherwise.

Cost model (as formulas, identical to the reference's): ``CommCost.bits``
is the wire bits of one estimation at ``comm_bits``; one (d, r) message
costs ``quantize.message_bits(d, r, comm_bits)``.  ``CommCost.words`` is
the precision-independent logical payload (the paper's accounting), and
``kind_bits`` splits ``bits`` per device by collective kind, under the
reference's ``hlo_bits`` keys.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.comm import transport
from repro_torch.comm.membership import Membership, resolve_membership
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

TOPOLOGIES = ("psum", "gather", "ring")

# Accepted spellings: "hier" is recognised so that it can be refused
# with its reason, "auto" resolves against the backend.
TOPOLOGY_CHOICES = TOPOLOGIES + ("hier", "auto")

HIER_LATER = (
    "topology='hier' (intra-pod psum plus an inter-pod ring over two "
    "process groups, repro/comm/hier.py) is the next slice of the port "
    "(ROADMAP A5-hier); use psum, gather or ring"
)


def resolve_topology(topology: str | None, backend: str = "torch") -> str:
    """Resolve a ``topology=`` switch against the resolved backend
    ("torch" | "cuda"): "auto" is "gather" under "cuda", else "psum"."""
    topology = topology or "auto"
    if topology == "auto":
        return "gather" if backend == "cuda" else "psum"
    if topology == "hier":
        raise NotImplementedError(HIER_LATER)
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
    """Communication bill of one estimation (n_iter rounds)."""

    topology: str
    comm_bits: int
    words: int
    bits: int
    kind_bits: Dict[str, int]


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
) -> CommCost:
    """Bits a topology moves for ``n_iter`` refinement rounds.

    ``ref_broadcast=False`` drops the initial reference broadcast
    (psum/ring; gather never broadcasts).  Under a degraded ``membership``
    psum and gather are unchanged (the collectives still span all m
    ranks), while the ring shrinks to n·(m'-1) hop messages and adds one
    exact f32 d·r broadcast that hands the survivors' answer to every
    rank."""
    t = resolve_topology(topology)
    bits_per = resolve_comm_bits(comm_bits)
    mem = resolve_membership(membership, m)
    n = max(n_iter, 1)
    basis = d * r
    msg = message_bits(d, r, bits_per)
    bcast_w = basis if ref_broadcast else 0
    bcast_b = msg if ref_broadcast else 0
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

"""Shard membership for elastic (degraded) collectives (port of
``repro/comm/membership.py``, plain Python, copied rather than imported).

``Membership`` is the masking contract every topology honours
(``repro_torch.core.distributed``, ``repro_torch.comm.ring``):

  * the mask is an active-shard vector over the ranks of the process
    group (length m), plus the survivor count m' = ``m_active``;
  * it is hashable and frozen, so one value describes one collective
    program: psum multiplies dead contributions away and reweights by m',
    gather drops dead rows of the gathered stack, and the ring links the
    survivors only (m' - 1 hops);
  * a masked round over the survivors computes the round a fresh
    m'-shard job would run on the survivors' data (within
    ``PARITY_TOL[comm_bits]``);
  * ``Membership.full(m)`` (or ``membership=None`` anywhere) is the no-op.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

__all__ = ["Membership", "pod_membership", "resolve_membership"]


@dataclasses.dataclass(frozen=True)
class Membership:
    """Active-shard mask over a mesh axis of m physical shards.

    ``active[i]`` is True iff shard i contributes to (and is trusted by)
    the collectives.  Frozen + tuple-backed, so instances are hashable
    and usable as dictionary keys and cached program arguments.
    """

    active: Tuple[bool, ...]

    def __post_init__(self):
        object.__setattr__(
            self, "active", tuple(bool(a) for a in self.active)
        )
        if not self.active:
            raise ValueError("Membership needs at least one shard")
        if not any(self.active):
            raise ValueError(
                "Membership needs at least one active shard (a fully dead "
                "mesh has no survivors to aggregate over)"
            )

    # -- derived views -----------------------------------------------------

    @property
    def m(self) -> int:
        """Physical axis size (alive or not)."""
        return len(self.active)

    @property
    def m_active(self) -> int:
        """Survivor count m' — the effective machine count."""
        return sum(self.active)

    @property
    def is_full(self) -> bool:
        return all(self.active)

    @property
    def indices(self) -> Tuple[int, ...]:
        """Active shard indices in mesh order (static — safe to index with)."""
        return tuple(i for i, a in enumerate(self.active) if a)

    @property
    def dead(self) -> Tuple[int, ...]:
        return tuple(i for i, a in enumerate(self.active) if not a)

    @property
    def first_active(self) -> int:
        """The reference shard: the paper's "shard 0" role falls to the
        first survivor when shard 0 itself is dead."""
        return self.indices[0]

    # -- constructors / transitions ---------------------------------------

    @classmethod
    def full(cls, m: int) -> "Membership":
        return cls(active=(True,) * m)

    @classmethod
    def from_dead(cls, m: int, dead: Iterable[int]) -> "Membership":
        dead = frozenset(int(s) for s in dead)
        bad = [s for s in dead if not 0 <= s < m]
        if bad:
            raise ValueError(f"dead shard ids {bad} out of range for m={m}")
        return cls(active=tuple(i not in dead for i in range(m)))

    def drop(self, *shards: int) -> "Membership":
        return Membership.from_dead(
            self.m, frozenset(self.dead) | frozenset(shards)
        )

    def recover(self, *shards: int) -> "Membership":
        back = frozenset(int(s) for s in shards)
        bad = [s for s in back if not 0 <= s < self.m]
        if bad:
            raise ValueError(
                f"recovered shard ids {bad} out of range for m={self.m}"
            )
        return Membership.from_dead(self.m, frozenset(self.dead) - back)


def pod_membership(membership: Membership, pods: int) -> Membership:
    """Pod-level liveness view of a flat pod-major membership.

    The hierarchical topology orders its m = pods * local shards
    pod-major (shard ``q * local + l`` is local slot ``l`` of pod ``q``,
    matching a ``(pod, local)`` mesh's row-major device order).  A pod is
    *active* iff any of its local shards is: a pod with one dead local
    still produces a representative basis from its survivors (the masked
    intra-pod psum), while a fully dead pod drops out of the inter-pod
    ring exactly as a dead shard drops out of the flat ring.
    """
    pods = int(pods)
    if pods < 1:
        raise ValueError(f"pods must be >= 1, got {pods}")
    if membership.m % pods:
        raise ValueError(
            f"membership over {membership.m} shards does not tile into "
            f"{pods} equal pods"
        )
    local = membership.m // pods
    return Membership(
        active=tuple(
            any(membership.active[q * local:(q + 1) * local])
            for q in range(pods)
        )
    )


def resolve_membership(
    membership: Optional[Membership], m: int
) -> Membership:
    """Normalize a ``membership=`` knob against a physical axis size.

    ``None`` means full membership (the byte-identical legacy program);
    an explicit ``Membership`` must describe exactly the m shards of the
    axis it masks — a length mismatch is a wiring bug, not a request.
    """
    if membership is None:
        return Membership.full(m)
    if not isinstance(membership, Membership):
        raise TypeError(
            f"membership must be a repro_torch.comm.Membership or None, "
            f"got {type(membership).__name__}"
        )
    if membership.m != m:
        raise ValueError(
            f"membership describes {membership.m} shards but the mesh axis "
            f"has {m}"
        )
    return membership

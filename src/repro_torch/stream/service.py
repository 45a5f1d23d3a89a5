"""The streaming subspace service: refresh loop and collective-free queries
(port of ``repro/stream/service.py``).

``SubspaceService`` keeps the paper's estimator live over a row stream.
Three moving parts:

  * **state**: one merge-able accumulator per shard
    (``repro_torch.stream.accumulator``), on the card.  A dead shard's
    state is frozen: its rows are skipped and nothing is launched for it;
  * **refresh**: every ``cadence`` observed steps, or when the drift
    metric crosses ``drift_threshold``, each live shard takes the local
    top-r eigenbasis of its accumulated covariance and the Procrustes
    rounds run with the previously served basis as ``ref``.  That
    reference is the continuity contract: ``polar(A R) = polar(A) R``
    makes the averaged subspace invariant to the reference rotation, so
    consecutive refreshes on stationary data agree element-wise (no sign
    or rotation flips).  With no basis served yet, the first survivor's
    basis is the reference;
  * **queries**: ``project(queries)`` is a plain ``queries @ basis``
    against the served basis, double-buffered: a refresh writes the back
    buffer and flips the front index only after the rounds returned.  It
    makes no ``torch.distributed`` call.

Two forms, as the elastic runtime has (``runtime/elastic.py``):

  * stacked (``shards=m``, one process): the m shards' states stacked on
    one device, (m, d, d) / (m, d) / (m,); the rounds are
    ``refinement_rounds`` over the live shards' bases (the gather
    schedule; with ``comm_bits`` each basis passes the gather wire's
    codec, as the collective gather delivers it), planned in the stacked
    context;
  * collective (``group=``, and ``pod_group=`` for the hier topology):
    one shard per rank, this rank's state with a leading axis of 1; the
    rounds are
    ``procrustes_average_collective(..., ref=, membership=)`` over the
    group.  Every rank calls ``observe``, ``refresh``, ``set_membership``,
    ``drift`` and ``stats`` together: the last two all-reduce.

Drift: with C̄ the mean covariance of the active shards that have seen
rows and V the served basis, ``drift = ||(I - V Vᵀ) C̄ V||_F / ||C̄ V||_F``,
formed as the weighted sum of each shard's ``cov_i V`` (the collective
form all-reduces that (d, r) sum, never a (d, d) matrix).

Elastic membership: ``set_membership`` classifies the edge with
``runtime.elastic.transition_reason``, re-prices the plan at the survivor
count with ``runtime.elastic.replan`` (``ref_broadcast=False``, in the
form's context), logs a ``RoundEvent``, and on a failure refreshes at
once so the dead shard's contribution leaves the served basis now.

Ingest follows the plan's backend: under "cuda" each chunk's Gram is the
B1 kernel (``accumulator.update``).  The reference's ``refresh_fn`` (a
cache of compiled mesh programs) has no counterpart: nothing is compiled.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.comm import transport
from repro_torch.comm.membership import Membership, resolve_membership
from repro_torch.comm.quantize import get_codec
from repro_torch.core.distributed import (
    _gather_codec,
    _machines,
    procrustes_average_collective,
    resolve_stacked_topology,
)
from repro_torch.core.eigenspace import refinement_rounds
from repro_torch.core.subspace import local_eigenbasis
from repro_torch.interop import resolve_device, strict_fp32
from repro_torch.plan.planner import Plan, _default_device_kind, resolve_plan
from repro_torch.runtime.elastic import RoundEvent, _pins, replan, transition_reason
from repro_torch.stream.accumulator import _fold, init_state

__all__ = ["SubspaceService", "basis_jump", "project"]


def basis_jump(u: torch.Tensor, v: torch.Tensor) -> float:
    """Element-wise Frobenius distance ||u - v||_F between served bases.

    Deliberately not a subspace distance: a sign or rotation flip between
    refreshes leaves the subspace fixed but registers here, and clients
    holding projections from the previous basis care about the element-
    wise change.
    """
    return float(torch.linalg.norm(u - v.to(u.device, u.dtype)))


def project(queries: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Batched projection (batch, d) @ (d, r) onto a served basis."""
    return queries @ basis


def _drift_metric(cv: torch.Tensor, v: torch.Tensor) -> float:
    """||(I - V Vᵀ) C V||_F / ||C V||_F from ``cv = C V``."""
    resid = cv - v @ (v.mT @ cv)
    den = max(float(torch.linalg.norm(cv)), torch.finfo(cv.dtype).tiny)
    return float(torch.linalg.norm(resid)) / den


class SubspaceService:
    """Long-lived distributed eigenspace estimate over a row stream.

    >>> svc = SubspaceService(64, 4, shards=8, cadence=4, device="cpu")
    >>> for chunk in stream:            # chunk: (8, n_k, 64) per-shard rows
    ...     svc.observe(chunk)          # accumulates; refreshes when due
    >>> svc.project(queries)            # (batch, 4), no collectives
    >>> svc.stats["staleness"], svc.stats["refreshes"]

    Exactly one of ``shards`` (the stacked form) and ``group`` (the
    collective form, one shard per rank; ``pod_group`` with
    ``topology="hier"``) is given.  Knob arguments (``backend`` /
    ``topology`` / ``polar`` / ``orth`` / ``ring_chunk`` / ``comm_bits`` /
    ``plan`` / ``membership``) mean what they mean on ``distributed_pca``
    and ``distributed_pca_collective``; the plan is resolved once per
    membership with ``ref_broadcast=False``.  ``device`` defaults to the
    card.
    """

    def __init__(
        self,
        d: int,
        r: int,
        *,
        shards: Optional[int] = None,
        group=None,
        pod_group=None,
        device: str | torch.device = "cuda",
        n_iter: int = 1,
        cadence: int = 8,
        drift_threshold: Optional[float] = None,
        solver: str = "eigh",
        iters: int = 30,
        backend: Optional[str] = None,
        polar: Optional[str] = None,
        orth: Optional[str] = None,
        topology: Optional[str] = None,
        ring_chunk: Optional[int] = None,
        comm_bits=None,
        plan=None,
        membership: Optional[Membership] = None,
        dtype: torch.dtype = torch.float32,
        device_kind: Optional[str] = None,
        calibration=None,
    ):
        if cadence < 1:
            raise ValueError(f"cadence must be >= 1 (got {cadence})")
        if (shards is None) == (group is None):
            raise ValueError("give shards= (the stacked form) or group= (one shard "
                             "per rank), not both or neither")
        self.dev = resolve_device(device)
        strict_fp32()
        self.d, self.r = d, r
        self.n_iter = max(n_iter, 1)
        self.cadence = cadence
        self.drift_threshold = drift_threshold
        self.solver, self.iters = solver, iters
        self._group, self._pod_group = group, pod_group
        pins = _pins(plan, backend=backend, topology=topology, polar=polar, orth=orth,
                     ring_chunk=ring_chunk, comm_bits=comm_bits)
        if group is None:
            resolve_stacked_topology(pins.get("topology"))
            self._context, self.m, self._pods = "stacked", shards, None
            self._pins = {k: v for k, v in pins.items()
                          if k in ("backend", "polar", "orth", "comm_bits")}
            self._machine = None
        else:
            self._context = "collective"
            self.m, self._pods = _machines(group, pod_group, pins.get("topology"))
            self._pins = pins
            self._machine = dist.get_rank(group) + (
                0 if pod_group is None
                else dist.get_rank(pod_group) * dist.get_world_size(group))
        self._mem = resolve_membership(membership, self.m)
        self._kind = device_kind or _default_device_kind(self.dev)
        self._calibration = calibration
        self._plan = resolve_plan(
            plan, m=self.m, d=d, r=r, n_iter=self.n_iter, ref_broadcast=False,
            context=self._context, device_kind=self._kind, calibration=calibration,
            membership=self._mem, pods=self._pods, tensor_device=self.dev, **self._pins,
        )
        lead = self.m if group is None else 1
        self._state = {k: v.expand((lead,) + v.shape).clone()
                       for k, v in init_state(d, dtype=dtype, device=self.dev).items()}
        # Double buffer: queries read _buffers[_front] once; a refresh
        # writes the back buffer and flips _front afterwards.
        self._buffers: List[Optional[torch.Tensor]] = [None, None]
        self._front = 0
        self._step = 0
        self._last_refresh_step = 0
        self._refreshes = 0
        self._replans = 0
        self._events: List[RoundEvent] = []
        self._last_drift: Optional[float] = None
        self._last_jump: Optional[float] = None

    # -- ingest ------------------------------------------------------------

    def _shard_state(self, i: int) -> Dict[str, torch.Tensor]:
        """Shard i's state as views into the stacked buffers."""
        return {k: v[i] for k, v in self._state.items()}

    def _live(self) -> List[int]:
        """The live machines among this process's state rows."""
        if self._machine is None:
            return list(self._mem.indices)
        return [0] if self._mem.active[self._machine] else []

    def observe(self, batches) -> "SubspaceService":
        """Fold one step of rows in; refresh if due.

        Stacked: ``batches`` (m, n_k, d), or a list of m (n_k, d) chunks;
        collective: this rank's (n_k, d) chunk.  Dead shards' rows are
        ignored (their accumulators stay frozen, nothing is launched).
        """
        if self._machine is None:
            if not isinstance(batches, (list, tuple)):
                batches = torch.as_tensor(batches)
            chunks = [torch.as_tensor(c) for c in batches]
            if len(chunks) != self.m or any(
                    c.dim() != 2 or c.shape[1] != self.d for c in chunks):
                raise ValueError(
                    f"expected (m={self.m}, n_k, d={self.d}) per-shard chunks, got "
                    f"{[tuple(c.shape) for c in chunks]}")
        else:
            chunks = [torch.as_tensor(batches)]
            if chunks[0].dim() != 2 or chunks[0].shape[1] != self.d:
                raise ValueError(f"expected this rank's (n_k, d={self.d}) chunk, got "
                                 f"{tuple(chunks[0].shape)}")
        for i in self._live():
            _fold(self._shard_state(i), chunks[i].to(self.dev), self._plan.backend,
                  in_place=True)
        self._step += 1
        if self._refresh_due():
            self.refresh()
        return self

    def _refresh_due(self) -> bool:
        if self.basis is None:
            return True  # first basis: serve as soon as there is data
        if self._step - self._last_refresh_step >= self.cadence:
            return True
        if self.drift_threshold is not None:
            return self.drift() > self.drift_threshold
        return False

    # -- refresh -----------------------------------------------------------

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over every machine of the collective form."""
        transport.all_reduce(t, group=self._group)
        if self._pod_group is not None:
            transport.all_reduce(t, group=self._pod_group)
        return t

    def _rows_seen(self) -> int:
        count = self._state["count"].sum()
        if self._machine is not None:
            count = self._all_reduce(count.reshape(1))[0]
        return int(count)

    def _local_basis(self, state: Dict[str, torch.Tensor]) -> torch.Tensor:
        cov = state["gram"] / torch.clamp(state["count"], min=1)
        return local_eigenbasis(cov, self.r, method=self.solver, iters=self.iters)[0]

    def refresh(self) -> torch.Tensor:
        """Run one aggregation now and swap the served basis."""
        if self._rows_seen() == 0:
            raise ValueError("refresh before any data: observe() first")
        prev = self._buffers[self._front]
        if self._machine is None:
            codec = get_codec(self._plan.comm_bits)
            vs = torch.stack([
                _gather_codec(self._local_basis(self._shard_state(i)), codec, i)
                for i in self._mem.indices])
            new = refinement_rounds(vs, prev, n_iter=self.n_iter, plan=self._plan)
        else:
            new = procrustes_average_collective(
                self._local_basis(self._shard_state(0)), group=self._group,
                n_iter=self.n_iter, ref=prev, plan=self._plan, membership=self._mem,
                pod_group=self._pod_group)
        if prev is not None:
            self._last_jump = basis_jump(prev, new)
        back = 1 - self._front
        self._buffers[back] = new
        self._front = back  # swap only after the rounds returned
        self._refreshes += 1
        self._last_refresh_step = self._step
        return new

    # -- elastic membership ------------------------------------------------

    def set_membership(self, membership) -> "SubspaceService":
        """Adopt a new shard mask: re-plan at m', refresh now on a failure.
        A recovery waits for the cadence (the rejoiner's frozen accumulator
        is valid, merely stale)."""
        mem = resolve_membership(membership, self.m)
        reason = transition_reason(self._mem, mem)
        if reason is None:
            return self
        self._mem = mem
        self._plan = replan(
            mem, d=self.d, r=self.r, n_iter=self.n_iter, ref_broadcast=False,
            device_kind=self._kind, calibration=self._calibration, pods=self._pods,
            context=self._context, **self._pins,
        )
        self._replans += 1
        self._events.append(RoundEvent(
            round_index=self._step, rounds=self.n_iter, reason=reason,
            membership=mem, plan=self._plan,
        ))
        if reason == "failure" and self.basis is not None:
            self.refresh()
        return self

    # -- queries -----------------------------------------------------------

    def project(self, queries: torch.Tensor) -> torch.Tensor:
        """Project (batch, d) query rows onto the served basis -> (batch, r)."""
        v = self._buffers[self._front]  # one front read: no torn swap
        if v is None:
            raise RuntimeError(
                "no basis served yet: observe() some data (or refresh()) first")
        q = torch.as_tensor(queries, device=v.device)
        dt = torch.promote_types(q.dtype, v.dtype)
        return project(q.to(dt), v.to(dt))

    # -- metrics -----------------------------------------------------------

    def drift(self) -> float:
        """Current drift of the served basis against the accumulated C̄."""
        v = self._buffers[self._front]
        if v is None:
            raise RuntimeError("no basis served yet; drift is undefined")
        dt = self._state["gram"].dtype
        v = v.to(dt)
        cv = torch.zeros((self.d, self.r), dtype=dt, device=self.dev)
        w = torch.zeros((), dtype=dt, device=self.dev)
        for i in self._live():
            state = self._shard_state(i)
            if float(state["count"]) > 0:
                cv += (state["gram"] / state["count"]) @ v
                w += 1
        if self._machine is not None:
            packed = self._all_reduce(torch.cat([cv.reshape(-1), w.reshape(1)]))
            cv, w = packed[:-1].reshape(self.d, self.r), packed[-1]
        self._last_drift = _drift_metric(cv / torch.clamp(w, min=1), v)
        return self._last_drift

    @property
    def basis(self) -> Optional[torch.Tensor]:
        """The currently served (d, r) basis (None before the first refresh)."""
        return self._buffers[self._front]

    @property
    def membership(self) -> Membership:
        return self._mem

    @property
    def plan(self) -> Plan:
        return self._plan

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """The accumulated state, (m, ...) stacked or this rank's (1, ...)."""
        return self._state

    @property
    def stats(self) -> Dict[str, Any]:
        """Service health: staleness / drift / refresh counters / plan (the
        reference's keys).  In the collective form ``rows_seen`` is summed
        over the ranks, so every rank reads ``stats`` together."""
        return {
            "step": self._step,
            "rows_seen": self._rows_seen(),
            "refreshes": self._refreshes,
            "staleness": self._step - self._last_refresh_step,
            "cadence": self.cadence,
            "drift": self._last_drift,
            "drift_threshold": self.drift_threshold,
            "last_jump": self._last_jump,
            "m_active": self._mem.m_active,
            "replans": self._replans,
            "events": [e.reason for e in self._events],
            "plan": self._plan,
        }

"""Eigen-compressed data-parallel gradient aggregation, role R2 (port of
``repro/optim/eigen_compress.py``).

The paper's technique doing production work inside the train step:

  * Each data-parallel shard computes its LOCAL gradient ``G_i`` of a
    compressible weight (a large matrix).  The top-r left eigenbasis of
    ``G_i G_iᵀ`` is a rotation-ambiguous subspace estimate: the paper's
    setting with X̂ⁱ = G_i G_iᵀ.
  * Every ``refresh_every`` steps the shards combine their local bases
    with Algorithm 1/2 (the Procrustes-fixed average) into a shared
    projection basis P (d x r), aligned to the previous period's basis
    once there is one, which keeps the low-rank Adam moments valid.
  * Every step the data-parallel reduction runs on ``Pᵀ(G_i + err_i)``
    (r x n) instead of G_i (d x n): an r/d compression of the dominant
    training collective, with per-shard error feedback (PowerSGD-style).

Two forms, as the port's other collectives:

  * stacked (one process holding m shards): the shards' local bases are
    stacked (m, d, r) and ``core.eigenspace.refinement_rounds`` averages
    them, the same rounds as the psum schedule;
  * collective (``group=``, one shard a rank):
    ``core.distributed.procrustes_average_collective`` over the group,
    and ``compress_and_reduce`` all-reduces the (r, n) coordinates
    through ``comm.transport``.  On a ``(data, model)`` mesh the group is
    the data axis's, and ``launch/steps.py`` hands these functions each
    compressed gradient gathered whole over 'model' and the local tensors
    of the replicated state (the error feedback is whole on every model
    rank, as the reference's).

The rounds run on ``backend="auto"`` (the reference's default, Pallas on
a TPU): on CUDA tensors the kernels B2 (``batched_gram``) and B4
(``align_average``), with the r x r SVD in ``torch.linalg``, once each
per round.  The reference computes both branches of a refresh (aligned
to the previous basis, and to shard 0's) and selects one with
``jnp.where(initialized, ...)``; here ``initialized`` is known on the
host and only the taken branch runs.  The subspace iteration's start
basis (``_local_basis``'s ``start``) is the caller's: the trainers draw
it from a ``torch.Generator`` that is the same on every shard, and the
parity tests pass the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.comm import transport
from repro_torch.core.distributed import procrustes_average_collective
from repro_torch.core.eigenspace import refinement_rounds

__all__ = [
    "EigenCompressConfig",
    "init_state",
    "draw_starts",
    "refresh_basis",
    "compress",
    "compress_and_reduce",
]


@dataclasses.dataclass(frozen=True)
class EigenCompressConfig:
    rank: int = 128
    refresh_every: int = 100
    min_dim: int = 1024      # compress only if leading dim >= min_dim
    power_iters: int = 4     # subspace iterations on G G^T (implicit)
    n_iter: int = 1          # Algorithm 1 (1) / Algorithm 2 (>1)


def _local_basis(g: torch.Tensor, r: int, iters: int, start: torch.Tensor) -> torch.Tensor:
    """Top-r left singular basis of G (d x n) by implicit subspace
    iteration on G Gᵀ from ``start`` (d, r): Q <- qr(G (Gᵀ Q))."""
    q = torch.linalg.qr(start.to(torch.float32))[0]
    gf = g.to(torch.float32)
    for _ in range(iters):
        q = torch.linalg.qr(gf @ (gf.T @ q))[0]
    return q


def init_state(d: int, n: int, cfg: EigenCompressConfig, *, err_lead: tuple = (),
               device=None) -> Dict[str, torch.Tensor]:
    """Low-rank state of one compressed (d, n) leaf: basis (d, r), Adam
    moments (r, n), the error feedback (``err_lead`` + (d, n): the shard
    axis in the stacked form, none in the collective one) and
    ``initialized``, with r = min(rank, d, n).  At r = n (a leaf no wider
    than the rank, such as mamba2's ``wdt`` (d, heads)) the basis spans
    every column the gradient has, so the compression loses nothing and
    the error feedback stays at rounding level; ``_local_basis``'s QR
    keeps r orthonormal columns when a shard's gradient has lower rank."""
    r = min(cfg.rank, d, n)
    kw = dict(dtype=torch.float32, device=device)
    return {
        "basis": torch.zeros(d, r, **kw),
        "m": torch.zeros(r, n, **kw),
        "v": torch.zeros(r, n, **kw),
        "err": torch.zeros(*err_lead, d, n, **kw),
        "initialized": torch.zeros((), dtype=torch.bool),  # known on the host
    }


def draw_starts(shapes: Dict[str, tuple], *, seed: int, step: int,
                device) -> Dict[str, torch.Tensor]:
    """Start bases for the refresh at ``step``: one standard normal
    (d, r) a leaf, in sorted name order, from a generator on ``device``
    seeded by (seed, step).  Every shard draws the same (as the
    reference's replicated key), and a resumed run draws what the
    uninterrupted one drew."""
    dev = torch.device(device)
    s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    gen = torch.Generator(device=dev).manual_seed(s)
    return {name: torch.randn(*shapes[name], generator=gen, device=dev)
            for name in sorted(shapes)}


def refresh_basis(
    v_local: torch.Tensor,
    prev_basis: torch.Tensor,
    initialized: bool,
    *,
    cfg: EigenCompressConfig,
    group=None,
) -> torch.Tensor:
    """Procrustes-fixed average of the shards' local bases: stacked
    ``v_local`` (m, d, r) with ``group=None``, this rank's (d, r) with
    ``group``.  Aligned to ``prev_basis`` once ``initialized``, else to
    shard 0's basis (Algorithm 1).  The collective form runs the psum
    schedule at full precision, as the reference's defaults."""
    ref = prev_basis if initialized else None
    if group is not None:
        return procrustes_average_collective(v_local, group=group, n_iter=cfg.n_iter,
                                             ref=ref, backend="auto")
    return refinement_rounds(v_local.contiguous(), ref, n_iter=cfg.n_iter, backend="auto")


@torch.no_grad()
def compress(g_local: torch.Tensor, state: Dict[str, torch.Tensor],
             err: torch.Tensor) -> torch.Tensor:
    """This shard's coordinates ``Pᵀ(G + err)`` (r, n), with the error
    feedback updated in place: ``err <- (G + err) - P Pᵀ(G + err)``, what
    the projection dropped (the reference's ``new_error``)."""
    p = state["basis"]
    err.add_(g_local)
    low = p.T @ err
    err.sub_(p @ low)
    return low


def compress_and_reduce(g_local: torch.Tensor, state: Dict[str, torch.Tensor], *,
                        group) -> torch.Tensor:
    """The collective form's per-step path: ``compress`` this rank's
    gradient (``state["err"]`` is its error feedback), all-reduce the
    (r, n) coordinates over ``group`` and divide by the world: r n words
    on the wire instead of d n.  Returns the global low-rank gradient."""
    low = compress(g_local, state, state["err"])
    return transport.all_reduce(low, group=group) / torch.distributed.get_world_size(group)

"""End-to-end distributed PCA on one device (port of the stacked path of
``repro/core/distributed.py::distributed_pca``).

The reference shards the samples over a device mesh; under its gather
topology every device all-gathers the m local bases and runs the stacked
rounds (``refinement_rounds``) on the (m, d, r) stack.  Here the m
machines are the leading axis of that stack on one card: each shard forms
its covariance (``empirical_covariance``) and local basis
(``local_eigenbasis``), and the rounds follow.  ``shards`` is the
counterpart of the reference's mesh data-axis size.

Topology: "gather" (and "auto", which resolves to it in this slice);
the psum, ring and hier schedules over ``torch.distributed`` are ROADMAP
A5 and raise.
"""

from __future__ import annotations

import torch

from repro_torch.core.covariance import empirical_covariance
from repro_torch.core.eigenspace import refinement_rounds
from repro_torch.core.subspace import local_eigenbasis
from repro_torch.interop import resolve_device, strict_fp32

__all__ = ["TOPOLOGY_CHOICES", "resolve_topology", "distributed_pca"]

TOPOLOGY_CHOICES = ("psum", "gather", "ring", "hier", "auto")


def resolve_topology(topology: str | None) -> str:
    """"gather" for None/"auto"/"gather"; the cross-rank schedules raise."""
    topology = topology or "auto"
    if topology in ("auto", "gather"):
        return "gather"
    if topology in ("psum", "ring", "hier"):
        raise NotImplementedError(
            f"topology={topology!r} runs over torch.distributed, not ported "
            "yet (ROADMAP A5); this slice runs the stacked 'gather' path"
        )
    raise ValueError(
        f"topology must be one of {TOPOLOGY_CHOICES}, got {topology!r}"
    )


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
    """One-shot (``n_iter=1``) or iterated Procrustes-fixed distributed PCA.

    ``samples`` (N, d) split into ``shards`` equal row blocks (the
    machines); each forms its covariance and top-r basis (``solver``
    "eigh" or "subspace" with ``iters`` steps), then ``n_iter`` rounds
    align, average and orthonormalize the (shards, d, r) stack.
    ``backend`` ("torch" | "cuda" | "auto", default "torch") routes both
    the covariance and the rounds; ``polar``/``orth`` as in
    ``refinement_rounds``.  Runs on ``device`` (default the card; raises
    if there is none).  Returns the (d, r) estimate.
    """
    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)
    strict_fp32()
    resolve_topology(topology)
    n_total, d = samples.shape
    if shards < 1 or n_total % shards:
        raise ValueError(
            f"{n_total} samples do not split into {shards} equal shards"
        )
    backend = kops.resolve_backend(backend or "torch", dev)
    xs = samples.to(dev).reshape(shards, n_total // shards, d)
    vs = torch.stack([
        local_eigenbasis(
            empirical_covariance(x, backend=backend), r,
            method=solver, iters=iters,
        )[0]
        for x in xs
    ])
    return refinement_rounds(
        vs, n_iter=n_iter, backend=backend, polar=polar, orth=orth
    )

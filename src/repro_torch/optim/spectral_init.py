"""Distributed spectral initialization for quadratic sensing (paper §3.7;
port of ``repro/optim/spectral_init.py``).

Each machine holds measurements (a_i, y_i), forms the truncated
second-moment matrix D_N (eq. 39, ``data.synthetic.truncated_second_moment``,
a plain weighted product as in the reference), takes its local top-r
eigenspace, and Algorithm 1/2 combines them: the experiment of the
paper's Fig. 10, as a library function that initializes local-search
recovery.  Two forms, as ``distributed_pca`` has: stacked (``shards=``,
one process) and one machine per rank (``group=``).
"""

from __future__ import annotations

import torch

from repro_torch.comm.quantize import get_codec
from repro_torch.core.distributed import (
    _gather_codec,
    _machines,
    distributed_pca_from_covs,
    resolve_stacked_topology,
)
from repro_torch.core.eigenspace import refinement_rounds
from repro_torch.core.subspace import local_eigenbasis
from repro_torch.data.synthetic import truncated_second_moment
from repro_torch.interop import resolve_device, strict_fp32

__all__ = ["distributed_spectral_init"]


def distributed_spectral_init(
    a: torch.Tensor,
    y: torch.Tensor,
    r: int,
    *,
    shards: int | None = None,
    group=None,
    pod_group=None,
    device: str | torch.device = "cuda",
    n_iter: int = 10,
    solver: str = "eigh",
    iters: int = 40,
    backend: str | None = None,
    polar: str | None = None,
    orth: str | None = None,
    topology: str | None = None,
    ring_chunk: int | None = None,
    comm_bits=None,
    plan=None,
) -> torch.Tensor:
    """The (d, r) Procrustes-averaged spectral initializer X_0.

    Stacked (``shards=m``): ``a`` (N, d) design vectors and ``y`` (N,)
    measurements split into m equal row blocks; each block's D_N and local
    basis (with ``comm_bits``, through the gather wire's codec), then
    ``refinement_rounds`` (the gather schedule).  One machine per rank
    (``group=``, ``pod_group=`` with ``topology="hier"``): ``a``, ``y``
    are this rank's measurements and ``distributed_pca_from_covs`` takes
    its D_N.  Knobs mean what they mean on ``distributed_pca``; ``plan``
    (``None`` | ``"auto"`` | a ``Plan``) is resolved once here.
    """
    from repro_torch.plan.planner import resolve_plan

    if (shards is None) == (group is None):
        raise ValueError("give shards= (the stacked form) or group= (one machine "
                         "per rank), not both or neither")
    dev = resolve_device(device)
    strict_fp32()
    a, y = a.to(dev), y.to(dev)
    d = a.shape[-1]
    if group is not None:
        m, pods = _machines(group, pod_group, getattr(plan, "topology", topology))
        pl = resolve_plan(
            plan, m=m, d=d, r=r, n_iter=n_iter, backend=backend, topology=topology,
            polar=polar, orth=orth, ring_chunk=ring_chunk, comm_bits=comm_bits,
            pods=pods, tensor_device=dev)
        return distributed_pca_from_covs(
            truncated_second_moment(a, y), r, group=group, pod_group=pod_group,
            device=dev, n_iter=n_iter, solver=solver, iters=iters, plan=pl)
    if shards < 1 or a.shape[0] % shards or y.shape[0] != a.shape[0]:
        raise ValueError(f"{a.shape[0]} measurements do not split into {shards} "
                         "equal shards")
    resolve_stacked_topology(getattr(plan, "topology", topology))
    pl = resolve_plan(
        plan, m=shards, d=d, r=r, n_iter=n_iter, backend=backend, polar=polar,
        orth=orth, comm_bits=comm_bits, context="stacked", tensor_device=dev)
    codec = get_codec(pl.comm_bits)
    n = a.shape[0] // shards
    vs = torch.stack([
        _gather_codec(local_eigenbasis(
            truncated_second_moment(a[i * n:(i + 1) * n], y[i * n:(i + 1) * n]), r,
            method=solver, iters=iters)[0], codec, i)
        for i in range(shards)])
    return refinement_rounds(vs, n_iter=n_iter, plan=pl)

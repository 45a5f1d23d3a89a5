"""Distributed eigenspace estimators over a stacked (m, d, r) array (port
of ``repro/core/eigenspace.py``).

Algorithm 1 (Procrustes fixing), Algorithm 2 (iterative refinement), the
naive average, the projector-averaging baseline and the centralized
estimator.  The round body has one home, ``refinement_rounds``, switched
by ``backend=`` ("torch" | "cuda" | "auto"), ``polar=`` ("svd" |
"newton-schulz") and ``orth=`` ("qr" | "cholesky-qr2"):

  * "cuda" runs the per-stage kernels (``repro_torch.kernels``): the
    Gram (with Newton-Schulz fused in under ``polar="newton-schulz"``),
    the r x r SVD in ``torch.linalg`` under ``polar="svd"``, the aligned
    average, and the orthonormalization in ``torch.linalg``.
  * The (cuda, newton-schulz, cholesky-qr2) cell runs each round as one
    launch of the fused round kernel (``kops.fused_round``, B5): Gram,
    polar, aligned average and both CholeskyQR passes in one kernel, with
    no torch op between rounds.
  * ``plan=None`` keeps the defaults ("torch", "svd", "qr");
    ``plan="auto"`` lets the cost-model planner (``repro_torch.plan``)
    score the (backend x polar x orth) cube for this (m, d, r), concrete
    knobs as pins; a ``repro_torch.plan.Plan`` is used verbatim.
"""

from __future__ import annotations

import torch

from repro_torch.core import procrustes
from repro_torch.core.orthonorm import orthonormalize, resolve_orth
from repro_torch.core.subspace import local_eigenbasis

__all__ = [
    "naive_average",
    "procrustes_fix_average",
    "refinement_rounds",
    "iterative_refinement",
    "projector_average",
    "central_estimate",
    "local_bases",
]


def local_bases(
    xhats: torch.Tensor, r: int, *, method: str = "eigh", iters: int = 30
) -> torch.Tensor:
    """Each machine's leading r-dim eigenbasis. xhats: (m, d, d) -> (m, d, r)."""
    return torch.stack(
        [local_eigenbasis(x, r, method=method, iters=iters)[0] for x in xhats]
    )


def naive_average(vs: torch.Tensor, *, orth: str = "qr") -> torch.Tensor:
    """Eq. (3): average the raw local bases, then orthonormalize."""
    return orthonormalize(vs.mean(dim=0), orth=orth)


def _rounds_cuda(
    vs: torch.Tensor, ref: torch.Tensor, *, n_iter: int, polar: str, orth: str
) -> torch.Tensor:
    """Kernel-dispatched round loop (mirrors the reference's
    ``_rounds_pallas``): the fused round kernel on the (newton-schulz,
    cholesky-qr2) cell, else Gram (+ polar) kernel, aligned-average
    kernel, orthonormalization, ``n_iter`` times."""
    from repro_torch.kernels import ops as kops

    if polar == "newton-schulz" and orth == "cholesky-qr2":
        return kops.fused_round(
            vs, ref.contiguous(), n_iter=n_iter, use_kernel=True
        )
    out = ref
    for _ in range(max(n_iter, 1)):
        out = out.contiguous()  # the kernels take row-major; QR's Q is not
        if polar == "newton-schulz":
            z = kops.batched_gram_polar(vs, out, use_kernel=True)
        else:
            g = kops.batched_gram(vs, out, use_kernel=True)  # (m, r, r) f32
            u, _, wt = torch.linalg.svd(g, full_matrices=False)
            z = u @ wt
        vbar = kops.align_average(vs, z, use_kernel=True)  # (d, r) f32
        out = orthonormalize(vbar, orth=orth).to(vs.dtype)
    return out


def _rounds_torch(
    vs: torch.Tensor, ref: torch.Tensor, *, n_iter: int, polar: str, orth: str
) -> torch.Tensor:
    """Plain round loop: align, average, orthonormalize, repeat."""
    out = ref
    for _ in range(max(n_iter, 1)):
        aligned = procrustes.align_batch(vs, out, polar=polar)
        out = orthonormalize(aligned.mean(dim=0), orth=orth)
    return out


def refinement_rounds(
    vs: torch.Tensor,
    ref: torch.Tensor | None = None,
    *,
    n_iter: int = 1,
    backend: str | None = None,
    polar: str | None = None,
    orth: str | None = None,
    plan=None,
) -> torch.Tensor:
    """Run the Algorithm-1 body (align to ``ref``, average, orthonormalize)
    ``n_iter`` times over a stacked (m, d, r) ``vs``, each output the next
    reference (Algorithm 2).  ``ref`` defaults to ``vs[0]``.  ``plan``
    resolves the knobs through ``repro_torch.plan.resolve_plan`` in the
    stacked context (see the module docstring)."""
    from repro_torch.plan.planner import resolve_plan

    m, d, r = vs.shape
    pl = resolve_plan(
        plan, m=m, d=d, r=r, n_iter=n_iter, backend=backend, polar=polar,
        orth=orth, context="stacked", tensor_device=vs.device,
    )
    backend = pl.backend
    polar = procrustes.resolve_polar(pl.polar)
    orth = resolve_orth(pl.orth)
    if ref is None:
        ref = vs[0]
    rounds = _rounds_cuda if backend == "cuda" else _rounds_torch
    return rounds(vs, ref, n_iter=n_iter, polar=polar, orth=orth)


def procrustes_fix_average(
    vs: torch.Tensor,
    ref: torch.Tensor | None = None,
    *,
    backend: str | None = None,
    polar: str | None = None,
    orth: str | None = None,
    plan=None,
) -> torch.Tensor:
    """Algorithm 1: exactly one refinement round (see ``refinement_rounds``)."""
    return refinement_rounds(
        vs, ref, n_iter=1, backend=backend, polar=polar, orth=orth, plan=plan
    )


def iterative_refinement(
    vs: torch.Tensor,
    n_iter: int = 2,
    *,
    backend: str | None = None,
    polar: str | None = None,
    orth: str | None = None,
    plan=None,
) -> torch.Tensor:
    """Algorithm 2: repeat Algorithm 1, re-using the output as reference."""
    return refinement_rounds(
        vs, n_iter=n_iter, backend=backend, polar=polar, orth=orth, plan=plan
    )


def projector_average(vs: torch.Tensor, r: int) -> torch.Tensor:
    """Fan et al. 2019 baseline: top-r eigenspace of (1/m) sum_i V_i V_i^T."""
    m = vs.shape[0]
    p = torch.einsum("mdr,mer->de", vs, vs) / m
    _, vec = torch.linalg.eigh(p)
    return vec.flip(-1)[:, :r]


def central_estimate(
    xhats: torch.Tensor, r: int, *, method: str = "eigh", iters: int = 30
) -> tuple[torch.Tensor, torch.Tensor]:
    """Centralized oracle: top-r eigenspace of the mean local matrix."""
    return local_eigenbasis(xhats.mean(dim=0), r, method=method, iters=iters)

"""Local top-r eigensolvers (port of ``repro/core/subspace.py``).

``subspace_iteration`` is blocked orthogonal iteration (matmul + QR) with
a final Rayleigh-Ritz rotation; ``top_r_eigh`` is the exact fallback.
The reference seeds its start block from ``jax.random.PRNGKey(0)``, a
stream torch cannot replay: here the start comes from ``v0=`` or from a
``torch.Generator`` (seed 0 on the matrix's device when neither is given),
and parity tests pass ``v0`` explicitly.
"""

from __future__ import annotations

import torch

__all__ = ["top_r_eigh", "subspace_iteration", "local_eigenbasis"]


def top_r_eigh(x: torch.Tensor, r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-r eigenpairs of a symmetric matrix via full ``eigh``.
    Returns (V (d, r), lam (r,)) sorted descending."""
    lam, vec = torch.linalg.eigh(x)
    return vec.flip(-1)[:, :r], lam.flip(-1)[:r]


def subspace_iteration(
    x: torch.Tensor,
    r: int,
    *,
    iters: int = 30,
    v0: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked orthogonal iteration for the leading r-dim invariant
    subspace; ``iters`` fixed steps, linear rate ``|lam_{r+1} / lam_r|``.
    Returns (V (d, r) orthonormal, Ritz values (r,) descending)."""
    d = x.shape[0]
    if v0 is None:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        v0 = torch.randn(
            (d, r), generator=generator, dtype=x.dtype, device=x.device
        )
    q = torch.linalg.qr(v0)[0]
    for _ in range(iters):
        q = torch.linalg.qr(x @ q)[0]
    # Rayleigh-Ritz: rotate the basis to (approximate) eigenvectors.
    h = q.mT @ (x @ q)
    h = 0.5 * (h + h.mT)
    lam, w = torch.linalg.eigh(h)
    order = torch.argsort(lam, descending=True)
    return q @ w[:, order], lam[order]


def local_eigenbasis(
    x: torch.Tensor,
    r: int,
    *,
    method: str = "eigh",
    iters: int = 30,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch between exact ``eigh`` and subspace iteration."""
    if method == "eigh":
        return top_r_eigh(x, r)
    if method == "subspace":
        return subspace_iteration(x, r, iters=iters, generator=generator)
    raise ValueError(f"unknown eigensolver method: {method!r}")

"""Orthonormalization of the averaged basis, the round's final stage
(port of ``repro/core/orthonorm.py``).

  * ``"qr"``           - thin Householder QR (``torch.linalg.qr``).
  * ``"cholesky-qr2"`` - two guarded CholeskyQR passes,
                         ``S = V^T V; L = chol(S); Q = V L^-T``.

Guard (``cholqr_guard_coeffs``): if a pivot ``diag(L)^2`` falls below
``r * eps * tr(S)``, or the factorization breaks down, the pass retries on
``S + sigma I`` with ``sigma = 11 (d + r + 1) * eps * tr(S)`` (Fukaya et
al. 2020).  The shift changes only the conditioning trajectory, not the
span, and the second pass re-measures the actual Gram.  Working range
``kappa(V) <~ eps^(-1/2)``; beyond it use ``orth="qr"``.
"""

from __future__ import annotations

import torch

__all__ = [
    "ORTH_METHODS",
    "resolve_orth",
    "qr_orthonormalize",
    "cholesky_qr2",
    "orthonormalize",
    "cholqr_guard_coeffs",
]

ORTH_METHODS = ("qr", "cholesky-qr2")


def resolve_orth(orth: str) -> str:
    """Validate an ``orth=`` switch ("qr" | "cholesky-qr2")."""
    if orth not in ORTH_METHODS:
        raise ValueError(f"orth must be one of {ORTH_METHODS}, got {orth!r}")
    return orth


def qr_orthonormalize(v: torch.Tensor) -> torch.Tensor:
    """Q factor of the thin QR of ``v`` (the paper's final step)."""
    return torch.linalg.qr(v, mode="reduced")[0]


def cholqr_guard_coeffs(d: int, r: int, eps: float) -> tuple[float, float]:
    """(pivot tolerance, shift) coefficients of the CholeskyQR guard, both
    multiplying ``tr(S)``: ``r * eps`` and ``11 (d + r + 1) * eps``."""
    return r * eps, 11.0 * (d + r + 1) * eps


def _cholqr_pass(v: torch.Tensor) -> torch.Tensor:
    """One guarded CholeskyQR pass: Q = V L^-T with L = chol(V^T V)."""
    d, r = v.shape[-2], v.shape[-1]
    eps = torch.finfo(v.dtype).eps
    pivot_c, shift_c = cholqr_guard_coeffs(d, r, eps)
    s = v.mT @ v
    tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(r, dtype=v.dtype, device=v.device)
    l0, info = torch.linalg.cholesky_ex(s)
    diag0 = torch.diagonal(l0, dim1=-2, dim2=-1)
    # Breakdown (info > 0 or a non-finite pivot) or a pivot at the Gram's
    # noise floor: retry on the shifted Gram.
    ok = (
        (info == 0)
        & torch.all(torch.isfinite(diag0), dim=-1)
        & torch.all(diag0 * diag0 > pivot_c * tr[..., 0], dim=-1)
    )
    # The 1e-30 floor keeps an all-zero V finite (Q = 0).
    l1, _ = torch.linalg.cholesky_ex(s + (shift_c * tr + 1e-30) * eye)
    l = torch.where(
        ok[..., None, None], torch.where(torch.isfinite(l0), l0, 0.0), l1
    )
    # Q = V (L^T)^-1: solve X @ L^T = V.
    return torch.linalg.solve_triangular(l.mT, v, upper=True, left=False)


def cholesky_qr2(v: torch.Tensor) -> torch.Tensor:
    """Orthonormalize ``v`` (..., d, r) by two guarded CholeskyQR passes,
    computing in f32 at least (f64 in, f64 out)."""
    compute = torch.promote_types(v.dtype, torch.float32)
    q = _cholqr_pass(v.to(compute))
    q = _cholqr_pass(q)
    return q.to(v.dtype)


def orthonormalize(v: torch.Tensor, *, orth: str = "qr") -> torch.Tensor:
    """Orthonormalize the columns of ``v`` by the selected method."""
    if resolve_orth(orth) == "cholesky-qr2":
        return cholesky_qr2(v)
    return qr_orthonormalize(v)

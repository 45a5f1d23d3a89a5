"""Orthogonal Procrustes alignment, the paper's core primitive (port of
``repro/core/procrustes.py``).

``Z = argmin_{Z in O_r} ||src Z - ref||_F`` is the orthogonal polar factor
of the Gram ``G = src^T ref`` (eq. (5)/(6)).  Two polar methods:

  * ``"svd"``           - ``U @ Wt`` from ``torch.linalg.svd(G)``.
  * ``"newton-schulz"`` - ``X <- X (3I - X^T X) / 2`` from ``G / ||G||_F``,
                          ``DEFAULT_NS_ITERS = 24`` steps (covers
                          cond(G) * sqrt(r) up to ~1e3; aggregation Grams
                          are near I and need ~8).  The card runs it
                          fused into the Gram kernel
                          (``repro_torch.kernels.procrustes_align``).
"""

from __future__ import annotations

import torch

__all__ = [
    "POLAR_METHODS",
    "DEFAULT_NS_ITERS",
    "resolve_polar",
    "newton_schulz_polar",
    "polar_factor",
    "procrustes_rotation",
    "align",
    "align_batch",
    "sign_fix",
    "procrustes_distance",
]

POLAR_METHODS = ("svd", "newton-schulz")

DEFAULT_NS_ITERS = 24


def resolve_polar(polar: str) -> str:
    """Validate a ``polar=`` switch ("svd" | "newton-schulz")."""
    if polar not in POLAR_METHODS:
        raise ValueError(f"polar must be one of {POLAR_METHODS}, got {polar!r}")
    return polar


def newton_schulz_polar(
    g: torch.Tensor, *, iters: int = DEFAULT_NS_ITERS, eps: float = 1e-30
) -> torch.Tensor:
    """Orthogonal polar factor of (..., r, r) ``g`` by Newton-Schulz, in
    f32 (returned in ``g``'s dtype).  ``eps`` floors the Frobenius norm so
    an all-zero Gram stays finite."""
    gf = g.to(torch.float32)
    norm = torch.sqrt(torch.sum(gf * gf, dim=(-2, -1), keepdim=True))
    x = gf / torch.clamp(norm, min=eps)
    eye3 = 3.0 * torch.eye(g.shape[-1], dtype=torch.float32, device=g.device)
    for _ in range(iters):
        x = 0.5 * x @ (eye3 - x.mT @ x)
    return x.to(g.dtype)


def polar_factor(
    g: torch.Tensor, *, polar: str = "svd", ns_iters: int = DEFAULT_NS_ITERS
) -> torch.Tensor:
    """Orthogonal polar factor of ``g`` (eq. (6)), batched over leading dims."""
    if resolve_polar(polar) == "newton-schulz":
        return newton_schulz_polar(g, iters=ns_iters)
    u, _, wt = torch.linalg.svd(g, full_matrices=False)
    return u @ wt


def procrustes_rotation(
    src: torch.Tensor, ref: torch.Tensor, *, polar: str = "svd"
) -> torch.Tensor:
    """The orthogonal (..., r, r) ``Z`` minimising ``||src Z - ref||_F``."""
    return polar_factor(src.mT @ ref, polar=polar)


def align(src: torch.Tensor, ref: torch.Tensor, *, polar: str = "svd") -> torch.Tensor:
    """Procrustes-align ``src`` (d, r) to ``ref``: ``src @ Z``."""
    return src @ procrustes_rotation(src, ref, polar=polar)


def align_batch(
    srcs: torch.Tensor, ref: torch.Tensor, *, polar: str = "svd"
) -> torch.Tensor:
    """Align a stack (m, d, r) to one reference (d, r): Algorithm 1's
    alignment step over all m machines."""
    return srcs @ procrustes_rotation(srcs, ref, polar=polar)


def sign_fix(src: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Rank-1 case (Garber et al.): flip ``src`` to match ``ref``'s sign."""
    ip = torch.sum(src * ref.reshape(src.shape))
    return src * torch.where(ip >= 0, 1.0, -1.0).to(src.dtype)


def procrustes_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min_Z ||a Z - b||_F over orthogonal Z:
    ``sqrt(||a||_F^2 + ||b||_F^2 - 2 ||a^T b||_*)``."""
    s = torch.linalg.svdvals(a.mT @ b)
    sq = torch.sum(a * a) + torch.sum(b * b) - 2.0 * torch.sum(s)
    return torch.sqrt(torch.clamp(sq, min=0.0))

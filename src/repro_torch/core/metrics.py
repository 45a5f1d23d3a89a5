"""Subspace distances used throughout the paper (port of
``repro/core/metrics.py``: ``dist_2``, ``dist_f``, ``subspace_dist64``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dist_2", "dist_f", "subspace_dist64"]


def _as_columns(u: torch.Tensor) -> torch.Tensor:
    return u[:, None] if u.dim() == 1 else u  # promote (d,) -> (d, 1)


def _gram_singulars(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Singular values of u^T v (cosines of principal angles), in [0, 1]."""
    return torch.linalg.svdvals(u.mT @ v).clamp(0.0, 1.0)


def dist_2(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Spectral subspace distance ``||UU^T - VV^T||_2`` for orthonormal U,
    V: the sine of the largest principal angle, from the r x r Gram."""
    c = _gram_singulars(_as_columns(u), _as_columns(v))
    cmin = c.min()
    return torch.sqrt(torch.clamp(1.0 - cmin * cmin, min=0.0))


def dist_f(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Frobenius projector distance ``sqrt(2 (r - ||U^T V||_F^2))``."""
    u, v = _as_columns(u), _as_columns(v)
    c = _gram_singulars(u, v)
    return torch.sqrt(torch.clamp(2.0 * (u.shape[1] - torch.sum(c * c)), min=0.0))


def subspace_dist64(u, v) -> float:
    """``dist_2`` in f64 on the host, re-orthonormalizing both arguments.

    The f32 ``dist_2`` bottoms out near sqrt(f32 eps) ~= 3.5e-4; parity
    checks assert agreement at 1e-5, so they measure here.  Takes tensors,
    numpy arrays, or anything ``np.asarray`` accepts; a pure column-span
    distance.
    """
    u = np.linalg.qr(_host64(u))[0]
    v = np.linalg.qr(_host64(v))[0]
    c = np.clip(np.linalg.svd(u.T @ v, compute_uv=False), 0.0, 1.0)
    return float(np.sqrt(max(1.0 - c.min() ** 2, 0.0)))


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)

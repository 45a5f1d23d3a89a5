"""Empirical covariance formation (port of ``repro/core/covariance.py``).

``empirical_covariance`` is the local hot spot of distributed PCA; under
``backend="cuda"`` it runs the B1 Gram kernel
(``repro_torch.kernels.covariance``).  ``gram_increment`` is the
unnormalized building block at a stated accumulation dtype.
"""

from __future__ import annotations

import torch

__all__ = ["empirical_covariance", "gram_increment"]


def gram_increment(x: torch.Tensor, *, dtype=torch.float32) -> torch.Tensor:
    """Unnormalized Gram X^T X of an (n, d) chunk, accumulated at ``dtype``
    promoted to at least f32: accumulation never follows a bf16 payload
    down.  n may be 0 (an exact zero (d, d) result)."""
    acc = torch.promote_types(dtype, torch.float32)
    xf = x.to(acc)
    return xf.mT @ xf


def empirical_covariance(x: torch.Tensor, *, backend: str = "torch") -> torch.Tensor:
    """(1/n) X^T X for samples X (n, d), accumulated in >= f32.

    ``backend``: "torch" (plain), "cuda" (the Gram kernel; a CPU tensor
    takes its plain version), or "auto" (cuda for a CUDA tensor).  The
    kernel accumulates f32 (f32 or bf16 input); the plain path keeps f64
    inputs in f64.
    """
    from repro_torch.kernels import ops as kops

    n = x.shape[0]
    if kops.resolve_backend(backend, x.device) == "cuda":
        return kops.gram(x, use_kernel=True) / n
    return gram_increment(x, dtype=x.dtype) / n

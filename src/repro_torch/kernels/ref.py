"""Plain PyTorch versions of the port's CUDA kernels.

Port of ``repro/kernels/ref.py`` (``gram`` :23, ``batched_gram`` :29,
``batched_gram_polar`` :36, ``align_average`` :95).  Each function is the
semantic ground truth of its kernel: the wrappers run it for tensors on
the CPU, the CPU tests hold it against the reference's Pallas kernels,
and ``chip_smoke.py`` holds each kernel against it on the card.  Nothing
on the card's main path calls it.
"""

from __future__ import annotations

import torch

__all__ = ["gram", "batched_gram", "batched_gram_polar", "align_average"]


def gram(x: torch.Tensor) -> torch.Tensor:
    """X^T X with f32 accumulation. x: (..., n, d) -> (..., d, d) f32."""
    xf = x.to(torch.float32)
    return xf.mT @ xf


def batched_gram(vs: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """G_i = V_i^T @ ref. vs: (m, d, r), ref: (d, r) -> (m, r, r) f32."""
    return torch.einsum(
        "mdr,ds->mrs", vs.to(torch.float32), ref.to(torch.float32)
    )


def batched_gram_polar(
    vs: torch.Tensor, ref: torch.Tensor, *, ns_iters: int | None = None
) -> torch.Tensor:
    """Z_i = polar(V_i^T @ ref) by Newton-Schulz. -> (m, r, r) f32."""
    # Function-level import: repro_torch.core imports the kernel package.
    from repro_torch.core.procrustes import DEFAULT_NS_ITERS, newton_schulz_polar

    iters = DEFAULT_NS_ITERS if ns_iters is None else ns_iters
    return newton_schulz_polar(batched_gram(vs, ref), iters=iters)


def align_average(vs: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """(1/m) sum_i V_i @ Z_i. vs: (m, d, r), zs: (m, r, r) -> (d, r) f32."""
    m = vs.shape[0]
    return (
        torch.einsum("mdr,mrs->ds", vs.to(torch.float32), zs.to(torch.float32))
        / m
    )

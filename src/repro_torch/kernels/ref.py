"""Plain PyTorch versions of the port's CUDA kernels.

Port of ``repro/kernels/ref.py`` (``gram`` :23, ``batched_gram`` :29,
``batched_gram_polar`` :36, ``fused_round`` :49, ``fused_ring_round``
:69, ``align_average`` :95).  Each function is the
semantic ground truth of its kernel: the wrappers run it for tensors on
the CPU, the CPU tests hold it against the reference's Pallas kernels,
and ``chip_smoke.py`` holds each kernel against it on the card.  Nothing
on the card's main path calls it.
"""

from __future__ import annotations

import torch

__all__ = [
    "gram",
    "batched_gram",
    "batched_gram_polar",
    "fused_round",
    "fused_ring_round",
    "align_average",
]


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


def fused_round(
    vs: torch.Tensor,
    ref: torch.Tensor,
    *,
    n_iter: int = 1,
    ns_iters: int | None = None,
) -> torch.Tensor:
    """``n_iter`` rounds of
    ``cholesky_qr2(align_average(vs, batched_gram_polar(vs, ref)))``.
    vs: (m, d, r), ref: (d, r) -> (d, r) in vs.dtype."""
    from repro_torch.core.orthonorm import cholesky_qr2

    out = ref
    for _ in range(max(n_iter, 1)):
        zs = batched_gram_polar(vs, out, ns_iters=ns_iters)
        out = cholesky_qr2(align_average(vs, zs)).to(vs.dtype)
    return out


def fused_ring_round(
    vs: torch.Tensor,
    ref: torch.Tensor,
    scales: torch.Tensor | None = None,
    *,
    ring_chunk: int | None = None,
    ns_iters: int | None = None,
) -> torch.Tensor:
    """Decode the (m', d, r) wire stack (f32 as is, bf16 upcast, int8 times
    its (m', r) per-column ``scales``), then one round of
    ``cholesky_qr2(align_average(vs, batched_gram_polar(vs, ref)))``.
    ``ring_chunk`` is the kernel's d-tile granularity and does not change
    the result.  Returns (d, r) f32."""
    from repro_torch.core.orthonorm import cholesky_qr2

    del ring_chunk
    vsf = vs.to(torch.float32)
    if vs.dtype == torch.int8:
        if scales is None:
            raise ValueError("int8 wire stack needs its (m, r) scales")
        vsf = vsf * scales.to(torch.float32)[:, None, :]
    zs = batched_gram_polar(vsf, ref.to(torch.float32), ns_iters=ns_iters)
    return cholesky_qr2(align_average(vsf, zs)).to(torch.float32)

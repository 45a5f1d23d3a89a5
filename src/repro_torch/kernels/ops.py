"""Public kernel entry points with backend dispatch.

Port of ``repro/kernels/ops.py``.  The shared rule (``_dispatch``):
``use_kernel=None`` resolves to "kernel on a Hopper card, plain version
elsewhere", ``True`` forces the kernel wrapper and ``False`` the plain
version.  A kernel wrapper given CPU tensors runs the plain version, the
counterpart of the reference running Pallas in interpret mode off-TPU; on
CUDA tensors it launches the hand-written kernel or raises.

``backend=`` vocabulary: ``BACKENDS = ("torch", "cuda", "auto")``.
"torch" is plain PyTorch, "cuda" the hand-written kernels, and "auto"
means "cuda" for tensors on a CUDA device and "torch" on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import covariance as _cov
from repro_torch.kernels import procrustes_align as _pa
from repro_torch.kernels import ref as _ref

__all__ = [
    "BACKENDS",
    "on_sm90",
    "resolve_backend",
    "gram",
    "batched_gram",
    "batched_gram_polar",
    "align_average",
    "align_one",
]

BACKENDS = ("torch", "cuda", "auto")


def on_sm90() -> bool:
    """True when the current CUDA device is a Hopper (sm_90) card."""
    return torch.cuda.is_available() and torch.cuda.get_device_capability() == (9, 0)


def resolve_backend(backend: str, device: torch.device | str) -> str:
    """Resolve ``backend`` ("torch" | "cuda" | "auto") for work on
    ``device``: "auto" is "cuda" on a CUDA device and "torch" elsewhere."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return backend


def _dispatch(kernel_fn, plain_fn, use_kernel: bool | None, *args, **kw):
    """Shared kernel/plain dispatch: ``None`` -> kernel iff on sm_90."""
    if use_kernel is None:
        use_kernel = on_sm90()
    if use_kernel:
        return kernel_fn(*args, **kw)
    return plain_fn(*args, **kw)


def gram(
    x: torch.Tensor, *, use_kernel: bool | None = None, symmetric: bool = False
) -> torch.Tensor:
    """X^T X (f32).  ``symmetric`` is a kernel knob (upper tiles only,
    mirrored); the plain version computes the full product either way."""
    return _dispatch(
        lambda x: _cov.gram(x, symmetric=symmetric), _ref.gram, use_kernel, x
    )


def batched_gram(
    vs: torch.Tensor, ref: torch.Tensor, *, use_kernel: bool | None = None
) -> torch.Tensor:
    return _dispatch(_pa.batched_gram, _ref.batched_gram, use_kernel, vs, ref)


def batched_gram_polar(
    vs: torch.Tensor, ref: torch.Tensor, *, use_kernel: bool | None = None, **kw
) -> torch.Tensor:
    """Gram + Newton-Schulz polar: Z_i = polar(V_i^T @ ref), (m, r, r)."""
    return _dispatch(
        _pa.batched_gram_polar, _ref.batched_gram_polar, use_kernel, vs, ref, **kw
    )


def align_average(
    vs: torch.Tensor, zs: torch.Tensor, *, use_kernel: bool | None = None
) -> torch.Tensor:
    return _dispatch(_pa.align_average, _ref.align_average, use_kernel, vs, zs)


def align_one(
    v: torch.Tensor,
    ref: torch.Tensor,
    *,
    polar: str = "svd",
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """Procrustes-align one (d, r) basis to ``ref`` through the kernel
    stages, as an m=1 stack: Gram (Newton-Schulz fused when
    ``polar="newton-schulz"``), then apply.  The per-shard compute of the
    reference's psum topology; returns (d, r) f32."""
    vs = v[None]
    if polar == "newton-schulz":
        z = batched_gram_polar(vs, ref, use_kernel=use_kernel)
    else:
        g = batched_gram(vs, ref, use_kernel=use_kernel)
        u, _, wt = torch.linalg.svd(g, full_matrices=False)
        z = u @ wt
    return align_average(vs, z, use_kernel=use_kernel)  # /m is /1

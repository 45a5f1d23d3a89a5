"""Public kernel entry points with backend dispatch.

Port of ``repro/kernels/ops.py``.  The shared rule (``_dispatch``):
``use_kernel=None`` resolves on the tensors, not on the host: the kernel
wrapper for CUDA tensors, the plain version for CPU tensors.  ``True``
forces the kernel wrapper and ``False`` the plain version.  A kernel
wrapper given CPU tensors runs the plain version, the counterpart of the
reference running Pallas in interpret mode off-TPU; on CUDA tensors it
launches the hand-written kernel or raises (a card other than Hopper
included), so CUDA work never falls back to the plain version quietly.

``backend=`` vocabulary: ``BACKENDS = ("torch", "cuda", "auto")``.
"torch" is plain PyTorch, "cuda" the hand-written kernels, and "auto"
means "cuda" for tensors on a CUDA device and "torch" on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import covariance as _cov
from repro_torch.kernels import flash_attention as _fa
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
    "align_for_backend",
    "fused_round",
    "fused_ring_round",
    "fused_ring_round_remote",
    "attention",
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
    """Shared kernel/plain dispatch: ``None`` -> kernel iff the first
    tensor is on a CUDA device."""
    if use_kernel is None:
        use_kernel = args[0].is_cuda
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


def align_for_backend(
    v: torch.Tensor, ref: torch.Tensor, *, polar: str, backend: str
) -> torch.Tensor:
    """Procrustes-align one basis on the resolved ``backend``: the kernel
    stages (``align_one``) under "cuda", ``procrustes.align`` under
    "torch".  The per-rank align of the psum and hop-ring schedules."""
    if backend == "cuda":
        return align_one(v.contiguous(), ref.contiguous(), polar=polar,
                         use_kernel=True)
    from repro_torch.core.procrustes import align

    return align(v, ref, polar=polar)


def fused_round(
    vs: torch.Tensor, ref: torch.Tensor, *, use_kernel: bool | None = None, **kw
) -> torch.Tensor:
    """Whole Algorithm-1 round(s), one launch each: Gram + Newton-Schulz
    polar + aligned average + CholeskyQR2 (the cuda backend's
    ``polar="newton-schulz", orth="cholesky-qr2"`` cell)."""
    return _dispatch(_pa.fused_round, _ref.fused_round, use_kernel, vs, ref, **kw)


def fused_ring_round(
    vs: torch.Tensor,
    ref: torch.Tensor,
    *,
    scales: torch.Tensor | None = None,
    use_kernel: bool | None = None,
    **kw,
) -> torch.Tensor:
    """One whole round over a staged (m', d, r) stack of wire payloads
    (f32 / bf16 / int8 + (m', r) scales) -> (d, r) f32, ready to be the
    next launch's reference (``repro_torch.comm.ring.fused_ring_rounds``
    stages the wire and loops the rounds)."""
    return _dispatch(
        _pa.fused_ring_round, _ref.fused_ring_round, use_kernel,
        vs, ref, scales, **kw,
    )


def fused_ring_round_remote(
    v_local: torch.Tensor,
    ref: torch.Tensor,
    *,
    group,
    use_kernel: bool | None = None,
    **kw,
) -> torch.Tensor:
    """One ring round over the ranks of ``group``, each holding its own
    (d, r) f32 basis, the hops peer writes between the ranks' buffers (B7)
    -> (d, r) f32.  CPU tensors take the plain version (each hop a
    ``transport.ring_shift``), sm_90 CUDA tensors the kernel; anything
    else raises."""
    return _dispatch(
        lambda v, r_, **k: _pa.fused_ring_round_remote(v, r_, group=group, **k),
        lambda v, r_, **k: _pa.plain_remote(v, r_, group=group, **k),
        use_kernel, v_local, ref, **kw,
    )


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    use_kernel: bool | None = None,
    probs_bf16: bool = False,
) -> torch.Tensor:
    """GQA attention, q (b, hq, s, d), k, v (b, hkv, t, d): the flash
    kernel (B8) for CUDA tensors with more than one query, the plain
    ``ref.attention`` for CPU tensors; decode (s = 1) stays on the plain
    path, as the reference keeps it in XLA.  ``use_kernel=True`` forces
    the wrapper (its plain version on CPU tensors), ``False`` the plain
    path.  ``probs_bf16`` applies to the plain path only: the kernel keeps
    the probabilities in f32, as the reference's kernel does."""
    if use_kernel is None:
        use_kernel = q.is_cuda and q.shape[2] > 1
    if use_kernel:
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    return _ref.attention(
        q, k, v, causal=causal, window=window, probs_bf16=probs_bf16
    )

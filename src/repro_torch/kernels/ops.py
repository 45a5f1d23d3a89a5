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

The kernel route calls the kernels' ``torch.library`` custom ops
(``kernels.library``) when no input needs a gradient: the same wrappers
run, and a dry run under ``FakeTensorMode`` traces them and counts their
operations.  ``attention`` takes DTensor q, k, v (a sharded model): it
runs the same call on each rank's local heads through ``local_map``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import covariance as _cov
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import library as _lib
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
    "head_placements",
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


def _dispatch(kernel_fn, plain_fn, use_kernel: bool | None, *args, op=None, **kw):
    """Shared kernel/plain dispatch: ``None`` -> kernel iff the first
    tensor is on a CUDA device.  The kernel route takes ``op`` (the custom
    op, positional arguments) when no input needs a gradient."""
    if use_kernel is None:
        use_kernel = args[0].is_cuda
    if use_kernel:
        if op is not None and not _needs_grad(args):
            return op()
        return kernel_fn(*args, **kw)
    return plain_fn(*args, **kw)


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def gram(
    x: torch.Tensor, *, use_kernel: bool | None = None, symmetric: bool = False
) -> torch.Tensor:
    """X^T X (f32).  ``symmetric`` is the reference's option; the result is
    the same either way (the kernel always mirrors its upper tiles)."""
    return _dispatch(
        lambda x: _cov.gram(x, symmetric=symmetric), _ref.gram, use_kernel, x,
        op=lambda: _lib.gram(x),
    )


def batched_gram(
    vs: torch.Tensor, ref: torch.Tensor, *, use_kernel: bool | None = None
) -> torch.Tensor:
    return _dispatch(_pa.batched_gram, _ref.batched_gram, use_kernel, vs, ref,
                     op=lambda: _lib.batched_gram(vs, ref))


def batched_gram_polar(
    vs: torch.Tensor, ref: torch.Tensor, *, use_kernel: bool | None = None, **kw
) -> torch.Tensor:
    """Gram + Newton-Schulz polar: Z_i = polar(V_i^T @ ref), (m, r, r)."""
    return _dispatch(
        _pa.batched_gram_polar, _ref.batched_gram_polar, use_kernel, vs, ref,
        op=lambda: _lib.batched_gram_polar(vs, ref, kw.get("ns_iters", _pa.DEFAULT_NS_ITERS)),
        **kw,
    )


def align_average(
    vs: torch.Tensor, zs: torch.Tensor, *, use_kernel: bool | None = None
) -> torch.Tensor:
    return _dispatch(_pa.align_average, _ref.align_average, use_kernel, vs, zs,
                     op=lambda: _lib.align_average(vs, zs))


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
    return _dispatch(
        _pa.fused_round, _ref.fused_round, use_kernel, vs, ref,
        op=lambda: _lib.fused_round(vs, ref, kw.get("n_iter", 1),
                                    kw.get("ns_iters", _pa.DEFAULT_NS_ITERS)),
        **kw)


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
        vs, ref, scales,
        op=lambda: _lib.fused_ring_round(vs, ref, scales, kw.get("ring_chunk"),
                                         kw.get("ns_iters", _pa.DEFAULT_NS_ITERS)),
        **kw,
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
    the probabilities in f32, as the reference's kernel does.

    DTensor q, k, v (a sharded model) go through ``local_map``: each rank
    makes this same call on its local (b / data, hq / model, s, d) and
    (b / data, hkv / model, t, d) blocks, so the kernel runs on each
    rank's own heads (nothing is gathered).  The heads shard over 'model'
    only when both hq and hkv divide by it, else every rank runs all the
    heads (the reference keeps such heads replicated); the batch shards
    over the data axes when it divides by them."""
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, causal=causal, window=window,
                                  use_kernel=use_kernel, probs_bf16=probs_bf16)
    if use_kernel is None:
        use_kernel = q.is_cuda and q.shape[2] > 1
    if use_kernel:
        if not _needs_grad((q, k, v)):
            return _lib.flash_attention(q, k, v, causal, window or 0)
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    return _ref.attention(
        q, k, v, causal=causal, window=window, probs_bf16=probs_bf16
    )


def head_placements(q, k) -> tuple[list, list]:
    """Placements of a sharded model's (b, h, s, d) attention tensors, q's
    and k's (and v's): the batch over the data axes when it divides by
    them, every other mesh axis replicated but 'model', which takes the
    heads when both q's and k's head counts divide by it.  One KV head
    (MQA) stays whole on every rank while the query heads shard, as the
    reference's constraints leave it (each rank's query heads all read
    that head)."""
    import math

    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    data = [a for a in ("pod", "data") if a in sizes]
    place = [Replicate() for _ in names]
    if data and q.shape[0] % math.prod(sizes[a] for a in data) == 0:
        for a in data:
            place[names.index(a)] = Shard(0)
    kv = list(place)
    if "model" in sizes and q.shape[1] % sizes["model"] == 0:
        if k.shape[1] % sizes["model"] == 0:
            place[names.index("model")] = kv[names.index("model")] = Shard(1)
        elif k.shape[1] == 1:
            place[names.index("model")] = Shard(1)
    return place, kv


def _sharded_attention(q, k, v, **kw):
    """``attention`` on each rank's local blocks of DTensor q, k, v."""
    from torch.distributed.tensor.experimental import local_map

    from torch.distributed.tensor import Partial

    place, kv = head_placements(q, k)
    # A KV head whole on every rank of a 'model' axis that splits the query
    # heads gets its gradient from each rank's heads: a partial sum there.
    kv_grad = [Partial() if p != c else c for p, c in zip(place, kv)]
    mesh = q.device_mesh
    run = local_map(lambda ql, kl, vl: attention(ql, kl, vl, **kw),
                    out_placements=place, in_placements=(place, kv, kv),
                    in_grad_placements=(place, kv_grad, kv_grad),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(q, k, v)

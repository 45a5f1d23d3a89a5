"""Plain PyTorch versions of the port's CUDA kernels.

Port of ``repro/kernels/ref.py`` (``gram`` :23, ``batched_gram`` :29,
``batched_gram_polar`` :36, ``fused_round`` :49, ``fused_ring_round``
:69, ``align_average`` :95, ``attention`` :104), and the plain version of
B7 ``fused_ring_round_remote``, which the reference has none of.  Each function but
``attention`` is the semantic ground truth of its kernel: the wrappers
run it for tensors on the CPU, the CPU tests hold it against the
reference's Pallas kernels, and ``chip_smoke.py`` holds each kernel
against it on the card.  ``flash_attention`` is the plain version of the
B8 kernel; ``attention`` is the reference's attention oracle, which the
model runs where it does not take the kernel (decode, CPU, or
``use_kernel=False``).  Nothing else on the card's main path calls them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "gram",
    "batched_gram",
    "batched_gram_polar",
    "fused_round",
    "fused_ring_round",
    "fused_ring_round_remote",
    "align_average",
    "attention",
    "flash_attention",
]

_NEG_INF = -1e30


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


def fused_ring_round_remote(
    v_local: torch.Tensor,
    ref: torch.Tensor,
    *,
    m: int,
    hop,
    ns_iters: int | None = None,
) -> torch.Tensor:
    """One ring round as rank j of an m-rank ring holding only its own
    (d, r) basis: m hops in the order the two-slot schedule delivers the
    bases (own, then ranks j-1, j-2, ...), each the per-hop Gram, polar and
    apply of ``fused_ring_round``, then ``cholesky_qr2(V-bar / m)``.
    ``hop(x)`` returns the left neighbour's ``x`` (the caller's ring
    shift; this module calls no collective).  Returns (d, r) f32."""
    from repro_torch.core.orthonorm import cholesky_qr2

    x = v_local.to(torch.float32)
    ref32 = ref.to(torch.float32)
    vbar = None
    for i in range(m):
        z = batched_gram_polar(x[None], ref32, ns_iters=ns_iters)[0]
        contrib = x @ z
        vbar = contrib if vbar is None else vbar + contrib
        if i < m - 1:
            x = hop(x)
    return cholesky_qr2(vbar / m).to(torch.float32)


def _attention_mask(
    s: int, t: int, causal: bool, window: int | None, device
) -> torch.Tensor:
    """(s, t) mask of the keys each query sees; queries are right-aligned
    against the key timeline (query i sits at position t - s + i)."""
    q_pos = torch.arange(s, device=device)[:, None] + (t - s)
    k_pos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return mask


def _expand_kv(x: torch.Tensor, hq: int) -> torch.Tensor:
    """(b, hkv, t, d) -> (b, hq, t, d): query head h reads KV head
    h // (hq / hkv) (GQA by broadcast; the reshape copies)."""
    b, hkv, t, d = x.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of KV heads {hkv}")
    return x[:, :, None].expand(b, hkv, hq // hkv, t, d).reshape(b, hq, t, d)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    probs_bf16: bool = False,
) -> torch.Tensor:
    """Multi-head attention oracle with GQA, causal and sliding-window
    masks (``repro/kernels/ref.attention``).

    q: (b, hq, s, d); k, v: (b, hkv, t, d); hq % hkv == 0.  Logits are
    products of the inputs accumulated in f32, scaled by 1/sqrt(d) in
    f32; softmax in f32; ``probs_bf16`` rounds the probabilities to bf16
    before the PV product.  A row with no visible key (s > t, causal)
    averages v uniformly, as the reference's softmax does.  Returns
    (b, hq, s, d) in q's dtype.
    """
    b, hq, s, d = q.shape
    t = k.shape[2]
    kx = _expand_kv(k, hq).to(torch.float32)
    vx = _expand_kv(v, hq).to(torch.float32)
    # 1/sqrt(d) in f32 as the reference computes it, kept a host scalar
    # (a device tensor made from it would cost a synchronising copy).
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    logits = (q.to(torch.float32) @ kx.mT) * scale
    mask = _attention_mask(s, t, causal, window, q.device)
    logits = torch.where(mask, logits, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    if probs_bf16:
        p = p.to(torch.bfloat16).to(torch.float32)
    return (p @ vx).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """What the flash kernel (B8, ``repro/kernels/flash_attention.py``)
    computes, in one pass.

    q is scaled by 1/sqrt(d) in f32 and rounded back to q's dtype; q, k
    and v are then taken in f32, logits and the PV product accumulate in
    f32 with the probabilities kept in f32.  Masks as ``attention``
    (right-aligned queries, causal, window).  Unlike ``attention``, a row
    with no visible key gives zeros (the kernel's ``l == 0`` guard).
    Returns (b, hq, s, d) in q's dtype.
    """
    b, hq, s, d = q.shape
    t = k.shape[2]
    scale = float(np.float32(1.0 / d**0.5))
    qs = (q.to(torch.float32) * scale).to(q.dtype).to(torch.float32)
    kx = _expand_kv(k, hq).to(torch.float32)
    vx = _expand_kv(v, hq).to(torch.float32)
    mask = _attention_mask(s, t, causal, window, q.device)
    logits = torch.where(mask, qs @ kx.mT, _NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ vx) / torch.where(l == 0.0, 1.0, l)
    return out.to(q.dtype)

"""The hand-written kernels as ``torch.library`` custom ops, so a dry run
traces them under ``FakeTensorMode`` and counts their work.

Each op's implementation is the kernel's wrapper (``covariance.gram``,
``procrustes_align.*``, ``flash_attention.flash_attention``): on a CUDA
tensor it launches the kernel and adds one to its launch count, on a CPU
tensor it runs the plain version, exactly as a direct call does.  Under
``FakeTensorMode`` the fake implementation gives the output's shape and
dtype and nothing launches (no data pointer exists there), and the
registered FLOP formula (``torch.utils.flop_counter``) gives the
operations the kernel does, the ones PERF.md's bound column counts:

  B1 gram                n d (d + 1)            (each distinct entry of
                                                 the symmetric product)
  B2 batched_gram        2 m d r s
  B3 batched_gram_polar  2 m d r s + ns_iters m 4 r^3
  B4 align_average       2 m d r s
  B5 fused_round         n_iter (4 m d r^2 + 8 d r^2 + ns_iters m 4 r^3)
  B6 fused_ring_round    4 m d r^2 + 8 d r^2 + ns_iters m 4 r^3
  B8 flash_attention     4 b hq hd (visible (query, key) pairs)

``kernels.ops`` calls the ops when no input needs a gradient (the
kernels have no backward; a differentiable CPU call goes to the wrapper).
B7 runs its hops over peer memory of live ranks and has no fake form.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

__all__ = ["visible_keys", "flash_flops", "gram_flops", "round_flops"]

_NS = "repro_torch"


def visible_keys(s: int, t: int, causal: bool = True, window: Optional[int] = None) -> int:
    """(query, key) pairs attention visits: the queries right-aligned on
    the key timeline, each seeing the keys up to its own (``causal``),
    within the last ``window``, or all t."""
    if not causal:
        return int(s) * int(t)
    seen = t - s + np.arange(s, dtype=np.int64) + 1
    if window:
        seen = np.minimum(seen, window)
    return int(np.clip(seen, 0, t).sum())


def flash_flops(b: int, hq: int, s: int, t: int, hd: int, causal: bool = True,
                window: Optional[int] = None) -> int:
    return 4 * b * hq * hd * visible_keys(s, t, causal, window)


def gram_flops(shape) -> int:
    *lead, n, d = shape
    return int(np.prod(lead, dtype=np.int64)) * n * d * (d + 1)


def round_flops(m: int, d: int, r: int, ns_iters: int) -> int:
    return 4 * m * d * r * r + 8 * d * r * r + ns_iters * m * 4 * r ** 3


# ------------------------------------------------------------------- B1 --
@torch.library.custom_op(f"{_NS}::gram", mutates_args=())
def gram(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import covariance

    return covariance.gram(x)


@gram.register_fake
def _(x):
    return x.new_empty((*x.shape[:-2], x.shape[-1], x.shape[-1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.gram)
def _(x_shape, *args, out_shape=None, **kw):
    return gram_flops(x_shape)


# ---------------------------------------------------------------- B2-B4 --
@torch.library.custom_op(f"{_NS}::batched_gram", mutates_args=())
def batched_gram(vs: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import procrustes_align

    return procrustes_align.batched_gram(vs, ref)


@batched_gram.register_fake
def _(vs, ref):
    return vs.new_empty((vs.shape[0], vs.shape[2], ref.shape[1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.batched_gram)
def _(vs_shape, ref_shape, *args, out_shape=None, **kw):
    m, d, r = vs_shape
    return 2 * m * d * r * ref_shape[1]


@torch.library.custom_op(f"{_NS}::batched_gram_polar", mutates_args=())
def batched_gram_polar(vs: torch.Tensor, ref: torch.Tensor, ns_iters: int) -> torch.Tensor:
    from repro_torch.kernels import procrustes_align

    return procrustes_align.batched_gram_polar(vs, ref, ns_iters=ns_iters)


@batched_gram_polar.register_fake
def _(vs, ref, ns_iters):
    return vs.new_empty((vs.shape[0], vs.shape[2], ref.shape[1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.batched_gram_polar)
def _(vs_shape, ref_shape, ns_iters, *args, out_shape=None, **kw):
    m, d, r = vs_shape
    return 2 * m * d * r * ref_shape[1] + ns_iters * m * 4 * r ** 3


@torch.library.custom_op(f"{_NS}::align_average", mutates_args=())
def align_average(vs: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import procrustes_align

    return procrustes_align.align_average(vs, zs)


@align_average.register_fake
def _(vs, zs):
    return vs.new_empty((vs.shape[1], zs.shape[2]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.align_average)
def _(vs_shape, zs_shape, *args, out_shape=None, **kw):
    m, d, r = vs_shape
    return 2 * m * d * r * zs_shape[2]


# ---------------------------------------------------------------- B5/B6 --
@torch.library.custom_op(f"{_NS}::fused_round", mutates_args=())
def fused_round(vs: torch.Tensor, ref: torch.Tensor, n_iter: int,
                ns_iters: int) -> torch.Tensor:
    from repro_torch.kernels import procrustes_align

    return procrustes_align.fused_round(vs, ref, n_iter=n_iter, ns_iters=ns_iters)


@fused_round.register_fake
def _(vs, ref, n_iter, ns_iters):
    return vs.new_empty(ref.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.fused_round)
def _(vs_shape, ref_shape, n_iter, ns_iters, *args, out_shape=None, **kw):
    return n_iter * round_flops(*vs_shape, ns_iters)


@torch.library.custom_op(f"{_NS}::fused_ring_round", mutates_args=())
def fused_ring_round(vs: torch.Tensor, ref: torch.Tensor, scales: Optional[torch.Tensor],
                     ring_chunk: Optional[int], ns_iters: int) -> torch.Tensor:
    from repro_torch.kernels import procrustes_align

    return procrustes_align.fused_ring_round(vs, ref, scales, ring_chunk=ring_chunk,
                                             ns_iters=ns_iters)


@fused_ring_round.register_fake
def _(vs, ref, scales, ring_chunk, ns_iters):
    return ref.new_empty(ref.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.fused_ring_round)
def _(vs_shape, ref_shape, scales_shape, ring_chunk, ns_iters, *args, out_shape=None,
      **kw):
    return round_flops(*vs_shape, ns_iters)


# ------------------------------------------------------------------- B8 --
@torch.library.custom_op(f"{_NS}::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    window: int) -> torch.Tensor:
    from repro_torch.kernels import flash_attention as fa

    return fa.flash_attention(q, k, v, causal=causal, window=window or None)


@flash_attention.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None, **kw):
    b, hq, s, hd = q_shape
    return flash_flops(b, hq, s, k_shape[2], hd, causal, window or None)

"""Gradient utilities: global norm, clipping (port of
``repro/optim/grad_utils.py``).

Trees are name -> tensor mappings (or any iterable of tensors for the
norm).  Both functions compute in f32 over every leaf; ``clip_by_global_norm``
scales in place, so clipping a gradient tree allocates nothing the size
of the tree.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

__all__ = ["global_norm", "clip_by_global_norm", "clip_scale", "host_value"]


def _leaves(tree) -> list[torch.Tensor]:
    return list(tree.values()) if isinstance(tree, Mapping) else list(tree)


def global_norm(tree: Mapping[str, torch.Tensor] | Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum over leaves of sum(x^2)), in f32: a 0-d f32 tensor on the
    leaves' device (a CPU zero for an empty tree).  Each leaf's sum of
    squares comes from ``vector_norm`` in f32, so no leaf-sized square is
    formed."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = torch.stack([torch.linalg.vector_norm(x, dtype=torch.float32) ** 2
                      for x in leaves])
    return sq.sum().sqrt()


def host_value(t, assume: float = 0.0) -> float:
    """``float(t)`` of a 0-d tensor read on the host: a DTensor's whole
    value (a sharded model), or ``assume`` for a tensor of a dry run
    (``FakeTensorMode`` holds no values; the dry run traces the branch
    that value takes)."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    if isinstance(t, torch.Tensor) and is_fake(t):
        return assume
    return float(t)


def clip_scale(norm: float, max_norm: float) -> float:
    """min(1, max_norm / max(norm, 1e-9)) in f32, as a Python float."""
    f32 = np.float32
    return float(min(f32(1.0), f32(max_norm) / max(f32(norm), f32(1e-9))))


def clip_by_global_norm(
    tree: Mapping[str, torch.Tensor], max_norm: float, norm=None
) -> Mapping[str, torch.Tensor]:
    """Scale every leaf in place by ``clip_scale(norm, max_norm)``
    (``norm`` defaults to ``global_norm(tree)``); returns ``tree``."""
    if norm is None:
        norm = global_norm(tree)
    scale = clip_scale(host_value(norm), max_norm)
    if scale != 1.0:
        for x in _leaves(tree):
            x.mul_(scale)
    return tree

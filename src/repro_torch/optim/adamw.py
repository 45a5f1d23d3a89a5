"""Hand-rolled AdamW with f32 moments, updated in place (port of
``repro/optim/adamw.py``).

State: ``{"m": {name: f32}, "v": {name: f32}, "step": 0-d int32}``.
``adamw_update`` walks the leaves one at a time and writes parameters and
moments in place: beside the gradient tree it allocates one leaf-sized
temporary at a time, never a tree (at llama3.2-3b's full width every
extra copy of the tree is 14.4 GB).

Clip at ``clip_norm`` by the global norm, and the NaN guard: a non-finite
global norm leaves parameters, moments and ``step`` as they were and
reports ``step_skipped`` 1.  The guard is decided on the host from the
norm (one device sync a step); the reference computes the update and
selects the old state with ``jnp.where``, which gives the same state.

Weight decay goes to a leaf when the *reference's* leaf has two or more
dimensions (``decays``, given by the caller): the reference stacks each
stage's layers, so its per-block norms are (L, d) and decayed, while the
port keeps a (d,) norm per block.  ``repro_torch.interop.decays`` is the
rule for the LM's leaf names.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping

import numpy as np
import torch

from repro_torch.optim.grad_utils import clip_by_global_norm, global_norm, host_value

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "bias_corrections", "adam_leaf",
           "adam_moments_", "adam_direction", "apply_update_"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict:
    """Zero f32 moments beside each parameter, step 0."""
    return {
        "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32),
    }


def bias_corrections(step: int, b1: float, b2: float) -> tuple[float, float]:
    """(1 - b1^step, 1 - b2^step) in f32, for the step after the increment."""
    f32, s = np.float32, np.float32(step)
    return (float(f32(1.0) - f32(b1) ** s), float(f32(1.0) - f32(b2) ** s))


def adam_moments_(m, v, g, cfg: AdamWConfig) -> None:
    """m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2) g^2, in place (f32)."""
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)


def adam_direction(m, v, c1: float, c2: float, eps: float) -> torch.Tensor:
    """(m / c1) / (sqrt(v / c2) + eps): a new tensor of m's shape."""
    denom = (v / c2).sqrt_().add_(eps)
    return (m / c1).div_(denom)


def apply_update_(p, delta, *, lr: float, weight_decay: float) -> None:
    """p <- p - lr (delta + wd p) on the f32 master weight ``p``, in place
    (``delta`` is consumed)."""
    if weight_decay > 0:
        delta.add_(p, alpha=weight_decay)
    p.add_(delta, alpha=-lr)


def adam_leaf(p, g, m, v, *, lr, c1, c2, cfg: AdamWConfig, decay: bool) -> None:
    """One leaf's AdamW update, in place: the f32 moments m, v from the
    gradient ``g``, then ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``
    (decay only where ``decay``)."""
    adam_moments_(m, v, g.to(torch.float32), cfg)
    delta = adam_direction(m, v, c1, c2, cfg.eps)
    apply_update_(p, delta, lr=lr, weight_decay=cfg.weight_decay if decay else 0.0)


@torch.no_grad()
def adamw_update(
    grads: Mapping[str, torch.Tensor],
    state: Dict,
    params: Mapping[str, torch.Tensor],
    *,
    lr: float,
    cfg: AdamWConfig,
    decays: Callable[[str, torch.Tensor], bool] = lambda name, p: p.ndim >= 2,
) -> Dict[str, float]:
    """Update ``params`` and ``state`` in place from ``grads`` (which the
    clip scales in place); returns the metrics ``grad_norm`` and
    ``step_skipped``."""
    # A dry run (no values) traces the finite, clipped step.
    gnorm = host_value(global_norm(grads), assume=1e30)
    finite = bool(np.isfinite(gnorm))
    metrics = {"grad_norm": gnorm, "step_skipped": 0.0 if finite else 1.0}
    if not finite:
        return metrics
    if cfg.clip_norm > 0:
        clip_by_global_norm(grads, cfg.clip_norm, gnorm)
    step = int(host_value(state["step"])) + 1
    c1, c2 = bias_corrections(step, cfg.b1, cfg.b2)
    for name, p in params.items():
        adam_leaf(p, grads[name], state["m"][name], state["v"][name], lr=lr, c1=c1,
                  c2=c2, cfg=cfg, decay=decays(name, p))
    state["step"].fill_(step)
    return metrics

"""Activation-sharding constraints (port of
``repro/models/sharding_ctx.py``).

The reference pins activation shardings at layer boundaries so GSPMD
propagation keeps the batch sharded (and the heads on 'model').  The port
runs DTensors: under a context each constraint ``redistribute``s its
tensor to the full placement the reference's constraint names (batch
over the data axes, heads or experts over 'model', every other dim
replicated), keeping the reference's divisibility guards.

Each function is the identity when no context is set, or when the tensor
is not a DTensor, so every one-process path runs bit for bit as it did.
The serving and train drivers install the mesh and the batch axes with
``activation_sharding``; ``no_activation_sharding`` suspends them.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch

__all__ = ["activation_sharding", "no_activation_sharding", "current", "constrain_batch",
           "constrain_batch_heads", "constrain_expert_dim", "constrain_weight"]

_CTX = threading.local()


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes: Tuple[str, ...]):
    """Install an activation-sharding context (a ``DeviceMesh`` and the
    axes the batch shards over)."""
    prev = getattr(_CTX, "value", None)
    _CTX.value = (mesh, tuple(batch_axes))
    try:
        yield
    finally:
        _CTX.value = prev


@contextlib.contextmanager
def no_activation_sharding():
    """Suspend the constraints."""
    prev = getattr(_CTX, "value", None)
    _CTX.value = None
    try:
        yield
    finally:
        _CTX.value = prev


def current():
    """The (mesh, batch axes) in force, or None."""
    return getattr(_CTX, "value", None)


def _active(x) -> Optional[tuple]:
    from torch.distributed.tensor import DTensor

    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return None
    return ctx


def _pin(x, mesh, spec: list):
    """Redistribute x to ``spec`` (per tensor dim: None, an axis name or a
    tuple of names), every other mesh axis replicated."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    place = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for axis in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            place[names.index(axis)] = Shard(dim)
    if list(x.placements) == place:
        return x
    return x.redistribute(mesh, place)


def _n_data(mesh, baxes) -> int:
    return math.prod(mesh.size(list(mesh.mesh_dim_names).index(a)) for a in baxes)


def _model_size(mesh) -> Optional[int]:
    names = list(mesh.mesh_dim_names)
    return mesh.size(names.index("model")) if "model" in names else None


def constrain_expert_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Pin an expert dimension onto the 'model' axis (EP)."""
    ctx = _active(x)
    if ctx is None:
        return x
    mesh, _ = ctx
    n = _model_size(mesh)
    if n is None or x.shape[dim] % n != 0:
        return x
    spec = [None] * x.dim()
    spec[dim] = "model"
    return _pin(x, mesh, spec)


def constrain_batch_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) attention tensors: batch over the data axes AND heads
    over 'model' (when divisible).  A full spec: pinning the batch alone
    would force the heads replicated."""
    ctx = _active(x)
    if ctx is None:
        return x
    mesh, baxes = ctx
    spec = [None] * x.dim()
    if x.shape[0] % _n_data(mesh, baxes) == 0:
        spec[0] = baxes if len(baxes) > 1 else baxes[0]
    n = _model_size(mesh)
    if n is not None and x.shape[1] % n == 0:
        spec[1] = "model"
    if all(s is None for s in spec):
        return x
    return _pin(x, mesh, spec)


def constrain_batch(x: torch.Tensor, batch_dim: int = 0) -> torch.Tensor:
    """Pin x's batch dim onto the data axes, every other dim replicated
    (no-op without a context, or when the batch does not divide the
    data-parallel world)."""
    ctx = _active(x)
    if ctx is None:
        return x
    mesh, baxes = ctx
    if x.shape[batch_dim] % _n_data(mesh, baxes) != 0:
        return x
    spec = [None] * x.dim()
    spec[batch_dim] = baxes if len(baxes) > 1 else baxes[0]
    return _pin(x, mesh, spec)


def constrain_weight(w: torch.Tensor) -> torch.Tensor:
    """A weight at its use against batch-sharded activations: gathered over
    the data axes (FSDP: ``embed`` on 'data'), its 'model' placement kept.
    Left to itself DTensor may instead gather the activations, or compute
    a product whole on every rank.  The gradient goes back as a
    reduce-scatter over the data axes."""
    ctx = _active(w)
    if ctx is None:
        return w
    from torch.distributed.tensor import Replicate

    mesh, baxes = ctx
    names = list(mesh.mesh_dim_names)
    place = [Replicate() if names[i] in baxes else p for i, p in enumerate(w.placements)]
    if place == list(w.placements):
        return w
    return w.redistribute(mesh, place)

"""Incremental per-shard covariance state of the streaming service (port of
``repro/stream/accumulator.py``).

A streaming shard sees its rows in chunks, so the local stage of the
paper's estimator becomes state: the running row count, row sum and
unnormalized second moment

    state = (n, s, G)     s = sum_i x_i,   G = sum_i x_i x_i^T

whose two transitions are exact additions:

    update(state, X_k):  (n + n_k,  s + sum(X_k),  G + X_k^T X_k)
    merge(a, b):         (n_a + n_b,  s_a + s_b,   G_a + G_b)

so a stream fed the same rows in any chunking lands on the covariance
``empirical_covariance`` computes one shot (bit for bit on integer-valued
rows, where every partial sum is exact).

Accumulation dtype: the state is f32 or f64, and a chunk accumulates at
``promote_types(state dtype, f32)``, so a bf16 chunk accumulates in f32.

``backend=`` routes each chunk's Gram: under "cuda" (or "auto" on a CUDA
tensor) an f32 state takes it from the B1 kernel (``kernels.ops.gram``),
the kernel ``empirical_covariance(backend="cuda")`` runs one shot, so the
chunked and the one-shot covariance come from the same kernel on the card
(the reference always uses XLA's product here: a deliberate difference).
An f64 state, and the "torch" backend, take ``gram_increment``.  An empty
chunk launches nothing and changes no bit.

The functional core (``init_state`` / ``update`` / ``merge`` /
``to_cov``) returns new state dicts; the ``Accumulator`` class adds its
chunks into its own buffers in place, as the reference's donated jit
does.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.covariance import gram_increment
from repro_torch.interop import resolve_device

__all__ = ["Accumulator", "init_state", "update", "merge", "to_cov"]

State = Dict[str, torch.Tensor]
_STATE_DTYPES = (torch.float32, torch.float64)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def init_state(
    d: int, *, dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda"
) -> State:
    """Empty accumulator state over feature dimension ``d`` on ``device``.

    ``dtype`` is the accumulation dtype (f32 or f64); narrower payloads
    upcast into it, it never follows the payload down.
    """
    if dtype not in _STATE_DTYPES:
        raise ValueError(
            f"accumulator state must be f32 or f64 (got {dtype}); payload "
            "dtypes narrower than the state upcast on update"
        )
    dev = resolve_device(device)
    return {
        "count": torch.zeros((), dtype=dtype, device=dev),
        "sum": torch.zeros((d,), dtype=dtype, device=dev),
        "gram": torch.zeros((d, d), dtype=dtype, device=dev),
    }


def _increment(batch: torch.Tensor, dtype: torch.dtype, backend: str) -> torch.Tensor:
    """The chunk's Gram at the state's ``dtype``: B1 for an f32 state
    under the cuda backend, else ``gram_increment``."""
    from repro_torch.kernels import ops as kops

    if dtype == torch.float32 and kops.resolve_backend(backend, batch.device) == "cuda":
        x = batch if batch.dtype in _KERNEL_DTYPES else batch.to(torch.float32)
        return kops.gram(x.contiguous(), use_kernel=True)
    return gram_increment(batch, dtype=dtype)


def _fold(state: State, batch: torch.Tensor, backend: str, *, in_place: bool) -> State:
    dt = state["gram"].dtype
    n = batch.shape[0]
    if n == 0:  # the exact identity, and no launch
        return state if in_place else {k: v.clone() for k, v in state.items()}
    s = batch.to(dt).sum(dim=0)
    g = _increment(batch, dt, backend)
    if in_place:
        state["count"].add_(n)
        state["sum"].add_(s)
        state["gram"].add_(g)
        return state
    return {"count": state["count"] + n, "sum": state["sum"] + s, "gram": state["gram"] + g}


def update(state: State, batch: torch.Tensor, *, backend: str = "torch") -> State:
    """Fold a chunk of rows ``batch`` (n_k, d) into the state; returns the
    new state.  ``backend`` "torch" | "cuda" | "auto" routes the chunk's
    Gram (module docstring).  An empty chunk (0, d) is the exact identity.
    """
    return _fold(state, batch, backend, in_place=False)


def merge(a: State, b: State) -> State:
    """Combine two accumulators over disjoint row sets (exact addition)."""
    if a["gram"].shape != b["gram"].shape:
        raise ValueError(
            f"cannot merge accumulators over different feature dims "
            f"({a['gram'].shape[0]} vs {b['gram'].shape[0]})"
        )
    return {k: a[k] + b[k].to(a[k].dtype) for k in ("count", "sum", "gram")}


def to_cov(state: State, *, center: bool = False) -> torch.Tensor:
    """The (d, d) covariance the accumulated rows imply: ``G / n``, exactly
    what ``empirical_covariance`` returns for the same rows one shot, or
    with ``center=True`` ``G / n - mu mu^T`` for streams that are not
    pre-centered."""
    n = state["count"]
    cov = state["gram"] / n
    if center:
        mu = state["sum"] / n
        cov = cov - torch.outer(mu, mu)
    return cov


class Accumulator:
    """One shard's streaming covariance state.

    >>> acc = Accumulator(d=64, device="cpu")
    >>> acc.update(x_chunk)          # (n_k, 64), any float dtype
    >>> acc.merge(other)             # fold a sibling accumulator in
    >>> cov = acc.to_cov()           # (64, 64) state-dtype covariance

    ``update`` adds into the state's buffers in place; ``merge`` leaves
    ``other`` intact.  ``backend`` routes every chunk's Gram (``update``).
    """

    def __init__(
        self,
        d: int,
        *,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
        backend: str = "torch",
        state: State | None = None,
    ):
        self._state = init_state(d, dtype=dtype, device=device) if state is None else state
        self.backend = backend

    def update(self, batch: torch.Tensor) -> "Accumulator":
        if batch.dim() != 2 or batch.shape[1] != self.d:
            raise ValueError(f"expected a (n, {self.d}) chunk, got {tuple(batch.shape)}")
        _fold(self._state, batch.to(self._state["gram"].device), self.backend,
              in_place=True)
        return self

    def merge(self, other: "Accumulator") -> "Accumulator":
        self._state = merge(self._state, other._state)
        return self

    def to_cov(self, *, center: bool = False) -> torch.Tensor:
        if int(self.count) == 0:
            raise ValueError("empty accumulator has no covariance")
        return to_cov(self._state, center=center)

    @property
    def state(self) -> State:
        return self._state

    @property
    def d(self) -> int:
        return self._state["gram"].shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self._state["gram"].dtype

    @property
    def count(self) -> torch.Tensor:
        return self._state["count"]

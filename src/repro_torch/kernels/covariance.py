"""Gram matrix ``X^T X``: wrapper over the B1 CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/covariance.py::gram``.
The kernel (``csrc/covariance.cu``) tiles the (d, d) output in 128x128
blocks, loops over n inside each block through a 3-stage ``cp.async``
ring of 32-row slices, accumulates plain f32 products on the CUDA cores,
masks ragged n and d itself, and serves an (m, n, d) stack in one launch.
It computes only the upper tiles and writes each off-diagonal one's
mirror too: half the products of the full product, and the same bits,
since every element is one sum over the rows in ascending order.

A CUDA tensor goes to the kernel (or the call raises); a CPU tensor goes
to the plain version in ``repro_torch.kernels.ref``.  ``gram.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["gram"]

_INT_MAX = 2**31 - 1
_MAX_GRID_Y = 65535  # the stack's leading axis (blockIdx.y)
_TILE = 128  # output tile edge (csrc kBM)
_ENTRY = {torch.float32: "rt_gram_f32", torch.bfloat16: "rt_gram_bf16"}


def gram(x: torch.Tensor, *, symmetric: bool = False) -> torch.Tensor:
    """``X^T X`` for x of shape (n, d), or (m, n, d) per leading index;
    f32 output (d, d) or (m, d, d).

    ``symmetric`` is the reference's option and changes nothing here: the
    kernel always computes the upper tiles and mirrors them, which gives
    the full product's bits, and on the CPU the plain version computes
    the full product.
    """
    if x.device.type == "cpu":
        return _ref.gram(x)
    if x.device.type != "cuda":
        raise ValueError(f"gram: unsupported device {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"gram kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() not in (2, 3):
        raise ValueError(f"gram expects (n, d) or (m, n, d), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("gram kernel needs a contiguous (row-major) input")
    stack = x if x.dim() == 3 else x[None]
    m, n, d = stack.shape
    if d < 1 or m < 1:
        raise ValueError(f"gram: empty input of shape {tuple(x.shape)}")
    tiles = -(-d // _TILE)
    if n > _INT_MAX or tiles * (tiles + 1) // 2 > _INT_MAX or m > _MAX_GRID_Y:
        raise ValueError(f"gram: shape {tuple(x.shape)} beyond the kernel's grid")
    _build.require_sm90(x)
    lib = _build.load()
    out = torch.empty((m, d, d), dtype=torch.float32, device=x.device)
    code = getattr(lib, _ENTRY[x.dtype])(
        x.device.index, x.data_ptr(), out.data_ptr(), m, n, d, _build.stream_of(x)
    )
    _build.check(code, "gram")
    gram.launches += 1
    return out if x.dim() == 3 else out[0]


gram.launches = 0

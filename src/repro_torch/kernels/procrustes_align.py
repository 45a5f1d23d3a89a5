"""Wrappers over the per-stage Procrustes-fixing CUDA kernels (B2-B4).

Replace the Pallas TPU kernels of ``repro/kernels/procrustes_align.py``:

  * ``batched_gram``       G_i = V_i^T ref               (m, r, r) f32
  * ``batched_gram_polar`` Z_i = NS-polar(V_i^T ref)     (m, r, r) f32
  * ``align_average``      (1/m) sum_i V_i Z_i           (d, r) f32

The TPU kernels walk d sequentially per machine.  On the card the Gram
stages split d across blocks instead (``_split_rows``): pass 1 writes
partial Grams into an (m, splits, r, r) f32 scratch allocated here, pass 2
reduces them in a fixed order (and, for the polar variant, runs the
Newton-Schulz steps on the r x r tile in shared memory).  See
``csrc/procrustes_align.cu`` for the design notes.

Each wrapper sends a CUDA tensor to its kernel (or raises) and a CPU
tensor to the plain version in ``repro_torch.kernels.ref``; each counts
its launches in ``<wrapper>.launches`` (one per call, whatever the number
of passes).  The kernels take float32 stacks only.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["batched_gram", "batched_gram_polar", "align_average"]

DEFAULT_NS_ITERS = 24  # as repro_torch.core.procrustes.DEFAULT_NS_ITERS

_GRAM_TILE = 64  # output tile edge of the Gram pass (csrc kBM)
_GRAM_ROWS = 16  # rows per shared-memory slice of the Gram pass (csrc kBK)
_BLOCKS_PER_SM = 2  # pass-1 blocks aimed at per SM
# Largest r whose Newton-Schulz working set (3 padded r x r f32 tiles)
# fits the 227 KB of shared memory a block may use on Hopper.
NS_MAX_R = 136
_MAX_GRID_YZ = 65535


def _split_rows(d: int, m: int, r: int, sms: int) -> tuple[int, int]:
    """(rows per split, splits) of the Gram pass: enough (machine, tile,
    split) blocks for ``_BLOCKS_PER_SM`` per SM, each split a whole number
    of ``_GRAM_ROWS`` slices, the splits covering all d rows."""
    tiles = math.ceil(r / _GRAM_TILE) ** 2
    want = max(1, math.ceil(_BLOCKS_PER_SM * sms / (m * tiles)))
    rows = max(_GRAM_ROWS, math.ceil(math.ceil(d / want) / _GRAM_ROWS) * _GRAM_ROWS)
    return rows, math.ceil(d / rows)


def _check_stack(name: str, vs: torch.Tensor, other: torch.Tensor,
                 other_shape) -> tuple[int, int, int]:
    """Validate a CUDA (m, d, r) f32 stack and its partner, whose shape
    ``other_shape(m, d, r)`` gives; returns (m, d, r)."""
    if vs.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {vs.device}")
    for t in (vs, other):
        if t.device != vs.device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous inputs")
    if vs.dim() != 3:
        raise ValueError(f"{name}: vs must be (m, d, r), got {tuple(vs.shape)}")
    m, d, r = vs.shape
    if min(m, d, r) < 1 or m > _MAX_GRID_YZ:
        raise ValueError(f"{name}: unsupported stack shape {tuple(vs.shape)}")
    want = other_shape(m, d, r)
    if tuple(other.shape) != want:
        raise ValueError(f"{name}: expected shape {want}, got {tuple(other.shape)}")
    _build.require_sm90(vs)
    return m, d, r


def _gram_stage(name: str, vs: torch.Tensor, ref: torch.Tensor,
                ns_iters: int | None) -> torch.Tensor:
    m, d, r = _check_stack(name, vs, ref, lambda m, d, r: (d, r))
    if ns_iters is not None and r > NS_MAX_R:
        raise ValueError(
            f"{name}: r={r} exceeds the in-shared-memory Newton-Schulz "
            f"limit r <= {NS_MAX_R}"
        )
    sms = torch.cuda.get_device_properties(vs.device).multi_processor_count
    rows, splits = _split_rows(d, m, r, sms)
    lib = _build.load()
    part = torch.empty((m, splits, r, r), dtype=torch.float32, device=vs.device)
    out = torch.empty((m, r, r), dtype=torch.float32, device=vs.device)
    args = [vs.device.index, vs.data_ptr(), ref.data_ptr(), part.data_ptr(),
            out.data_ptr(), m, d, r, rows, splits]
    if ns_iters is None:
        code = lib.rt_batched_gram(*args, _build.stream_of(vs))
    else:
        code = lib.rt_batched_gram_polar(*args, ns_iters, _build.stream_of(vs))
    _build.check(code, name)
    return out


def batched_gram(vs: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """G_i = V_i^T @ ref for vs (m, d, r), ref (d, r) -> (m, r, r) f32."""
    if vs.device.type == "cpu":
        return _ref.batched_gram(vs, ref)
    out = _gram_stage("batched_gram", vs, ref, None)
    batched_gram.launches += 1
    return out


def batched_gram_polar(
    vs: torch.Tensor, ref: torch.Tensor, *, ns_iters: int = DEFAULT_NS_ITERS
) -> torch.Tensor:
    """Z_i = polar(V_i^T @ ref) by ``ns_iters`` Newton-Schulz steps on the
    Frobenius-normalised Gram; vs (m, d, r), ref (d, r) -> (m, r, r) f32."""
    if vs.device.type == "cpu":
        return _ref.batched_gram_polar(vs, ref, ns_iters=ns_iters)
    out = _gram_stage("batched_gram_polar", vs, ref, ns_iters)
    batched_gram_polar.launches += 1
    return out


def align_average(vs: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """(1/m) sum_i V_i @ Z_i for vs (m, d, r), zs (m, r, r) -> (d, r) f32."""
    if vs.device.type == "cpu":
        return _ref.align_average(vs, zs)
    m, d, r = _check_stack("align_average", vs, zs, lambda m, d, r: (m, r, r))
    if math.ceil(d / _GRAM_TILE) > _MAX_GRID_YZ:
        raise ValueError(f"align_average: d={d} beyond the kernel's grid")
    lib = _build.load()
    out = torch.empty((d, r), dtype=torch.float32, device=vs.device)
    code = lib.rt_align_average(
        vs.device.index, vs.data_ptr(), zs.data_ptr(), out.data_ptr(),
        m, d, r, _build.stream_of(vs),
    )
    _build.check(code, "align_average")
    align_average.launches += 1
    return out


batched_gram.launches = 0
batched_gram_polar.launches = 0
align_average.launches = 0

"""GQA flash attention, forward: causal, sliding-window (causal within the
window), or bidirectional (``causal=False``, every query row sees all t
keys: the enc-dec encoder); wrapper over the B8 CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``.  The kernel (``csrc/flash_attention.cu``) runs one
block per (128-row query tile, batch x query head), reads each query
head's KV head in place, loops over only the key tiles that hold a
visible key (all of them when bidirectional), and masks ragged s, t and
head_dim itself.  bf16 inputs go through the tensor cores: Q, K and V
tiles stream by TMA into a ring of shared-memory stages, each refilled
as soon as the block's two warpgroups have run ``wgmma`` on it (f32
accumulation, the probabilities split into two bf16 parts so they keep
~16 bits); head_dim up to 128 in 128-key tiles, head_dim 136..256
(recurrentgemma's local attention) padded to 256 in 64-key tiles.  f32 inputs go through plain f32 FMAs on the CUDA cores,
at head_dim 136..256 four lanes per query row
(``flash_attention.last_form`` names the kernel the last launch took, as
the library reports it).  Every wait of the bf16 kernel is bounded
by ``FLASH_WAIT_S``: one that runs out records which wait in a host-mapped
word and traps.  The trap ends the CUDA context, so the caller first sees
CUDA's own launch failure at its next synchronising call; a later call of
this wrapper raises with the recorded wait (a card test makes a wait run
out through the library's test-only ``rt_flash_stall_for_test``).

A CUDA tensor goes to the kernel (or the call raises); CPU tensors go to
the plain version ``repro_torch.kernels.ref.flash_attention``.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["FLASH_WAIT_S", "flash_attention"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535
# Bound on every mbarrier wait of the bf16 kernel; a tile's wait takes
# microseconds.
FLASH_WAIT_S = 10.0
_WAITS = {1: "Q tile", 2: "K/V stage to fill"}
# The kernel ``rt_flash_attention`` reports it launched.
_FORMS = {1: "wgmma (TMA)", 2: "f32 (CUDA cores)", 3: "wide (CUDA cores, f32)",
          4: "wgmma (TMA, hd 256)"}


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """q: (b, hq, s, d); k, v: (b, hkv, t, d) with hq % hkv == 0.  When
    s != t the queries are right-aligned (the suffix of the key
    timeline).  Scales by 1/sqrt(d).  Returns (b, hq, s, d) in q's dtype;
    a row with no visible key is zeros."""
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return _ref.flash_attention(q, k, v, causal=causal, window=window)
    if any(x.device != q.device for x in (k, v)) or q.device.type != "cuda":
        raise ValueError(
            f"flash_attention: q, k, v on {q.device}, {k.device}, {v.device}; "
            "the kernel takes all three on one CUDA device"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes q, k, v all float32 or all bfloat16, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention expects q (b, hq, s, d), k = v (b, hkv, t, d); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hq, s, d = q.shape
    _, hkv, t, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads not a multiple of {hkv} KV heads")
    if not (16 <= d <= 256 and d % 8 == 0):
        raise ValueError(
            f"flash_attention kernel takes head_dim 16..256 in steps of 8, got {d}"
        )
    if min(b, s, t) < 1 or b * hq > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} x {tuple(k.shape)} "
                         "outside the kernel's grid")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("flash_attention kernel needs contiguous (row-major) q, k, v")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash_attention kernel has no backward: train through "
                           "the plain ref.attention")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention kernel needs 16-byte aligned q, k, v")
    _build.require_sm90(q)
    lib = _build.load()
    stalled = lib.rt_flash_status()
    if stalled:
        raise RuntimeError(
            f"flash_attention: an earlier launch waited {FLASH_WAIT_S} s for a "
            f"{_WAITS.get(stalled, stalled)} and trapped")
    out = torch.empty_like(q)
    launched = ctypes.c_int(0)
    code = lib.rt_flash_attention(
        q.device.index, int(q.dtype == torch.bfloat16), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, s, t, d,
        int(causal), window or 0, 1.0 / d**0.5, int(FLASH_WAIT_S * 1e9),
        ctypes.addressof(launched), _build.stream_of(q),
    )
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    flash_attention.last_form = _FORMS[launched.value]
    return out


flash_attention.launches = 0
flash_attention.last_form = None

"""Carrying state between the reference package and the port.

The system has no weights: what the reference hands over is arrays
(samples, covariances, the (m, d, r) stack of local bases, a reference
basis, a subspace-iteration start ``v0``, wire payloads in bf16 or int8
with their f32 column scales, a ``Membership``'s mask).  They cross as
numpy arrays, so one set of inputs made from a numpy seed feeds both
packages; a bf16 array (numpy's ``ml_dtypes`` bfloat16) crosses bit for
bit.

Also the device rule of the port's entry points: ``resolve_device``
places work on the card unless the caller names the CPU, and raises when
asked for a card that is not there.  ``strict_fp32`` turns TF32 off,
because the reference computes in f32 and TF32 would cut the SVD, QR and
subspace-iteration products to about three digits.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["from_reference", "to_numpy", "resolve_device", "strict_fp32"]


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch finds no CUDA device; pass "
            "device='cpu' to run the port's plain PyTorch path"
        )
    return dev


def strict_fp32() -> None:
    """Keep float32 matrix products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def from_reference(
    arrays: Mapping[str, np.ndarray],
    *,
    device: str | torch.device,
    dtype: torch.dtype | None = None,
) -> dict[str, torch.Tensor]:
    """Copy named host arrays (numpy, or anything ``np.asarray`` takes,
    such as the reference's device arrays) onto ``device`` as tensors,
    optionally cast to ``dtype``."""
    dev = resolve_device(device)
    out = {}
    for name, arr in arrays.items():
        host = np.array(arr, copy=True)
        if host.dtype.name == "bfloat16":  # no numpy dtype torch reads
            t = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(host)
        out[name] = t.to(device=dev, dtype=dtype or t.dtype)
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor (bf16 widens to f32, which numpy has)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()

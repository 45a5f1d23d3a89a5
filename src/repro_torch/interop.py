"""Carrying state between the reference package and the port.

The system has no weights: what the reference hands over is arrays
(samples, covariances, the (m, d, r) stack of local bases, a reference
basis, a subspace-iteration start ``v0``, wire payloads in bf16 or int8
with their f32 column scales, a ``Membership``'s mask).  They cross as
numpy arrays, so one set of inputs made from a numpy seed feeds both
packages; a bf16 array (numpy's ``ml_dtypes`` bfloat16) crosses bit for
bit.

For the LM, ``lm_params_from_reference`` loads the reference's parameter
tree (as numpy arrays) into the port's ``LM``, so both packages compute
the same function in the parity tests.

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

__all__ = [
    "from_reference", "to_numpy", "resolve_device", "strict_fp32",
    "lm_params_from_reference",
]


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


def lm_params_from_reference(values, cfg, *, device: str | torch.device):
    """The port's ``LM`` for ``cfg`` holding the reference's parameters.

    ``values`` is the reference's tree (``init_split(cfg, key)[0]``) with
    numpy leaves: ``embed`` (V_pad, d), ``unembed`` (d, V_pad),
    ``final_norm`` (d,), and per stage ``stages[i]["block{j}"]`` with a
    leading layer axis: ``norm1``, ``norm2``, ``mixer.{wq (d, h, hd), wk,
    wv (d, kv, hd), wo (h, hd, d)}``, ``mlp.{wi, wg (d, f), wo (f, d)}``.
    Projections are cast to the config's dtype (the reference casts at
    every use), norms stay f32.
    """
    # Function-level import: the models import the kernels, which this
    # module's other helpers must not pull in.
    from repro_torch.models.lm import LM

    model = LM(cfg, device=resolve_device(device))

    def put(param: torch.Tensor, arr) -> None:
        host = torch.tensor(np.asarray(arr, dtype=np.float32))  # a copy
        param.copy_(host.reshape(param.shape))

    with torch.no_grad():
        put(model.embed, values["embed"])
        if model.unembed is not None:
            put(model.unembed, values["unembed"])
        put(model.final_norm, values["final_norm"])
        blocks = iter(model.blocks)
        for (pattern, count), stage in zip(cfg.stages(), values["stages"]):
            for i in range(count):
                for j in range(len(pattern)):
                    tree, blk = stage[f"block{j}"], next(blocks)
                    put(blk.norm1, tree["norm1"][i])
                    for name in ("wq", "wk", "wv", "wo"):
                        put(getattr(blk.mixer, name), tree["mixer"][name][i])
                    if blk.mlp is not None:
                        put(blk.norm2, tree["norm2"][i])
                        for name, w in tree["mlp"].items():
                            put(getattr(blk.mlp, name), w[i])
    return model

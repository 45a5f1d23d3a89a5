"""Input stand-ins for every (arch x shape) cell (port of
``repro/launch/specs.py``): tensors on the ``meta`` device, with the
reference's shapes and dtypes, so nothing is allocated.  The modality
frontends are stubs as in the reference: an encoder-decoder gets frame
embeddings, a VLM patch embeddings.  The decode cache is the port's
(one dict per block, ``LM.init_cache`` / ``EncDec.init_cache``), with an
encoder-decoder's cross K/V beside its self K/V, as the reference's."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.lm import dtype_of
from repro_torch.models.registry import model_class

__all__ = ["train_input_specs", "prefill_input_specs", "decode_state_specs"]

I32 = torch.int32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {"tokens": _meta((b, s), I32), "labels": _meta((b, s), I32)}
    if cfg.is_encoder_decoder:
        specs["frames"] = _meta((b, s, cfg.d_model), dtype_of(cfg))
    if cfg.num_patches:
        specs["patch_embeds"] = _meta((b, cfg.num_patches, cfg.patch_embed_dim),
                                      dtype_of(cfg))
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    return train_input_specs(cfg, shape) | {}


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(tokens, cache, pos) stand-ins for one decode step."""
    b, s = shape.global_batch, shape.seq_len
    tokens, pos = _meta((b, 1), I32), _meta((), I32)
    kw = dict(cross_len=s) if cfg.is_encoder_decoder else {}
    cache = model_class(cfg)(cfg, device="meta").init_cache(b, s, **kw)
    return tokens, cache, pos

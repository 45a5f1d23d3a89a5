"""Building the port's model from a config (port of
``repro/models/registry.py``, the LM lane).

``build(cfg, device=..., generator=...)`` returns the ``LM`` module,
whose ``prefill`` / ``decode_step`` / ``init_cache`` are the serving
surface of the reference's ``ModelApi``.  ``init_params`` fills it from a
``torch.Generator`` with the reference's distributions
(``repro/models/layers.py:70-81``): every projection, the embedding and
the unembedding a standard normal truncated to [-2, 2] times
1/sqrt(fan_in), drawn in f32 and stored in the model's dtype (the
reference stores f32 and casts at every use: the same values); norm
scales zero.  The two frameworks draw different numbers from one seed:
equivalence is of distributions, and the parity tests carry the
reference's own weights across with ``interop.lm_params_from_reference``.
"""

from __future__ import annotations

import torch

from repro_torch.interop import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM

__all__ = ["build", "init_params"]


def _trunc_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = (1.0 / max(fan_in, 1)) ** 0.5
    x = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.copy_(x.mul_(std))


@torch.no_grad()
def init_params(model: LM, generator: torch.Generator) -> LM:
    """Draw every parameter of ``model`` in place (see module docstring)."""
    cfg = model.cfg
    d = cfg.d_model
    _trunc_normal_(model.embed, d, generator)
    if model.unembed is not None:
        _trunc_normal_(model.unembed, d, generator)
    model.final_norm.zero_()
    for blk in model.blocks:
        blk.norm1.zero_()
        att = blk.mixer
        for w in (att.wq, att.wk, att.wv):
            _trunc_normal_(w, d, generator)
        _trunc_normal_(att.wo, cfg.num_heads * cfg.head_dim, generator)
        if blk.mlp is not None:
            blk.norm2.zero_()
            _trunc_normal_(blk.mlp.wi, d, generator)
            _trunc_normal_(blk.mlp.wo, cfg.d_ff, generator)
            if blk.mlp.gated:
                _trunc_normal_(blk.mlp.wg, d, generator)
    return model


def build(
    cfg: ModelConfig,
    *,
    device: str | torch.device = "cuda",
    generator: torch.Generator | None = None,
) -> LM:
    """The LM of ``cfg`` on ``device`` (the card unless the caller names
    the CPU), initialised from ``generator`` (a generator on that device;
    seeded 0 if None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return init_params(LM(cfg, device=dev), generator)

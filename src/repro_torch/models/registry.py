"""Building the port's model from a config (port of
``repro/models/registry.py``).

``build(cfg, device=..., generator=...)`` returns the ``LM`` module, or
the ``EncDec`` one for an encoder-decoder config, as the reference's
``ModelApi`` picks ``lm`` or ``encdec``; their ``prefill`` /
``decode_step`` / ``init_cache`` are its serving surface and ``loss``
its loss (``lm.loss_fn`` or ``encdec.loss_fn``).  ``init_params`` fills it from a
``torch.Generator`` with the reference's distributions
(``repro/models/layers.py:70-81``): every projection, the embedding and
the unembedding a standard normal truncated to [-2, 2] times
1/sqrt(fan_in), drawn in f32 and stored in the model's parameter dtype
(the config's dtype to serve: the reference stores f32 and casts at every
use, the same values; f32 master weights to train); a causal conv's fan-in
is its kernel width K; an MoE layer's ``router`` (d, e), ``wi`` and ``wg``
(e, d, f) have fan-in d and its ``wo`` (e, f, d) fan-in f (the
reference's ``in_axis=1``); the VLM's ``patch_proj`` has fan-in
patch_embed_dim; the enc-dec's attention (self and cross: the
reference's ``init_cross_attention`` is ``init_attention``) and MLP
leaves are drawn as the decoder-only model's, each drawn one leaf at a time on the model's
device, so a full MoE config is never held in f32; norm scales zero.
RG-LRU's ``lam`` is
``linspace(2.2, 6.9, w)``; SSD's ``a_log`` is ``log(linspace(1, 16, H))``,
``dt_bias`` zeros and ``dskip`` ones (``init_rglru`` :468, ``init_ssd``
:562).  The two frameworks draw different numbers from one seed:
equivalence is of distributions, and the parity tests carry the
reference's own weights across with ``interop.lm_params_from_reference``.
"""

from __future__ import annotations

import torch

from repro_torch.interop import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import ATTENTION_KINDS, LM

__all__ = ["build", "init_params", "loss", "model_class"]


def _trunc_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = (1.0 / max(fan_in, 1)) ** 0.5
    x = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.copy_(x.mul_(std))


def _init_attention(mix, cfg: ModelConfig, gen: torch.Generator) -> None:
    for w in (mix.wq, mix.wk, mix.wv):
        _trunc_normal_(w, cfg.d_model, gen)
    _trunc_normal_(mix.wo, cfg.num_heads * cfg.head_dim, gen)


def _init_mlp(mlp, cfg: ModelConfig, gen: torch.Generator) -> None:
    _trunc_normal_(mlp.wi, cfg.d_model, gen)
    _trunc_normal_(mlp.wo, cfg.d_ff, gen)
    if mlp.gated:
        _trunc_normal_(mlp.wg, cfg.d_model, gen)


@torch.no_grad()
def _init_encdec(model: EncDec, gen: torch.Generator) -> EncDec:
    cfg = model.cfg
    _trunc_normal_(model.embed, cfg.d_model, gen)
    _trunc_normal_(model.unembed, cfg.d_model, gen)
    for p in (model.enc_norm, model.dec_norm):
        p.zero_()
    for layer in model.encoder:
        layer.norm1.zero_()
        layer.norm2.zero_()
        _init_attention(layer.attn, cfg, gen)
        _init_mlp(layer.mlp, cfg, gen)
    for layer in model.decoder:
        for p in (layer.norm1, layer.norm_x, layer.norm2):
            p.zero_()
        _init_attention(layer.self_attn, cfg, gen)
        _init_attention(layer.cross_attn, cfg, gen)
        _init_mlp(layer.mlp, cfg, gen)
    return model


@torch.no_grad()
def init_params(model: LM | EncDec, generator: torch.Generator) -> LM | EncDec:
    """Draw every parameter of ``model`` in place (see module docstring)."""
    if isinstance(model, EncDec):
        return _init_encdec(model, generator)
    cfg = model.cfg
    d = cfg.d_model
    _trunc_normal_(model.embed, d, generator)
    if model.unembed is not None:
        _trunc_normal_(model.unembed, d, generator)
    if model.patch_proj is not None:
        _trunc_normal_(model.patch_proj, cfg.patch_embed_dim, generator)
    model.final_norm.zero_()
    for blk in model.blocks:
        blk.norm1.zero_()
        mix = blk.mixer
        if blk.kind in ATTENTION_KINDS:
            _init_attention(mix, cfg, generator)
        elif blk.kind == "rglru":
            w = mix.width
            for p_, fan_in in ((mix.wx, d), (mix.wgate, d), (mix.conv, cfg.conv_width),
                               (mix.wa, w), (mix.wi, w), (mix.wo, w)):
                _trunc_normal_(p_, fan_in, generator)
            mix.lam.copy_(torch.linspace(2.2, 6.9, w, dtype=torch.float32))
        else:  # ssd
            for p_, fan_in in ((mix.wx, d), (mix.wz, d), (mix.wb, d), (mix.wc, d),
                               (mix.wdt, d), (mix.conv, cfg.conv_width),
                               (mix.wo, cfg.d_inner)):
                _trunc_normal_(p_, fan_in, generator)
            mix.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, cfg.ssm_heads,
                                                     dtype=torch.float32)))
            mix.dt_bias.zero_()
            mix.dskip.fill_(1.0)
        if blk.mlp is not None:
            blk.norm2.zero_()
            if cfg.is_moe:
                for p_, fan_in in ((blk.mlp.router, d), (blk.mlp.wi, d),
                                   (blk.mlp.wg, d), (blk.mlp.wo, cfg.d_ff)):
                    _trunc_normal_(p_, fan_in, generator)
            else:
                _init_mlp(blk.mlp, cfg, generator)
    return model


def model_class(cfg: ModelConfig) -> type:
    """``EncDec`` for an encoder-decoder config, else ``LM``."""
    return EncDec if cfg.is_encoder_decoder else LM


def loss(model: LM | EncDec, batch: dict) -> tuple[torch.Tensor, dict]:
    """The model's training loss on ``batch`` and ``{"ce", "aux"}``:
    ``encdec.loss_fn`` (the batch carries ``frames``) or ``lm.loss_fn``
    (optionally ``patch_embeds``)."""
    return (encdec.loss_fn if isinstance(model, EncDec) else lm.loss_fn)(model, batch)


def build(
    cfg: ModelConfig,
    *,
    device: str | torch.device = "cuda",
    generator: torch.Generator | None = None,
    param_dtype: torch.dtype | None = None,
) -> LM | EncDec:
    """The model of ``cfg`` on ``device`` (the card unless the caller
    names the CPU), initialised from ``generator`` (a generator on that
    device; seeded 0 if None), parameters stored in ``param_dtype``
    (default the config's dtype; ``torch.float32`` for training)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = model_class(cfg)(cfg, device=dev, param_dtype=param_dtype)
    return init_params(model, generator)

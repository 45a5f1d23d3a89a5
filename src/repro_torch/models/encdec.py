"""Whisper-style encoder-decoder of the audio family (port of
``repro/models/encdec.py``).

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d_model), the output of
whisper's conv stack, adds sinusoidal positions and runs bidirectional
self-attention layers over them.  The decoder is a causal LM whose
layers add cross-attention to the encoder's output.  Positions are
sinusoidal (``_sinusoid``: computed in f32, then cast to the compute
dtype), and both stacks' self-attention also applies RoPE, as the
reference's ``apply_attention`` does; cross-attention applies none.

Layers (each pre-norm residual, norm scales f32 with the reference's
``1 + scale`` gain):
  encoder: ``norm1`` -> bidirectional ``attn`` -> ``norm2`` -> ``mlp``;
  decoder: ``norm1`` -> causal ``self_attn`` -> ``norm_x`` ->
           ``cross_attn`` -> ``norm2`` -> ``mlp``;
then ``enc_norm`` / ``dec_norm`` and the unembedding: products of the
compute dtype accumulated in f32, padded vocab entries -1e30.

Attention paths: the encoder's self-attention runs in the reference's
train mode in every use; with no gradient taken (serving) it goes
through the flash kernel (B8, ``causal=False``) for CUDA tensors, once a
layer, as the reference's encoder takes its Pallas kernel on its
accelerator; with a gradient it takes the plain ``ref.attention`` (B8 has
no backward).  The decoder's self-attention is ``Attention``'s: B8 in
prefill, the plain grouped product in decode and in train.  Cross-
attention is plain, with f32 probabilities (the reference's
``use_kernel=False``).  So a prefill launches B8 once per encoder and
once per decoder layer (``attention_blocks``) and decode never.

The cache is a list with one dict a decoder layer:
``{"self": {"k", "v"} (B, KV, cache_len, D), "cross": {"k", "v"}
(B, KV, S_enc, D)}``.  ``prefill`` preallocates the self caches at
``cache_len`` (the reference pads them to it, ``grow``), the decoder
writes the prompt's K/V into them in place and builds the cross cache
once from the encoder's output; ``decode_step`` updates the self cache
in place and reuses the cross cache.

A sharded model (DTensor parameters, ``launch.sharding.shard_model``)
runs the same code: the vocab-split embedding through ``embed_lookup``,
the unembedding through ``linear``'s fold, each stack's residual pinned
to the batch sharding, self- and cross-attention on each rank's batch
rows and heads (``kernels.ops.attention``'s ``local_map``), and a cache
of DTensors (``init_cache``), the cross K/V built at prefill in its
placements (batch, KV heads).

In train mode with ``cfg.remat == "full"`` each layer of both stacks
runs under ``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` of each body.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    MODES,
    Attention,
    CrossAttention,
    cross_entropy,
    embed_lookup,
    linear,
    rms_norm,
)
from repro_torch.models.lm import dtype_of
from repro_torch.models.sharding_ctx import constrain_batch, constrain_weight

__all__ = ["EncDec", "loss_fn"]

Cache = list[dict[str, dict[str, torch.Tensor] | None]]


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S,) positions -> (S, d) f32 ``[sin(p f), cos(p f)]`` with
    ``f = exp(-ln(10000) j / max(d/2 - 1, 1))``, the reference's order of
    f32 operations."""
    half = d // 2
    neg_log = float(-np.log(np.float32(10000.0)))  # jnp.log of a weak f32
    j = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = torch.exp(neg_log * j / max(half - 1, 1))
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _norm(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, device=device))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.eps = cfg.norm_eps
        kw = dict(device=device, dtype=dtype)
        self.norm1 = _norm(cfg.d_model, device)
        self.attn = Attention(cfg, causal=False, **kw)
        self.norm2 = _norm(cfg.d_model, device)
        self.mlp = MLP(cfg, **kw)

    def forward(self, x, *, positions, use_kernel):
        out, _ = self.attn(rms_norm(x, self.norm1, self.eps), positions=positions,
                           mode="train", use_kernel=use_kernel)
        x = x + out
        return x + self.mlp(rms_norm(x, self.norm2, self.eps))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.eps = cfg.norm_eps
        kw = dict(device=device, dtype=dtype)
        self.norm1 = _norm(cfg.d_model, device)
        self.self_attn = Attention(cfg, **kw)
        self.norm_x = _norm(cfg.d_model, device)
        self.cross_attn = CrossAttention(cfg, **kw)
        self.norm2 = _norm(cfg.d_model, device)
        self.mlp = MLP(cfg, **kw)

    def forward(self, x, enc_out, *, positions, mode, cache=None, pos=None,
                use_kernel=None):
        out, self_c = self.self_attn(
            rms_norm(x, self.norm1, self.eps), positions=positions, mode=mode,
            cache=None if cache is None else cache["self"], pos=pos,
            use_kernel=use_kernel)
        x = x + out
        out, cross_c = self.cross_attn(
            rms_norm(x, self.norm_x, self.eps), enc_out=enc_out,
            cache=None if cache is None else cache["cross"])
        x = x + out
        x = x + self.mlp(rms_norm(x, self.norm2, self.eps))
        return x, (None if cache is None else {"self": self_c, "cross": cross_c})


class EncDec(nn.Module):
    """Embedding, encoder stack, decoder stack, norms, unembedding.
    Parameters are allocated uninitialised on ``device`` in
    ``param_dtype`` (default the config's dtype; norms f32), filled by
    ``repro_torch.models.build`` from a generator or by
    ``interop.lm_params_from_reference`` from the reference's tree."""

    def __init__(self, cfg: ModelConfig, *, device=None, param_dtype=None):
        super().__init__()
        cfg.validate()
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is decoder-only: build models.LM")
        self.cfg = cfg
        dtype = param_dtype or dtype_of(cfg)
        d, vp = cfg.d_model, cfg.padded_vocab
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Parameter(torch.empty(vp, d, **kw))
        self.unembed = nn.Parameter(torch.empty(d, vp, **kw))
        self.enc_norm = _norm(d, device)
        self.dec_norm = _norm(d, device)
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg, **kw) for _ in range(cfg.num_encoder_layers))
        self.decoder = nn.ModuleList(DecoderLayer(cfg, **kw) for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def attention_blocks(self) -> int:
        """Self-attention layers of both stacks: the flash kernel's
        launches in one prefill on the card."""
        return len(self.encoder) + len(self.decoder)

    def _remat(self, train: bool) -> bool:
        return train and self.cfg.remat == "full" and torch.is_grad_enabled()

    def encode(self, frames: torch.Tensor, *, use_kernel: bool | None = None) -> torch.Tensor:
        """frames (B, S_enc, d_model) -> encoder states (B, S_enc, d_model)
        in the compute dtype.  ``use_kernel`` None: B8 for CUDA tensors
        when no gradient is taken and S_enc > 1, else the plain path."""
        cdt = dtype_of(self.cfg)
        s = frames.shape[1]
        positions = torch.arange(s, device=frames.device)
        x = constrain_batch(frames.to(cdt) + _sinusoid(positions, self.cfg.d_model).to(cdt))
        if use_kernel is None:
            use_kernel = frames.is_cuda and not torch.is_grad_enabled() and s > 1
        remat = self._remat(True)
        for layer in self.encoder:
            kw = dict(positions=positions, use_kernel=use_kernel)
            x = checkpoint(layer, x, use_reentrant=False, **kw) if remat else layer(x, **kw)
            x = constrain_batch(x)
        return rms_norm(x, self.enc_norm, self.cfg.norm_eps)

    def decode(
        self,
        tokens: torch.Tensor,
        *,
        enc_out: torch.Tensor | None = None,
        mode: str = "train",
        cache: Cache | None = None,
        pos: int | None = None,
        use_kernel: bool | None = None,
    ) -> tuple[torch.Tensor, Cache | None]:
        """Decoder forward: tokens (B, S) -> (f32 logits, cache).  train
        and prefill attend to ``enc_out``; prefill writes the self K/V into
        ``cache`` and builds its cross K/V; decode (S == 1 at ``pos``)
        reads both from ``cache``.  Prefill computes the last position's
        logits only."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        cfg = self.cfg
        cdt = dtype_of(cfg)
        s = tokens.shape[1]
        if mode == "decode":
            positions = torch.full((1,), pos, device=tokens.device)
        else:
            positions = torch.arange(s, device=tokens.device)
        # Gather, then cast: the reference's take of the cast table.
        x = embed_lookup(tokens, self.embed).to(cdt)
        x = constrain_batch(x + _sinusoid(positions, cfg.d_model).to(cdt))
        remat = self._remat(mode == "train")
        new_cache = [] if mode in ("prefill", "decode") else None
        for i, layer in enumerate(self.decoder):
            kw = dict(positions=positions, mode=mode,
                      cache=None if cache is None else cache[i], pos=pos,
                      use_kernel=use_kernel)
            if remat:
                x, c = checkpoint(layer, x, enc_out, use_reentrant=False, **kw)
            else:
                x, c = layer(x, enc_out, **kw)
            x = constrain_batch(x)
            if new_cache is not None:
                new_cache.append(c)
        x = rms_norm(x, self.dec_norm, cfg.norm_eps)
        if mode == "prefill":
            x = x[:, -1:, :]
        # Products of the model's dtype accumulated in f32, f32 out.
        logits = linear(x.to(torch.float32),
                        constrain_weight(self.unembed.to(cdt)).to(torch.float32))
        if cfg.padded_vocab != cfg.vocab_size:  # padded entries out of the softmax
            pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
            if isinstance(logits, DTensor):
                logits = logits.masked_fill(pad, -1e30)  # may be partial sums
            else:
                logits.masked_fill_(pad, -1e30)
        return logits, new_cache

    def init_cache(self, batch: int, cache_len: int, cross_len: int | None = None) -> Cache:
        """Zero self caches of ``cache_len`` slots, one a decoder layer;
        the cross caches are built by ``prefill``, or, with ``cross_len``,
        zero ones of that many encoder positions (a decode step's state
        without a prefill: the dry run).  For a sharded model (DTensor
        parameters) each tensor a DTensor placed by
        ``launch.sharding.shard_cache``."""
        cfg = self.cfg
        kw = dict(device=self.device, dtype=dtype_of(cfg))

        def kv(slots):
            shape = (batch, cfg.num_kv_heads, slots, cfg.head_dim)
            return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}

        cache = [{"self": kv(cache_len), "cross": None if cross_len is None else kv(cross_len)}
                 for _ in self.decoder]
        mesh = getattr(self.embed, "device_mesh", None)
        if mesh is None:
            return cache
        from repro_torch.launch.sharding import shard_cache

        return shard_cache(cache, cfg, mesh)

    @torch.no_grad()
    def prefill(
        self,
        frames: torch.Tensor,
        tokens: torch.Tensor,
        *,
        cache_len: int | None = None,
        use_kernel: bool | None = None,
    ) -> tuple[torch.Tensor, Cache]:
        """Encode ``frames`` and prime the decoder's cache with the prompt
        ``tokens`` (B, S): the last position's logits (B, V_pad) f32 and
        the cache for a serving length of ``max(cache_len, S)``.
        ``use_kernel`` picks both stacks' attention path (None: B8 for
        CUDA tensors)."""
        b, s = tokens.shape
        enc_out = self.encode(frames, use_kernel=use_kernel)
        cache = self.init_cache(b, max(cache_len or s, s))
        logits, cache = self.decode(tokens, enc_out=enc_out, mode="prefill", cache=cache,
                                    use_kernel=use_kernel)
        return logits[:, -1], cache

    @torch.no_grad()
    def decode_step(
        self, tokens: torch.Tensor, cache: Cache, pos: int
    ) -> tuple[torch.Tensor, Cache]:
        """One serving step: tokens (B, 1) at position ``pos``, the self
        cache updated in place, the cross cache reused; logits (B, V_pad)
        f32."""
        logits, cache = self.decode(tokens, mode="decode", cache=cache, pos=pos)
        return logits[:, 0], cache


def loss_fn(
    model: EncDec, batch: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Teacher-forced CE of ``batch``: frames (B, S_enc, d_model), tokens
    and labels (B, S_dec), optional loss_mask; ``{"ce", "aux"}`` with aux
    0, as the reference's."""
    enc_out = model.encode(batch["frames"])
    logits, _ = model.decode(batch["tokens"], enc_out=enc_out, mode="train")
    ce = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device)}

"""Decoder-only LM of the dense, MoE, hybrid, SSM and VLM families (port
of ``repro/models/lm.py``; the audio family's encoder-decoder is
``models/encdec.py``).

The depth follows ``cfg.stages()``, the remainder stage included: one
``Block`` per mixer of each stage's pattern, repeated ``count`` times, in
a ``ModuleList``; a Python loop over it takes the place of the
reference's ``jax.lax.scan`` over stacked parameters.  A block's kind
picks its mixer: ``attn`` (full attention), ``local_attn`` (windowed,
``cfg.window_size``), ``rglru`` or ``ssd``; its MLP is the routed
``MoE`` when ``cfg.is_moe``, else the dense ``MLP``.

A VLM config (``cfg.num_patches``) has the reference's patch stub: its
``patch_embeds`` (B, P, patch_embed_dim), the stand-in for the vision
tower's output, are projected by ``patch_proj`` (patch_embed_dim, d) in
the compute dtype and put ahead of the token embeddings; positions run
over all P + S, ``loss_fn`` keeps the text positions' logits only, and a
served prompt's decode positions start at P + S.  Without
``patch_embeds`` the model is a text LM (``patch_proj`` unused), as the
reference's trainer runs it on its token batches.

Modes of ``LM.forward``:
  train   - causal forward over the whole sequence, (B, S, V_pad) logits;
  prefill - the same, and the per-block KV cache; only the last
            position's logits are computed (the reference's §Perf cut);
  decode  - one token per row at position ``pos`` against the cache.

Logits come out in f32 (products of the model's dtype accumulated in f32,
as the reference's ``preferred_element_type``), and the padded vocab
entries are set to -1e30.  A tied config (mamba2) unembeds with
``embed.T``: autograd sums the gather's gradient and the unembedding's
into the one leaf, as the reference's ``jax.grad`` does.  ``loss_fn`` is
the next-token mean CE over them plus ``aux_coef`` times the MoE layers'
aux loss, summed over the blocks (``LM.forward_with_aux``; 0 for the
other families).  Serving ignores the aux.

Parameters: ``LM(cfg, param_dtype=...)`` stores the projections, the
embedding and the unembedding in ``param_dtype`` (default the config's
dtype, which serving uses as is) and casts each to the config's dtype at
its use; training stores f32 master weights (``param_dtype=torch.float32``),
as the reference stores every parameter in f32, so AdamW updates f32
values.  Norm scales, and the recurrent mixers' leaves that the
reference uses in f32 (``models/layers.py``), are f32 either way.  In
train mode with
``cfg.remat == "full"`` each block runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward, as the reference's ``jax.checkpoint`` of
each layer body.

The cache is a list with one dict per block, of its kind
(``models/layers.py``): ``attn`` K/V (B, KV, cache_len, D) and
``local_attn`` rings of ``min(window, cache_len)`` slots in the model's
dtype, RG-LRU and SSD states and conv tails in f32.  Only ``attn``
caches grow with ``cache_len``, as in the reference.  ``prefill``
allocates the cache and the blocks write into it in place, and
``decode_step`` updates it in place: the reference instead builds a fresh
cache, pads its ``attn`` K/V to ``cache_len`` and donates it to its jitted
decode step, which XLA then updates in place.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    MODES,
    MoE,
    RGLRU,
    SSD,
    Attention,
    cross_entropy,
    embed_lookup,
    linear,
    rms_norm,
)
from repro_torch.models.sharding_ctx import constrain_batch, constrain_weight

__all__ = ["ATTENTION_KINDS", "Block", "LM", "dtype_of", "loss_fn"]

Cache = list[dict[str, torch.Tensor]]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


ATTENTION_KINDS = ("attn", "local_attn")


class Block(nn.Module):
    """Pre-norm residual block of one ``kind``: ``x + mixer(norm1(x))``,
    then ``x + mlp(norm2(x))`` when the config has an MLP (the routed
    ``MoE`` for an MoE config).  ``forward`` returns (x, the block's cache,
    its aux loss: the MoE's f32 scalar, else None)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device=None, dtype=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.eps = cfg.norm_eps
        dtype = dtype or dtype_of(cfg)
        kw = dict(device=device, dtype=dtype)
        self.norm1 = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        if kind in ATTENTION_KINDS:
            window = cfg.window_size if kind == "local_attn" else None
            self.mixer = Attention(cfg, window=window, **kw)
        elif kind == "rglru":
            self.mixer = RGLRU(cfg, **kw)
        elif kind == "ssd":
            self.mixer = SSD(cfg, **kw)
        else:
            raise ValueError(f"unknown mixer {kind!r}")
        self.mlp = None
        if cfg.d_ff > 0:
            self.norm2 = nn.Parameter(torch.zeros(cfg.d_model, device=device))
            self.mlp = MoE(cfg, **kw) if cfg.is_moe else MLP(cfg, **kw)

    def forward(self, x, *, positions, mode, cache=None, pos=None, use_kernel=None):
        out, new_cache = self.mixer(
            rms_norm(x, self.norm1, self.eps), positions=positions, mode=mode,
            cache=cache, pos=pos, use_kernel=use_kernel,
        )
        # A sharded model's residual is pinned to its batch sharding before
        # the MLP too (the reference pins it between blocks; DTensor's own
        # choice after the attention's partial sums can split the batch
        # over 'model').
        x = constrain_batch(x + out)
        aux = None
        if self.mlp is not None:
            out = self.mlp(rms_norm(x, self.norm2, self.eps))
            if self.cfg.is_moe:
                out, aux = out
            x = x + out
        return x, new_cache, aux

    def init_cache(self, batch: int, cache_len: int) -> dict[str, torch.Tensor]:
        """This block's zero cache for ``batch`` rows and a serving length
        of ``cache_len`` (see the module docstring)."""
        cfg, mixer = self.cfg, self.mixer
        dev = self.norm1.device
        if self.kind in ATTENTION_KINDS:
            shape = (batch, cfg.num_kv_heads, mixer.cache_slots(cache_len), cfg.head_dim)
            kw = dict(device=dev, dtype=dtype_of(cfg))
            return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
        f32 = dict(device=dev, dtype=torch.float32)
        conv = mixer.conv.shape  # (K, width)
        tail = torch.zeros(batch, conv[0] - 1, conv[1], **f32)
        if self.kind == "rglru":
            return {"h": torch.zeros(batch, mixer.width, **f32), "conv": tail}
        return {"s": torch.zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state_dim, **f32), "conv": tail}


class LM(nn.Module):
    """Embedding, blocks, final norm, unembedding.  Parameters are
    allocated uninitialised on ``device`` in ``param_dtype`` (default the
    config's dtype; norms f32); ``repro_torch.models.build`` fills them
    from a generator, ``interop.lm_params_from_reference`` from the
    reference's parameter tree."""

    def __init__(self, cfg: ModelConfig, *, device=None, param_dtype=None):
        super().__init__()
        cfg.validate()
        if cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is an encoder-decoder: build models.EncDec")
        self.cfg = cfg
        dtype = param_dtype or dtype_of(cfg)
        d, vp = cfg.d_model, cfg.padded_vocab
        self.embed = nn.Parameter(torch.empty(vp, d, device=device, dtype=dtype))
        self.unembed = None
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(torch.empty(d, vp, device=device, dtype=dtype))
        self.patch_proj = None
        if cfg.num_patches:
            self.patch_proj = nn.Parameter(
                torch.empty(cfg.patch_embed_dim, d, device=device, dtype=dtype))
        self.final_norm = nn.Parameter(torch.zeros(d, device=device))
        self.blocks = nn.ModuleList(
            Block(cfg, kind, device=device, dtype=dtype)
            for pattern, count in cfg.stages()
            for _ in range(count)
            for kind in pattern
        )

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def attention_blocks(self) -> int:
        """Blocks whose mixer is attention (full or local): the flash
        kernel's launches in one prefill on the card."""
        return sum(blk.kind in ATTENTION_KINDS for blk in self.blocks)

    def forward(
        self,
        tokens: torch.Tensor,
        *,
        patch_embeds: torch.Tensor | None = None,
        mode: str = "train",
        cache: Cache | None = None,
        pos: int | None = None,
        use_kernel: bool | None = None,
    ) -> tuple[torch.Tensor, Cache | None]:
        """tokens (B, S) -> (f32 logits, cache).  decode: S == 1 at
        position ``pos``; prefill with a ``cache`` writes into it.
        ``patch_embeds`` (B, P, patch_embed_dim) go ahead of the tokens
        (VLM).  ``use_kernel`` picks the prefill's attention path
        (``kernels.ops.attention``: None = the flash kernel for CUDA
        tensors); train always takes plain attention, decode the plain
        grouped product."""
        logits, new_cache, _ = self.forward_with_aux(
            tokens, patch_embeds=patch_embeds, mode=mode, cache=cache, pos=pos,
            use_kernel=use_kernel)
        return logits, new_cache

    def forward_with_aux(
        self,
        tokens: torch.Tensor,
        *,
        patch_embeds: torch.Tensor | None = None,
        mode: str = "train",
        cache: Cache | None = None,
        pos: int | None = None,
        use_kernel: bool | None = None,
    ) -> tuple[torch.Tensor, Cache | None, torch.Tensor]:
        """``forward``, and the blocks' aux losses summed (f32 scalar)."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        cfg = self.cfg
        cdt = dtype_of(cfg)
        # Gather, then cast: the reference's take of the cast table.
        x = constrain_batch(embed_lookup(tokens, self.embed).to(cdt))  # (B, S, M)
        if patch_embeds is not None:
            if self.patch_proj is None:
                raise ValueError(f"{cfg.name} takes no patch embeddings")
            patches = constrain_batch(
                linear(patch_embeds.to(cdt), constrain_weight(self.patch_proj.to(cdt))))
            x = torch.cat([patches, x], dim=1)
        s = x.shape[1]
        if mode == "decode":
            positions = torch.full((1,), pos, device=x.device)
        else:
            positions = torch.arange(s, device=x.device)
        new_cache = [] if mode in ("prefill", "decode") else None
        remat = mode == "train" and cfg.remat == "full" and torch.is_grad_enabled()
        total_aux = None
        for i, blk in enumerate(self.blocks):
            kw = dict(positions=positions, mode=mode,
                      cache=None if cache is None else cache[i], pos=pos,
                      use_kernel=use_kernel)
            if remat:
                x, c, aux = checkpoint(blk, x, use_reentrant=False, **kw)
            else:
                x, c, aux = blk(x, **kw)
            x = constrain_batch(x)
            if aux is not None:
                total_aux = aux if total_aux is None else total_aux + aux
            if new_cache is not None:
                new_cache.append(c)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if mode == "prefill":
            x = x[:, -1:, :]  # serving needs the last position only
        w = self.embed.T if self.unembed is None else self.unembed
        # Products of the model's dtype accumulated in f32, f32 out.
        logits = linear(x.to(torch.float32), constrain_weight(w.to(cdt)).to(torch.float32))
        if cfg.padded_vocab != cfg.vocab_size:  # padded entries out of the softmax
            pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
            if isinstance(logits, DTensor):
                logits = logits.masked_fill(pad, -1e30)  # may be partial sums
            else:
                logits.masked_fill_(pad, -1e30)
        if total_aux is None:
            total_aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        return logits, new_cache, total_aux

    def init_cache(self, batch: int, cache_len: int) -> Cache:
        """Zero cache, one dict per block of its kind (``Block.init_cache``);
        for a sharded model (DTensor parameters) each tensor a DTensor
        placed by ``launch.sharding.shard_cache``."""
        cache = [blk.init_cache(batch, cache_len) for blk in self.blocks]
        mesh = getattr(self.embed, "device_mesh", None)
        if mesh is None:
            return cache
        from repro_torch.launch.sharding import shard_cache

        return shard_cache(cache, self.cfg, mesh)

    @torch.no_grad()
    def prefill(
        self,
        tokens: torch.Tensor,
        *,
        patch_embeds: torch.Tensor | None = None,
        cache_len: int | None = None,
        use_kernel: bool | None = None,
    ) -> tuple[torch.Tensor, Cache]:
        """Build the serving cache from a prompt (B, S), after its P patch
        embeddings if given: returns the last position's logits
        (B, V_pad) f32 and the cache for a serving length of
        ``max(cache_len, P + S)``: full-attention K/V in its first P + S
        slots, local rings holding the last ``window`` keys, recurrent
        states after the prompt's last token."""
        b, s = tokens.shape
        s += 0 if patch_embeds is None else patch_embeds.shape[1]
        cache = self.init_cache(b, max(cache_len or s, s))
        logits, cache = self.forward(
            tokens, patch_embeds=patch_embeds, mode="prefill", cache=cache,
            use_kernel=use_kernel,
        )
        return logits[:, -1], cache

    @torch.no_grad()
    def decode_step(
        self, tokens: torch.Tensor, cache: Cache, pos: int
    ) -> tuple[torch.Tensor, Cache]:
        """One serving step: tokens (B, 1) at position ``pos`` (the same for
        every row), the cache updated in place; logits (B, V_pad) f32."""
        logits, cache = self.forward(tokens, mode="decode", cache=cache, pos=pos)
        return logits[:, 0], cache


def loss_fn(
    model: LM, batch: dict[str, torch.Tensor], *, aux_coef: float = 0.01
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token CE of ``batch`` (tokens (B, S), labels (B, S), optional
    loss_mask, optional patch_embeds) in f32 plus ``aux_coef`` times the
    MoE layers' aux loss summed over the blocks, and ``{"ce", "aux"}``.
    The aux loss is 0 for the families without MoE layers, so their loss
    is the CE (the reference adds ``aux_coef * 0``).  With patches the
    CE is over the text positions' logits (the last S)."""
    logits, _, aux = model.forward_with_aux(
        batch["tokens"], patch_embeds=batch.get("patch_embeds"), mode="train")
    logits = logits[:, -batch["labels"].shape[1]:]  # patches are context only
    ce = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}

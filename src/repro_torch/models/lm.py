"""Decoder-only LM of the dense family (port of ``repro/models/lm.py``).

The depth follows ``cfg.stages()``: one ``Block`` per mixer of each
stage's pattern, repeated ``count`` times, in a ``ModuleList``; a Python
loop over it takes the place of the reference's ``jax.lax.scan`` over
stacked parameters.

Modes of ``LM.forward``:
  train   - causal forward over the whole sequence, (B, S, V_pad) logits;
  prefill - the same, and the per-block KV cache; only the last
            position's logits are computed (the reference's §Perf cut);
  decode  - one token per row at position ``pos`` against the cache.

Logits come out in f32 (products of the model's dtype accumulated in f32,
as the reference's ``preferred_element_type``), and the padded vocab
entries are set to -1e30.

The KV cache is a list with one ``{"k", "v"}`` per block, each
(B, KV, cache_len, D) in the model's dtype.  ``prefill`` allocates it at
``cache_len`` slots and the blocks write their K/V into it in place, and
``decode_step`` writes each new K/V into its slot in place: the
reference instead pads a fresh cache to ``cache_len`` and donates it to
its jitted decode step, which XLA then updates in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, MODES, Attention, rms_norm

__all__ = ["Block", "LM", "dtype_of"]

Cache = list[dict[str, torch.Tensor]]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _refuse_unported(cfg: ModelConfig) -> None:
    """The port's LM runs the dense family; name the ROADMAP item of the
    rest rather than run something else."""
    pending = []
    if cfg.is_moe:
        pending.append("MoE MLP: ROADMAP A11-moe")
    if cfg.num_patches:
        pending.append("VLM patch stub: ROADMAP A11-vlm")
    if cfg.is_encoder_decoder:
        pending.append("encoder-decoder: ROADMAP A11-whisper")
    mixers = {"local_attn": "A11-hybrid", "rglru": "A11-hybrid", "ssd": "A11-ssm"}
    pending += [f"{m} mixer: ROADMAP {mixers[m]}"
                for m in dict.fromkeys(cfg.block_pattern) if m in mixers]
    if pending:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet ({'; '.join(pending)})"
        )


class Block(nn.Module):
    """Pre-norm residual block: ``x + attn(norm1(x))``, then
    ``x + mlp(norm2(x))`` when the config has an MLP."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.eps = cfg.norm_eps
        dtype = dtype_of(cfg)
        self.norm1 = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        self.mixer = Attention(cfg, device=device, dtype=dtype)
        self.mlp = None
        if cfg.d_ff > 0:
            self.norm2 = nn.Parameter(torch.zeros(cfg.d_model, device=device))
            self.mlp = MLP(cfg, device=device, dtype=dtype)

    def forward(self, x, *, positions, mode, cache=None, pos=None, use_kernel=None):
        out, new_cache = self.mixer(
            rms_norm(x, self.norm1, self.eps), positions=positions, mode=mode,
            cache=cache, pos=pos, use_kernel=use_kernel,
        )
        x = x + out
        if self.mlp is not None:
            x = x + self.mlp(rms_norm(x, self.norm2, self.eps))
        return x, new_cache


class LM(nn.Module):
    """Embedding, blocks, final norm, unembedding.  Parameters are
    allocated uninitialised on ``device``; ``repro_torch.models.build``
    fills them from a generator, ``interop.lm_params_from_reference``
    from the reference's parameter tree."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        cfg.validate()
        _refuse_unported(cfg)
        self.cfg = cfg
        dtype = dtype_of(cfg)
        d, vp = cfg.d_model, cfg.padded_vocab
        self.embed = nn.Parameter(torch.empty(vp, d, device=device, dtype=dtype))
        self.unembed = None
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(torch.empty(d, vp, device=device, dtype=dtype))
        self.final_norm = nn.Parameter(torch.zeros(d, device=device))
        self.blocks = nn.ModuleList(
            Block(cfg, device=device)
            for pattern, count in cfg.stages()
            for _ in range(count)
            for _kind in pattern  # "attn" only: _refuse_unported above
        )

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(
        self,
        tokens: torch.Tensor,
        *,
        mode: str = "train",
        cache: Cache | None = None,
        pos: int | None = None,
        use_kernel: bool | None = None,
    ) -> tuple[torch.Tensor, Cache | None]:
        """tokens (B, S) -> (f32 logits, cache).  decode: S == 1 at
        position ``pos``; prefill with a ``cache`` writes into it.
        ``use_kernel`` picks the prefill's attention path
        (``kernels.ops.attention``: None = the flash kernel for CUDA
        tensors); train always takes plain attention, decode the plain
        grouped product."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        cfg = self.cfg
        x = F.embedding(tokens, self.embed)  # (B, S, M)
        s = x.shape[1]
        if mode == "decode":
            positions = torch.full((1,), pos, device=x.device)
        else:
            positions = torch.arange(s, device=x.device)
        new_cache = [] if mode in ("prefill", "decode") else None
        for i, blk in enumerate(self.blocks):
            x, c = blk(
                x, positions=positions, mode=mode,
                cache=None if cache is None else cache[i], pos=pos,
                use_kernel=use_kernel,
            )
            if new_cache is not None:
                new_cache.append(c)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if mode == "prefill":
            x = x[:, -1:, :]  # serving needs the last position only
        w = self.embed.T if self.unembed is None else self.unembed
        # Products of the model's dtype accumulated in f32, f32 out.
        logits = x.to(torch.float32) @ w.to(torch.float32)
        if cfg.padded_vocab != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = -1e30  # padded entries out of the softmax
        return logits, new_cache

    def init_cache(self, batch: int, cache_len: int) -> Cache:
        """Zero KV cache, one {"k", "v"} (B, KV, cache_len, D) per block."""
        cfg = self.cfg
        shape = (batch, cfg.num_kv_heads, cache_len, cfg.head_dim)
        kw = dict(device=self.device, dtype=dtype_of(cfg))
        return [{"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
                for _ in self.blocks]

    @torch.no_grad()
    def prefill(
        self,
        tokens: torch.Tensor,
        *,
        cache_len: int | None = None,
        use_kernel: bool | None = None,
    ) -> tuple[torch.Tensor, Cache]:
        """Build the serving cache from a prompt (B, S): returns the last
        position's logits (B, V_pad) f32 and a cache of
        ``max(cache_len, S)`` slots with the prompt's K/V in the first S."""
        b, s = tokens.shape
        cache = self.init_cache(b, max(cache_len or s, s))
        logits, cache = self.forward(
            tokens, mode="prefill", cache=cache, use_kernel=use_kernel
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

"""Model-layer primitives of the dense LM: RMS norm, RoPE, GQA attention
and the MLP (port of ``repro/models/layers.py``).

Layouts follow the reference so weights cross unchanged in meaning:
activations are (B, S, M); the attention's projections hold the
reference's (M, H, D) / (H, D, M) tensors flattened to matrices,
``wq`` (M, H*D), ``wk``/``wv`` (M, KV*D), ``wo`` (H*D, M); the KV cache
of a block is ``{"k", "v"}`` of shape (B, KV, S_cache, D) with absolute
slots.  Norm scales are kept in f32 (the reference stores f32 and uses
``1 + scale`` in f32); projections in the config's dtype (the reference
stores f32 and casts at every use, which gives the same values).

Ported so far: full (causal) attention in its train / prefill / decode
modes and the SwiGLU / GELU MLP.  ``local_attn``'s ring-buffer cache,
MoE, RG-LRU, SSD and cross-attention wait for their families (ROADMAP
A11).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig

__all__ = ["rms_norm", "apply_rope", "Attention", "MLP"]

_NEG_INF = -1e30
MODES = ("train", "prefill", "decode")


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python scalar: the reference's
    weak-typed constants are f32, and a scalar operand costs no
    host-to-device copy (a ``torch.tensor(..., device="cuda")`` would, and
    it synchronises the stream)."""
    return float(np.float32(x))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in f32 with the reference's ``1 + scale`` gain; returns
    x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float, fraction: float = 1.0
) -> torch.Tensor:
    """Rotary embedding on the leading ``fraction`` of the head dim, in the
    half-split form (x1 = first half, x2 = second half of the rotated
    part), computed in f32.

    x: (..., S, H, D) with positions (..., S) broadcastable.
    ``fraction=0.5`` is chatglm's 2d-RoPE analogue (half the dim rotary,
    half passed through).
    """
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    half = rot // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(_f32(theta), exps)
    ang = positions[..., None, None].to(torch.float32) * freq  # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:rot].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, x[..., rot:]], dim=-1) if rot < d else out


class Attention(nn.Module):
    """GQA self-attention (full, causal), ``apply_attention`` of the
    reference without the window and cross-attention branches.

    train:   causal attention over the sequence, no cache.
    prefill: the same, and the block's K/V written in place into the
             first S slots of the preallocated ``cache`` (the reference
             returns fresh K/V and pads them to the cache length later).
    decode:  S == 1 at position ``pos`` (an int): writes the new K/V into
             slot ``pos`` of the cache in place (the reference updates a
             donated cache) and attends over the slots <= pos with the
             grouped GQA product (K/V never repeated).

    Prefill goes through ``kernels.ops.attention``: the flash kernel (B8)
    for CUDA tensors, the plain ``ref.attention`` for CPU tensors or when
    ``use_kernel=False``.  Train always takes the plain ``ref.attention``:
    B8 has no backward (the reference trains through XLA too), so its
    output would carry no gradient to wq, wk and wv.  Decode always takes
    the plain product, as the reference keeps it in XLA.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = nn.Parameter(torch.empty(d, h * hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, kv * hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, kv * hd, **kw))
        self.wo = nn.Parameter(torch.empty(h * hd, d, **kw))

    def forward(
        self,
        x: torch.Tensor,
        *,
        positions: torch.Tensor,
        mode: str = "train",
        cache: dict[str, torch.Tensor] | None = None,
        pos: int | None = None,
        use_kernel: bool | None = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
        cfg = self.cfg
        b, s, _ = x.shape
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = (x @ self.wq).view(b, s, h, hd)
        k = (x @ self.wk).view(b, s, kv, hd)
        v = (x @ self.wv).view(b, s, kv, hd)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
        qt = q.transpose(1, 2).contiguous()  # (B, H, S, D)
        kt = k.transpose(1, 2).contiguous()
        vt = v.transpose(1, 2).contiguous()

        if mode != "train" and cache is None:
            raise ValueError(f"{mode} writes into a preallocated KV cache")
        if mode == "decode":
            if s != 1 or pos is None:
                raise ValueError("decode takes one token and its position")
            ck, cv = cache["k"], cache["v"]
            ck[:, :, pos] = kt[:, :, 0].to(ck.dtype)
            cv[:, :, pos] = vt[:, :, 0].to(cv.dtype)
            valid = torch.arange(ck.shape[2], device=x.device) <= pos
            qg = qt.reshape(b, kv, h // kv, 1, hd)
            # Operands in their dtype, products accumulated in f32 (the
            # reference's preferred_element_type): upcast, then multiply.
            logits = torch.einsum(
                "bkgsd,bktd->bkgst", qg.to(torch.float32), ck.to(torch.float32)
            ) * _f32(1.0 / hd**0.5)
            logits = torch.where(valid, logits, _NEG_INF)
            probs = torch.softmax(logits, dim=-1)
            if cfg.attn_probs_bf16:
                probs = probs.to(cv.dtype)
            out = torch.einsum(
                "bkgst,bktd->bkgsd", probs.to(torch.float32), cv.to(torch.float32)
            ).reshape(b, h, 1, hd).to(x.dtype)
            new_cache = cache
        elif mode in ("train", "prefill"):
            if mode == "train":
                if use_kernel:
                    raise ValueError("train takes plain attention: B8 has no backward")
                use_kernel = False
            out = kops.attention(
                qt, kt, vt, causal=True, window=None, use_kernel=use_kernel,
                probs_bf16=cfg.attn_probs_bf16,
            )
            new_cache = None
            if mode == "prefill":
                cache["k"][:, :, :s] = kt
                cache["v"][:, :, :s] = vt
                new_cache = cache
        else:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")

        y = out.transpose(1, 2).reshape(b, s, h * hd)
        return y @ self.wo, new_cache


class MLP(nn.Module):
    """SwiGLU MLP (``silu(x wg) * (x wi)``, then ``wo``), or the plain
    tanh-approximate GELU MLP when ``cfg.gated_mlp`` is off (whisper)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.gated = cfg.gated_mlp
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        self.wi = nn.Parameter(torch.empty(d, f, **kw))
        self.wo = nn.Parameter(torch.empty(f, d, **kw))
        if self.gated:
            self.wg = nn.Parameter(torch.empty(d, f, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.wi
        if self.gated:
            h = F.silu(x @ self.wg) * h
        else:
            h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
        return h @ self.wo

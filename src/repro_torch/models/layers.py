"""Model-layer primitives of the port's models: RMS norm, RoPE, GQA
self-attention (causal full and local, or bidirectional), cross-attention,
the MLP, the routed MoE MLP, the causal conv, the RG-LRU and Mamba2 SSD
mixers (port of ``repro/models/layers.py``).

Layouts follow the reference so weights cross unchanged in meaning:
activations are (B, S, M); the attention's projections hold the
reference's (M, H, D) / (H, D, M) tensors flattened to matrices,
``wq`` (M, H*D), ``wk``/``wv`` (M, KV*D), ``wo`` (H*D, M).  Caches, one
per block, of its mixer's kind:

  attn:       {"k", "v"} (B, KV, S_cache, D), absolute slots;
  local_attn: {"k", "v"} (B, KV, min(window, S_cache), D), a ring: the
              key of position p sits in slot p % window (RoPE applied at
              write time with the absolute position);
  rglru:      {"h"} (B, W) f32 state, {"conv"} (B, K-1, W) f32 conv tail;
  ssd:        {"s"} (B, H, P, N) f32 state, {"conv"} (B, K-1, d_inner) f32.

Prefill and decode update the cache they are given in place.

Norm scales are kept in f32 (the reference stores f32 and uses
``1 + scale`` in f32), and so are the leaves the reference uses in f32
whatever the activations' dtype: the MoE router, RG-LRU's ``wa``, ``wi``
and ``lam``, and SSD's ``wb``, ``wc``, ``wdt``, ``a_log``, ``dt_bias`` and
``dskip``.  The
other projections are stored in the dtype the caller gives (``dtype``:
the config's dtype to serve, f32 master weights to train) and cast to the
activations' dtype at every use, as the reference casts its f32
parameters; a cast to the dtype a weight already has is a no-op, so
serving's bf16 weights are used as they are.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig

__all__ = ["rms_norm", "apply_rope", "Attention", "CrossAttention", "MLP", "MoE", "Routing", "moe_capacity",
           "causal_conv", "RGLRU", "SSD", "doubling_scan", "silu_ref", "gelu_tanh_ref",
           "cross_entropy"]

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
    """GQA self-attention, full (causal) or local (causal within the last
    ``window`` positions), or bidirectional with ``causal=False`` (the
    enc-dec encoder): ``apply_attention`` of the reference.

    train:   causal (windowed) attention over the sequence, no cache.
    prefill: the same, and the block's K/V written in place into the
             preallocated ``cache``: the first S slots of a full cache;
             for a local one, the last ``min(window, S)`` keys into ring
             slots ``pos % window`` (the reference builds a fresh ring).
    decode:  S == 1 at position ``pos`` (an int): writes the new K/V into
             slot ``pos`` (``pos % window``) of the cache in place (the
             reference updates a donated cache) and attends over the
             valid slots with the grouped GQA product (K/V never
             repeated).  A ring slot j holds position
             ``p_j = pos - ((pos - j) mod window)`` and is valid when
             ``p_j >= 0`` and ``p_j > pos - window``; the modulus takes the
             divisor's sign (``torch.remainder``, as ``jnp``'s ``%``).

    Prefill goes through ``kernels.ops.attention``: the flash kernel (B8)
    for CUDA tensors, the plain ``ref.attention`` for CPU tensors or when
    ``use_kernel=False``.  Train takes the plain ``ref.attention`` unless
    the caller passes ``use_kernel=True`` with no gradient taken (the
    encoder while serving, ``EncDec.encode``): B8 has no backward, so its
    output would carry no gradient to wq, wk and wv.  Decode always takes
    the plain product, as the reference keeps it in XLA.
    """

    def __init__(self, cfg: ModelConfig, *, window: int | None = None,
                 causal: bool = True, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.window = window
        self.causal = causal
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = nn.Parameter(torch.empty(d, h * hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, kv * hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, kv * hd, **kw))
        self.wo = nn.Parameter(torch.empty(h * hd, d, **kw))

    def cache_slots(self, cache_len: int) -> int:
        """Slots of this block's cache for a serving length of
        ``cache_len``: all of them, or a ring of at most ``window``."""
        return cache_len if self.window is None else min(self.window, cache_len)

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
        cfg, window = self.cfg, self.window
        b, s, _ = x.shape
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        cdt = x.dtype
        q = (x @ self.wq.to(cdt)).view(b, s, h, hd)
        k = (x @ self.wk.to(cdt)).view(b, s, kv, hd)
        v = (x @ self.wv.to(cdt)).view(b, s, kv, hd)
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
            slot = pos if window is None else pos % window
            ck[:, :, slot] = kt[:, :, 0].to(ck.dtype)
            cv[:, :, slot] = vt[:, :, 0].to(cv.dtype)
            idx = torch.arange(ck.shape[2], device=x.device)
            if window is None:
                valid = idx <= pos
            else:
                p_j = pos - torch.remainder(pos - idx, window)
                valid = (p_j >= 0) & (p_j > pos - window)
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
                if use_kernel and torch.is_grad_enabled():
                    raise ValueError("train takes plain attention: B8 has no backward")
                use_kernel = bool(use_kernel)
            out = kops.attention(
                qt, kt, vt, causal=self.causal, window=window, use_kernel=use_kernel,
                probs_bf16=cfg.attn_probs_bf16,
            )
            new_cache = None
            if mode == "prefill":
                if window is None:
                    cache["k"][:, :, :s] = kt
                    cache["v"][:, :, :s] = vt
                else:
                    w = min(window, s)
                    slots = torch.remainder(positions[-w:], window)
                    cache["k"][:, :, slots] = kt[:, :, -w:].to(cache["k"].dtype)
                    cache["v"][:, :, slots] = vt[:, :, -w:].to(cache["v"].dtype)
                new_cache = cache
        else:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")

        y = out.transpose(1, 2).reshape(b, s, h * hd)
        return y @ self.wo.to(cdt), new_cache


class CrossAttention(Attention):
    """Cross-attention of the enc-dec decoder (``apply_cross_attention``):
    queries from x (B, S, M), keys and values projected from the
    encoder's output (B, T_enc, M), no RoPE, every query seeing every
    key.  Without a cache it projects ``enc_out`` and returns the
    (B, KV, T_enc, D) K/V as the cache (prefill builds it once); with one
    it reuses it (decode).  Plain attention with f32 probabilities, as
    the reference's ``use_kernel=False`` call.  ``Attention``'s leaves
    (``init_cross_attention`` is ``init_attention``)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__(cfg, causal=False, device=device, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        *,
        enc_out: torch.Tensor | None = None,
        cache: dict[str, torch.Tensor] | None = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        cfg = self.cfg
        b, s, _ = x.shape
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        cdt = x.dtype
        q = (x @ self.wq.to(cdt)).view(b, s, h, hd).transpose(1, 2)
        if cache is None:
            t = enc_out.shape[1]
            k = (enc_out @ self.wk.to(cdt)).view(b, t, kv, hd).transpose(1, 2)
            v = (enc_out @ self.wv.to(cdt)).view(b, t, kv, hd).transpose(1, 2)
            cache = {"k": k.contiguous(), "v": v.contiguous()}
        out = kops.attention(q, cache["k"], cache["v"], causal=False, use_kernel=False)
        y = out.transpose(1, 2).reshape(b, s, h * hd)
        return y @ self.wo.to(cdt), cache


class MLP(nn.Module):
    """SwiGLU MLP (``silu(x wg) * (x wi)``, then ``wo``), or the plain
    tanh-approximate GELU MLP when ``cfg.gated_mlp`` is off (whisper):
    ``F.gelu`` rounds once where the reference's ``jax.nn.gelu`` rounds
    every op, within one bf16 step of the input, which whisper's bf16
    parity bars absorb (``tests/test_torch_encdec.py``)."""

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
        cdt = x.dtype
        h = x @ self.wi.to(cdt)
        if self.gated:
            h = F.silu(x @ self.wg.to(cdt)) * h
        else:
            h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
        return h @ self.wo.to(cdt)


def moe_capacity(cfg: ModelConfig, seq: int) -> int:
    """Slots an expert has in each row of ``seq`` tokens (the einsum
    form's capacity): ``cf * seq * k / e`` rounded down, then up to a
    multiple of 4, at least 4."""
    c = int(cfg.capacity_factor * seq * cfg.num_experts_per_token / cfg.num_experts)
    return max(4, (c + 3) // 4 * 4)


class Routing(NamedTuple):
    """One MoE layer's routing of x (B, S, M): each token's K experts in
    top-k order and their renormalised gates (B, S, K), whether each pair
    got a slot (``keep``) and which (``slots``: expert-major into the
    (E, groups * cap) buffer; meaningless where not kept), the capacity,
    the number of token groups sharing one capacity, and the Switch aux
    loss (f32 scalar)."""

    gates: torch.Tensor
    experts: torch.Tensor
    keep: torch.Tensor
    slots: torch.Tensor
    cap: int
    groups: int
    aux: torch.Tensor


def _queue_places(flat: torch.Tensor, e: int) -> torch.Tensor:
    """flat (G, P) expert ids, pairs in queue order -> (G, P) int64: each
    pair's place in its expert's queue of its group, the number of pairs
    before it routed to the same expert.  A stable sort by expert keeps
    the queue order within an expert, so a pair's place is its index in
    the sorted ids minus where its expert's run starts."""
    order = torch.argsort(flat, dim=-1, stable=True)
    run = flat.gather(-1, order)
    experts = torch.arange(e, device=flat.device).repeat(flat.shape[0], 1)
    starts = torch.searchsorted(run, experts)
    rank = torch.arange(flat.shape[1], device=flat.device) - starts.gather(-1, run)
    return torch.empty_like(rank).scatter_(-1, order, rank)


class MoE(nn.Module):
    """Routed SwiGLU experts with capacity (``init_moe`` / ``apply_moe``):
    the same experts, places, drops, combine weights and rounding points
    as the reference's two dispatch forms, computed with gathers and
    batched products instead of one-hot contractions.

    Routing: router logits in f32 (x and the router widened), softmax,
    the top k (ties to the lower expert id, as ``jax.lax.top_k``), gates
    renormalised by ``max(sum, 1e-9)``; aux ``e * sum_e f_e p_e`` with f_e
    the share of tokens whose top-1 is e.  A (token, k) pair's place in
    its expert's queue counts the pairs before it in token-major, then k
    order; a pair at place >= cap is dropped (contributes zero; the
    residual carries the token).

    ``cfg.moe_impl == "sort"`` takes the sort form: one capacity
    ``max(4, int(cf B S k / e + 3) // 4 * 4)`` over the whole B*S token
    group, and the combine adds each kept pair's ``out * gate`` (rounded
    to the compute dtype) into its token in the compute dtype, pairs in
    expert order (the reference's scatter-add of pairs sorted by expert).
    Any other name takes the einsum form: a capacity per row
    (``moe_capacity(cfg, S)``), and the combine rounds the gates to the
    compute dtype, sums each token's K products in f32 and rounds once
    (the reference's one bf16 dot with f32 accumulation; the order of
    that f32 sum differs).

    Both forms gather x into one (E, groups * cap, M) buffer (an empty
    slot holds zeros), run ``h = silu(x wg) * (x wi)`` then ``h wo`` as
    three batched products in the compute dtype, and gather each kept
    pair's output back.  The silu is ``silu_ref``, rounded op by op as
    the reference's: with it a bf16 layer gives the reference's bits on
    the CPU (``F.silu`` moves ~half of the outputs by up to a bf16 step).
    Leaves (the reference's layouts): ``router`` (d, e) in f32, ``wi`` /
    ``wg`` (e, d, f) and ``wo`` (e, f, d) in the parameter dtype.

    Gradients (``jax.grad`` of the reference's forms): a dropped pair
    sends none to x or the experts (it holds no slot, and its combine
    weight is a zero that blocks its gate's); the router's comes through
    the renormalised gates of the top k and the aux loss's mean
    probabilities (f_e is one-hot, constant); the sort's backward is a
    gather, so the gradients land on the experts the stable sort chose.
    x's gradient sums its kept pairs' rows and the router's in f32 and
    rounds once (the dispatch gathers from the router's f32 copy of x);
    with ``silu_ref``'s backward that holds a bf16 layer's gradients no
    further from the reference's f32 ones than the reference's own bf16
    gradients lie.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        kw = dict(device=device, dtype=dtype)
        self.router = nn.Parameter(torch.empty(d, e, device=device, dtype=torch.float32))
        self.wi = nn.Parameter(torch.empty(e, d, f, **kw))
        self.wg = nn.Parameter(torch.empty(e, d, f, **kw))
        self.wo = nn.Parameter(torch.empty(e, f, d, **kw))

    def routing(self, x: torch.Tensor) -> Routing:
        """Experts, gates, slots and drops of x (B, S, M); see the class
        docstring."""
        cfg = self.cfg
        b, s, _ = x.shape
        e, k = cfg.num_experts, cfg.num_experts_per_token
        probs = torch.softmax(x.to(torch.float32) @ self.router.to(torch.float32), dim=-1)
        top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, experts = top[..., :k], idx[..., :k]
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=_f32(1e-9))
        f_e = F.one_hot(experts[..., 0], e).to(torch.float32).mean(dim=(0, 1))
        aux = e * (f_e * probs.mean(dim=(0, 1))).sum()
        if cfg.moe_impl == "sort":
            groups = 1
            cap = max(4, int(cfg.capacity_factor * b * s * k / e + 3) // 4 * 4)
        else:
            groups, cap = b, moe_capacity(cfg, s)
        places = _queue_places(experts.reshape(groups, -1), e).view(b, s, k)
        group = 0 if groups == 1 else torch.arange(b, device=x.device)[:, None, None]
        slots = experts * (groups * cap) + group * cap + places
        return Routing(gates, experts, places < cap, slots, cap, groups, aux)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, M) -> (out (B, S, M) in x's dtype, aux f32 scalar)."""
        cfg, cdt = self.cfg, x.dtype
        b, s, m = x.shape
        e, k = cfg.num_experts, cfg.num_experts_per_token
        # Under a gradient the dispatch gathers from the router's f32 copy
        # of x and casts back (the same values), so x's gradient sums the
        # kept pairs' rows and the router's in f32 and rounds once, as the
        # reference's dot with f32 accumulation does; a dropped pair sends
        # none.  Serving gathers x itself (half the bytes in bf16).
        rows = x.to(torch.float32) if torch.is_grad_enabled() else x
        rt = self.routing(rows)
        n_slots = e * rt.groups * rt.cap
        # Dispatch: the token each slot holds; empty slots read a zero row.
        tok = torch.arange(b * s, device=x.device).view(b, s, 1).expand(b, s, k)
        src = torch.full((n_slots + 1,), b * s, dtype=torch.long, device=x.device)
        src.scatter_(0, torch.where(rt.keep, rt.slots, n_slots).reshape(-1),
                     tok.reshape(-1))  # dropped pairs all land in the last slot
        xs = torch.cat([rows.reshape(b * s, m), rows.new_zeros(1, m)])
        buf = xs[src[:n_slots]].to(cdt).view(e, rt.groups * rt.cap, m)
        h = torch.bmm(buf, self.wi.to(cdt))
        h = silu_ref(torch.bmm(buf, self.wg.to(cdt))) * h
        out = torch.bmm(h, self.wo.to(cdt)).view(n_slots, m)
        # Combine: each token's pairs in expert order, a dropped pair's
        # weight zero.
        order = torch.argsort(rt.experts, dim=-1)
        slots = torch.clamp(rt.slots.gather(-1, order), max=n_slots - 1).view(b * s, k)
        w = torch.where(rt.keep, rt.gates, 0.0).gather(-1, order).view(b * s, k).to(cdt)
        if cfg.moe_impl == "sort":
            y = out[slots[:, 0]] * w[:, :1]
            for j in range(1, k):
                y = y + out[slots[:, j]] * w[:, j:j + 1]
        else:
            wf = w.to(torch.float32)
            y = out[slots[:, 0]].to(torch.float32) * wf[:, :1]
            for j in range(1, k):
                y.addcmul_(out[slots[:, j]].to(torch.float32), wf[:, j:j + 1])
        return y.to(cdt).view(b, s, m), rt.aux


class _SiluRef(torch.autograd.Function):
    """``silu_ref``: forward and backward rounded where the reference's are."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        # jax.nn.silu = x * logistic(x): the product's two cotangents, the
        # logistic's through ans * (1 - ans), added last.
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1.0 - s))


def silu_ref(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))`` one op at a time in x's dtype: the
    reference's ``jax.nn.silu``, which rounds each step to bf16 in a bf16
    model (``F.silu`` rounds once, and differs in ~40 % of bf16 values).
    Its gradient, ``g s + (g x)(s (1 - s))`` with s the logistic, rounds
    each op as ``jax.grad`` of ``jax.nn.silu`` does (a bf16 MoE's ``wg``
    gradient is the reference's, bit for bit on the CPU); autograd through
    the forward's ops would round elsewhere.  It keeps x and s for the
    backward."""
    return _SiluRef.apply(x)


def gelu_tanh_ref(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU one op at a time in x's dtype, constants
    rounded to it: the reference's ``jax.nn.gelu`` (its default form)."""
    def c(v: float) -> float:  # the constant rounded to x's dtype
        return float(torch.tensor(v, dtype=x.dtype))

    inner = c(np.sqrt(2.0 / np.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (1.0 + torch.tanh(inner)))


def causal_conv(
    x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time (the reference's ``_causal_conv``).

    x: (B, S, W); w: (K, W); ``tail`` (B, K-1, W) the last K-1 inputs
    before x (zeros when None), cast to x's dtype.  The K products are
    summed in x's dtype in the reference's order, term 0 first.  Returns
    (y (B, S, W) in x's dtype, the new tail: the last K-1 inputs, f32).
    """
    kw, s = w.shape[0], x.shape[1]
    if tail is None:
        pad = x.new_zeros(x.shape[0], kw - 1, x.shape[2])
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, W)
    wc = w.to(x.dtype)
    y = xp[:, :s] * wc[0]
    for i in range(1, kw):
        y = y + xp[:, i:i + s] * wc[i]
    return y, xp[:, -(kw - 1):].to(torch.float32)


def doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All states of ``h_t = a_t h_{t-1} + b_t`` (h_{-1} = 0) along dim 1,
    by the doubling (Hillis-Steele) scan: ceil(log2 S) elementwise passes,
    each combining every step with the one ``d`` before it,
    (A, B)_t <- (A_{t-d} A_t, A_t B_{t-d} + B_t), d = 1, 2, 4, ...

    The same recurrence as the reference's ``associative_scan``, summed
    in another order: the two agree to f32 rounding, not bit for bit.
    Not the log-space cumsum form: over thousands of steps the summed
    log a reaches -1e3 and ``exp(-L)`` overflows."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1)
        if 2 * d < s:  # the last pass needs no A
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


class RGLRU(nn.Module):
    """RG-LRU mixer of RecurrentGemma (``init_rglru`` / ``apply_rglru``):
    the gated linear recurrence

        h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t),
        a_t = a^(c r_t),  a = sigmoid(lam),  c = 8,

    with u the causal conv of ``x wx``, r = sigmoid(u wa) and
    i = sigmoid(u wi) in f32, and the output ``(h * gelu(x wgate)) wo``.
    Train and prefill run the whole sequence through ``doubling_scan``
    in f32, the cache's state folded into the first step
    (``b_0 += a_0 h0``); decode takes one step.  Prefill and decode start
    from the cache's ``h`` and conv tail and write the new ones into it
    in place.

    Leaves: ``wx``, ``wgate`` (d, w), ``conv`` (K, w), ``wo`` (w, d) in the
    parameter dtype; ``wa``, ``wi`` (w, w) and ``lam`` (w,) in f32.
    """

    C = 8.0

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width or cfg.d_model
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.width = w
        self.wx = nn.Parameter(torch.empty(d, w, **kw))
        self.wgate = nn.Parameter(torch.empty(d, w, **kw))
        self.conv = nn.Parameter(torch.empty(cfg.conv_width, w, **kw))
        self.wa = nn.Parameter(torch.empty(w, w, **f32))
        self.wi = nn.Parameter(torch.empty(w, w, **f32))
        self.wo = nn.Parameter(torch.empty(w, d, **kw))
        self.lam = nn.Parameter(torch.empty(w, **f32))

    def forward(self, x, *, mode="train", cache=None, **_):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode != "train" and cache is None:
            raise ValueError(f"{mode} writes into a preallocated state cache")
        cdt = x.dtype
        u = x @ self.wx.to(cdt)
        gate = x @ self.wgate.to(cdt)
        u, new_tail = causal_conv(u, self.conv, None if cache is None else cache["conv"])
        uf = u.to(torch.float32)
        r = torch.sigmoid(uf @ self.wa)
        i = torch.sigmoid(uf @ self.wi)
        log_a = -self.C * F.softplus(-self.lam)  # log sigmoid(lam), f32
        a = torch.exp(log_a * r)  # (B, S, W) in (0, 1)
        b_in = torch.sqrt(torch.clamp(1.0 - a * a, min=_f32(1e-9))) * (i * uf)
        h0 = None if cache is None else cache["h"]
        if mode == "decode":
            hs = (a[:, 0] * h0 + b_in[:, 0])[:, None]
        else:
            if h0 is not None:  # prefill's cache: no autograd there (LM.prefill)
                b_in[:, 0] += a[:, 0] * h0
            hs = doubling_scan(a, b_in)
        y = hs.to(cdt) * gelu_tanh_ref(gate)
        out = y @ self.wo.to(cdt)
        if cache is not None:
            cache["h"].copy_(hs[:, -1])
            cache["conv"].copy_(new_tail)
        return out, cache


class SSD(nn.Module):
    """Mamba2 SSD mixer (``init_ssd`` / ``_ssd_scan_chunked`` /
    ``apply_ssd``), one group (B and C shared by the heads).

    x wx goes through the causal conv and silu; B = x wb, C = x wc and
    dt = softplus(x wdt + dt_bias) come from x in f32, the decay
    a = exp(-dt exp(a_log)) and the input u = dt * x per head.  Train and
    prefill run the chunked dual form: S is padded to a multiple of the
    chunk (a = 1, u = B = C = 0 on the pad); within a chunk a masked
    lower-triangular product (the exponent masked to -1e30 before
    ``exp``, as the reference does), across chunks a Python loop carrying
    the (B, H, P, N) state from the cache's ``s``.  Decode takes one state
    step.  Then the ``dskip`` term, the gate silu(x wz) and ``wo``.
    Prefill and decode write the new state and conv tail into the cache
    in place.

    Leaves: ``wx``, ``wz`` (d, di), ``conv`` (K, di), ``wo`` (di, d) in the
    parameter dtype; ``wb``, ``wc`` (d, N), ``wdt`` (d, H), ``a_log``,
    ``dt_bias``, ``dskip`` (H,) in f32.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d, di, nh, ns = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state_dim
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.wx = nn.Parameter(torch.empty(d, di, **kw))
        self.wz = nn.Parameter(torch.empty(d, di, **kw))
        self.wb = nn.Parameter(torch.empty(d, ns, **f32))
        self.wc = nn.Parameter(torch.empty(d, ns, **f32))
        self.wdt = nn.Parameter(torch.empty(d, nh, **f32))
        self.conv = nn.Parameter(torch.empty(cfg.conv_width, di, **kw))
        self.wo = nn.Parameter(torch.empty(di, d, **kw))
        self.a_log = nn.Parameter(torch.empty(nh, **f32))
        self.dt_bias = nn.Parameter(torch.empty(nh, **f32))
        self.dskip = nn.Parameter(torch.empty(nh, **f32))

    def forward(self, x, *, mode="train", cache=None, **_):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode != "train" and cache is None:
            raise ValueError(f"{mode} writes into a preallocated state cache")
        cfg = self.cfg
        cdt = x.dtype
        b, s, _ = x.shape
        nh, hp = cfg.ssm_heads, cfg.ssm_head_dim
        xin = x @ self.wx.to(cdt)
        z = x @ self.wz.to(cdt)
        xin, new_tail = causal_conv(xin, self.conv, None if cache is None else cache["conv"])
        xin = silu_ref(xin)
        xf = x.to(torch.float32)
        bmat = xf @ self.wb
        cmat = xf @ self.wc
        dt = F.softplus(xf @ self.wdt + self.dt_bias)  # (B, S, H)
        a = torch.exp(-dt * torch.exp(self.a_log))  # (B, S, H) in (0, 1)
        xh = xin.to(torch.float32).view(b, s, nh, hp)
        u = dt[..., None] * xh  # (B, S, H, P)
        s0 = None if cache is None else cache["s"]
        if mode == "decode":
            s_last = a[:, 0, :, None, None] * s0 + torch.einsum(
                "bhp,bn->bhpn", u[:, 0], bmat[:, 0])
            y = torch.einsum("bn,bhpn->bhp", cmat[:, 0], s_last)[:, None]
        else:
            q = min(cfg.ssm_chunk, s)
            pad = (-s) % q
            if pad:
                a = F.pad(a, (0, 0, 0, pad), value=1.0)
                u = F.pad(u, (0, 0, 0, 0, 0, pad))
                bmat = F.pad(bmat, (0, 0, 0, pad))
                cmat = F.pad(cmat, (0, 0, 0, pad))
            y, s_last = _ssd_scan_chunked(a, u, bmat, cmat, s0, q)
            y = y[:, :s]
        y = y + self.dskip[:, None] * xh
        y = y.reshape(b, s, nh * hp).to(cdt) * silu_ref(z)
        out = y @ self.wo.to(cdt)
        if cache is not None:
            cache["s"].copy_(s_last)
            cache["conv"].copy_(new_tail)
        return out, cache


def _ssd_scan_chunked(a, u, bmat, cmat, s0, chunk):
    """Chunked SSD forward (the reference's ``_ssd_scan_chunked``).

    a: (B, S, H) per-step decay in (0, 1]; u: (B, S, H, P) inputs (dt x);
    bmat / cmat: (B, S, N); s0: (B, H, P, N) or None; S a multiple of
    ``chunk``.  Returns (y (B, S, H, P), the last state (B, H, P, N)), f32.
    """
    b, s, h = a.shape
    p, n, q = u.shape[-1], bmat.shape[-1], chunk
    nc = s // q
    ar = a.reshape(b, nc, q, h)
    ur = u.reshape(b, nc, q, h, p)
    br = bmat.reshape(b, nc, q, n)
    cr = cmat.reshape(b, nc, q, n)

    cum = torch.cumsum(torch.log(torch.clamp(ar, min=_f32(1e-20))), dim=2)  # (B,NC,Q,H)
    total = cum[:, :, -1]  # (B, NC, H)

    # Intra-chunk: y[t] = sum_{tau <= t} (C_t . B_tau) exp(cum_t - cum_tau) u_tau.
    scores = torch.einsum("bcqn,bckn->bcqk", cr, br)  # (B, NC, Q, Q)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=a.device))[:, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, NC, Q, K, H)
    decay = torch.exp(torch.where(tri, diff, _NEG_INF))  # masked before exp
    w = torch.where(tri, scores[..., None] * decay, 0.0)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", w, ur)

    # Chunk-local final states: sum_tau exp(total - cum_tau) B_tau u_tau^T.
    state_w = torch.exp(total[:, :, None, :] - cum)  # (B, NC, Q, H)
    s_local = torch.einsum("bcqhp,bcqn->bchpn", state_w[..., None] * ur, br)

    # The state entering each chunk, carried across the chunks.
    carry = s_local.new_zeros(b, h, p, n) if s0 is None else s0
    decays = torch.exp(total)
    s_in = []
    for c in range(nc):
        s_in.append(carry)
        carry = decays[:, c, :, None, None] * carry + s_local[:, c]
    s_in = torch.stack(s_in, dim=1)  # (B, NC, H, P, N)

    # Inter-chunk: y[t] += exp(cum_t) C_t . S_in.
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cr, s_in) * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(b, s, h, p), carry


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean token CE in f32. logits: (B, S, V); labels: (B, S) integers."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

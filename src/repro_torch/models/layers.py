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

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding_ctx import constrain_batch_heads, constrain_weight

__all__ = ["rms_norm", "linear", "embed_lookup", "cache_write", "apply_rope", "Attention", "CrossAttention", "MLP", "MoE", "Routing", "moe_capacity",
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


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K) and a (K, N) weight.  DTensor operands (a
    sharded model) are folded to one (rows, K) x (K, N) product, as torch
    folds plain tensors: DTensor's own decomposition would run a batched
    product over a broadcast weight, a different cuBLAS kernel that rounds
    otherwise."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or x.dim() < 3:
        return x @ w
    lead = x.shape[:-1]
    return (x.reshape(-1, x.shape[-1]) @ w).view(*lead, w.shape[-1])


def cache_write(dst: torch.Tensor, at: tuple, src: torch.Tensor) -> None:
    """``dst[at] = src`` in place.  A DTensor cache (a sharded model) is
    written on each rank's block: ``src`` is pinned to the cache's own
    placements (the reference's constraint on the updated cache, the batch
    over the data axes and the KV heads where ``shard_cache`` put them),
    then each rank writes its local rows (``at`` indexes no sharded
    dim)."""
    from torch.distributed.tensor import DTensor

    if isinstance(dst, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements).to_local()
        dst = dst.to_local()
    dst[at] = src


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``.  A DTensor table (a sharded model)
    is looked up on each rank's block (``local_map``): its FSDP shards of
    the embed dim gathered, each rank's vocab rows answering the tokens
    that fall in them and zeros elsewhere, summed over 'model' (a
    ``Partial`` result), the batch kept where ``tokens`` has it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    names = list(mesh.mesh_dim_names)
    vocab = names.index("model") if "model" in names else None
    split = vocab is not None and table.placements[vocab] == Shard(0)
    tok_place = list(tokens.placements)
    if vocab is not None:
        tok_place[vocab] = Replicate()
    tab_place = [Replicate() for _ in names]
    out_place = [Shard(0) if p == Shard(0) else Replicate() for p in tok_place]
    if split:
        tab_place[vocab] = Shard(0)
        out_place[vocab] = Partial()
    rows = table.shape[0] // (mesh.size(vocab) if split else 1)

    def local(tok, tab):
        if not split:
            return F.embedding(tok, tab)
        lo = mesh.get_local_rank("model") * rows
        inside = (tok >= lo) & (tok < lo + rows)
        out = F.embedding(torch.where(inside, tok - lo, 0), tab)
        return out * inside[..., None].to(out.dtype)

    # Each data rank looks up its own rows: the table's gradient is a
    # partial sum over the data axes.
    tab_grad = [Partial() if p == Shard(0) and i != vocab else q
                for i, (p, q) in enumerate(zip(tok_place, tab_place))]
    return local_map(local, out_placements=out_place, in_placements=(tok_place, tab_place),
                     in_grad_placements=(tok_place, tab_grad), device_mesh=mesh,
                     redistribute_inputs=True)(tokens, table)


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
        q = _split_heads(linear(x, constrain_weight(self.wq.to(cdt))), h)
        k = _split_heads(linear(x, constrain_weight(self.wk.to(cdt))), kv)
        v = _split_heads(linear(x, constrain_weight(self.wv.to(cdt))), kv)
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
            cache_write(ck, (slice(None), slice(None), slot), kt[:, :, 0].to(ck.dtype))
            cache_write(cv, (slice(None), slice(None), slot), vt[:, :, 0].to(cv.dtype))
            out = _decode_attention(qt, ck, cv, pos, window, cfg.attn_probs_bf16)
            new_cache = cache
        elif mode in ("train", "prefill"):
            if mode == "train":
                if use_kernel and torch.is_grad_enabled():
                    raise ValueError("train takes plain attention: B8 has no backward")
                use_kernel = bool(use_kernel)
            qt, kt, vt = (constrain_batch_heads(t) for t in (qt, kt, vt))
            out = constrain_batch_heads(kops.attention(
                qt, kt, vt, causal=self.causal, window=window, use_kernel=use_kernel,
                probs_bf16=cfg.attn_probs_bf16,
            ))
            new_cache = None
            if mode == "prefill":
                if window is None:
                    cache_write(cache["k"], (slice(None), slice(None), slice(None, s)), kt)
                    cache_write(cache["v"], (slice(None), slice(None), slice(None, s)), vt)
                else:
                    w = min(window, s)
                    slots = torch.remainder(positions[-w:], window)
                    at = (slice(None), slice(None), slots)
                    cache_write(cache["k"], at, kt[:, :, -w:].to(cache["k"].dtype))
                    cache_write(cache["v"], at, vt[:, :, -w:].to(cache["v"].dtype))
                new_cache = cache
        else:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")

        y = out.transpose(1, 2).reshape(b, s, h * hd)
        return linear(y, constrain_weight(self.wo.to(cdt))), new_cache


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, heads * D) -> (B, S, heads, D).  A DTensor (a sharded model)
    whose last dim a mesh axis splits into pieces that are not whole heads
    is first replicated over that axis (the reference keeps such heads
    replicated)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(t, DTensor):
        place = [Replicate() if p == Shard(2) and heads % t.device_mesh.size(i) else p
                 for i, p in enumerate(t.placements)]
        if place != list(t.placements):
            t = t.redistribute(t.device_mesh, place)
    b, s, _ = t.shape
    return t.view(b, s, heads, -1)


def _decode_attend(qt, ck, cv, *, pos: int, window, probs_bf16: bool):
    """One query a row against the cache: the valid slots, the grouped GQA
    product (K/V never repeated), products of the operands' dtype
    accumulated in f32 (the reference's preferred_element_type)."""
    b, h, _, hd = qt.shape
    kv = ck.shape[1]
    idx = torch.arange(ck.shape[2], device=qt.device)
    if window is None:
        valid = idx <= pos
    else:
        p_j = pos - torch.remainder(pos - idx, window)
        valid = (p_j >= 0) & (p_j > pos - window)
    qg = qt.reshape(b, kv, h // kv, 1, hd)
    # Operands in their dtype, products accumulated in f32: upcast, then
    # multiply.
    logits = torch.einsum(
        "bkgsd,bktd->bkgst", qg.to(torch.float32), ck.to(torch.float32)
    ) * _f32(1.0 / hd**0.5)
    logits = torch.where(valid, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if probs_bf16:
        probs = probs.to(cv.dtype)
    return torch.einsum(
        "bkgst,bktd->bkgsd", probs.to(torch.float32), cv.to(torch.float32)
    ).reshape(b, h, 1, hd).to(qt.dtype)


def _decode_attention(qt, ck, cv, pos: int, window, probs_bf16: bool):
    """``_decode_attend``; DTensor operands (a sharded model) on each
    rank's local batch rows and heads (``local_map``, the placements of
    ``kernels.ops.attention``'s sharded path)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    kw = dict(pos=pos, window=window, probs_bf16=probs_bf16)
    if not isinstance(qt, DTensor):
        return _decode_attend(qt, ck, cv, **kw)
    place, kv = kops.head_placements(qt, ck)
    return local_map(lambda q, k, v: _decode_attend(q, k, v, **kw), out_placements=place,
                     in_placements=(place, kv, kv), device_mesh=qt.device_mesh,
                     redistribute_inputs=True)(qt, ck, cv)


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
        q = _split_heads(linear(x, constrain_weight(self.wq.to(cdt))), h).transpose(1, 2)
        if cache is None:
            k = _split_heads(linear(enc_out, constrain_weight(self.wk.to(cdt))), kv)
            v = _split_heads(linear(enc_out, constrain_weight(self.wv.to(cdt))), kv)
            cache = {"k": constrain_batch_heads(k.transpose(1, 2).contiguous()),
                     "v": constrain_batch_heads(v.transpose(1, 2).contiguous())}
        # DTensor operands: each rank's own batch rows and heads (local_map).
        out = kops.attention(constrain_batch_heads(q), cache["k"], cache["v"], causal=False,
                             use_kernel=False)
        y = out.transpose(1, 2).reshape(b, s, h * hd)
        return linear(y, constrain_weight(self.wo.to(cdt))), cache


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
        h = linear(x, constrain_weight(self.wi.to(cdt)))
        if self.gated:
            h = F.silu(linear(x, constrain_weight(self.wg.to(cdt)))) * h
        else:
            h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
        return linear(h, constrain_weight(self.wo.to(cdt)))


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
    the number of token groups sharing one capacity, the Switch aux loss
    (f32 scalar) and its two factors: ``f_e`` (E,), the share of tokens
    whose top-1 is each expert, and ``p_mean`` (E,), the mean router
    probabilities (aux = E sum_e f_e p_mean)."""

    gates: torch.Tensor
    experts: torch.Tensor
    keep: torch.Tensor
    slots: torch.Tensor
    cap: int
    groups: int
    aux: torch.Tensor
    f_e: torch.Tensor
    p_mean: torch.Tensor


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

    def routing(self, x: torch.Tensor, router: torch.Tensor | None = None) -> Routing:
        """Experts, gates, slots and drops of x (B, S, M); see the class
        docstring.  ``router`` defaults to the layer's."""
        cfg = self.cfg
        b, s, _ = x.shape
        e, k = cfg.num_experts, cfg.num_experts_per_token
        router = self.router if router is None else router
        probs = torch.softmax(x.to(torch.float32) @ router.to(torch.float32), dim=-1)
        top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, experts = top[..., :k], idx[..., :k]
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=_f32(1e-9))
        f_e = F.one_hot(experts[..., 0], e).to(torch.float32).mean(dim=(0, 1))
        p_mean = probs.mean(dim=(0, 1))
        aux = e * (f_e * p_mean).sum()
        if cfg.moe_impl == "sort":
            groups = 1
            cap = max(4, int(cfg.capacity_factor * b * s * k / e + 3) // 4 * 4)
        else:
            groups, cap = b, moe_capacity(cfg, s)
        places = _queue_places(experts.reshape(groups, -1), e).view(b, s, k)
        group = 0 if groups == 1 else torch.arange(b, device=x.device)[:, None, None]
        slots = experts * (groups * cap) + group * cap + places
        return Routing(gates, experts, places < cap, slots, cap, groups, aux, f_e, p_mean)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, M) -> (out (B, S, M) in x's dtype, aux f32 scalar)."""
        from torch.distributed.tensor import DTensor

        if isinstance(self.wi, DTensor):
            y, aux = self._sharded(x)
        else:
            y, rt = self._experts(x, self.router, self.wi, self.wg, self.wo, 0)
            aux = rt.aux
        return y.to(x.dtype), aux

    def _experts(self, x, router, wi, wg, wo, lo: int):
        """The layer on experts [lo, lo + wi.shape[0]) of all of x's
        tokens: (the combine's sum over those experts' pairs, before its
        rounding to x's dtype; the routing).  All experts (lo 0) is the
        layer."""
        cfg, cdt = self.cfg, x.dtype
        b, s, m = x.shape
        k = cfg.num_experts_per_token
        # Under a gradient the dispatch gathers from the router's f32 copy
        # of x and casts back (the same values), so x's gradient sums the
        # kept pairs' rows and the router's in f32 and rounds once, as the
        # reference's dot with f32 accumulation does; a dropped pair sends
        # none.  Serving gathers x itself (half the bytes in bf16).
        rows = x.to(torch.float32) if torch.is_grad_enabled() else x
        rt = self.routing(rows, router)
        per = rt.groups * rt.cap
        n_slots, base = wi.shape[0] * per, lo * per
        mine = rt.keep & (rt.experts >= lo) & (rt.experts < lo + wi.shape[0])
        # Dispatch: the token each slot holds; empty slots read a zero row.
        tok = torch.arange(b * s, device=x.device).view(b, s, 1).expand(b, s, k)
        src = torch.full((n_slots + 1,), b * s, dtype=torch.long, device=x.device)
        src.scatter_(0, torch.where(mine, rt.slots - base, n_slots).reshape(-1),
                     tok.reshape(-1))  # dropped pairs all land in the last slot
        xs = torch.cat([rows.reshape(b * s, m), rows.new_zeros(1, m)])
        buf = xs[src[:n_slots]].to(cdt).view(wi.shape[0], per, m)
        h = torch.bmm(buf, wi.to(cdt))
        h = silu_ref(torch.bmm(buf, wg.to(cdt))) * h
        out = torch.bmm(h, wo.to(cdt)).view(n_slots, m)
        # Combine: each token's pairs in expert order, a dropped pair's
        # (or another rank's expert's) weight zero.
        order = torch.argsort(rt.experts, dim=-1)
        slots = torch.clamp(rt.slots.gather(-1, order) - base, min=0,
                            max=n_slots - 1).view(b * s, k)
        w = torch.where(mine, rt.gates, 0.0).gather(-1, order).view(b * s, k).to(cdt)
        if cfg.moe_impl == "sort":
            y = out[slots[:, 0]] * w[:, :1]
            for j in range(1, k):
                y = y + out[slots[:, j]] * w[:, j:j + 1]
        else:
            wf = w.to(torch.float32)
            y = out[slots[:, 0]].to(torch.float32) * wf[:, :1]
            for j in range(1, k):
                y.addcmul_(out[slots[:, j]].to(torch.float32), wf[:, j:j + 1])
        return y.view(b, s, m), rt

    def _sharded(self, x):
        """The layer of a sharded model (DTensor leaves), through
        ``local_map``: each rank dispatches the pairs of its own experts
        (the expert dim pinned on the mesh axes that hold it, as the
        reference's ``constrain_expert_dim``; no expert weight is gathered
        over them), and the combines add up over those axes (a ``Partial``
        sum, rounded to x's dtype after it is reduced).  The einsum form
        routes each row alone (a capacity per row), so a data rank routes
        its own rows, and the aux loss's two factors are averaged over the
        data ranks before their product (each given by the ranks that hold
        expert 0, so the aux reaches the router once).  The sort form's one capacity
        spans the whole batch, so there every rank routes all the tokens
        (x gathered over the data axes)."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        from repro_torch.models.sharding_ctx import constrain_expert_dim

        mesh = self.wi.device_mesh
        axes = range(len(mesh.mesh_dim_names))
        cdt = x.dtype
        ws = [constrain_expert_dim(w.to(cdt), 0) for w in (self.wi, self.wg, self.wo)]
        ep = [i for i, p in enumerate(ws[0].placements) if p == Shard(0)]
        rows = [i for i, p in enumerate(x.placements) if p == Shard(0) and i not in ep]
        if self.cfg.moe_impl == "sort":
            rows = []
        place = lambda on_ep, on_rows: [on_ep if i in ep else on_rows if i in rows  # noqa: E731
                                        else Replicate() for i in axes]
        x_place = place(Replicate(), Shard(0))
        w_place = place(Shard(0), Replicate())
        # Gradients: x's and the router's gather each rank's experts' pairs
        # (partial sums over the expert axes); the router's and the
        # experts' weights' gather each data rank's rows (partial sums over
        # those axes).
        x_grad = place(Partial(), Shard(0))
        r_grad = place(Partial(), Partial())
        w_grad = place(Shard(0), Partial())
        y_place = place(Partial(), Shard(0))
        # The aux's factors: each row group's share, given once over the
        # expert axes (so its gradient reaches the router once).
        factor = place(Partial(), Partial())
        n_rows = math.prod(mesh.size(i) for i in rows)
        e_loc = self.cfg.num_experts // math.prod(mesh.size(i) for i in ep)

        def local(xl, rl, wil, wgl, wol):
            lo = sum(mesh.get_local_rank(i) * math.prod(mesh.size(j) for j in ep[n + 1:])
                     for n, i in enumerate(ep)) * e_loc
            y, rt = self._experts(xl, rl, wil, wgl, wol, lo)
            share = 1.0 / n_rows if lo == 0 else 0.0
            return y, rt.f_e * share, rt.p_mean * share

        run = local_map(local, out_placements=(y_place, factor, factor),
                        in_placements=(x_place, place(Replicate(), Replicate()),
                                       w_place, w_place, w_place),
                        in_grad_placements=(x_grad, r_grad, w_grad, w_grad, w_grad),
                        device_mesh=mesh, redistribute_inputs=True)
        y, f_e, p_mean = run(x, self.router, *ws)
        return y, _whole(self.cfg.num_experts * (f_e * p_mean).sum())


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


def _ssd_on_ranks(core, x, xin, z, bmat, cmat, dtp, leaves, s0, heads: int):
    """``_ssd_core`` of a sharded model (x a DTensor) on each rank's batch
    rows and heads (``local_map``).  'model' splits d_inner into whole
    heads where it divides them, else every rank runs all the heads (the
    reference's divisibility rule).  B, C and dt's pre-activation come
    whole to every rank, which takes its heads' slices of dt and of the
    (H,) leaves; their gradients are partial sums over 'model' (and the
    leaves' over the batch axes too).  DTensor's own rules fail here at
    (16, 16): the head split of d_inner leaves a strided shard that the
    chunked scan's ``bmm`` cannot propagate."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    m = names.index("model") if "model" in names else None
    if m is not None and heads % mesh.size(m):
        m = None
    lo = 0 if m is None else mesh.get_local_rank(m) * (heads // mesh.size(m))

    def places(on_rows, on_model):
        return [on_rows if p == Shard(0) and on_rows is not None
                else on_model if i == m and on_model is not None else Replicate()
                for i, p in enumerate(x.placements)]

    act, state = places(Shard(0), Shard(2)), places(Shard(0), Shard(1))
    whole, whole_g = places(Shard(0), None), places(Shard(0), Partial())
    vec, vec_g = places(None, None), places(Partial(), Partial())
    args = [(xin, act, act), (z, act, act), (bmat, whole, whole_g), (cmat, whole, whole_g),
            (dtp, whole, whole_g), *((t, vec, vec_g) for t in leaves), (s0, state, state)]
    held = [a for a in args if a[0] is not None]  # train: no state

    def local(*ts):
        return _ssd_core(*ts, *(() if s0 is not None else (None,)), lo=lo, **core)

    return local_map(local, out_placements=(act, state),
                     in_placements=tuple(a[1] for a in held),
                     in_grad_placements=tuple(a[2] for a in held),
                     device_mesh=mesh, redistribute_inputs=True)(*(a[0] for a in held))


def _ssd_core(xin, z, bmat, cmat, dtp, a_log, dt_bias, dskip, s0, *, decode: bool,
              head_dim: int, chunk: int, lo: int = 0):
    """The SSD after its input products and conv, on plain tensors: heads
    [lo, lo + W / head_dim) of the (H,) leaves and of ``dtp`` (B, S, H),
    the pre-activation of dt, against xin and z (B, S, W); returns (the
    gated y (B, S, W) in z's dtype, the last state (B, heads, P, N) f32)."""
    b, s, w = xin.shape
    nh = w // head_dim
    if nh != dt_bias.shape[0]:  # this rank's heads
        dtp, a_log = dtp[..., lo:lo + nh], a_log[lo:lo + nh]
        dt_bias, dskip = dt_bias[lo:lo + nh], dskip[lo:lo + nh]
    xin = silu_ref(xin)
    dt = F.softplus(dtp + dt_bias)  # (B, S, H)
    a = torch.exp(-dt * torch.exp(a_log))  # (B, S, H) in (0, 1)
    xh = xin.to(torch.float32).view(b, s, nh, head_dim)
    u = dt[..., None] * xh  # (B, S, H, P)
    if decode:
        s_last = a[:, 0, :, None, None] * s0 + torch.einsum(
            "bhp,bn->bhpn", u[:, 0], bmat[:, 0])
        y = torch.einsum("bn,bhpn->bhp", cmat[:, 0], s_last)[:, None]
    else:
        q = min(chunk, s)
        pad = (-s) % q
        if pad:
            a = F.pad(a, (0, 0, 0, pad), value=1.0)
            u = F.pad(u, (0, 0, 0, 0, 0, pad))
            bmat = F.pad(bmat, (0, 0, 0, pad))
            cmat = F.pad(cmat, (0, 0, 0, pad))
        y, s_last = _ssd_scan_chunked(a, u, bmat, cmat, s0, q)
        y = y[:, :s]
    y = y + dskip[:, None] * xh
    return y.reshape(b, s, w).to(z.dtype) * silu_ref(z), s_last


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

    A sharded model (DTensor leaves, the width over 'model' as the
    reference's ``mlp`` axis) runs this same code under DTensor's rules
    (``u wa`` and ``u wi`` contract over the split width: DTensor reduces
    the partial sums before the sigmoid, as the reference all-reduces
    them); the new state and conv tail go into the cache through
    ``cache_write``.
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
        u = linear(x, constrain_weight(self.wx.to(cdt)))
        gate = linear(x, constrain_weight(self.wgate.to(cdt)))
        u, new_tail = causal_conv(u, self.conv, None if cache is None else cache["conv"])
        uf = u.to(torch.float32)
        r = torch.sigmoid(linear(uf, self.wa))
        i = torch.sigmoid(linear(uf, self.wi))
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
        out = linear(y, constrain_weight(self.wo.to(cdt)))
        if cache is not None:
            cache_write(cache["h"], (Ellipsis,), hs[:, -1])
            cache_write(cache["conv"], (Ellipsis,), new_tail)
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

    A sharded model (DTensor leaves, d_inner over 'model' in whole heads)
    runs the projections and the conv under DTensor's rules and the scan
    on each rank's batch rows and heads (``_ssd_on_ranks``).
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
        from torch.distributed.tensor import DTensor

        cfg = self.cfg
        cdt = x.dtype
        xin = linear(x, constrain_weight(self.wx.to(cdt)))
        z = linear(x, constrain_weight(self.wz.to(cdt)))
        s0 = None if cache is None else cache["s"]
        xin, new_tail = causal_conv(xin, self.conv, None if cache is None else cache["conv"])
        xf = x.to(torch.float32)
        bmat = linear(xf, constrain_weight(self.wb))
        cmat = linear(xf, constrain_weight(self.wc))
        dtp = linear(xf, constrain_weight(self.wdt))
        core = dict(decode=mode == "decode", head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk)
        leaves = (self.a_log, self.dt_bias, self.dskip)
        if isinstance(x, DTensor):
            y, s_last = _ssd_on_ranks(core, x, xin, z, bmat, cmat, dtp, leaves, s0,
                                      cfg.ssm_heads)
        else:
            y, s_last = _ssd_core(xin, z, bmat, cmat, dtp, *leaves, s0, **core)
        out = linear(y, constrain_weight(self.wo.to(cdt)))
        if cache is not None:
            cache_write(cache["s"], (Ellipsis,), s_last)
            cache_write(cache["conv"], (Ellipsis,), new_tail)
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


def _gold(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's logit at its label.  DTensor logits (a sharded
    model, the vocab possibly split over 'model') are read on each rank's
    block (``local_map``): the labels in a rank's vocab rows answer there,
    zeros elsewhere, summed over 'model'."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(lf, DTensor):
        return torch.gather(lf, -1, labels[..., None])[..., 0]
    mesh, last = lf.device_mesh, lf.dim() - 1
    split = [i for i, p in enumerate(lf.placements) if p in (Shard(last), Shard(-1))]
    lf_place = [p if i in split or p == Shard(0) else Replicate()
                for i, p in enumerate(lf.placements)]
    lab_place = [Shard(0) if p == Shard(0) else Replicate() for p in lf_place]
    out_place = [Partial() if i in split else p for i, p in enumerate(lab_place)]
    cols = lf.shape[-1] // math.prod(mesh.size(i) for i in split)

    def local(lfl, lab):
        lo = sum(mesh.get_local_rank(i) * math.prod(mesh.size(j) for j in split[n + 1:])
                 for n, i in enumerate(split)) * cols
        inside = (lab >= lo) & (lab < lo + cols)
        got = torch.gather(lfl, -1, torch.where(inside, lab - lo, 0)[..., None])[..., 0]
        return got * inside.to(got.dtype)

    return local_map(local, out_placements=out_place, in_placements=(lf_place, lab_place),
                     device_mesh=mesh, redistribute_inputs=True)(lf, labels)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor scalar (a sharded model's loss term) replicated on every
    rank, so terms reduced in different ways (a mean, a sum) add."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean token CE in f32. logits: (B, S, V); labels: (B, S) integers."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = _gold(lf, labels.long())
    nll = logz - gold
    if mask is None:
        return _whole(nll.mean())
    mask = mask.to(torch.float32)
    return _whole((nll * mask).sum() / torch.clamp(mask.sum(), min=1.0))

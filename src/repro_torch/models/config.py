"""Model and shape configuration dataclasses (port of
``repro/models/config.py``, copied: the port imports nothing of the
reference package).

One block-pattern decoder covers the dense, MoE, hybrid, SSM and VLM
families; whisper adds an encoder stack.  The depth is expressed as
repeating *stages*, ``stages() = ((pattern, count), ...)``.  The port
builds a ``ModuleList`` of blocks over that structure (a Python loop
takes the place of the reference's ``jax.lax.scan``).

Every field of the reference is kept, so the two packages' configs
compare field by field; the sharding and scan knobs (``scan_layers``,
``serve_*``, ``fsdp``, ``eigen_compress``) are read by the reference only
(``remat`` picks per-block checkpointing in training, ``moe_impl`` the MoE
dispatch form).  Of the families, the port runs
the dense, MoE, hybrid and SSM ones (``repro_torch.configs.registry``).
"""


from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

MIXERS = ("attn", "local_attn", "rglru", "ssd")


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- layer stack ---------------------------------------------------
    # mixer pattern cycled over the depth, e.g. ("rglru","rglru","local_attn")
    block_pattern: Tuple[str, ...] = ("attn",)
    window_size: int = 2048  # for local_attn mixers
    # --- MoE -----------------------------------------------------------
    num_experts: int = 0
    num_experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 SSD) ------------------------------------------------
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # --- RG-LRU ----------------------------------------------------------
    lru_width: int = 0  # 0 -> d_model
    conv_width: int = 4
    # --- enc-dec (whisper) ----------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    gated_mlp: bool = True  # SwiGLU vs plain GELU MLP (whisper)
    # --- VLM stub ---------------------------------------------------------
    num_patches: int = 0  # >0: prepend stubbed patch embeddings
    patch_embed_dim: int = 1024  # stub ViT output dim, projected to d_model
    # --- numerics / misc --------------------------------------------------
    rope_theta: float = 1e6
    rope_fraction: float = 1.0  # chatglm applies RoPE to half the head dim
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: str = "full"  # none | full (per-layer jax.checkpoint)
    # scan over stacked layers (bounded HLO; production default).  The
    # dry-run sets False: XLA's cost analysis counts while-loop bodies ONCE,
    # so FLOP/byte/collective accounting needs the unrolled graph.
    scan_layers: bool = True
    # --- §Perf hillclimb levers -----------------------------------------
    # MoE dispatch: 'einsum' (Switch-style one-hot dispatch/combine einsums,
    # the honest baseline) or 'sort' (argsort + gather/scatter: O(S*K)
    # dispatch state instead of O(S*E*C) one-hot tensors).
    moe_impl: str = "einsum"
    # attention softmax probabilities dtype for the PV matmul: bf16 is the
    # production default (§Perf A4/B5: halves S^2 probs traffic, keeps the
    # PV matmul MXU-native, and stops f32 upcasts re-gathering the KV
    # cache); set False for f32 probs (paper-faithful baseline accounting).
    attn_probs_bf16: bool = True
    # serving layout: shard experts over the data axis (EP-over-data) and
    # disable FSDP — removes per-step parameter all-gathers in decode.
    serve_ep_over_data: bool = False
    # serving layout v2 (§Perf B8): EP over 'model' x expert-ff over 'data'
    # — expert weights fully sharded with NO per-step gathers (the ff
    # contraction psums a tiny (e,cap,m) buffer instead), and FSDP off.
    serve_mlp_over_data: bool = False
    tie_embeddings: bool = False
    fsdp: bool = True  # shard the 'embed' logical dim over the data axis
    eigen_compress: bool = True  # paper technique in the optimizer (R2)

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, 256)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:  # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def stages(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Decompose depth into (pattern, count) scan stages + remainder."""
        p = len(self.block_pattern)
        full, rem = divmod(self.num_layers, p)
        out = []
        if full:
            out.append((self.block_pattern, full))
        if rem:
            out.append((self.block_pattern[:rem], 1))
        return tuple(out)

    def validate(self) -> None:
        for b in self.block_pattern:
            if b not in MIXERS:
                raise ValueError(f"unknown mixer {b!r}")
        if self.num_heads and self.d_model % self.num_heads:
            raise ValueError("d_model must divide num_heads")
        if self.num_heads and self.num_kv_heads:
            if self.num_heads % self.num_kv_heads:
                raise ValueError("num_heads must divide num_kv_heads")
        if self.is_moe and not self.num_experts_per_token:
            raise ValueError("MoE requires num_experts_per_token")
        if "ssd" in self.block_pattern and self.ssm_state_dim <= 0:
            raise ValueError("ssd mixer requires ssm_state_dim")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned LM shapes (identical across archs).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Skip policy (DESIGN.md §5): long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        sub_quadratic = all(m in ("rglru", "ssd", "local_attn") for m in cfg.block_pattern)
        if not sub_quadratic:
            return False, (
                "long_500k skipped: pure full-attention arch (dense 512k KV "
                "cache is the quadratic-memory regime the brief excludes)"
            )
    return True, ""


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (embedding included once; logical vocab)."""
    d, v = cfg.d_model, cfg.vocab_size
    n = v * d  # embedding
    if not cfg.tie_embeddings:
        n += v * d
    hd = cfg.head_dim

    def attn_params():
        return (
            d * cfg.num_heads * hd          # q
            + 2 * d * cfg.num_kv_heads * hd  # k, v
            + cfg.num_heads * hd * d         # o
        )

    def mlp_params():
        if cfg.d_ff == 0:
            return 0
        if cfg.is_moe:
            per = 3 * d * cfg.d_ff if cfg.gated_mlp else 2 * d * cfg.d_ff
            return cfg.num_experts * per + d * cfg.num_experts  # + router
        return 3 * d * cfg.d_ff if cfg.gated_mlp else 2 * d * cfg.d_ff

    def rglru_params():
        w = cfg.lru_width or d
        # in-proj (x & gate), conv, gates (a & input), out-proj, Lambda
        return 2 * d * w + cfg.conv_width * w + 2 * w * w + w * d + w

    def ssd_params():
        di, nh, ns = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state_dim
        #  in-proj: x, z; B, C; dt; out-proj; A, D per head
        return d * (2 * di + 2 * ns + nh) + di * d + 2 * nh

    mixer_cost = {
        "attn": attn_params,
        "local_attn": attn_params,
        "rglru": rglru_params,
        "ssd": ssd_params,
    }
    per_layer = []
    for i in range(cfg.num_layers):
        kind = cfg.block_pattern[i % len(cfg.block_pattern)]
        c = mixer_cost[kind]() + mlp_params() + 2 * d  # 2 rmsnorm scales
        per_layer.append(c)
    n += sum(per_layer) + d  # final norm
    if cfg.is_encoder_decoder:
        enc = cfg.num_encoder_layers * (attn_params() + mlp_params() + 2 * d)
        dec_cross = cfg.num_layers * (attn_params() + d)  # cross-attn + norm
        n += enc + dec_cross
    if cfg.num_patches:
        n += cfg.patch_embed_dim * d  # stub patch projection
    return n


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top-k experts instead of all)."""
    if not cfg.is_moe:
        return param_count(cfg)
    full = param_count(cfg)
    d = cfg.d_model
    per_expert = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    inactive = (cfg.num_experts - cfg.num_experts_per_token) * per_expert
    return full - cfg.num_layers * inactive

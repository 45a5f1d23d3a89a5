"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per-expert) vocab=163840,
MoE 384 experts top-8.  About 1.04 T parameters: one card serves only
the reduced config (the full one waits for ROADMAP A11-sharded).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    num_experts_per_token=8,
    fsdp=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=32,
        vocab_size=512,
        num_experts=8,
        num_experts_per_token=2,
        remat="none",
    )

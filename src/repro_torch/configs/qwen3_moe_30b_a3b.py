"""Qwen3-30B-A3B — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

48L d_model=2048 32H (GQA kv=4) d_ff=768 (per-expert) vocab=151936:
30,079,125,504 parameters (param_count), 60.16 GB in bf16, which one
80 GB H100 holds whole.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
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

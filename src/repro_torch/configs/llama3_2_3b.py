"""Llama-3.2-3B — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256: about 3.2 B
parameters, 6.4 GB in bf16, which one H100 holds whole.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    fsdp=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        remat="none",
    )

"""Granite-3.0-2B — dense GQA [hf:ibm-granite/granite-3.0-2b-base; hf].

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155 (padded to 49408
for 16-way vocab TP).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    fsdp=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=515,  # deliberately odd: exercises vocab padding
        remat="none",
    )

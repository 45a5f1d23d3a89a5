"""RecurrentGemma-2B — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1, i.e. MQA) d_ff=7680 vocab=256000,
window 2048.  26 = (rglru, rglru, local_attn) x 8 + 2 rglru remainder.
Sub-quadratic: runs the long_500k shape.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    window_size=2048,
    lru_width=2560,
    conv_width=4,
    fsdp=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=5,  # exercises the remainder stage (5 = 3*1 + 2)
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        window_size=16,
        lru_width=64,
        remat="none",
    )

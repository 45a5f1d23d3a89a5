"""InternLM2-20B — dense GQA [arXiv:2403.17297; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
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

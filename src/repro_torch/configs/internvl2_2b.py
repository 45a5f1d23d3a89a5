"""InternVL2-2B — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553: 1.89 B
parameters, 3.8 GB in bf16.  The ViT frontend is a stub, as in the
reference: precomputed patch embeddings (B, 256, 1024), which the model
projects into the LM stream (``patch_proj``) ahead of the tokens.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    num_patches=256,
    patch_embed_dim=1024,
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
        vocab_size=512,
        num_patches=8,
        patch_embed_dim=32,
        remat="none",
    )

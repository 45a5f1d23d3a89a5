"""Mamba2-370M — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified].

48L d_model=1024, d_ff=0 (no MLP; the SSD block carries the capacity),
vocab=50280, ssm_state=128.  Sub-quadratic: runs the long_500k shape.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("ssd",),
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    fsdp=False,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=3,
        d_model=64,
        vocab_size=512,
        ssm_state_dim=16,
        ssm_head_dim=16,
        ssm_chunk=16,
        remat="none",
    )

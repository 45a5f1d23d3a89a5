"""Whisper-tiny — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356; unverified].

4L encoder + 4L decoder, d_model=384 6H (kv=6) d_ff=1536 vocab=51865:
56 M parameters.  Frame embeddings (B, S_enc, 384), the output of
whisper's conv stack, come precomputed, as in the reference.
``eigen_compress=False`` is the reference's field, which its trainer does
not read (nor does the port's).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    num_encoder_layers=4,
    gated_mlp=False,  # whisper uses plain GELU MLPs
    fsdp=False,
    eigen_compress=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        num_encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        remat="none",
    )

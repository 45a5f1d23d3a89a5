"""Architecture registry: ``--arch <id>`` -> ModelConfig (port of
``repro/configs/registry.py``).

All ten arch ids of the reference are known, and the port runs every
family: dense, MoE, hybrid (RG-LRU + local attention), SSM (Mamba2 SSD),
VLM (the patch-stub prefix) and audio (the encoder-decoder).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "family_of", "get_config", "get_reduced_config"]

# arch id -> (module name, family)
ARCHS: dict[str, tuple[str, str]] = {
    "kimi-k2-1t-a32b": ("kimi_k2_1t_a32b", "moe"),
    "qwen3-moe-30b-a3b": ("qwen3_moe_30b_a3b", "moe"),
    "internlm2-20b": ("internlm2_20b", "dense"),
    "chatglm3-6b": ("chatglm3_6b", "dense"),
    "llama3.2-3b": ("llama3_2_3b", "dense"),
    "granite-3-2b": ("granite_3_2b", "dense"),
    "internvl2-2b": ("internvl2_2b", "vlm"),
    "recurrentgemma-2b": ("recurrentgemma_2b", "hybrid"),
    "whisper-tiny": ("whisper_tiny", "audio"),
    "mamba2-370m": ("mamba2_370m", "ssm"),
}


def family_of(arch: str) -> str:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch][1]


def _module(arch: str):
    family_of(arch)
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch][0]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).reduced()

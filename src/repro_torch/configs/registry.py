"""Architecture registry: ``--arch <id>`` -> ModelConfig (port of
``repro/configs/registry.py``).

All ten arch ids of the reference are known.  The port runs the dense
family so far; asking for an arch of another family raises
``NotImplementedError`` naming the ROADMAP item that ports it, rather
than falling through to something else.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "PORTED_FAMILIES", "family_of", "get_config", "get_reduced_config"]

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
PORTED_FAMILIES = ("dense",)
# Family not ported yet -> the ROADMAP item that ports it.
_PENDING = {
    "moe": "A11-moe",
    "vlm": "A11-vlm",
    "hybrid": "A11-hybrid",
    "audio": "A11-whisper",
    "ssm": "A11-ssm",
}


def family_of(arch: str) -> str:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch][1]


def _module(arch: str):
    family = family_of(arch)
    if family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{arch} ({family} family) is not ported to repro_torch yet: "
            f"ROADMAP {_PENDING[family]}"
        )
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch][0]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).reduced()

"""Architecture configs of the port (copies of ``repro/configs``): the
dense family, qwen3-moe-30b-a3b and kimi-k2-1t-a32b (MoE),
recurrentgemma-2b (hybrid), mamba2-370m (SSM), internvl2-2b (VLM) and
whisper-tiny (audio, encoder-decoder)."""

from repro_torch.configs.registry import (  # noqa: F401
    ARCHS,
    get_config,
    get_reduced_config,
)

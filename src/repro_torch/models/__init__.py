"""The port's LM stack: configs, layers, the decoder-only LM and its
builder (dense family so far; ROADMAP A11 lists the rest)."""

from repro_torch.models.config import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    param_count,
)
from repro_torch.models.lm import LM  # noqa: F401
from repro_torch.models.registry import build, init_params  # noqa: F401

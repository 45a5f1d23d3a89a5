"""The port's model stack: configs, layers, the decoder-only LM (dense,
MoE, hybrid, SSM and VLM families), the encoder-decoder (audio) and
``build``, which picks between them."""

from repro_torch.models.config import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    param_count,
)
from repro_torch.models.encdec import EncDec  # noqa: F401
from repro_torch.models.lm import LM, loss_fn  # noqa: F401
from repro_torch.models.registry import build, init_params, loss, model_class  # noqa: F401

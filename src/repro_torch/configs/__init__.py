"""Architecture configs of the port (copies of ``repro/configs``, the
dense family so far)."""

from repro_torch.configs.registry import (  # noqa: F401
    ARCHS,
    get_config,
    get_reduced_config,
)

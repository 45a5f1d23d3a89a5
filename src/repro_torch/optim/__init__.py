"""Optimizers and initializers of the port (mirrors ``repro.optim``):
AdamW with f32 moments updated in place, its schedules and gradient
utilities, the eigen-compressed data-parallel gradients (the paper's
technique in training), and the distributed spectral initialization."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.eigen_compress import EigenCompressConfig  # noqa: F401
from repro_torch.optim.schedule import constant, warmup_cosine  # noqa: F401
from repro_torch.optim.spectral_init import distributed_spectral_init  # noqa: F401

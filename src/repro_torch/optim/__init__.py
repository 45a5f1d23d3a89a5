"""Optimizers and initializers of the port (mirrors ``repro.optim``): the
distributed spectral initialization for now; the trainer's modules
(``eigen_compress``, ``adamw``, ``schedule``, ``grad_utils``) come with
the trainer (ROADMAP A11-train)."""

from repro_torch.optim.spectral_init import distributed_spectral_init  # noqa: F401

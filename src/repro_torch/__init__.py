"""PyTorch/CUDA port of the distributed eigenspace estimator.

The JAX/Pallas package ``repro`` is the reference; this package keeps its
module layout (``repro_torch/core/procrustes.py`` answers to
``repro/core/procrustes.py``) and imports only ``torch`` and ``numpy``.
Its kernels are written by hand for Hopper (``repro_torch/kernels/csrc``)
and are built with ``nvcc`` on first use.

Ported so far: distributed PCA, stacked and across the ranks of a
process group (covariance -> local eigenbasis -> Procrustes-fixing
rounds; ``repro_torch.core.distributed``, the launcher ``python -m
repro_torch.launch.eigen``), and dense-LM serving
(``repro_torch.models``, ``repro_torch.configs``, ``python -m
repro_torch.launch.serve``).  Entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``; with no card present they
raise rather than fall back.
"""

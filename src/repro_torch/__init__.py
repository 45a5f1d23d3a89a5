"""PyTorch/CUDA port of the distributed eigenspace estimator.

The JAX/Pallas package ``repro`` is the reference; this package keeps its
module layout (``repro_torch/core/procrustes.py`` answers to
``repro/core/procrustes.py``) and imports only ``torch`` and ``numpy``.
Its kernels are written by hand for Hopper (``repro_torch/kernels/csrc``)
and are built with ``nvcc`` on first use.

The slice ported so far is the stacked distributed-PCA path:
covariance -> local eigenbasis -> Procrustes-fixing rounds over the
(m, d, r) stack (``repro_torch.core.distributed.distributed_pca``, and
the launcher ``python -m repro_torch.launch.eigen``).  Entry points run
on ``device="cuda"`` unless the caller passes ``device="cpu"``; with no
card present they raise rather than fall back.
"""

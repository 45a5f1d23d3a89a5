"""Hand-written Hopper kernels of the port, their wrappers and plain
versions.

  * ``covariance.gram``                 B1, ``csrc/covariance.cu``
  * ``procrustes_align.batched_gram``   B2, ``csrc/procrustes_align.cu``
  * ``procrustes_align.batched_gram_polar``  B3, same source
  * ``procrustes_align.align_average``  B4, same source
  * ``procrustes_align.fused_round``    B5, ``csrc/fused_round.cu``
  * ``procrustes_align.fused_ring_round``  B6, same source

``launch_counts`` / ``reset_launch_counts`` read and zero every wrapper's
launch counter, so a run can show which kernels its main path launched.
Nothing is built or loaded at import: the first launch builds
(``_build``).
"""

from __future__ import annotations

from repro_torch.kernels import covariance, procrustes_align

__all__ = ["WRAPPERS", "launch_counts", "reset_launch_counts"]

WRAPPERS = {
    "gram": covariance.gram,
    "batched_gram": procrustes_align.batched_gram,
    "batched_gram_polar": procrustes_align.batched_gram_polar,
    "align_average": procrustes_align.align_average,
    "fused_round": procrustes_align.fused_round,
    "fused_ring_round": procrustes_align.fused_ring_round,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0

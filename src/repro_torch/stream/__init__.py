"""Streaming subspace service: the paper's estimator as a long-lived job
(port of ``repro.stream``).

  * ``repro_torch.stream.accumulator``: per-shard merge-able second-moment
    state (``update`` / ``merge`` / ``to_cov``); the same rows fed in any
    chunking give the covariance ``empirical_covariance`` computes one
    shot;
  * ``repro_torch.stream.service``: ``SubspaceService``, periodic
    Procrustes refreshes against the previously served basis, a drift and
    cadence trigger, elastic membership, and a double-buffered query path
    (``project``) that makes no collective call.

Layering: ``stream`` sits above ``core`` / ``comm`` / ``plan`` /
``runtime`` and below ``launch`` (``serve --subspace``, ``eigen
--stream``).
"""

from repro_torch.stream.accumulator import (  # noqa: F401
    Accumulator,
    init_state,
    merge,
    to_cov,
    update,
)
from repro_torch.stream.service import SubspaceService, basis_jump, project  # noqa: F401

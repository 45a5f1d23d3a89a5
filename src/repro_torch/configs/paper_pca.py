"""The paper's own workload as a config (a copy of
``repro/configs/paper_pca.py``): distributed PCA of a d-dim covariance
with target rank r across the data axis (see launch/eigen.py).

Not one of the 10 assigned archs — this is the 11th 'architecture' used to
dry-run and roofline the paper's algorithm itself at production scale.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PcaConfig:
    name: str = "paper-pca"
    d: int = 8192            # ambient dimension
    r: int = 128             # target subspace rank
    n_per_shard: int = 65536  # samples per data shard
    n_iter: int = 2          # Algorithm 2 refinement rounds
    solver: str = "subspace"
    solver_iters: int = 30


CONFIG = PcaConfig()


def reduced() -> PcaConfig:
    return PcaConfig(d=64, r=4, n_per_shard=256, solver_iters=15)

"""Core estimator of the port: Procrustes-fixing distributed eigenspace
estimation (mirrors ``repro.core``)."""

from repro_torch.core.procrustes import (  # noqa: F401
    align,
    align_batch,
    newton_schulz_polar,
    polar_factor,
    procrustes_distance,
    procrustes_rotation,
    sign_fix,
)
from repro_torch.core.orthonorm import (  # noqa: F401
    cholesky_qr2,
    orthonormalize,
    qr_orthonormalize,
    resolve_orth,
)
from repro_torch.core.metrics import dist_2, dist_f, subspace_dist64  # noqa: F401
from repro_torch.core.subspace import (  # noqa: F401
    local_eigenbasis,
    subspace_iteration,
    top_r_eigh,
)
from repro_torch.core.eigenspace import (  # noqa: F401
    central_estimate,
    iterative_refinement,
    local_bases,
    naive_average,
    procrustes_fix_average,
    projector_average,
    refinement_rounds,
)
from repro_torch.core.covariance import empirical_covariance  # noqa: F401
from repro_torch.core.distributed import (  # noqa: F401
    distributed_pca,
    distributed_pca_collective,
    distributed_pca_from_covs,
    procrustes_average_collective,
    sign_average_collective,
)

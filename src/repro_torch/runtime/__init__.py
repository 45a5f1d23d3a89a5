"""Runtime of the port (mirrors ``repro.runtime``): failure injection and
retries (``fault``), straggler detection (``straggler``), and the elastic
aggregation that re-plans on membership changes (``elastic``)."""

from repro_torch.runtime.elastic import (  # noqa: F401
    ElasticReport,
    RoundEvent,
    elastic_pca,
    elastic_pca_collective,
    replan,
    transition_reason,
)
from repro_torch.runtime.fault import (  # noqa: F401
    FailureInjector,
    SimulatedPreemption,
    with_retries,
)
from repro_torch.runtime.straggler import StepTimer, StragglerMonitor  # noqa: F401

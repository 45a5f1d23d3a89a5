"""Execution planner of the port (mirrors ``repro.plan``).

``plan_aggregation(m=..., d=..., r=...)`` scores every valid (backend x
topology x polar x orth x comm_bits) cell with the ``comm_cost`` bits
model and the ``roofline`` device models and returns the cheapest
feasible ``Plan``; every aggregation entry point takes
``plan=None|"auto"|Plan`` and funnels through ``resolve_plan``;
``explain()`` renders the scored table (the launcher's ``--explain``);
``calibration`` refines the device constants from a recorded sweep.
Above ``repro_torch.comm`` / ``core`` / ``kernels``, below ``launch``.
"""

from repro_torch.plan.calibration import Calibration, load_calibration  # noqa: F401
from repro_torch.plan.planner import (  # noqa: F401
    BACKEND_CHOICES,
    BACKENDS_CONCRETE,
    COMM_BITS,
    COMM_BITS_CHOICES,
    CellScore,
    MIN_RING_CHUNK,
    ORTH_CHOICES,
    PLAN_CHOICES,
    POLAR_CHOICES,
    Plan,
    TOPOLOGY_CHOICES,
    choose_ring_chunk,
    explain,
    format_plan_table,
    plan_aggregation,
    resolve_plan,
    score_cells,
    stacked_round_flops,
)
from repro_torch.plan.roofline import (  # noqa: F401
    DEVICE_MODELS,
    DeviceModel,
    RooflineTerms,
    device_model,
    roofline_terms,
)

"""Planner calibration from a recorded ``bench_aggregate`` sweep (port of
``repro/plan/calibration.py``).

The planner's latency constants (``DeviceModel``) are priors; a recorded
aggregation sweep on the target machine measures two of them:

  * **dispatch overhead**: the minimum ``wall_us_min`` over the compiled
    stacked cells (the smallest-work cells' wall is mostly dispatch);
  * **effective FLOP rate**: the largest-work compiled stacked cell, less
    the dispatch estimate, over the planner's own stacked-round flop count.

Only ``mode == "compiled"`` stacked records are used, and a calibration
applies only to the device kind it was recorded on (``meta.platform``);
an empty or mismatched one is a no-op.  The file format is the
reference's ``bench_aggregate/v*`` JSON (``{"meta": {"platform": ...},
"records": [...]}``); the card's phase-4 timings (``chip_smoke.py``) are
handed to ``Calibration.from_records`` in the same record form with
platform ``"h100"``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

__all__ = ["Calibration", "load_calibration"]


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured constants to refine a ``DeviceModel`` with (``None``: keep
    the prior)."""

    platform: str
    dispatch_s: Optional[float] = None
    flops_per_s: Optional[float] = None
    cells: int = 0
    source: str = ""

    def applies_to(self, device_kind: str) -> bool:
        return bool(self.platform) and self.platform == device_kind

    @classmethod
    def from_records(
        cls, platform: str, records: List[Dict[str, Any]], source: str = ""
    ) -> "Calibration":
        """Estimate (dispatch, flop rate) from compiled stacked records."""
        from repro_torch.plan.planner import stacked_round_flops

        usable = [
            r for r in records
            if r.get("topology") == "stacked"
            and r.get("mode") == "compiled"
            and r.get("wall_us_min", r.get("wall_us", 0)) > 0
        ]
        if not usable:
            return cls(platform=platform, cells=0, source=source)

        def wall_s(r: Dict[str, Any]) -> float:
            wall = r.get("wall_us_min")
            if wall is None:
                wall = r["wall_us"]
            return float(wall) * 1e-6

        def work(r: Dict[str, Any]) -> float:
            return stacked_round_flops(
                m=r["m"], d=r["d"], r=r["r"], n_iter=r.get("n_iter", 1),
                polar=r.get("polar", "svd"), orth=r.get("orth", "qr"),
            )

        dispatch_s = min(wall_s(r) for r in usable)
        heaviest = max(usable, key=work)
        flops_per_s: Optional[float] = None
        residual = wall_s(heaviest) - dispatch_s
        if residual > 0 and work(heaviest) > 0:
            flops_per_s = work(heaviest) / residual
        return cls(
            platform=platform, dispatch_s=dispatch_s, flops_per_s=flops_per_s,
            cells=len(usable), source=source,
        )


def load_calibration(path: str) -> Calibration:
    """Load a ``bench_aggregate`` JSON file into a ``Calibration``."""
    with open(path) as f:
        data = json.load(f)
    platform = str(data.get("meta", {}).get("platform", ""))
    return Calibration.from_records(platform, data.get("records", []), source=path)

"""Device models and roofline terms (port of ``repro/plan/roofline.py``).

``DeviceModel`` holds the per-device-kind constants that price an
operation; ``roofline_terms`` is the three-term roofline of one step.
``repro_torch.plan.planner`` prices every (backend x topology x polar x
orth x comm_bits) cell of an aggregation against these models.

Two models, by kind:

  * ``CPU_HOST`` ("cpu"): the reference's host model, field for field, so
    the planner's decisions on the CPU match the reference's.
  * ``H100`` ("h100"): one NVIDIA H100 80GB HBM3 (SXM5).  Peaks and links
    are the data sheet's; the latencies were measured on the card by
    ``tools/h100_model.py`` (each constant names its run).

The port carries no TPU model: the parity tests build the reference's
TPU and generic-GPU models from its own objects and pass them in as
``device=``.  The reference's dry-run table helpers are not ported here
(ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = [
    "DeviceModel",
    "DEVICE_MODELS",
    "device_model",
    "CPU_HOST",
    "H100",
    "RooflineTerms",
    "roofline_terms",
]


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Hardware constants one device kind exposes to the cost models.

    The throughput terms (``peak_flops``, ``hbm_bw``, ``net_bw``) price
    bulk work; the latency terms price the fixed overheads that dominate
    the paper's small (d, r) shapes:

      * ``op_latency_s``      - per sequential plain torch op (the cost
                                of a 48-matmul Newton-Schulz chain that a
                                fused kernel collapses to one launch);
      * ``launch_latency_s``  - per launch of one of the port's kernels;
      * ``lapack_latency_s``  - per LAPACK-style call (SVD, Householder
                                QR);
      * ``coll_latency_s``    - per collective operation on the wire.

    ``interpret_penalty`` multiplies kernel compute where the kernels do
    not run (off an sm_90 card the wrappers run their plain versions, a
    correctness path); ``hbm_cap_bytes`` bounds working sets (the gather
    topology's (m, d, r) stack, the fused ring's staged stack);
    ``vmem_cap_bytes`` is the reference's kernel-resident envelope, kept
    for the field set (the port's planner gates nothing on it).
    """

    kind: str
    peak_flops: float
    hbm_bw: float
    net_bw: float
    op_latency_s: float
    launch_latency_s: float
    lapack_latency_s: float
    coll_latency_s: float
    interpret_penalty: float
    hbm_cap_bytes: float
    vmem_cap_bytes: float = float(16 * 2**20)
    # ``net_bw`` is the fast intra-pod link (``ici_bw`` aliases it);
    # ``dcn_bw`` the slow inter-pod fabric the hier topology prices its pod
    # ring against.  0.0 resolves to ``net_bw`` (one fabric).
    dcn_bw: float = 0.0

    def __post_init__(self):
        if self.dcn_bw <= 0.0:
            object.__setattr__(self, "dcn_bw", self.net_bw)

    @property
    def ici_bw(self) -> float:
        """The fast intra-pod link, an alias of ``net_bw``."""
        return self.net_bw

    def calibrated(
        self,
        *,
        dispatch_s: Optional[float] = None,
        flops_per_s: Optional[float] = None,
    ) -> "DeviceModel":
        """Refined copy: a measured per-call dispatch overhead replaces the
        launch latency, a measured effective FLOP rate replaces the peak
        (``repro_torch.plan.calibration``)."""
        updates: Dict[str, float] = {}
        if dispatch_s is not None and dispatch_s > 0:
            updates["launch_latency_s"] = dispatch_s
        if flops_per_s is not None and flops_per_s > 0:
            updates["peak_flops"] = flops_per_s
        return dataclasses.replace(self, **updates) if updates else self


# A host CPU (the reference's model, copied field for field).
CPU_HOST = DeviceModel(
    kind="cpu",
    peak_flops=1e11,
    hbm_bw=2e10,
    net_bw=2e10,
    op_latency_s=2e-7,
    launch_latency_s=2e-5,
    lapack_latency_s=2e-6,
    coll_latency_s=5e-7,
    interpret_penalty=200.0,
    hbm_cap_bytes=3.2e10,
    vmem_cap_bytes=float(256 * 2**20),
)

# One NVIDIA H100 80GB HBM3 (SXM5).  Latencies: measured with
# tools/h100_model.py on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit (torch 2.11.0, CUDA 12.8).
H100 = DeviceModel(
    kind="h100",
    # FP32 on the CUDA cores (data sheet): TF32 stays off in the port
    # (interop.strict_fp32), and B1-B7 are f32 kernels.
    peak_flops=67e12,
    hbm_bw=3.35e12,  # HBM3 (data sheet)
    net_bw=450e9,  # NVLink 4, 900 GB/s both directions (data sheet)
    # Host wall per sequential small torch op (a chained (8, 8) matmul,
    # 2000 calls): 18.76 us.
    op_latency_s=1.876e-5,
    # Host wall per launch of the port's smallest kernel (B4 through its
    # wrapper on a (1, 8, 8) stack, 2000 calls back to back): 21.74 us.
    launch_latency_s=2.174e-5,
    # Per LAPACK-style call: the mean of one torch.linalg.svd of the
    # (8, 128, 128) Gram stack (21.17 ms) and one torch.linalg.qr of
    # (8192, 128) (1.51 ms), each synchronised, median of 7: 11.34 ms.
    lapack_latency_s=1.134e-2,
    # Not measured: NCCL refuses two ranks on one card, and the card's
    # cross-rank lanes run over gloo through host memory.  A prior of
    # NCCL's small-message latency over NVLink (ROADMAP queues it).
    coll_latency_s=1e-5,
    interpret_penalty=200.0,
    hbm_cap_bytes=80e9,
    vmem_cap_bytes=float(228 * 2**10),  # shared memory per SM (data sheet)
    dcn_bw=50e9,  # one 400 Gb/s NIC a GPU between pods (data sheet)
)

DEVICE_MODELS: Dict[str, DeviceModel] = {m.kind: m for m in (CPU_HOST, H100)}


def device_model(kind: str) -> DeviceModel:
    """Model for a device kind ("cpu" | "h100"); unknown kinds get the CPU
    model (conservative: no kernels, cheap LAPACK), as in the reference."""
    return DEVICE_MODELS.get(kind, CPU_HOST)


@dataclasses.dataclass
class RooflineTerms:
    """Three-term roofline of one step: per-device flops, HBM bytes and
    collective wire bytes, each over its rate; the bottleneck is the
    largest term."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    coll_breakdown: Dict[str, int]

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    coll_breakdown: Dict[str, int],
    chips: int,
    device: DeviceModel = H100,
) -> RooflineTerms:
    """Pure roofline arithmetic over one device model."""
    coll_total = float(sum(coll_breakdown.values()))
    compute_s = flops / device.peak_flops
    memory_s = hbm_bytes / device.hbm_bw
    collective_s = coll_total / device.net_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm_bytes, coll_bytes=coll_total, chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=max(terms, key=terms.get), coll_breakdown=coll_breakdown,
    )

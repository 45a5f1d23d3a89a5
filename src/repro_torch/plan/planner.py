"""Cost-model execution planner for the aggregation (port of
``repro/plan/planner.py``).

The aggregation takes five switches, ``backend`` ("torch" | "cuda"),
``topology`` ("psum" | "gather" | "ring" | "hier"), ``polar`` ("svd" |
"newton-schulz"), ``orth`` ("qr" | "cholesky-qr2") and ``comm_bits`` (32 |
16 | 8), plus the ring's ``ring_chunk``.  Given (m, d, r, n_iter, device
kind) the planner scores every valid cell with the bits-per-round model
(``repro_torch.comm.comm_cost``) and a compute / memory / latency
roofline priced by ``repro_torch.plan.roofline``'s device models, and
picks the cheapest feasible one.  Enumeration order, tie-breaks and the
scoring formula are the reference's.

Every aggregation entry point takes ``plan=``:

  * ``None``    - the per-knob defaults, byte-identical to the port
                  without a planner ("torch", "svd", "qr", "auto"
                  topology paired with the backend, 32 bits);
  * ``"auto"``  - the planner decides every knob left free; a concrete
                  knob is a pin; ``comm_bits`` stays pinned at 32 unless
                  the caller passes ``comm_bits="auto"``;
  * a ``Plan``  - used verbatim.

Where the port's rules differ from the reference's (each a named case in
``tests/test_torch_plan.py``, listed in ROADMAP C):

  * **The cuda backend runs on an sm_90 model only** (kind "h100"), in
    place of the reference's "pallas on TPU only".  Off it a cuda cell is
    infeasible unless pinned; a pinned one is noted "plain versions
    (correctness path)" and its compute pays ``interpret_penalty``: on
    CPU tensors the wrappers run their plain versions.
  * **The wrappers' own limits.**  B3 (the Gram + Newton-Schulz kernel of
    every non-fused cuda newton-schulz cell) refuses r past
    ``NS_GROUP_MAX_R``; on the sm_90 model those cells are infeasible
    there.
  * **B5/B6 past ``NS_SMEM_MAX_R``** run their Newton-Schulz steps one
    block a machine on a global workspace: on the sm_90 model the fused
    cells' compute is priced at that form's measured rate
    (``WIDE_ROUND_NS_FLOPS_S``), not at the card's peak.
  * **The fused ring's gate** is the staged stack in HBM (see
    ``fused_ring_hbm_bytes``), in place of the reference's VMEM envelope.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.comm.membership import Membership, resolve_membership
from repro_torch.comm.quantize import COMM_BITS, COMM_BITS_CHOICES, resolve_comm_bits
from repro_torch.comm.ring import DEFAULT_RING_CHUNK, chunk_spans
from repro_torch.comm.topology import TOPOLOGIES, TOPOLOGY_CHOICES, comm_cost
from repro_torch.core.orthonorm import ORTH_METHODS
from repro_torch.core.procrustes import DEFAULT_NS_ITERS, POLAR_METHODS
from repro_torch.kernels.ops import BACKENDS as BACKEND_CHOICES  # includes "auto"
from repro_torch.kernels.procrustes_align import NS_GROUP_MAX_R, NS_SMEM_MAX_R
from repro_torch.plan.calibration import Calibration
from repro_torch.plan.roofline import DeviceModel, device_model

__all__ = [
    "Plan",
    "CellScore",
    "BACKENDS_CONCRETE",
    "BACKEND_CHOICES",
    "TOPOLOGY_CHOICES",
    "POLAR_CHOICES",
    "ORTH_CHOICES",
    "COMM_BITS",
    "COMM_BITS_CHOICES",
    "PLAN_CHOICES",
    "MIN_RING_CHUNK",
    "WIDE_ROUND_NS_FLOPS_S",
    "choose_ring_chunk",
    "stacked_round_flops",
    "fused_ring_hbm_bytes",
    "score_cells",
    "plan_aggregation",
    "resolve_plan",
    "explain",
    "format_plan_table",
]

BACKENDS_CONCRETE = tuple(b for b in BACKEND_CHOICES if b != "auto")
POLAR_CHOICES = POLAR_METHODS + ("auto",)
ORTH_CHOICES = ORTH_METHODS + ("auto",)
PLAN_CHOICES = ("none", "auto")  # CLI spelling; "none" -> plan=None

# Operation counts of the scoring model (the reference's): a dense SVD
# ~26 r^3 FLOP, CholeskyQR2 ~10 plain ops, three plain stages a round.
_SVD_FLOP_COEFF = 26.0
_CHOLQR2_OPS = 10
_BASE_STAGE_OPS = 3  # gram, average, apply

MIN_RING_CHUNK = 256

# B5/B6 past NS_SMEM_MAX_R: one block a machine runs the 24 Newton-Schulz
# steps (4 r^3 FLOP each) on a global workspace.  The measured rate of a
# whole round a machine, 24 * 4 r^3 FLOP over the round's time: B5 at
# (8, 8192, 192) 4.857e10 and (8, 8192, 256) 4.758e10 FLOP/s, measured
# with tools/h100_model.py on an NVIDIA H100 80GB HBM3 at 700.00 W; their
# mean.
WIDE_ROUND_NS_FLOPS_S = 4.81e10

_SM90_KIND = "h100"


def choose_ring_chunk(
    d: int, r: int, device: Optional[DeviceModel] = None,
    *, bw: Optional[float] = None,
) -> int:
    """The ring's chunk: the smallest row count whose f32 payload covers
    the link's latency-bandwidth product, ``ceil(coll_latency * bw / (4
    r))``, floored at ``MIN_RING_CHUNK`` and capped at ``d``.  ``bw``
    defaults to ``device.net_bw`` (the hier pod ring passes ``dcn_bw``)."""
    device = device or device_model("cpu")
    latency_rows = math.ceil(
        device.coll_latency_s * (bw or device.net_bw) / (4.0 * max(r, 1))
    )
    return max(1, min(d, max(latency_rows, MIN_RING_CHUNK)))


def _polar_flops(polar: str, r: int) -> float:
    if polar == "svd":
        return _SVD_FLOP_COEFF * r**3
    return 4.0 * r**3 * DEFAULT_NS_ITERS  # two r x r matmuls a step


def _orth_flops(orth: str, d: int, r: int) -> float:
    # Householder QR ~4 d r^2; CholeskyQR2 two passes of (gram + solve)
    # ~6 d r^2.
    return (4.0 if orth == "qr" else 6.0) * d * r * r


def stacked_round_flops(
    *, m: int, d: int, r: int, n_iter: int, polar: str, orth: str
) -> float:
    """Flops of ``n_iter`` stacked refinement rounds (shared with
    ``calibration`` so both price the same work)."""
    n = max(n_iter, 1)
    return n * (
        4.0 * m * d * r * r + m * _polar_flops(polar, r) + _orth_flops(orth, d, r)
    )


def fused_ring_hbm_bytes(*, m: int, d: int, r: int, n_iter: int, comm_bits: int) -> float:
    """HBM the fused ring cell (B6, ``comm.ring.fused_ring_rounds``) holds
    at once on a rank.

    Every round's wire payload is staged before the first launch: one
    all-gather of the m (d, r) payloads at wire width (``comm_bits / 8``
    bytes an element) at 32 bits, where the payload is the same every
    round, and one a round (``n_iter`` stages) at 16 and 8 bits, each
    stage with its (m, r) f32 column scales at 8 bits.  The launches then
    keep five (d, r) f32 tiles: the reference, the averaged V-bar, the
    first CholeskyQR pass's Q and two outputs that alternate as the next
    round's reference.  (The r x r partials and factors are smaller than
    one tile.)  So ``stages * m * d r * bits / 8 + stages * m * r * 4 [8
    bits] + 5 * 4 d r``; the planner holds it to the same quarter of
    ``hbm_cap_bytes`` as the gather topology's stack.
    """
    stages = 1 if comm_bits == 32 else max(n_iter, 1)
    scales = stages * m * r * 4.0 if comm_bits == 8 else 0.0
    return stages * m * d * r * comm_bits / 8.0 + scales + 5 * 4.0 * d * r


@dataclasses.dataclass(frozen=True)
class CellScore:
    """One scored cell of the (backend x topology x polar x orth x
    comm_bits) cube."""

    backend: str
    topology: str
    polar: str
    orth: str
    comm_bits: int
    ring_chunk: int
    words: int            # logical collective payload (comm_cost.words)
    bits: int             # wire bits at comm_bits (comm_cost.bits)
    flops: float          # predicted per-device flops
    wire_bytes: float     # predicted per-device wire bytes
    hbm_bytes: float      # predicted per-device HBM bytes streamed
    comm_s: float
    compute_s: float
    memory_s: float
    latency_s: float
    total_s: float
    feasible: bool
    note: str = ""


@dataclasses.dataclass(frozen=True)
class Plan:
    """A fully resolved aggregation plan.  Hashable and concrete;
    ``ring_chunk`` is what the ring would use even when the ring is not
    chosen.  The prediction fields are provenance, excluded from equality
    (``compare=False``)."""

    backend: str
    topology: str
    polar: str
    orth: str
    ring_chunk: int
    comm_bits: int = 32
    # Pod count of the (pod, local) groups: nonzero iff topology is "hier".
    pods: int = 0
    words: int = dataclasses.field(default=0, compare=False)
    bits: int = dataclasses.field(default=0, compare=False)
    flops: float = dataclasses.field(default=0.0, compare=False)
    total_s: float = dataclasses.field(default=0.0, compare=False)
    device_kind: str = dataclasses.field(default="", compare=False)
    source: str = dataclasses.field(default="pinned", compare=False)


def _validate_pin(value: Optional[str], name: str, choices: Sequence[str]):
    """A knob value is a pin iff concrete; None/"auto" mean free."""
    if value is None or value == "auto":
        return None
    if value not in choices:
        raise ValueError(
            f"{name} must be one of {tuple(choices) + ('auto',)}, got {value!r}"
        )
    return value


def _default_device_kind(device=None) -> str:
    """The device kind to plan for: "h100" on an sm_90 card, else "cpu".
    ``device`` (a torch device) is where the work will run: a CPU device
    plans for the CPU whatever card the host has."""
    import torch

    from repro_torch.kernels.ops import on_sm90

    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    return _SM90_KIND if on_sm90() else "cpu"


def score_cells(
    *,
    m: int,
    d: int,
    r: int,
    n_iter: int = 1,
    device: Optional[DeviceModel] = None,
    device_kind: Optional[str] = None,
    backend: Optional[str] = None,
    topology: Optional[str] = None,
    polar: Optional[str] = None,
    orth: Optional[str] = None,
    ring_chunk: Optional[int] = None,
    comm_bits=None,
    ref_broadcast: bool = True,
    context: str = "collective",
    calibration: Optional[Calibration] = None,
    pods: Optional[int] = None,
) -> List[CellScore]:
    """Score every cell of the cube compatible with the pins.

    Enumeration order is the tie-break: backends in registry order
    (torch first), topologies (psum first), polars, orths, comm_bits (32
    first).  ``comm_bits=None`` pins 32; only ``"auto"`` frees the wire
    axis.  ``context="stacked"`` scores the already-gathered form (gather
    only, no wire).  ``pods`` declares the (pods, m/pods) groups: it
    unlocks the hier cells and prices every flat cell's wire at
    ``device.dcn_bw``.  Returns the cells sorted by (feasibility,
    predicted seconds, enumeration order).
    """
    if context not in ("collective", "stacked"):
        raise ValueError(f"context must be collective|stacked, got {context!r}")
    if device is None:
        device = device_model(device_kind or _default_device_kind())
    if calibration is not None and calibration.applies_to(device.kind):
        device = device.calibrated(
            dispatch_s=calibration.dispatch_s, flops_per_s=calibration.flops_per_s,
        )
    pin_b = _validate_pin(backend, "backend", BACKENDS_CONCRETE)
    pin_t = _validate_pin(topology, "topology", TOPOLOGIES)
    pin_p = _validate_pin(polar, "polar", POLAR_METHODS)
    pin_o = _validate_pin(orth, "orth", ORTH_METHODS)
    if pods is not None:
        pods = int(pods)
        if pods < 1 or (m >= 1 and m % pods):
            raise ValueError(f"pods={pods} does not tile m={m} into equal pods")
    if pin_t == "hier" and (pods is None or context == "stacked"):
        raise ValueError(
            "topology='hier' needs pods= (the (pod, local) groups) and the "
            "collective context"
        )
    backends = (pin_b,) if pin_b else BACKENDS_CONCRETE
    if pin_t:
        topos = (pin_t,)
    elif context == "stacked":
        topos = ("gather",)
    elif pods is not None:
        topos = TOPOLOGIES
    else:
        topos = tuple(t for t in TOPOLOGIES if t != "hier")
    polars = (pin_p,) if pin_p else POLAR_METHODS
    orths = (pin_o,) if pin_o else ORTH_METHODS
    if comm_bits == "auto" and context == "collective":
        cbs = COMM_BITS
    else:
        cbs = (resolve_comm_bits(None if comm_bits == "auto" else comm_bits),)

    scored = [
        _score_one(
            b, t, p, o, cb, m=m, d=d, r=r, n_iter=n_iter, device=device,
            ring_chunk=ring_chunk, ref_broadcast=ref_broadcast, context=context,
            backend_pinned=pin_b is not None, topology_pinned=pin_t is not None,
            pods=pods,
        )
        for b in backends for t in topos for p in polars for o in orths for cb in cbs
    ]
    # Stable sort: feasible first, then cheapest; enumeration breaks ties.
    scored.sort(key=lambda c: (not c.feasible, c.total_s))
    return scored


def _score_one(
    b: str, t: str, p: str, o: str, cb: int,
    *,
    m: int, d: int, r: int, n_iter: int,
    device: DeviceModel,
    ring_chunk: Optional[int],
    ref_broadcast: bool,
    context: str,
    backend_pinned: bool,
    topology_pinned: bool,
    pods: Optional[int] = None,
) -> CellScore:
    n = max(n_iter, 1)
    basis = d * r
    hier = t == "hier"
    n_pods = int(pods) if (hier and pods) else 0
    n_local = m // n_pods if n_pods else 0
    # The hier pod ring rides the slow link, so its chunk is sized there.
    chunk = ring_chunk if ring_chunk else choose_ring_chunk(
        d, r, device, bw=device.dcn_bw if hier else None
    )
    nchunks = len(chunk_spans(d, chunk))
    on_sm90 = device.kind == _SM90_KIND
    ns_chol = b == "cuda" and p == "newton-schulz" and o == "cholesky-qr2"
    # B5: the whole stacked round in one launch; B6: its ring sibling over
    # the staged wire stack.
    fused = ns_chol and t == "gather"
    fused_ring = ns_chol and t == "ring" and context == "collective"
    # Every other ring cell is priced as the reference prices it: its hop
    # compute as plain ops, whatever the backend.
    ring = t == "ring" and context == "collective" and not fused_ring
    kernels_in_play = b == "cuda" and not ring

    feasible = True
    notes: List[str] = []
    if b == "cuda" and not on_sm90:
        if backend_pinned:
            notes.append("plain versions (correctness path)")
        else:
            feasible = False
            notes.append("cuda kernels run on sm_90 only")
    if (on_sm90 and b == "cuda" and p == "newton-schulz" and not (fused or fused_ring)
            and r > NS_GROUP_MAX_R):
        feasible = False
        notes.append(f"B3 refuses r > {NS_GROUP_MAX_R}")
    if fused_ring:
        staged = fused_ring_hbm_bytes(m=m, d=d, r=r, n_iter=n, comm_bits=cb)
        if staged > 0.25 * device.hbm_cap_bytes:
            if topology_pinned:
                notes.append(f"staged ring stack {staged/2**30:.1f}GiB is memory-hostile")
            else:
                feasible = False
                notes.append(f"staged ring stack {staged/2**30:.1f}GiB over memory budget")

    if t == "psum" and cb == 8 and m > 126 and context == "collective":
        feasible = False
        notes.append("int8 psum overflow headroom needs m <= 126")

    # ---- communication ---------------------------------------------------
    intra_bytes = inter_bytes = 0.0
    if context == "stacked":
        words, bits, wire_bytes, colls = 0, 0, 0.0, 0
    else:
        cost = comm_cost(
            t, m=m, d=d, r=r, n_iter=n, ref_broadcast=ref_broadcast,
            comm_bits=cb, pods=n_pods if hier else None,
        )
        words, bits = cost.words, cost.bits
        wire_bytes = float(sum(v // 8 for v in cost.kind_bits.values()))
        bcast = 1 if ref_broadcast else 0
        if hier:
            intra_bytes = float(sum(v // 8 for v in cost.levels["intra"].values()))
            inter_bytes = float(sum(v // 8 for v in cost.levels["inter"].values()))
            colls = ((bcast + n) if n_local > 1 else 0) + (
                (bcast + n * (n_pods - 1)) if n_pods > 1 else 0
            )
            if cb == 8 and n_pods > 1:
                colls += bcast
        else:
            colls = {"psum": bcast + n, "gather": 1, "ring": bcast + n * (m - 1)}[t]
            if cb == 8:
                # The int8 scale rides as a second small collective a message.
                colls += {"psum": bcast + n, "gather": 1, "ring": bcast}[t]
        if fused_ring:
            # One staged gather for all rounds at 32 bits, one a round below.
            gathers = 1 if cb == 32 else n
            colls = bcast + gathers + ((bcast + gathers) if cb == 8 else 0)
    if m <= 1:
        words_wire, colls = 0.0, 0
        intra_bytes = inter_bytes = 0.0
    else:
        words_wire = wire_bytes
    if hier:
        intra_comm_s = intra_bytes / device.ici_bw
        inter_comm_s = inter_bytes / device.dcn_bw
        comm_s = intra_comm_s + inter_comm_s + colls * device.coll_latency_s
    else:
        intra_comm_s = inter_comm_s = 0.0
        wire_bw = device.dcn_bw if pods is not None else device.net_bw
        comm_s = words_wire / wire_bw + colls * device.coll_latency_s

    # ---- compute ---------------------------------------------------------
    bases = 1 if ((t == "psum" or hier) and context == "collective") else m
    flops = n * (
        4.0 * bases * d * r * r + bases * _polar_flops(p, r) + _orth_flops(o, d, r)
    )
    compute_s = flops / device.peak_flops
    if kernels_in_play and not on_sm90:
        compute_s *= device.interpret_penalty
    if (fused or fused_ring) and on_sm90 and r > NS_SMEM_MAX_R:
        # One block a machine runs the Newton-Schulz steps: the measured
        # round rate of that form, the machines side by side.
        compute_s = max(compute_s, n * _polar_flops(p, r) / WIDE_ROUND_NS_FLOPS_S)

    # ---- memory ----------------------------------------------------------
    if fused_ring:
        hbm_bytes = n * (bases * basis * (cb / 8.0) + 2 * basis * 4.0)
    else:
        stream_passes = 4 if fused else 2
        hbm_bytes = n * (stream_passes * bases + 2) * basis * 4.0
    memory_s = hbm_bytes / device.hbm_bw
    stack_bytes = m * basis * 4.0
    if t == "gather" and context == "collective" and stack_bytes > 0.25 * device.hbm_cap_bytes:
        if topology_pinned:
            notes.append(f"(m,d,r) stack {stack_bytes/2**30:.1f}GiB is memory-hostile")
        else:
            feasible = False
            notes.append(f"(m,d,r) stack {stack_bytes/2**30:.1f}GiB over memory budget")

    # ---- fixed latency (ops, launches, LAPACK calls) ---------------------
    polar_ops = 0 if p == "svd" else 2 * DEFAULT_NS_ITERS
    orth_ops = 0 if o == "qr" else _CHOLQR2_OPS
    polar_lapack = 1 if p == "svd" else 0
    orth_lapack = 1 if o == "qr" else 0
    if ring:
        ops = n * (
            (m - 1) * (2 * nchunks + polar_ops)
            + (_BASE_STAGE_OPS + polar_ops)
            + orth_ops
        )
        launches = 0
        lapack = n * (m * polar_lapack + orth_lapack)
    elif b == "cuda":
        if fused or fused_ring:
            ops, launches, lapack = 0, n, 0
        else:
            launches = n * 2  # Gram (+ Newton-Schulz) kernel, apply kernel
            ops = n * orth_ops
            lapack = n * (polar_lapack + orth_lapack)
    else:
        ops = n * (_BASE_STAGE_OPS + polar_ops + orth_ops)
        launches = 0
        lapack = n * (polar_lapack + orth_lapack)
    if hier and n_pods > 1:
        ops += n * (n_pods - 1) * 2 * nchunks
    if cb != 32 and context == "collective":
        # The wire codec's encode/decode ops: 32 stays strictly cheapest
        # where the wire saves nothing.
        ops += (1 if cb == 16 else 3) * (n + 1)
    latency_s = (
        ops * device.op_latency_s
        + launches * device.launch_latency_s
        + lapack * device.lapack_latency_s
    )

    # ---- total -----------------------------------------------------------
    if (ring or fused_ring) and m > 1:
        # The ring's wire overlaps its compute.
        total_s = max(comm_s, compute_s, memory_s) + latency_s
    elif hier and m > 1:
        total_s = (
            max(inter_comm_s, compute_s, memory_s)
            + intra_comm_s + colls * device.coll_latency_s + latency_s
        )
    else:
        total_s = comm_s + max(compute_s, memory_s) + latency_s

    return CellScore(
        backend=b, topology=t, polar=p, orth=o, comm_bits=cb, ring_chunk=chunk,
        words=words, bits=bits, flops=flops, wire_bytes=wire_bytes,
        hbm_bytes=hbm_bytes, comm_s=comm_s, compute_s=compute_s,
        memory_s=memory_s, latency_s=latency_s, total_s=total_s,
        feasible=feasible, note="; ".join(notes),
    )


def plan_aggregation(
    *,
    m: int,
    d: int,
    r: int,
    n_iter: int = 1,
    device_kind: Optional[str] = None,
    backend: Optional[str] = None,
    topology: Optional[str] = None,
    polar: Optional[str] = None,
    orth: Optional[str] = None,
    ring_chunk: Optional[int] = None,
    comm_bits=None,
    ref_broadcast: bool = True,
    context: str = "collective",
    calibration: Optional[Calibration] = None,
    pods: Optional[int] = None,
) -> Plan:
    """Score the cube and return the cheapest feasible plan.

    Pins restrict the enumeration; if they leave only infeasible cells the
    cheapest pinned cell is returned with its note (pins are the caller's
    decision).  On a one-shard axis every schedule is the same program, so
    the planner keeps the legacy backend/topology pairing ("gather" under
    "cuda", "psum" otherwise) rather than let float ties pick.
    """
    kind = device_kind or _default_device_kind()
    pin_t = _validate_pin(topology, "topology", TOPOLOGIES)
    degenerate_axis = context == "collective" and m <= 1 and pin_t is None

    def _choose(topo_pin):
        return score_cells(
            m=m, d=d, r=r, n_iter=n_iter, device_kind=kind,
            backend=backend, topology=topo_pin, polar=polar, orth=orth,
            ring_chunk=ring_chunk, comm_bits=comm_bits,
            ref_broadcast=ref_broadcast, context=context,
            calibration=calibration, pods=pods,
        )[0]

    if degenerate_axis:
        b_guess = _validate_pin(backend, "backend", BACKENDS_CONCRETE) or (
            "cuda" if device_model(kind).kind == _SM90_KIND else "torch"
        )
        best = _choose("gather" if b_guess == "cuda" else "psum")
        if best.backend != b_guess:
            best = _choose("gather" if best.backend == "cuda" else "psum")
    else:
        best = _choose(topology)
    return Plan(
        backend=best.backend, topology=best.topology, polar=best.polar,
        orth=best.orth, ring_chunk=best.ring_chunk, comm_bits=best.comm_bits,
        pods=(pods or 0) if best.topology == "hier" else 0,
        words=best.words, bits=best.bits, flops=best.flops, total_s=best.total_s,
        device_kind=kind, source="planner",
    )


def resolve_plan(
    plan: Union[None, str, Plan],
    *,
    m: int,
    d: int,
    r: int,
    n_iter: int = 1,
    backend: Optional[str] = None,
    topology: Optional[str] = None,
    polar: Optional[str] = None,
    orth: Optional[str] = None,
    ring_chunk: Optional[int] = None,
    comm_bits=None,
    ref_broadcast: bool = True,
    context: str = "collective",
    device_kind: Optional[str] = None,
    calibration: Optional[Calibration] = None,
    membership: Optional[Membership] = None,
    pods: Optional[int] = None,
    tensor_device=None,
) -> Plan:
    """The one resolution funnel of every aggregation entry point.

    ``plan=None`` is the port's per-knob resolution: backend
    ``kops.resolve_backend(backend or "torch", tensor_device)``, topology
    ``resolve_topology`` paired with it (collective context) or "gather",
    polar "svd", orth "qr", ``ring_chunk`` ``DEFAULT_RING_CHUNK``, 32 bits;
    a leftover "auto" polar, orth or comm_bits is planned alone with the
    rest pinned.  ``plan="auto"`` plans every free knob; a ``Plan`` is
    returned as is.

    ``tensor_device`` is where the work runs (a torch device): it resolves
    the legacy "auto" backend and, unless ``device_kind`` is given, the
    kind planned for.  ``membership`` prices planning paths at the
    survivor count m' (the fresh m'-shard job a masked round equals) and
    the legacy path's provenance at the physical wire; with ``pods``
    planning stays at the physical m.
    """
    from repro_torch.comm.topology import resolve_topology
    from repro_torch.kernels.ops import resolve_backend

    if isinstance(plan, Plan):
        return plan
    if device_kind is None:
        device_kind = _default_device_kind(tensor_device)
    mem = resolve_membership(membership, m)
    m_eff = mem.m_active if pods is None else m
    if plan is None:
        on = tensor_device if tensor_device is not None else (
            "cuda" if device_kind == _SM90_KIND else "cpu")
        b = resolve_backend(backend or "torch", on)
        t = (resolve_topology(topology or "auto", b)
             if context == "collective" else "gather")
        p = polar or "svd"
        o = orth or "qr"
        chunk = DEFAULT_RING_CHUNK if ring_chunk is None else ring_chunk
        if t == "hier" and (pods is None or pods < 1 or m % pods):
            raise ValueError(
                "topology='hier' needs pods= (m = pods * local); got "
                f"pods={pods!r} for m={m}"
            )
        if "auto" in (p, o) or comm_bits == "auto":
            return plan_aggregation(
                m=m_eff, d=d, r=r, n_iter=n_iter, device_kind=device_kind,
                backend=b, topology=t if context == "collective" else None,
                polar=p, orth=o, ring_chunk=chunk, comm_bits=comm_bits,
                ref_broadcast=ref_broadcast, context=context,
                calibration=calibration, pods=pods,
            )
        cb = resolve_comm_bits(comm_bits)
        if context == "collective":
            cost = comm_cost(t, m=m, d=d, r=r, n_iter=max(n_iter, 1),
                             ref_broadcast=ref_broadcast, comm_bits=cb,
                             membership=mem, pods=pods if t == "hier" else None)
            cost_words, cost_bits = cost.words, cost.bits
        else:
            cost_words, cost_bits = 0, 0
        return Plan(
            backend=b, topology=t, polar=p, orth=o, ring_chunk=chunk,
            comm_bits=cb, pods=(pods or 0) if t == "hier" else 0,
            words=cost_words, bits=cost_bits, device_kind=device_kind,
            source="legacy",
        )
    if plan == "auto":
        return plan_aggregation(
            m=m_eff, d=d, r=r, n_iter=n_iter, device_kind=device_kind,
            backend=backend, topology=topology, polar=polar, orth=orth,
            ring_chunk=ring_chunk, comm_bits=comm_bits,
            ref_broadcast=ref_broadcast, context=context,
            calibration=calibration, pods=pods,
        )
    raise ValueError(f"plan must be None, 'auto', or a Plan, got {plan!r}")


# ---------------------------------------------------------------------------
# Explanation / table rendering (the launcher's --explain).


def format_plan_table(cells: Sequence[CellScore], chosen: Plan) -> str:
    """Render the scored cells plus the chosen-cell summary line (its
    words and bits are ``comm_cost``'s for that cell)."""
    def is_chosen(c: CellScore) -> bool:
        return (
            c.backend == chosen.backend and c.topology == chosen.topology
            and c.polar == chosen.polar and c.orth == chosen.orth
            and c.comm_bits == chosen.comm_bits
        )

    hdr = (
        f"{'backend':<8} {'topology':<8} {'polar':<14} {'orth':<13} "
        f"{'cbits':>5} {'chunk':>6} {'words':>12} {'bits':>14} "
        f"{'flops':>10} {'comm_us':>9} "
        f"{'comp_us':>9} {'mem_us':>8} {'lat_us':>8} {'total_us':>9}  note"
    )
    lines = [hdr, "-" * len(hdr)]
    for c in cells:
        mark = "*" if is_chosen(c) else (" " if c.feasible else "x")
        lines.append(
            f"{c.backend:<8} {c.topology:<8} {c.polar:<14} {c.orth:<13} "
            f"{c.comm_bits:>5} {c.ring_chunk:>6} {c.words:>12} "
            f"{c.bits:>14} {c.flops:>10.3g} "
            f"{c.comm_s*1e6:>9.2f} {c.compute_s*1e6:>9.2f} "
            f"{c.memory_s*1e6:>8.2f} {c.latency_s*1e6:>8.2f} "
            f"{c.total_s*1e6:>9.2f}  {mark} {c.note}"
        )
    chosen_cell = next((c for c in cells if is_chosen(c)), None)
    words = chosen_cell.words if chosen_cell else chosen.words
    bits = chosen_cell.bits if chosen_cell else chosen.bits
    flops = chosen_cell.flops if chosen_cell else chosen.flops
    total_s = chosen_cell.total_s if chosen_cell else chosen.total_s
    runner = next((c for c in cells if c.feasible and not is_chosen(c)), None)
    why = ""
    if runner is not None and chosen_cell is not None:
        hi, lo = (
            (runner, chosen_cell)
            if runner.total_s >= chosen_cell.total_s
            else (chosen_cell, runner)
        )
        deltas = {
            "comm": hi.comm_s - lo.comm_s,
            "compute": hi.compute_s - lo.compute_s,
            "memory": hi.memory_s - lo.memory_s,
            "latency": hi.latency_s - lo.latency_s,
        }
        decisive = max(deltas, key=lambda k: deltas[k])
        label = (
            "runner-up"
            if chosen_cell.feasible and is_chosen(cells[0])
            else "planner pick"
        )
        why = (
            f"; {label} {runner.backend}/{runner.topology}/{runner.polar}/"
            f"{runner.orth} at {runner.total_s*1e6:.2f}us (decisive term: "
            f"{decisive})"
        )
    lines.append(
        f"chosen: {chosen.backend}/{chosen.topology}/{chosen.polar}/"
        f"{chosen.orth} ring_chunk={chosen.ring_chunk} "
        f"comm_bits={chosen.comm_bits} "
        f"words={words} bits={bits} flops={flops:.6g} "
        f"predicted_total_us={total_s*1e6:.2f}{why}"
    )
    return "\n".join(lines)


def explain(
    *,
    m: int,
    d: int,
    r: int,
    n_iter: int = 1,
    device_kind: Optional[str] = None,
    backend: Optional[str] = None,
    topology: Optional[str] = None,
    polar: Optional[str] = None,
    orth: Optional[str] = None,
    ring_chunk: Optional[int] = None,
    comm_bits=None,
    ref_broadcast: bool = True,
    context: str = "collective",
    calibration: Optional[Calibration] = None,
    plan: Union[None, str, Plan] = "auto",
    pods: Optional[int] = None,
) -> Tuple[Plan, str]:
    """Score the cube and render the table; returns (plan, table_text).
    ``plan`` picks the cell the table marks chosen (default the planner's
    pick; a ``Plan`` or ``None`` marks the cell that will run)."""
    kind = device_kind or _default_device_kind()
    kwargs = dict(
        m=m, d=d, r=r, n_iter=n_iter, device_kind=kind,
        backend=backend, topology=topology, polar=polar, orth=orth,
        ring_chunk=ring_chunk, comm_bits=comm_bits, ref_broadcast=ref_broadcast,
        context=context, calibration=calibration, pods=pods,
    )
    cells = score_cells(**kwargs)
    chosen = resolve_plan(plan, **kwargs)
    header = (
        f"# plan[{chosen.source}]: m={m} d={d} r={r} n_iter={n_iter} "
        + (f"pods={pods} " if pods else "")
        + f"device={kind}"
        + (f" calibration={calibration.source}" if calibration else "")
    )
    return chosen, header + "\n" + format_plan_table(cells, chosen)

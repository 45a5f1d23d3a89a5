"""Port parity of the execution planner (``repro_torch.plan`` against
``repro.plan``), and the port's own rules.

* Every scored cell of ``score_cells`` (backends mapped xla -> torch,
  pallas -> cuda): the same cells, in the same order, with the same
  feasibility, words, bits and ring chunk, and seconds, flops and bytes
  to 1e-12 relative, on the reference's CPU, TPU and generic-GPU models
  (built from the reference's objects and passed as ``device=``), at the
  shapes and pins of ``tests/test_plan.py``'s golden, monotonicity,
  ring-chunk, int8-headroom and dcn cases, ``comm_bits="auto"`` and
  ``pods=``.  Where one of the port's rules applies (ROADMAP C: the cuda
  backend on an sm_90 model only; the fused ring's HBM gate) the cell
  differs exactly as the rule says, and the rule has a named case below.
* ``plan_aggregation`` and ``resolve_plan`` (``None``, ``"auto"``, a
  ``Plan``, a degraded membership) against the reference's on the CPU.
* ``load_calibration`` on the committed sweeps gives the reference's
  constants.
* The H100 model and the rules that only it triggers: B3's r limit,
  B5/B6 past ``NS_SMEM_MAX_R`` priced at their measured rate.
"""

from __future__ import annotations

import dataclasses
import math
import os

import pytest

import repro.plan.planner as jp
import repro.plan.roofline as jr
from conftest import REPO
from repro.comm.membership import Membership as JMembership
from repro.plan.calibration import load_calibration as j_load_calibration
from repro_torch.comm import Membership, comm_cost
from repro_torch.kernels.procrustes_align import NS_GROUP_MAX_R, NS_SMEM_MAX_R
import repro_torch.plan.planner as tp
import repro_torch.plan.roofline as tr
from repro_torch.plan import Calibration, Plan, device_model, load_calibration

BACKEND = {"xla": "torch", "pallas": "cuda"}
REF_BACKEND = {v: k for k, v in BACKEND.items()}
NUMBERS = ("flops", "wire_bytes", "hbm_bytes", "comm_s", "compute_s",
           "memory_s", "latency_s", "total_s")


def _port_model(model: jr.DeviceModel) -> tr.DeviceModel:
    return tr.DeviceModel(**{f.name: getattr(model, f.name)
                             for f in dataclasses.fields(jr.DeviceModel)})


REF_MODELS = {"cpu": jr.CPU_HOST, "tpu": jr.TPU_V5E, "gpu": jr.GPU_GENERIC}

# Shapes and pins of test_plan.py's cases (backend pins in the reference's
# names; the port's are mapped).
SHAPES = [
    dict(m=8, d=512, r=16, n_iter=2),
    dict(m=64, d=65536, r=128, n_iter=1),
    dict(m=64, d=65536, r=128, n_iter=1, comm_bits="auto"),
    dict(m=8, d=512, r=16, n_iter=2, comm_bits="auto"),
    dict(m=200, d=65536, r=128, n_iter=1, comm_bits="auto"),
    dict(m=8, d=512, r=16, n_iter=2, backend="xla"),
    dict(m=8, d=512, r=16, n_iter=2, backend="pallas"),
    dict(m=2048, d=65536, r=128, n_iter=1),
    dict(m=2048, d=65536, r=128, n_iter=1, topology="gather"),
    dict(m=64, d=8192, r=128, n_iter=3),
    dict(m=2, d=96, r=4, n_iter=1),
    dict(m=8, d=96, r=4, n_iter=1, topology="ring", ring_chunk=40),
    dict(m=8, d=96, r=4, n_iter=1, topology="ring"),
    dict(m=8, d=96, r=4, n_iter=2, pods=4),
    dict(m=2048, d=65536, r=128, n_iter=1, comm_bits=8),
    dict(m=2048, d=65536, r=128, n_iter=1, comm_bits=8, pods=64),
    dict(m=8, d=512, r=16, n_iter=2, context="stacked"),
    dict(m=8, d=8192, r=128, n_iter=2, context="stacked"),
    dict(m=1, d=64, r=4),
    dict(m=8, d=512, r=16, n_iter=2, ref_broadcast=False, comm_bits=16),
    dict(m=16, d=2048, r=64, n_iter=5, polar="newton-schulz", orth="cholesky-qr2"),
]


def _port_kw(kw: dict) -> dict:
    kw = dict(kw)
    if "backend" in kw:
        kw["backend"] = BACKEND[kw["backend"]]
    return kw


def _key(c, mapped=False):
    b = BACKEND[c.backend] if mapped else c.backend
    return (b, c.topology, c.polar, c.orth, c.comm_bits)


def _rule(model: jr.DeviceModel, kw: dict, cell) -> str | None:
    """The port's rule that changes ``cell`` on ``model`` at ``kw``, if any."""
    if cell.backend == "cuda" and model.kind == "tpu":
        return "cuda on sm_90 only"
    fused_ring = (cell.backend == "cuda" and cell.topology == "ring"
                  and cell.polar == "newton-schulz" and cell.orth == "cholesky-qr2"
                  and kw.get("context", "collective") == "collective")
    if fused_ring:
        n = max(kw.get("n_iter", 1), 1)
        basis = kw["d"] * kw["r"]
        vmem_ok = basis * (3 * cell.comm_bits / 8.0 + 12.0) <= model.vmem_cap_bytes
        staged = tp.fused_ring_hbm_bytes(m=kw["m"], d=kw["d"], r=kw["r"], n_iter=n,
                                         comm_bits=cell.comm_bits)
        hbm_ok = staged <= 0.25 * model.hbm_cap_bytes or "topology" in kw
        if vmem_ok != hbm_ok:
            return "fused ring HBM gate"
    return None


def _same_numbers(a, b):
    return all(math.isclose(getattr(a, f), getattr(b, f), rel_tol=1e-12, abs_tol=0.0)
               for f in NUMBERS)


@pytest.mark.parametrize("kw", SHAPES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("kind", sorted(REF_MODELS))
def test_every_scored_cell_matches_reference(kind, kw):
    model = REF_MODELS[kind]
    want = jp.score_cells(device=model, **kw)
    got = tp.score_cells(device=_port_model(model), **_port_kw(kw))
    assert len(got) == len(want)
    by_key = {_key(c): c for c in got}
    ruled = False
    for w in want:
        g = by_key[_key(w, mapped=True)]
        rule = _rule(model, kw, g)
        assert (g.words, g.bits, g.ring_chunk) == (w.words, w.bits, w.ring_chunk), w
        for f in ("flops", "wire_bytes", "hbm_bytes", "comm_s", "memory_s", "latency_s"):
            assert math.isclose(getattr(g, f), getattr(w, f), rel_tol=1e-12), (f, w)
        if rule is None:
            assert g.feasible == w.feasible, (w, g)
            assert _same_numbers(g, w), (w, g)
            continue
        ruled = True
        if rule == "cuda on sm_90 only":
            pinned = "backend" in kw
            assert g.feasible == (w.feasible if pinned else False), (w, g)
            assert ("plain versions (correctness path)" if pinned
                    else "cuda kernels run on sm_90 only") in g.note
        else:
            # Exactly one of the two gates fires; a verdict that differs is
            # the gate's.
            assert ("VMEM" in w.note) != ("staged ring stack" in g.note), (w, g)
            if g.feasible != w.feasible:
                assert ("over memory budget" in g.note) or ("VMEM" in w.note), (w, g)
    if not ruled:
        assert [_key(c) for c in got] == [_key(c, mapped=True) for c in want]


@pytest.mark.parametrize("kw", SHAPES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_plan_aggregation_matches_reference_on_the_cpu(kw):
    kw = {k: v for k, v in kw.items() if k != "ref_broadcast"}
    want = jp.plan_aggregation(device_kind="cpu", **kw)
    got = tp.plan_aggregation(device_kind="cpu", **_port_kw(kw))
    assert (got.backend, got.topology, got.polar, got.orth, got.ring_chunk,
            got.comm_bits, got.pods, got.words, got.bits) == (
        BACKEND[want.backend], want.topology, want.polar, want.orth,
        want.ring_chunk, want.comm_bits, want.pods, want.words, want.bits)
    assert math.isclose(got.total_s, want.total_s, rel_tol=1e-12)
    assert got.source == "planner" and got.device_kind == "cpu"


@pytest.mark.parametrize("topology", ["psum", "gather", "ring", "hier"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_monotone_cells_match_reference(topology, backend):
    """The monotonicity case of test_plan.py: one pinned cell grown along
    each of m, d, r, n_iter, on the TPU model; the port prices the same
    numbers (cuda off sm_90 pays the plain versions' penalty: compute
    only)."""
    pods = 4 if topology == "hier" else None
    model = jr.TPU_V5E
    base = dict(m=8, d=512, r=16, n_iter=2)
    for knob, bigger in ((None, None), ("m", 16), ("d", 2048), ("r", 64), ("n_iter", 5)):
        args = dict(base, **({knob: bigger} if knob else {}))
        kw = dict(args, backend=backend, topology=topology, polar="newton-schulz",
                  orth="cholesky-qr2", pods=pods)
        [w] = jp.score_cells(device=model, **kw)
        [g] = tp.score_cells(device=_port_model(model), **_port_kw(kw))
        assert (g.words, g.bits) == (w.words, w.bits)
        for f in ("flops", "wire_bytes", "hbm_bytes", "comm_s", "memory_s", "latency_s"):
            assert math.isclose(getattr(g, f), getattr(w, f), rel_tol=1e-12), f


def test_ring_chunk_rule_matches_reference():
    for kind, model in REF_MODELS.items():
        for d in (64, 512, 1024, 8192, 16384):
            for r in (4, 16, 64, 128, 256):
                for bw in (None, model.dcn_bw / 3):
                    assert tp.choose_ring_chunk(d, r, _port_model(model), bw=bw) == \
                        jp.choose_ring_chunk(d, r, model, bw=bw), (kind, d, r)
    assert tp.choose_ring_chunk(8192, 128) == jp.choose_ring_chunk(8192, 128)


def test_stacked_round_flops_and_registries_match_reference():
    for p in ("svd", "newton-schulz"):
        for o in ("qr", "cholesky-qr2"):
            kw = dict(m=8, d=8192, r=128, n_iter=2, polar=p, orth=o)
            assert tp.stacked_round_flops(**kw) == jp.stacked_round_flops(**kw)
    assert tp.POLAR_CHOICES == jp.POLAR_CHOICES and tp.ORTH_CHOICES == jp.ORTH_CHOICES
    assert tp.TOPOLOGY_CHOICES == jp.TOPOLOGY_CHOICES
    assert tp.COMM_BITS == jp.COMM_BITS and tp.COMM_BITS_CHOICES == jp.COMM_BITS_CHOICES
    assert tp.PLAN_CHOICES == jp.PLAN_CHOICES and tp.MIN_RING_CHUNK == jp.MIN_RING_CHUNK
    assert tp.BACKENDS_CONCRETE == tuple(BACKEND[b] for b in jp.BACKENDS_CONCRETE)


# ------------------------------------------------------------ resolve_plan --

RESOLVE_CASES = [
    dict(),
    dict(backend="torch"),
    dict(backend="cuda"),
    dict(polar="newton-schulz", orth="cholesky-qr2"),
    dict(topology="ring", ring_chunk=40),
    dict(topology="psum", comm_bits=8),
    dict(polar="auto"),
    dict(comm_bits="auto"),
    dict(context="stacked"),
    dict(topology="hier", pods=4),
]


def _ref_kw(kw):
    kw = dict(kw)
    if "backend" in kw:
        kw["backend"] = REF_BACKEND[kw["backend"]]
    return kw


@pytest.mark.parametrize("plan", [None, "auto"])
@pytest.mark.parametrize("kw", RESOLVE_CASES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
@pytest.mark.parametrize("dead", [(), (3,)])
def test_resolve_plan_matches_reference(plan, kw, dead):
    """``None`` (the per-knob defaults, the legacy "auto" knobs planned
    alone), ``"auto"`` and a degraded membership (planning at m')."""
    m, d, r = 8, 96, 4
    jm = JMembership.from_dead(m, dead) if dead else None
    tm = Membership.from_dead(m, dead) if dead else None
    want = jp.resolve_plan(plan, m=m, d=d, r=r, n_iter=2, device_kind="cpu",
                           membership=jm, **_ref_kw(kw))
    got = tp.resolve_plan(plan, m=m, d=d, r=r, n_iter=2, device_kind="cpu",
                          membership=tm, tensor_device="cpu", **kw)
    assert (got.backend, got.topology, got.polar, got.orth, got.ring_chunk,
            got.comm_bits, got.pods, got.words, got.bits, got.source) == (
        BACKEND[want.backend], want.topology, want.polar, want.orth,
        want.ring_chunk, want.comm_bits, want.pods, want.words, want.bits,
        want.source)


def test_resolve_plan_passes_a_plan_through_and_ignores_provenance():
    pl = Plan("cuda", "ring", "newton-schulz", "cholesky-qr2", 40, comm_bits=8)
    assert tp.resolve_plan(pl, m=8, d=96, r=4) is pl
    twin = dataclasses.replace(pl, words=1, total_s=2.0, source="planner")
    assert twin == pl and hash(twin) == hash(pl)
    assert dataclasses.replace(pl, comm_bits=32) != pl
    with pytest.raises(ValueError, match="plan must be"):
        tp.resolve_plan("fast", m=8, d=96, r=4)


def test_legacy_auto_backend_follows_the_tensor_device():
    """plan=None resolves backend "auto" on the tensors' device, as the
    port did before the planner: the CPU runs the plain path."""
    pl = tp.resolve_plan(None, m=4, d=64, r=4, backend="auto", tensor_device="cpu")
    assert (pl.backend, pl.topology) == ("torch", "psum")
    assert tp.resolve_plan(None, m=4, d=64, r=4, backend="auto",
                           tensor_device="cpu", context="stacked").topology == "gather"


def test_default_device_kind(monkeypatch):
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "on_sm90", lambda: True)
    assert tp._default_device_kind() == "h100"
    assert tp._default_device_kind("cuda") == "h100"
    assert tp._default_device_kind("cpu") == "cpu"  # a CPU-pinned call
    monkeypatch.setattr(ops, "on_sm90", lambda: False)
    assert tp._default_device_kind() == "cpu"


def test_explain_chosen_line_matches_comm_cost():
    for kw in (dict(m=8, d=512, r=16, n_iter=2), dict(m=8, d=96, r=4, n_iter=2, pods=4),
               dict(m=8, d=8192, r=128, n_iter=2, context="stacked")):
        pl, table = tp.explain(device_kind="cpu", **kw)
        want_pl, want_table = jp.explain(device_kind="cpu", **kw)
        chosen = table.splitlines()[-1]
        assert chosen.startswith(f"chosen: {pl.backend}/{pl.topology}/{pl.polar}/{pl.orth} ")
        if kw.get("context") != "stacked":
            cost = comm_cost(pl.topology, m=kw["m"], d=kw["d"], r=kw["r"],
                             n_iter=kw["n_iter"], comm_bits=pl.comm_bits,
                             pods=kw.get("pods") if pl.topology == "hier" else None)
            assert f"words={cost.words} bits={cost.bits} " in chosen
        # The same table as the reference's, backends renamed.
        assert len(table.splitlines()) == len(want_table.splitlines())
        assert chosen.split(" predicted_total_us")[0].replace("torch/", "xla/").replace(
            "cuda/", "pallas/") == want_table.splitlines()[-1].split(" predicted_total_us")[0]


# ------------------------------------------------------------- calibration --

@pytest.mark.parametrize("name", ["BENCH_aggregate.json", "BENCH_aggregate_tiny.json"])
def test_load_calibration_matches_reference(name):
    path = os.path.join(REPO, name)
    got, want = load_calibration(path), j_load_calibration(path)
    assert (got.platform, got.dispatch_s, got.flops_per_s, got.cells, got.source) == (
        want.platform, want.dispatch_s, want.flops_per_s, want.cells, want.source)
    assert got.platform == "cpu" and got.applies_to("cpu") and not got.applies_to("h100")
    pl = tp.plan_aggregation(m=8, d=512, r=16, n_iter=2, device_kind="cpu", calibration=got)
    ref = jp.plan_aggregation(m=8, d=512, r=16, n_iter=2, device_kind="cpu",
                              calibration=want)
    assert (pl.backend, pl.polar, pl.orth, pl.topology) == (
        BACKEND[ref.backend], ref.polar, ref.orth, ref.topology)
    assert math.isclose(pl.total_s, ref.total_s, rel_tol=1e-12)


def test_calibration_degrades_and_refines():
    empty = Calibration.from_records("h100", [])
    assert empty.cells == 0 and empty.dispatch_s is None
    h = device_model("h100")
    assert h.calibrated(dispatch_s=None, flops_per_s=None) == h
    recs = [dict(topology="stacked", mode="compiled", wall_us_min=100.0, m=4, d=64, r=4,
                 n_iter=1, polar="svd", orth="qr"),
            dict(topology="stacked", mode="compiled", wall_us_min=9000.0, m=16, d=4096,
                 r=64, n_iter=2, polar="svd", orth="qr"),
            dict(topology="stacked", mode="interpret", wall_us_min=5.0, m=4, d=64, r=4)]
    cal = Calibration.from_records("h100", recs)
    assert cal.cells == 2 and cal.dispatch_s == pytest.approx(100e-6)
    tuned = h.calibrated(dispatch_s=cal.dispatch_s, flops_per_s=cal.flops_per_s)
    assert tuned.launch_latency_s == pytest.approx(100e-6)
    assert tuned.peak_flops == pytest.approx(cal.flops_per_s)
    # A calibration applies to its own device kind only.
    a = tp.score_cells(m=8, d=512, r=16, device_kind="cpu", calibration=cal)
    assert a == tp.score_cells(m=8, d=512, r=16, device_kind="cpu")


# --------------------------------------------------------- the port's rules --

def test_models_carry_no_tpu_constants():
    assert set(tr.DEVICE_MODELS) == {"cpu", "h100"}
    assert not hasattr(tr, "TPU_V5E") and not hasattr(tr, "GPU_GENERIC")
    assert device_model("tpu") is tr.CPU_HOST and device_model("gpu") is tr.CPU_HOST
    for f in dataclasses.fields(jr.DeviceModel):
        assert getattr(tr.CPU_HOST, f.name) == getattr(jr.CPU_HOST, f.name), f.name
    h = tr.H100
    assert (h.kind, h.peak_flops, h.hbm_bw, h.net_bw, h.dcn_bw, h.hbm_cap_bytes) == (
        "h100", 67e12, 3.35e12, 450e9, 50e9, 80e9)
    assert h.ici_bw == h.net_bw
    for f in ("op_latency_s", "launch_latency_s", "lapack_latency_s", "coll_latency_s"):
        assert 0 < getattr(h, f) < 1, f
    terms = tr.roofline_terms(67e12, 3.35e12, {"all-reduce": 450e9}, 1, h)
    assert (terms.compute_s, terms.memory_s, terms.collective_s) == (1.0, 1.0, 1.0)


def test_rule_cuda_runs_on_an_sm90_model_only():
    """Named port rule 1: off the h100 model a cuda cell is infeasible
    unless pinned; pinned, it runs the wrappers' plain versions and pays
    the penalty (the reference's "pallas on TPU only", moved to sm_90)."""
    cells = tp.score_cells(m=8, d=512, r=16, device_kind="cpu")
    assert all(not c.feasible and "sm_90" in c.note for c in cells if c.backend == "cuda")
    pinned = tp.plan_aggregation(m=8, d=512, r=16, device_kind="cpu", backend="cuda")
    assert pinned.backend == "cuda"
    cell = tp.score_cells(m=8, d=512, r=16, device_kind="cpu", backend="cuda",
                          topology="gather", polar="svd", orth="qr")[0]
    assert cell.feasible and cell.note == "plain versions (correctness path)"
    # The reference's TPU model: its pallas cells are feasible, the port's
    # cuda cells are not (kind "tpu" is not sm_90).
    tpu = _port_model(jr.TPU_V5E)
    assert all(not c.feasible for c in tp.score_cells(device=tpu, m=8, d=512, r=16)
               if c.backend == "cuda")
    assert any(c.feasible for c in jp.score_cells(device=jr.TPU_V5E, m=8, d=512, r=16)
               if c.backend == "pallas")
    # On the h100 model they are feasible and take no penalty.
    h = tp.score_cells(m=8, d=512, r=16, device_kind="h100", backend="cuda",
                       topology="gather", polar="svd", orth="qr")[0]
    assert h.feasible and h.note == ""
    assert math.isclose(h.compute_s, h.flops / tr.H100.peak_flops)


def test_rule_b3_refuses_past_its_group_limit():
    """Named port rule 2: on the h100 model the non-fused cuda
    newton-schulz cells (B3) are infeasible past NS_GROUP_MAX_R, where the
    wrapper raises; the fused cells (B5/B6) and the plain ones stay."""
    for r, refused in ((NS_GROUP_MAX_R, False), (NS_GROUP_MAX_R + 8, True)):
        cells = tp.score_cells(m=2, d=4 * r, r=r, n_iter=1, device_kind="h100")
        b3 = [c for c in cells if c.backend == "cuda" and c.polar == "newton-schulz"
              and not (c.orth == "cholesky-qr2" and c.topology in ("gather", "ring"))]
        assert b3 and all((not c.feasible) == refused for c in b3)
        assert all(("B3 refuses" in c.note) == refused for c in b3)
        fused = [c for c in cells if c.backend == "cuda" and c.polar == "newton-schulz"
                 and c.orth == "cholesky-qr2" and c.topology == "gather"]
        assert fused and all(c.feasible for c in fused)
    # Off sm_90 the wrappers run their plain versions: no limit applies.
    pinned = tp.score_cells(m=2, d=4 * 2256, r=2256, device_kind="cpu", backend="cuda",
                            polar="newton-schulz", orth="qr", topology="psum")[0]
    assert pinned.feasible


def test_rule_fused_rounds_past_shared_memory_priced_at_their_rate():
    """Named port rule 3: past NS_SMEM_MAX_R, B5/B6 run their
    Newton-Schulz steps one block a machine; the h100 model prices the
    fused cells at that form's measured rate, so the stacked plan at
    r = 256 is no B5 cell, and at r = 128 it is."""
    def fused(r):
        [c] = tp.score_cells(m=8, d=8192, r=r, n_iter=2, device_kind="h100",
                             context="stacked", backend="cuda",
                             polar="newton-schulz", orth="cholesky-qr2")
        return c

    at, past = fused(NS_SMEM_MAX_R), fused(NS_SMEM_MAX_R + 1)
    assert math.isclose(at.compute_s, at.flops / tr.H100.peak_flops)
    want = 2 * 24 * 4.0 * (NS_SMEM_MAX_R + 1) ** 3 / tp.WIDE_ROUND_NS_FLOPS_S
    assert math.isclose(past.compute_s, want)
    assert past.compute_s > 10 * past.flops / tr.H100.peak_flops
    small = tp.plan_aggregation(m=8, d=8192, r=128, n_iter=2, device_kind="h100",
                                context="stacked")
    wide = tp.plan_aggregation(m=8, d=8192, r=256, n_iter=2, device_kind="h100",
                               context="stacked")
    assert (small.backend, small.polar, small.orth) == ("cuda", "newton-schulz", "cholesky-qr2")
    assert not (wide.backend == "cuda" and wide.orth == "cholesky-qr2"
                and wide.polar == "newton-schulz")
    # The CPU model keeps the reference's pricing (the kernels do not run).
    [cpu] = tp.score_cells(m=8, d=8192, r=256, n_iter=2, device_kind="cpu",
                           context="stacked", backend="cuda", polar="newton-schulz",
                           orth="cholesky-qr2")
    assert math.isclose(cpu.compute_s, cpu.flops / tr.CPU_HOST.peak_flops
                        * tr.CPU_HOST.interpret_penalty)


def test_rule_fused_ring_gate_is_the_staged_stack_in_hbm():
    """Named port rule 4: the fused ring cell holds the staged (m, d, r)
    wire stack (one gather at 32 bits, one a round below) and five f32
    (d, r) tiles in HBM; past a quarter of hbm_cap_bytes it is infeasible
    unless the topology is pinned.  The reference's VMEM envelope is gone:
    a shape it rejects on its generic GPU model passes here."""
    assert tp.fused_ring_hbm_bytes(m=8, d=100, r=10, n_iter=3, comm_bits=32) == \
        8 * 1000 * 4 + 5 * 4 * 1000
    assert tp.fused_ring_hbm_bytes(m=8, d=100, r=10, n_iter=3, comm_bits=8) == \
        3 * 8 * 1000 + 3 * 8 * 10 * 4 + 5 * 4 * 1000
    kw = dict(m=1024, d=65536, r=128, n_iter=1, device_kind="h100", backend="cuda",
              polar="newton-schulz", orth="cholesky-qr2")
    [big] = [c for c in tp.score_cells(**kw) if c.topology == "ring"]
    staged = tp.fused_ring_hbm_bytes(m=1024, d=65536, r=128, n_iter=1, comm_bits=32)
    assert staged > 0.25 * 80e9 and not big.feasible and "staged ring stack" in big.note
    [pinned] = tp.score_cells(topology="ring", **kw)
    assert pinned.feasible and "memory-hostile" in pinned.note
    gpu = jr.GPU_GENERIC
    ref = [c for c in jp.score_cells(device=gpu, m=8, d=65536, r=128, backend="pallas")
           if c.topology == "ring" and c.polar == "newton-schulz" and c.orth == "cholesky-qr2"]
    port = [c for c in tp.score_cells(device=_port_model(gpu), m=8, d=65536, r=128,
                                      backend="cuda")
            if c.topology == "ring" and c.polar == "newton-schulz" and c.orth == "cholesky-qr2"]
    assert not ref[0].feasible and "VMEM" in ref[0].note
    assert port[0].feasible

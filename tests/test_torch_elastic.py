"""Port parity of the elastic runtime (``repro_torch.runtime``) and of the
stacked ``distributed_pca(membership=, comm_bits=)``.

* gloo CPU worlds of 4 ranks, one shard a rank (as in
  ``test_torch_collective.py``):
  - a healthy ``elastic_pca_collective`` equals ``distributed_pca_collective``
    bit for bit (psum, gather, ring);
  - shard 1 killed before round 1 of 3 equals the composed serial oracle
    (1 round over all 4 local bases, then 2 over the survivors from that
    basis, the reference's ``refinement_rounds``) within
    ``PARITY_TOL[bits]``, for psum, gather and ring at 32 and 8 bits and
    the fused cell (cuda, newton-schulz, cholesky-qr2; plain versions on
    the CPU) on the ring; and the same runs against the reference's own
    ``elastic_pca`` on 4 fake CPU devices;
  - a shard that recovers rejoins by alignment (the oracle's third round
    over all 4 from the running estimate);
  - a straggler escalation (an injected timer) re-plans at the next group;
  - the collective gather at 8 bits with a dead shard against the
    stacked ``distributed_pca(membership=, comm_bits=8)``.
* The stacked ``elastic_pca`` against the same oracle, in process.
* The unit cases of ``tests/test_fault_tolerance.py`` (injector, retries,
  straggler monitor) on the port's classes; the train cases there are
  ROADMAP A11's.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC, run_with_devices
from repro.core import eigenspace as jeig
from repro_torch.comm import PARITY_TOL, Membership
from repro_torch.core import distributed as tdist
from repro_torch.core.metrics import subspace_dist64
from repro_torch.runtime import (
    FailureInjector,
    SimulatedPreemption,
    StepTimer,
    StragglerMonitor,
    elastic_pca,
    replan,
    transition_reason,
    with_retries,
)

M, D, R, N, N_ITER, SEED = 4, 48, 3, 400, 3, 7
KILL = ((1, 1),)
PLAIN = {"backend": "torch", "polar": "svd", "orth": "qr"}
FUSED = {"backend": "cuda", "polar": "newton-schulz", "orth": "cholesky-qr2"}


def _samples(seed=SEED, m=M, n=N, d=D):
    """(m * n, d) Gaussian rows with a clear gap after the top R."""
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((d, d)))[0]
    spec = np.concatenate([np.linspace(4.0, 3.0, R), np.linspace(0.5, 0.1, d - R)])
    return (rng.standard_normal((m * n, d)) * np.sqrt(spec)) @ q.T


# (name, kind, topology, bits, knobs, fail_at, recover_at)
CELLS = [(f"healthy/{t}", "healthy", t, 32, "plain", (), ()) for t in ("psum", "gather", "ring")]
CELLS += [(f"kill/{t}/{b}", "elastic", t, b, "plain", KILL, ())
          for t in ("psum", "gather", "ring") for b in (32, 8)]
CELLS += [("kill/ring/32/fused", "elastic", "ring", 32, "fused", KILL, ()),
          ("recover/psum/32", "elastic", "psum", 32, "plain", ((2, 1),), ((2, 2),)),
          ("straggler/psum/32", "straggler", "psum", 32, "plain", (), ()),
          ("gather8/dead1", "masked", "gather", 8, "plain", (), ())]

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, out_path, data_path, spec = sys.argv[1:7]
rank, world, spec = int(rank), int(world), json.loads(spec)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)

from repro_torch.comm import Membership
from repro_torch.core.distributed import _local_basis, distributed_pca_collective
from repro_torch.runtime import FailureInjector, StragglerMonitor, elastic_pca_collective


class Laps:
    def __init__(self, laps):
        self.laps = list(laps)

    def lap(self):
        return self.laps.pop(0)


x = torch.from_numpy(np.load(data_path).astype(np.float32)).reshape(world, -1, spec["d"])[rank]
group = dist.group.WORLD
common = dict(group=group, device="cpu", solver="eigh", r=spec["r"])
res = {"basis": _local_basis(x, spec["r"], backend="torch", solver="eigh", iters=30).tolist()}
for name, kind, topo, bits, knobs, fail_at, recover_at in spec["cells"]:
    kw = dict(topology=topo, comm_bits=bits, **spec["knobs"][knobs])
    rec = {}
    if kind == "masked":
        out = distributed_pca_collective(x, n_iter=2, membership=Membership.from_dead(world, [1]),
                                         **kw, **common)
    elif kind == "healthy":
        rep = elastic_pca_collective(x, n_iter=spec["n_iter"], **kw, **common)
        base = distributed_pca_collective(x, n_iter=spec["n_iter"], **kw, **common)
        rec["equal"] = bool(torch.equal(rep.basis, base))
        out = rep.basis
    else:
        extra = {}
        if kind == "straggler":
            extra = dict(monitor=StragglerMonitor(warmup=1, patience=1, threshold=1.0),
                         timer=Laps([1.0, 1.0, 10.0, 1.0]), max_group=1)
        inj = FailureInjector(fail_at=tuple(map(tuple, fail_at)),
                              recover_at=tuple(map(tuple, recover_at)))
        n = 4 if kind == "straggler" else spec["n_iter"]
        rep = elastic_pca_collective(x, n_iter=n, injector=inj, **extra, **kw, **common)
        rec.update(replans=rep.replans, final=rep.final_membership.m_active,
                   events=[[e.round_index, e.rounds, e.reason, e.membership.m_active,
                            e.plan.topology, e.plan.comm_bits] for e in rep.events])
        out = rep.basis
    rec["out"] = out.tolist()
    res[name] = rec
dist.destroy_process_group()
with open(out_path, "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("elastic-data") / "samples.npy"
    np.save(path, _samples())
    return path


@pytest.fixture(scope="module")
def port(tmp_path_factory, data_path):
    """Run WORKER on M gloo ranks; {rank: {cell: result}}."""
    tmp = tmp_path_factory.mktemp("elastic-world")
    script = tmp / "worker.py"
    script.write_text(WORKER)
    spec = json.dumps({"cells": CELLS, "n_iter": N_ITER, "d": D, "r": R,
                       "knobs": {"plain": PLAIN, "fused": FUSED}})
    init = f"file://{tmp / 'rendezvous'}"
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(k), str(M), init, str(tmp / f"rank{k}.json"),
         str(data_path), spec],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(M)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return {k: json.loads((tmp / f"rank{k}.json").read_text()) for k in range(M)}


@pytest.fixture(scope="module")
def reference(data_path):
    """The reference's own ``elastic_pca`` on 4 fake CPU devices, shard 1
    killed before round 1 of 3, each (topology, bits) cell."""
    out = run_with_devices(f"""
        import json
        import numpy as np, jax.numpy as jnp
        from repro.compat import make_mesh
        from repro.runtime.elastic import elastic_pca
        from repro.runtime.fault import FailureInjector

        x = jnp.asarray(np.load({str(data_path)!r}).astype(np.float32))
        mesh = make_mesh(({M},), ("data",))
        res = {{}}
        for topo in ("psum", "gather", "ring"):
            for bits in (32, 8):
                rep = elastic_pca(x, mesh, {R}, n_iter={N_ITER}, solver="eigh",
                                  topology=topo, comm_bits=bits,
                                  injector=FailureInjector(fail_at={KILL!r}))
                res[f"{{topo}}/{{bits}}"] = np.asarray(rep.basis).tolist()
        print("RESULT", json.dumps(res))
        """, n_devices=M)
    line = next(s for s in out.splitlines() if s.startswith("RESULT "))
    return {k: np.asarray(v) for k, v in json.loads(line[7:]).items()}


def _bases(port):
    return np.stack([np.asarray(port[k]["basis"], np.float32) for k in range(M)])


def _oracle(vs, schedule):
    """Composed serial rounds: ``schedule`` is [(live shard ids, rounds)],
    each segment starting from the previous one's basis."""
    out = None
    for live, rounds in schedule:
        stack = vs[list(live)]
        out = np.asarray(jeig.refinement_rounds(stack, out, n_iter=rounds))
    return out


@pytest.mark.parametrize("topo", ["psum", "gather", "ring"])
def test_healthy_elastic_equals_distributed_pca_collective(port, topo):
    for k in range(M):
        assert port[k][f"healthy/{topo}"]["equal"]


KILLS = [c for c in CELLS if c[1] == "elastic" and c[0].startswith("kill")]


@pytest.mark.parametrize("cell", KILLS, ids=lambda c: c[0])
def test_midrun_kill_matches_composed_oracle(port, cell):
    name, _, topo, bits, *_ = cell
    want = _oracle(_bases(port), [(range(M), 1), ((0, 2, 3), N_ITER - 1)])
    for k in range(M):
        rec = port[k][name]
        got = np.asarray(rec["out"])
        assert got.shape == (D, R) and np.isfinite(got).all()
        assert subspace_dist64(got, want) <= PARITY_TOL[bits], (k, name)
        assert rec["replans"] == 1 and rec["final"] == M - 1
        assert [e[2] for e in rec["events"]] == ["initial", "failure"]
        assert rec["events"][1][:4] == [1, N_ITER - 1, "failure", M - 1]


@pytest.mark.parametrize("cell", [c for c in KILLS if c[4] == "plain"], ids=lambda c: c[0])
def test_midrun_kill_matches_reference_elastic_pca(port, reference, cell):
    name, _, topo, bits, *_ = cell
    got = np.asarray(port[0][name]["out"])
    assert subspace_dist64(got, reference[f"{topo}/{bits}"]) <= PARITY_TOL[bits]


def test_recovered_shard_rejoins_by_alignment(port):
    want = _oracle(_bases(port), [(range(M), 1), ((0, 1, 3), 1), (range(M), 1)])
    rec = port[0]["recover/psum/32"]
    assert [e[2] for e in rec["events"]] == ["initial", "failure", "recovery"]
    assert rec["replans"] == 2 and rec["final"] == M
    assert subspace_dist64(np.asarray(rec["out"]), want) <= PARITY_TOL[32]


def test_straggler_escalation_replans(port):
    rec = port[0]["straggler/psum/32"]
    assert [e[:3] for e in rec["events"]] == [[0, 1, "initial"], [3, 1, "straggler"]]
    assert rec["replans"] == 1 and rec["final"] == M
    want = _oracle(_bases(port), [(range(M), 4)])
    assert subspace_dist64(np.asarray(rec["out"]), want) <= PARITY_TOL[32]


def test_stacked_distributed_pca_membership_and_bits_match_collective_gather(port, data_path):
    x = torch.from_numpy(np.load(data_path).astype(np.float32))
    got = tdist.distributed_pca(x, R, shards=M, device="cpu", solver="eigh", n_iter=2,
                                topology="gather", comm_bits=8,
                                membership=Membership.from_dead(M, [1]), **PLAIN)
    want = np.asarray(port[0]["gather8/dead1"]["out"])
    assert subspace_dist64(got, want) <= PARITY_TOL[8]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # The dead shard's rows are gone: the estimate is the survivors' job.
    alive = torch.cat([x.reshape(M, N, D)[i] for i in (0, 2, 3)])
    fresh = tdist.distributed_pca(alive, R, shards=M - 1, device="cpu", solver="eigh",
                                  n_iter=2, **PLAIN)
    exact = tdist.distributed_pca(x, R, shards=M, device="cpu", solver="eigh", n_iter=2,
                                  membership=Membership.from_dead(M, [1]), **PLAIN)
    assert torch.equal(fresh, exact)


def test_stacked_elastic_pca_matches_composed_oracle(port, data_path):
    x = torch.from_numpy(np.load(data_path).astype(np.float32))
    rep = elastic_pca(x, R, shards=M, device="cpu", solver="eigh", n_iter=N_ITER,
                      injector=FailureInjector(fail_at=KILL), **PLAIN)
    want = _oracle(_bases(port), [(range(M), 1), ((0, 2, 3), N_ITER - 1)])
    assert subspace_dist64(rep.basis, want) <= PARITY_TOL[32]
    assert [e.reason for e in rep.events] == ["initial", "failure"]
    assert rep.replans == 1 and rep.final_membership.m_active == M - 1
    assert rep.events[1].plan.topology == "gather"
    healthy = elastic_pca(x, R, shards=M, device="cpu", solver="eigh", n_iter=N_ITER,
                          **PLAIN)
    assert torch.equal(healthy.basis, tdist.distributed_pca(
        x, R, shards=M, device="cpu", solver="eigh", n_iter=N_ITER, **PLAIN))


def test_replan_prices_the_survivor_count():
    mem = Membership.from_dead(8, [3])
    pl = replan(mem, d=96, r=4, n_iter=2, device_kind="cpu")
    from repro_torch.plan import plan_aggregation

    assert pl == plan_aggregation(m=7, d=96, r=4, n_iter=2, device_kind="cpu")
    # int8 psum's headroom is re-checked at m' (and priced at m with pods).
    big = Membership.from_dead(130, range(3))
    pinned = replan(big, d=96, r=4, device_kind="cpu", topology="psum", comm_bits=8)
    assert pinned.topology == "psum"
    with_pods = replan(Membership.from_dead(8, [3]), d=96, r=4, device_kind="cpu",
                       topology="hier", pods=4)
    assert with_pods.topology == "hier" and with_pods.pods == 4
    assert transition_reason(None, mem) is None
    assert transition_reason(Membership.full(8), mem) == "failure"
    assert transition_reason(mem, Membership.full(8)) == "recovery"
    assert transition_reason(mem, Membership.from_dead(8, [5])) == "failure"


def test_step_timer_laps():
    timer = StepTimer("cpu")
    assert timer.lap() >= 0.0


# ------------------------------------ unit cases of test_fault_tolerance.py --

def test_failure_injector_fires_once():
    inj = FailureInjector(fail_at_steps=(3,))
    inj.check(2)
    with pytest.raises(SimulatedPreemption):
        inj.check(3)
    inj.check(3)


def test_with_retries_recovers():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise SimulatedPreemption("flake")
        return 42

    assert with_retries(flaky, backoff_s=0.0)() == 42
    assert calls["n"] == 3


@pytest.mark.parametrize("cap,jitter,rng,want", [
    (30.0, 0.5, 1.0, [1.5, 3.0, 6.0]),
    (2.0, 0.0, 0.0, [1.0, 2.0, 2.0]),
])
def test_with_retries_backoff_fake_clock(cap, jitter, rng, want):
    sleeps, calls = [], {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 4:
            raise SimulatedPreemption("flake")
        return "ok"

    assert with_retries(flaky, max_retries=3, backoff_s=1.0, max_backoff_s=cap,
                        jitter=jitter, sleep=sleeps.append, rng=lambda: rng)() == "ok"
    assert sleeps == want


def test_with_retries_reraises_after_budget_and_skips_unretryable():
    sleeps = []

    def always():
        raise SimulatedPreemption("down for good")

    with pytest.raises(SimulatedPreemption):
        with_retries(always, max_retries=2, backoff_s=1.0, jitter=0.0,
                     sleep=sleeps.append, rng=lambda: 0.0)()
    assert sleeps == [1.0, 2.0]

    def boom():
        raise ValueError("logic bug, not a flake")

    with pytest.raises(ValueError):
        with_retries(boom, sleep=lambda s: None)()


def test_straggler_warmup_mean_and_variance():
    import statistics

    mon = StragglerMonitor(warmup=3)
    for i, dt in enumerate((1.0, 2.0, 3.0)):
        assert mon.record(i, dt) is False
    assert mon.mean_step_time == pytest.approx(2.0)
    samples = (0.10, 0.14, 0.12, 0.16)
    mon = StragglerMonitor(warmup=len(samples))
    for i, dt in enumerate(samples):
        mon.record(i, dt)
    assert mon._var == pytest.approx(statistics.pvariance(samples))


def test_straggler_patience_and_reset(caplog):
    hits = []
    mon = StragglerMonitor(warmup=4, patience=3, threshold=2.0,
                           on_escalate=lambda s, dt: hits.append((s, dt)))
    with caplog.at_level(logging.WARNING, logger="repro_torch.straggler"):
        for i in range(10):
            mon.record(i, 0.10 + 0.002 * (i % 2))
        mon.record(10, 1.0)
        mon.record(11, 1.0)
        mon.record(12, 0.10)
        assert mon.escalations == 0 and not hits
        for i in range(13, 16):
            mon.record(i, 5.0)
    assert mon.escalations == 1 and hits == [(15, 5.0)] and mon._slow_run == 0
    assert any("slow step" in r.message for r in caplog.records)


def test_straggler_monitor_escalates():
    hits = []
    mon = StragglerMonitor(warmup=2, patience=2, threshold=2.0,
                           on_escalate=lambda s, dt: hits.append(s))
    for i in range(30):
        mon.record(i, 0.10 + 0.001 * (i % 3))
    assert mon.escalations == 0
    for i in range(30, 34):
        mon.record(i, 1.0)
    assert mon.escalations >= 1 and hits


def test_injector_schedule_and_membership():
    inj = FailureInjector(fail_at=((2, 1), (5, 3)), recover_at=((2, 3),))
    assert [inj.dead_shards(t) for t in (0, 1, 2, 3, 7)] == [
        frozenset(), frozenset({2}), frozenset({2}), frozenset({5}), frozenset({5})]
    assert FailureInjector(fail_at=((1, 2),), recover_at=((1, 2),)).dead_shards(2) == frozenset()
    inj = FailureInjector(fail_at=((2, 1),))
    assert inj.membership_at(0, 4) == Membership.full(4)
    assert inj.membership_at(1, 4) == Membership.from_dead(4, (2,))
    with pytest.raises(ValueError):
        inj.membership_at(1, 2)


def test_parse_fail_spec():
    parse = FailureInjector.parse_fail_spec
    assert parse("2:1") == ((2, 1),)
    assert parse("2:1, 5:3") == ((2, 1), (5, 3))
    assert parse("") == ()
    for bad in ("2", "a:b"):
        with pytest.raises(ValueError, match="expected shard:round"):
            parse(bad)

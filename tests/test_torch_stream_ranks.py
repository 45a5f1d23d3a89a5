"""Port parity of the streaming service's collective form and of its
launchers, on gloo CPU worlds.

* ``SubspaceService(group=)`` (one shard a rank) on 4 gloo ranks against
  the reference's service on 4 fake CPU devices, fed the same rows, shard
  1 dying before step 3: psum, gather and ring at 32 and 8 wire bits, the
  fused ring cell (cuda, newton-schulz, cholesky-qr2; plain versions on
  the CPU), and hier over 2 pods x 2 at 32 and 8 bits.  Every refresh's
  basis on every rank within 1e-5 f64 subspace distance of the
  reference's (``PARITY_TOL[8]`` on 8-bit wires: their stochastic
  rounding draws from ``torch.Generator`` streams), equal ``step``,
  ``rows_seen``, ``refreshes``, ``staleness``, ``m_active``, ``replans``
  and ``events``, drift within 1e-5 on the exact wires; and the query
  path makes no ``torch.distributed`` call on any rank.
* ``python -m repro_torch.launch.serve --subspace`` in one process and
  under ``torchrun`` on 4 ranks; ``python -m repro_torch.launch.eigen
  --stream --cadence`` (with ``--fail-at``) under ``torchrun`` on 4 ranks
  against the same lane in one process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import SRC, run_with_devices
from repro_torch.comm import PARITY_TOL
from repro_torch.core.metrics import subspace_dist64

M, D, R, STEPS, NPER, CADENCE, N_ITER = 4, 40, 3, 6, 512, 2, 2
KILL_STEP, KILL_SHARD, PODS = 3, 1, 2
STAT_KEYS = ("step", "rows_seen", "refreshes", "staleness", "m_active", "replans",
             "events")
PLAIN = {"backend": "torch", "polar": "svd", "orth": "qr"}
FUSED = {"backend": "cuda", "polar": "newton-schulz", "orth": "cholesky-qr2"}
# (name, topology, bits, port knobs)
CELLS = [(f"{t}/{b}", t, b, PLAIN) for t in ("psum", "gather", "ring", "hier")
         for b in (32, 8)]
CELLS += [("ring/32/fused", "ring", 32, FUSED)]

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, out_path, spec_path = sys.argv[1:6]
rank, world = int(rank), int(world)
with open(spec_path) as f:
    spec = json.load(f)
from repro_torch.comm import Membership
from repro_torch.launch.mesh import make_aggregation_mesh
from repro_torch.stream import SubspaceService

agg = make_aggregation_mesh(device="cpu", rank=rank, world_size=world,
                            init_method=init, pods=spec["pods"])
rows = np.load(spec["rows"])
res = {}
for name, topo, bits, knobs in spec["cells"]:
    hier = topo == "hier"
    svc = SubspaceService(
        spec["d"], spec["r"], group=agg.local_group if hier else agg.group,
        pod_group=agg.pod_group if hier else None, device="cpu",
        n_iter=spec["n_iter"], cadence=spec["cadence"], solver="eigh",
        topology=topo, comm_bits=bits, **knobs)
    bases = []
    for t in range(spec["steps"]):
        if t == spec["kill_step"]:
            svc.set_membership(Membership.from_dead(world, [spec["kill_shard"]]))
            if svc.stats["refreshes"] > len(bases):
                bases.append(svc.basis.tolist())
        svc.observe(torch.from_numpy(rows[t, rank]))
        if svc.stats["refreshes"] > len(bases):
            bases.append(svc.basis.tolist())
    stats = svc.stats
    calls = []
    saved = {n: getattr(dist, n) for n in dir(dist)
             if callable(getattr(dist, n)) and not n.startswith("_")
             and not isinstance(getattr(dist, n), type)}
    for n in saved:
        setattr(dist, n, lambda *a, _n=n, **k: calls.append(_n))
    proj = svc.project(torch.ones((8, spec["d"])))
    for n, fn in saved.items():
        setattr(dist, n, fn)
    res[name] = {"bases": bases, "stats": {k: stats[k] for k in spec["stat_keys"]},
                 "drift": svc.drift(), "query_calls": calls,
                 "proj": list(proj.shape), "plan": [svc.plan.backend, svc.plan.topology]}
dist.destroy_process_group()
with open(out_path, "w") as f:
    json.dump(res, f)
"""


def _rows(seed=11) -> np.ndarray:
    """(STEPS, M, NPER, D) f32 Gaussian rows with a clear gap after the top R."""
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((D, D)))[0]
    spec = np.concatenate([np.linspace(4.0, 3.0, R), np.linspace(0.5, 0.1, D - R)])
    x = (rng.standard_normal((STEPS * M * NPER, D)) * np.sqrt(spec)) @ q.T
    return x.astype(np.float32).reshape(STEPS, M, NPER, D)


@pytest.fixture(scope="module")
def rows_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("stream-ranks") / "rows.npy"
    np.save(path, _rows())
    return path


@pytest.fixture(scope="module")
def port(tmp_path_factory, rows_path):
    """WORKER on M gloo ranks: {rank: {cell: result}}."""
    tmp = tmp_path_factory.mktemp("stream-world")
    (tmp / "worker.py").write_text(WORKER)
    spec = {"cells": CELLS, "rows": str(rows_path), "d": D, "r": R, "n_iter": N_ITER,
            "cadence": CADENCE, "steps": STEPS, "kill_step": KILL_STEP,
            "kill_shard": KILL_SHARD, "pods": PODS, "stat_keys": list(STAT_KEYS)}
    (tmp / "spec.json").write_text(json.dumps(spec))
    init = f"file://{tmp / 'rendezvous'}"
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(k), str(M), init,
         str(tmp / f"rank{k}.json"), str(tmp / "spec.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(M)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return {k: json.loads((tmp / f"rank{k}.json").read_text()) for k in range(M)}


@pytest.fixture(scope="module")
def reference(rows_path):
    """The reference's service on M fake CPU devices, each cell."""
    out = run_with_devices(f"""
        import json
        import numpy as np, jax.numpy as jnp
        from repro.comm import Membership
        from repro.launch.mesh import make_aggregation_mesh
        from repro.stream import SubspaceService

        rows = np.load({str(rows_path)!r})
        res = {{}}
        for name, topo, bits, knobs in {CELLS!r}:
            mesh = make_aggregation_mesh({M}, pods={PODS} if topo == "hier" else None)
            knobs = dict(knobs, backend="xla")
            svc = SubspaceService(mesh, {D}, {R}, n_iter={N_ITER}, cadence={CADENCE},
                                  solver="eigh", topology=topo, comm_bits=bits, **knobs)
            bases = []
            for t in range({STEPS}):
                if t == {KILL_STEP}:
                    svc.set_membership(Membership.from_dead({M}, [{KILL_SHARD}]))
                    if svc.stats["refreshes"] > len(bases):
                        bases.append(np.asarray(svc.basis).tolist())
                svc.observe(jnp.asarray(rows[t]))
                if svc.stats["refreshes"] > len(bases):
                    bases.append(np.asarray(svc.basis).tolist())
            stats = {{k: svc.stats[k] for k in {list(STAT_KEYS)!r}}}
            res[name] = {{"bases": bases, "stats": stats, "drift": svc.drift()}}
        print("RESULT", json.dumps(res))
        """, n_devices=M)
    return json.loads(out.split("RESULT ", 1)[1])


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_collective_service_matches_reference(port, reference, cell):
    name, topo, bits, knobs = cell
    want = reference[name]
    tol = max(1e-5, PARITY_TOL[bits])
    assert want["stats"]["events"] == ["failure"]
    for k in range(M):
        got = port[k][name]
        assert len(got["bases"]) == len(want["bases"]) == want["stats"]["refreshes"]
        for i, (b, ref) in enumerate(zip(got["bases"], want["bases"])):
            b = np.asarray(b)
            assert b.shape == (D, R) and np.isfinite(b).all()
            assert subspace_dist64(b, np.asarray(ref)) <= tol, (name, k, i)
        assert got["stats"] == want["stats"], (name, k)
        assert got["plan"] == [knobs["backend"], topo]
        if bits == 32:
            assert abs(got["drift"] - want["drift"]) <= 1e-5
    spread = max(subspace_dist64(port[k][name]["bases"][-1], port[0][name]["bases"][-1])
                 for k in range(1, M))
    assert spread <= 1e-5


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_collective_query_path_makes_no_collective_call(port, cell):
    for k in range(M):
        rec = port[k][cell[0]]
        assert rec["query_calls"] == [] and rec["proj"] == [8, R]


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------


def _run(args, timeout=300):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(line.split(": ", 1) for line in proc.stdout.strip().splitlines()
                if ": " in line)


def _torchrun(*args):
    return ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(M),
            *args]


SERVE = ["-m", "repro_torch.launch.serve", "--subspace", "--device", "cpu", "--dim", "48",
         "--subspace-rank", "3", "--steps", "8", "--rows-per-step", "64", "--cadence",
         "3", "--queries", "1000", "--batch", "128"]


def test_serve_subspace_one_process():
    stats = _run([*SERVE, "--shards", "3"])
    assert stats["device"] == "cpu"
    assert (stats["step"], stats["rows_seen"], stats["refreshes"]) == ("8", str(3 * 8 * 64), "3")
    assert stats["staleness"] == "1" and stats["m_active"] == "3"
    assert stats["projection_shape"] == "(104, 3)"  # the last wave of 1000 in 128s
    assert stats["plan"].startswith("Plan(backend='torch', topology='gather'")
    for key in ("ingest_s", "query_s", "queries_per_s"):
        assert float(stats[key]) > 0


def test_serve_subspace_under_torchrun():
    stats = _run(_torchrun(*SERVE))
    assert (stats["step"], stats["rows_seen"], stats["refreshes"]) == ("8", str(M * 8 * 64), "3")
    assert stats["m_active"] == str(M) and "topology='psum'" in stats["plan"]
    assert float(stats["queries_per_s"]) > 0


EIGEN = ["-m", "repro_torch.launch.eigen", "--device", "cpu", "--dim", "48",
         "--subspace-rank", "3", "--n-per-shard", "512", "--solver", "eigh",
         "--stream", "8", "--cadence", "2", "--fail-at", "2:5"]


def test_eigen_stream_under_torchrun_matches_one_process():
    """The collective stream lane (psum on the CPU) and the stacked one on
    the same shards and schedule: the same stream stats, and estimates
    as close as the f32 distances can show."""
    ranks = _run(_torchrun(*EIGEN))
    one = _run([*EIGEN, "--shards", str(M)])
    assert ranks["ranks"] == str(M) and ranks["topology"] == "psum"
    for key in ("stream_steps", "stream_rows_seen", "stream_refreshes", "stream_staleness",
                "replans", "events"):
        assert ranks[key] == one[key], key
    assert ranks["events"] == "['failure']" and ranks["stream_staleness"] == "0"
    assert abs(float(ranks["dist_aligned"]) - float(one["dist_aligned"])) < 1e-4
    assert abs(float(ranks["stream_drift"]) - float(one["stream_drift"])) < 1e-5

"""Port parity of the two-level ``topology="hier"`` (A5-hier) and of
``distributed_pca_from_covs`` on a gloo CPU world of 8 ranks.

* The reference's acceptance cube (``tests/test_hier.py::
  test_hier_parity_cube_eight_devices``): m = 8 as 4 pods x 2 and as
  2 pods x 4, backends torch and cuda (whose kernel wrappers run their
  plain versions on CPU tensors, the reference's pallas) x wire bits
  32 / 16 / 8, plus the two dead memberships (rank 3 dead in a live pod;
  pod 1 wholly dead) at 4 x 2.  Every rank's output is held at
  ``PARITY_TOL[bits]`` f64 subspace distance against the reference's
  serial ``refinement_rounds`` oracle on the survivors and against the
  reference's hier collective, run once through ``run_with_devices`` on
  8 fake CPU devices.  8-bit cells draw from ``torch.Generator``
  streams keyed by pod, so they match at ``PARITY_TOL[8]``, not bit for
  bit.
* ``comm_cost("hier", ...)`` equals the reference's in ``bits``,
  ``words``, the per-kind split and ``levels`` over a grid of shapes,
  pods, tiers, rounds and memberships.
* The bytes each rank hands to ``torch.distributed``, split by group
  (the pod's local group: intra; the slot's pod group: inter), equal
  ``comm_cost(...).levels``: exactly on a live pod's ranks; a dead pod's
  ranks take no hops.
* ``distributed_pca_from_covs`` over psum, gather, ring and hier (2 x 4),
  with and without ``ref=``, against the reference's on the same (8, d, d)
  matrices: <= 1e-4 (an f32 eigensolve of each matrix, amplified by
  1/gap, as in ``tests/test_torch_eigen.py``).
* The launcher under ``torchrun`` with ``--topology hier --pods 2`` on 4
  CPU ranks against the one-process launcher on the same shards; the
  mesh helper refuses pods that do not tile the ranks.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import SRC, run_with_devices
from repro.comm import Membership as JMembership
from repro.comm import comm_cost as j_comm_cost
from repro.core import eigenspace as jeig
from repro_torch.comm import PARITY_TOL, Membership, comm_cost
from repro_torch.core.metrics import subspace_dist64

M, D, R, N_ITER = 8, 96, 4, 2
CELLS = [(pods, backend, bits, ()) for pods in (4, 2) for backend in ("torch", "cuda")
         for bits in (32, 16, 8)]
CELLS += [(4, "torch", 32, (3,)), (4, "torch", 32, (2, 3))]
COV_TOPOS = ("psum", "gather", "ring", "hier")
COV_TOL = 1e-4

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, out_path, spec_path = sys.argv[1:6]
rank, world = int(rank), int(world)
with open(spec_path) as f:
    spec = json.load(f)
from repro_torch.launch.mesh import make_aggregation_mesh

aggs = {p: make_aggregation_mesh(device="cpu", rank=rank, world_size=world,
                                 init_method=init, pods=p) for p in (4, 2)}

handed = {}  # payload bytes this rank passes to torch.distributed, by group


def count(group, t):
    handed[id(group)] = handed.get(id(group), 0) + t.numel() * t.element_size()


def counting(fn, pos):
    def call(*args, **kw):
        count(kw.get("group"), args[pos])
        return fn(*args, **kw)
    return call


gather_name = ("all_gather_single" if hasattr(dist, "all_gather_single")
               else "all_gather_into_tensor")
for name, pos in (("all_reduce", 0), ("broadcast", 0), (gather_name, 1)):
    setattr(dist, name, counting(getattr(dist, name), pos))
p2p = dist.batch_isend_irecv


def batch(ops):
    for op in ops:
        if getattr(op.op, "__name__", "") == "isend":
            count(op.group, op.tensor)
    return p2p(ops)


dist.batch_isend_irecv = batch

from repro_torch.comm import Membership
from repro_torch.core.distributed import (
    distributed_pca_from_covs,
    procrustes_average_collective,
)

vs = torch.from_numpy(np.asarray(spec["vs"], np.float32))
res = {"cells": {}, "covs": {}}
for pods, backend, bits, dead in spec["cells"]:
    agg = aggs[pods]
    mem = Membership.from_dead(world, dead) if dead else None
    handed.clear()
    out = procrustes_average_collective(
        vs[rank].contiguous(), group=agg.local_group, pod_group=agg.pod_group,
        topology="hier", n_iter=spec["n_iter"], backend=backend,
        comm_bits=bits, membership=mem)
    res["cells"][f"{pods}/{backend}/{bits}/{','.join(map(str, dead))}"] = {
        "out": out.tolist(),
        "intra": handed.get(id(agg.local_group), 0),
        "inter": handed.get(id(agg.pod_group), 0),
        "other": sum(v for k, v in handed.items()
                     if k not in (id(agg.local_group), id(agg.pod_group))),
    }
covs = torch.from_numpy(np.asarray(spec["covs"], np.float32))
ref = torch.from_numpy(np.asarray(spec["ref"], np.float32))
for topo in spec["cov_topos"]:
    hier = topo == "hier"
    for with_ref in (False, True):
        out = distributed_pca_from_covs(
            covs[rank], spec["r"], group=aggs[2].local_group if hier else dist.group.WORLD,
            pod_group=aggs[2].pod_group if hier else None, device="cpu",
            n_iter=spec["n_iter"], solver="eigh", topology=topo,
            ref=ref if with_ref else None)
        res["covs"][f"{topo}/{with_ref}"] = out.tolist()
dist.destroy_process_group()
with open(out_path, "w") as f:
    json.dump(res, f)
"""


def _key(pods, backend, bits, dead):
    return f"{pods}/{backend}/{bits}/{','.join(map(str, dead))}"


def _inputs():
    g = np.random.default_rng(53)
    u = np.linalg.qr(g.standard_normal((D, R)))[0]
    vs = np.linalg.qr(u[None] + 0.1 * g.standard_normal((M, D, R)))[0].astype(np.float32)
    # Each machine's matrix: a sample covariance of a spiked model.
    spec = np.concatenate([np.full(R, 4.0), np.ones(D - R)])
    factor = u @ np.diag(np.sqrt(spec[:R] - 1)) @ u.T + np.eye(D)
    xs = g.standard_normal((M, 512, D)) @ factor
    covs = (np.einsum("mnd,mne->mde", xs, xs) / 512).astype(np.float32)
    ref = np.linalg.qr(u + 0.05 * g.standard_normal((D, R)))[0].astype(np.float32)
    return vs, covs, ref


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hier_world")
    vs, covs, ref = _inputs()
    (tmp / "worker.py").write_text(WORKER)
    (tmp / "spec.json").write_text(json.dumps({
        "vs": vs.tolist(), "covs": covs.tolist(), "ref": ref.tolist(), "r": R,
        "cells": CELLS, "n_iter": N_ITER, "cov_topos": COV_TOPOS}))
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(k), str(M),
         f"file://{tmp / 'rendezvous'}", str(tmp / f"rank{k}.json"),
         str(tmp / "spec.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(M)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return [json.loads((tmp / f"rank{k}.json").read_text()) for k in range(M)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's hier collective (every cell, every device's row)
    and its distributed_pca_from_covs, on 8 fake CPU devices, run once."""
    tmp = tmp_path_factory.mktemp("hier_ref")
    vs, covs, ref = _inputs()
    np.savez(tmp / "inputs.npz", vs=vs, covs=covs, ref=ref)
    out = run_with_devices(f"""
        import json
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.comm import Membership
        from repro.compat import make_mesh, shard_map
        from repro.core.distributed import (
            distributed_pca_from_covs, procrustes_average_collective)
        from repro.launch.mesh import make_aggregation_mesh

        inp = np.load({str(tmp / "inputs.npz")!r})
        vs, covs, ref = (jnp.asarray(inp[k]) for k in ("vs", "covs", "ref"))
        res = {{"cells": {{}}, "covs": {{}}}}
        backends = {{"torch": "xla", "cuda": "pallas"}}
        for pods, backend, bits, dead in {CELLS!r}:
            mem = Membership.from_dead({M}, tuple(dead)) if dead else None
            mesh = make_mesh((pods, {M} // pods), ("pod", "data"))
            fn = jax.jit(shard_map(
                lambda v, b=backends[backend], cb=bits, mm=mem:
                    procrustes_average_collective(
                        v[0], axis_name="data", pod_axis="pod", n_iter={N_ITER},
                        topology="hier", backend=b, comm_bits=cb,
                        membership=mm)[None],
                mesh=mesh, in_specs=P(("pod", "data"), None, None),
                out_specs=P(("pod", "data"), None, None), check_vma=False))
            key = f"{{pods}}/{{backend}}/{{bits}}/" + ",".join(map(str, dead))
            res["cells"][key] = np.asarray(fn(vs)).tolist()
        for topo in {COV_TOPOS!r}:
            mesh = make_aggregation_mesh({M}, pods=2 if topo == "hier" else None)
            for with_ref in (False, True):
                out = distributed_pca_from_covs(
                    covs, mesh, {R}, n_iter={N_ITER}, solver="eigh",
                    topology=topo, ref=ref if with_ref else None)
                res["covs"][f"{{topo}}/{{with_ref}}"] = np.asarray(out).tolist()
        print("RESULT", json.dumps(res))
        """, n_devices=M)
    line = next(s for s in out.splitlines() if s.startswith("RESULT "))
    return json.loads(line[7:])


def _survivors(dead):
    return [k for k in range(M) if k not in dead]


@pytest.mark.parametrize("pods,backend,bits,dead", CELLS)
def test_hier_cube_matches_reference(port, reference, pods, backend, bits, dead):
    vs, _, _ = _inputs()
    oracle = np.asarray(jeig.refinement_rounds(vs[_survivors(dead)], n_iter=N_ITER))
    want = np.asarray(reference["cells"][_key(pods, backend, bits, dead)])
    tol = PARITY_TOL[bits]
    for k in range(M):
        got = np.asarray(port[k]["cells"][_key(pods, backend, bits, dead)]["out"])
        assert got.shape == (D, R) and np.isfinite(got).all()
        assert subspace_dist64(got, oracle) <= tol, (k, "oracle")
        assert subspace_dist64(got, want[k]) <= tol, (k, "reference")


@pytest.mark.parametrize("pods,backend,bits,dead", CELLS)
def test_bytes_handed_per_level_match_comm_cost(port, pods, backend, bits, dead):
    mem = Membership.from_dead(M, dead) if dead else None
    cost = comm_cost("hier", m=M, d=D, r=R, n_iter=N_ITER, comm_bits=bits,
                     pods=pods, membership=mem)
    local = M // pods
    dead_pods = {q for q in range(pods)
                 if all(q * local + l in dead for l in range(local))}
    for k in range(M):
        cell = port[k]["cells"][_key(pods, backend, bits, dead)]
        assert cell["other"] == 0
        assert cell["intra"] * 8 == sum(cost.levels["intra"].values()), k
        inter = cost.levels["inter"]
        hops = 0 if k // local in dead_pods else inter["collective-permute"]
        assert cell["inter"] * 8 == inter["all-reduce"] + hops, k


MEMBERSHIPS = (None, (3,), (2, 3), (0, 1, 2, 3))


@pytest.mark.parametrize("dead", MEMBERSHIPS)
@pytest.mark.parametrize("m,pods", [(8, 1), (8, 2), (8, 4), (8, 8), (12, 3)])
def test_comm_cost_hier_matches_reference(m, pods, dead):
    if dead is not None and max(dead) >= m:
        pytest.skip("membership beyond m")
    tm = None if dead is None else Membership.from_dead(m, dead)
    jm = None if dead is None else JMembership.from_dead(m, dead)
    for bits in (32, 16, 8):
        for n_iter in (1, 3):
            for ref_broadcast in (True, False):
                kw = dict(m=m, d=96, r=4, n_iter=n_iter, comm_bits=bits,
                          ref_broadcast=ref_broadcast, pods=pods)
                got = comm_cost("hier", membership=tm, **kw)
                want = j_comm_cost("hier", membership=jm, **kw)
                assert (got.topology, got.comm_bits, got.words, got.bits) == (
                    want.topology, want.comm_bits, want.words, want.bits)
                assert got.kind_bits == want.hlo_bits
                assert got.levels == want.levels


@pytest.mark.parametrize("topo", COV_TOPOS)
@pytest.mark.parametrize("with_ref", [False, True])
def test_distributed_pca_from_covs_matches_reference(port, reference, topo, with_ref):
    want = np.asarray(reference["covs"][f"{topo}/{with_ref}"])
    for k in range(M):
        got = np.asarray(port[k]["covs"][f"{topo}/{with_ref}"])
        assert got.shape == (D, R) and np.isfinite(got).all()
        assert subspace_dist64(got, want) <= COV_TOL, k


def test_launcher_hier_under_torchrun_matches_one_process_run():
    """4 CPU ranks as 2 pods x 2 run the hier schedule on shards 0-3 of
    the data rule; the one-process launcher stacks the same shards."""
    args = ["--device", "cpu", "--n-per-shard", "512", "--solver", "eigh"]
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}

    def stats(cmd):
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return dict(line.split(": ", 1) for line in proc.stdout.strip().splitlines())

    ranks = stats([sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc-per-node", "4", "-m", "repro_torch.launch.eigen",
                   "--topology", "hier", "--pods", "2", "--dim", "128",
                   "--subspace-rank", "6", *args])
    one = stats([sys.executable, "-m", "repro_torch.launch.eigen", "--shards", "4",
                 "--d", "128", "--r", "6", *args])
    assert ranks["topology"] == "hier" and ranks["pods"] == "2" and ranks["ranks"] == "4"
    assert one["topology"] == "gather" and one["pods"] == "0"
    for k in ("dist_central", "dist_naive", "dist_local0"):
        assert ranks[k] == one[k]
    assert abs(float(ranks["dist_aligned"]) - float(one["dist_aligned"])) < 1e-5


def test_mesh_refuses_pods_that_do_not_tile():
    from repro_torch.launch.mesh import make_aggregation_mesh

    for pods in (3, 0):
        with pytest.raises(ValueError, match="tile"):
            make_aggregation_mesh(device="cpu", rank=0, world_size=8, pods=pods)

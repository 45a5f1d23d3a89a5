"""Port parity of the cross-rank aggregation (``procrustes_average_collective``
over ``torch.distributed``) on gloo CPU worlds.

* The psum / gather / ring x 32 / 16 / 8 cube at m = 4, with the plain
  knobs (torch, svd, qr) and the kernel cell (cuda, newton-schulz,
  cholesky-qr2, whose wrappers run their plain versions on CPU tensors:
  the fused ring round B6, the fused round B5 under gather, the Gram and
  apply stages under psum), plus one degraded-membership cell (ring,
  8 bits, rank 1 dead).  Held against the reference's collectives, run
  once in a subprocess on 4 fake CPU devices (``run_with_devices``), at
  ``PARITY_TOL[bits]`` f64 subspace distance; 8-bit cells cannot match
  bit for bit (``torch.Generator`` streams, not ``jax.random``).
* Every rank holds the same answer (to 1e-5).
* The bytes each rank hands to ``torch.distributed`` (counted by wrapping
  its calls in the workers) against ``comm_cost(...).bits``: psum and the
  hop ring hand exactly ``bits``, gather ``bits / m``; the fused ring
  stages by all-gather, so it hands the broadcast plus one message per
  staged round, each reaching m' - 1 ranks: the model's hop count at 16
  and 8 bits, and one round's worth at 32 bits, where the payload is the
  same every round and is gathered once (as in the reference, ROADMAP C2).
* ``sign_average_collective`` (rank 1) against the reference's.
* One cell at m = 8 (the fused ring, 32 bits) against the reference's
  serial rounds, and the launcher under ``torchrun`` on 2 CPU ranks
  against the one-process launcher on the same data.

Each world is one set of processes per fixture with a ``file://``
rendezvous in a temporary directory, so xdist workers share no port.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import SRC, run_with_devices
from repro.core import eigenspace as jeig
from repro_torch.comm import PARITY_TOL, Membership, comm_cost, message_bits
from repro_torch.core.metrics import subspace_dist64

M, D, R, N_ITER, CHUNK, SEED = 4, 96, 4, 2, 40, 0
DEAD = (1,)
TOPOS, BITS = ("psum", "gather", "ring"), (32, 16, 8)
KNOBS = {
    "plain": {"backend": "torch", "polar": "svd", "orth": "qr"},
    "fused": {"backend": "cuda", "polar": "newton-schulz", "orth": "cholesky-qr2"},
}
CELLS = [(t, b, k, ()) for t in TOPOS for b in BITS for k in KNOBS]
CELLS += [("ring", 8, k, DEAD) for k in KNOBS]

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, out_path, spec = sys.argv[1:6]
rank, world, spec = int(rank), int(world), json.loads(spec)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)

handed = [0]  # payload bytes this rank passes to torch.distributed


def counting(fn, pos):
    def call(*args, **kw):
        t = args[pos]
        handed[0] += t.numel() * t.element_size()
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
            handed[0] += op.tensor.numel() * op.tensor.element_size()
    return p2p(ops)


dist.batch_isend_irecv = batch

from repro_torch.comm import Membership
from repro_torch.core.distributed import (
    procrustes_average_collective,
    sign_average_collective,
)

vs = torch.from_numpy(np.asarray(spec["vs"], np.float32))
results = {}
for topo, bits, knobs, dead in spec["cells"]:
    mem = Membership.from_dead(world, dead) if dead else None
    handed[0] = 0
    out = procrustes_average_collective(
        vs[rank], group=dist.group.WORLD, n_iter=spec["n_iter"],
        topology=topo, comm_bits=bits, ring_chunk=spec["chunk"],
        membership=mem, **spec["knobs"][knobs])
    key = f"{topo}/{bits}/{knobs}/{','.join(map(str, dead))}"
    results[key] = {"out": out.tolist(), "bytes": handed[0]}
sign = sign_average_collective(vs[rank][:, :1].contiguous(), group=dist.group.WORLD)
results["sign"] = {"out": sign.tolist()}
dist.destroy_process_group()
with open(out_path, "w") as f:
    json.dump(results, f)
"""


def _stack(seed, m, d, r):
    g = np.random.default_rng(seed).standard_normal((m, d, r))
    return np.linalg.qr(g)[0].astype(np.float32)


def _key(topo, bits, knobs, dead):
    return f"{topo}/{bits}/{knobs}/{','.join(map(str, dead))}"


def _world(tmp, world, vs, cells):
    """Run WORKER on ``world`` gloo ranks; {rank: {cell key: result}}."""
    script = tmp / "worker.py"
    script.write_text(WORKER)
    spec = json.dumps({"vs": vs.tolist(), "cells": cells, "n_iter": N_ITER,
                       "chunk": CHUNK, "knobs": KNOBS})
    init = f"file://{tmp / 'rendezvous'}"
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(k), str(world), init,
             str(tmp / f"rank{k}.json"), spec],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(world)
    ]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return {k: json.loads((tmp / f"rank{k}.json").read_text()) for k in range(world)}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return _world(tmp_path_factory.mktemp("world4"), M, _stack(SEED, M, D, R), CELLS)


@pytest.fixture(scope="module")
def reference():
    """The reference's collectives (xla, svd, qr) on 4 fake devices, each
    (topology, comm_bits) cell and the degraded ring cell, run once."""
    out = run_with_devices(f"""
        import json
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.comm import Membership
        from repro.compat import make_mesh, shard_map
        from repro.core.distributed import (
            procrustes_average_collective, sign_average_collective)

        g = np.random.default_rng({SEED}).standard_normal(({M}, {D}, {R}))
        vs = jnp.asarray(np.linalg.qr(g)[0].astype(np.float32))
        mesh = make_mesh(({M},), ("data",))
        res = {{}}
        cells = [(t, b, ()) for t in {TOPOS!r} for b in {BITS!r}]
        cells.append(("ring", 8, {DEAD!r}))
        for topo, bits, dead in cells:
            mem = Membership.from_dead({M}, dead) if dead else None
            fn = jax.jit(shard_map(
                lambda v, t=topo, b=bits, mm=mem: procrustes_average_collective(
                    v[0], axis_name="data", n_iter={N_ITER}, topology=t,
                    comm_bits=b, ring_chunk={CHUNK}, membership=mm)[None],
                mesh=mesh, in_specs=P("data", None, None),
                out_specs=P("data", None, None), check_vma=False))
            res[f"{{topo}}/{{bits}}/" + ",".join(map(str, dead))] = np.asarray(fn(vs)[0]).tolist()
        sign = jax.jit(shard_map(
            lambda v: sign_average_collective(v[0][:, :1], axis_name="data")[None],
            mesh=mesh, in_specs=P("data", None, None),
            out_specs=P("data", None, None), check_vma=False))
        res["sign"] = np.asarray(sign(vs)[0]).tolist()
        print("RESULT", json.dumps(res))
        """, n_devices=M)
    line = next(s for s in out.splitlines() if s.startswith("RESULT "))
    return {k: np.asarray(v) for k, v in json.loads(line[7:]).items()}


@pytest.mark.parametrize("topo,bits,knobs,dead", CELLS)
def test_collective_cube_matches_reference(port, reference, topo, bits, knobs, dead):
    got = np.asarray(port[0][_key(topo, bits, knobs, dead)]["out"])
    want = reference[f"{topo}/{bits}/{','.join(map(str, dead))}"]
    assert got.shape == (D, R) and np.isfinite(got).all()
    assert subspace_dist64(got, want) <= PARITY_TOL[bits]
    np.testing.assert_allclose(got.T @ got, np.eye(R), atol=1e-5)


@pytest.mark.parametrize("topo,bits,knobs,dead", CELLS)
def test_every_rank_holds_the_same_answer(port, topo, bits, knobs, dead):
    key = _key(topo, bits, knobs, dead)
    first = np.asarray(port[0][key]["out"])
    for k in range(1, M):
        np.testing.assert_allclose(np.asarray(port[k][key]["out"]), first, atol=1e-5)


def _rank_bits(topo, bits, knobs, dead):
    """What one rank hands to torch.distributed, from the cost model."""
    mem = Membership.from_dead(M, dead) if dead else None
    cost = comm_cost(topo, m=M, d=D, r=R, n_iter=N_ITER, comm_bits=bits,
                     membership=mem)
    if topo == "psum":
        return cost.bits
    if topo == "gather":
        assert cost.bits % M == 0
        return cost.bits // M
    if knobs == "plain":
        return cost.bits  # ring_rounds: one message per hop, as modelled
    msg = message_bits(D, R, bits)
    staged = 1 if bits == 32 else N_ITER
    if not dead:
        hops = cost.kind_bits["collective-permute"]
        assert staged * msg * (M - 1) * (N_ITER // staged) == hops
    return msg + staged * msg  # broadcast + the staged all-gathers


@pytest.mark.parametrize("topo,bits,knobs,dead", CELLS)
def test_bytes_handed_to_torch_distributed_match_comm_cost(port, topo, bits, knobs, dead):
    key = _key(topo, bits, knobs, dead)
    want = _rank_bits(topo, bits, knobs, dead)
    for k in range(M):
        if topo == "ring" and knobs == "plain" and k in dead:
            continue  # a dead rank takes no hops
        assert port[k][key]["bytes"] * 8 == want, (k, port[k][key]["bytes"] * 8, want)


def test_sign_average_collective_matches_reference(port, reference):
    """Rank-1 sign fixing (Garber et al.) over the group."""
    for k in range(M):
        np.testing.assert_allclose(np.asarray(port[k]["sign"]["out"]),
                                   reference["sign"], atol=1e-6)


def test_fused_ring_at_eight_ranks_matches_serial_reference(tmp_path):
    vs = _stack(SEED + 1, 8, D, R)
    res = _world(tmp_path, 8, vs, [("ring", 32, "fused", ())])
    want = np.asarray(jeig.refinement_rounds(vs, n_iter=N_ITER))
    for k in range(8):
        got = np.asarray(res[k][_key("ring", 32, "fused", ())]["out"])
        assert subspace_dist64(got, want) <= PARITY_TOL[32]


def test_launcher_under_torchrun_matches_one_process_run():
    """Two CPU ranks over gloo run the fused ring cell on shards 0 and 1
    of the data rule; the one-process launcher stacks the same shards."""
    # Under torchrun the width flags take their long spellings (some
    # torchrun versions read "--d" and "--r" as prefixes of their own).
    args = ["--device", "cpu", "--backend", "cuda", "--polar", "newton-schulz",
            "--orth", "cholesky-qr2", "--n-per-shard", "512", "--solver", "eigh"]
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}

    def stats(cmd):
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return dict(line.split(": ", 1) for line in proc.stdout.strip().splitlines())

    ranks = stats([sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc-per-node", "2", "-m", "repro_torch.launch.eigen",
                   "--topology", "ring", "--comm-bits", "32", "--dim", "128",
                   "--subspace-rank", "6", *args])
    one = stats([sys.executable, "-m", "repro_torch.launch.eigen", "--shards", "2",
                 "--d", "128", "--r", "6", *args])
    assert ranks["d"] == one["d"] == "128" and ranks["r"] == one["r"] == "6"
    assert ranks["topology"] == "ring" and ranks["ranks"] == "2"
    assert ranks["transport"].endswith("gloo") and ranks["staged_bytes"] == "0"
    assert one["topology"] == "gather" and one["m"] == ranks["m"] == "2"
    for k in ("dist_central", "dist_naive", "dist_local0"):
        assert ranks[k] == one[k]
    assert abs(float(ranks["dist_aligned"]) - float(one["dist_aligned"])) < 1e-5

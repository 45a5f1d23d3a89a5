"""Port parity of the remote-hop fused ring round (B7,
``fused_ring_round_remote``) on gloo CPU worlds.

The reference's own B7 (``repro.kernels.procrustes_align.
fused_ring_round_remote``) runs only compiled on a TPU: off-TPU it raises
(``tests/test_fused_ring.py:285``), so it cannot be run here.  Its two
stand-ins are the functions its round equals on the stack the ring hands
rank j, in hop order (own basis, then ranks j-1, j-2, ...):

* ``repro.kernels.ref.fused_ring_round``, the oracle of the staged ring
  round, on that rolled stack;
* ``repro.kernels.procrustes_align.fused_ring_round``, the staged ring
  round's Pallas kernel, in interpret mode, on the same stack.

In worlds of 1, 2, 3, 4 and 8 ranks (one process each, ``file://``
rendezvous in a temporary directory), every rank runs the port's B7
wrapper on CPU tensors, which takes its plain version (each hop a
``transport.ring_shift``) and launches nothing.  Bars: 1e-5 f64 subspace
distance and 1e-5 max abs against both stand-ins (f32 sums in another
order), and the ranks agree to 1e-6 max abs (each sums the same m
contributions in its own order).  Two rounds through
``comm.ring.remote_ring_rounds`` are held against the oracle's round
applied twice.  The wrapper's refusals (dtype, shape, device) need no
world.  The kernel itself is held against this plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SRC
from repro.kernels import procrustes_align as jpa
from repro.kernels import ref as jref
from repro_torch.core.metrics import subspace_dist64
from repro_torch.kernels import procrustes_align as tpa

WORLDS = (1, 2, 3, 4, 8)
SHAPES = ((96, 4), (205, 5))  # block-aligned and ragged d
N_ROUNDS = 2
TOL, AGREE = 1e-5, 1e-6

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, out_path, spec = sys.argv[1:6]
rank, world = int(rank), int(world)
with open(spec) as f:
    spec = json.load(f)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
from repro_torch import kernels
from repro_torch.comm.ring import remote_ring_rounds
from repro_torch.kernels import ops, procrustes_align as pa

group = dist.group.WORLD
res = {}
kernels.reset_launch_counts()
for key, stack in spec["stacks"].items():
    vs = torch.from_numpy(np.asarray(stack, np.float32))
    v, ref = vs[rank].contiguous(), vs[0].contiguous()
    res[key] = {
        "wrapper": pa.fused_ring_round_remote(v, ref, group=group).tolist(),
        "ops": ops.fused_ring_round_remote(v, ref, group=group).tolist(),
        "rounds": remote_ring_rounds(v, group=group, n_iter=spec["n_rounds"]).tolist(),
    }
res["launches"] = kernels.launch_counts()
dist.destroy_process_group()
with open(out_path, "w") as f:
    json.dump(res, f)
"""


def _stack(seed, m, d, r):
    """Noisy orthonormal copies of one subspace, from a numpy seed."""
    g = np.random.default_rng(seed)
    base = np.linalg.qr(g.standard_normal((d, r)))[0]
    noisy = base[None] + 0.1 / np.sqrt(d) * g.standard_normal((m, d, r))
    return np.linalg.qr(noisy)[0].astype(np.float32)


def _key(d, r):
    return f"{d}x{r}"


def _rolled(vs, j):
    """The stack in rank j's hop order: own basis, then j-1, j-2, ..."""
    m = vs.shape[0]
    return vs[[(j - h) % m for h in range(m)]]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: (stacks, [per-rank results])}, each world one set of rank
    processes over gloo."""
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"world{world}")
        stacks = {_key(d, r): _stack(world * 1000 + d, world, d, r) for d, r in SHAPES}
        script = tmp / "worker.py"
        script.write_text(WORKER)
        spec = tmp / "spec.json"
        spec.write_text(json.dumps({"stacks": {k: v.tolist() for k, v in stacks.items()},
                                    "n_rounds": N_ROUNDS}))
        env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(k), str(world),
             f"file://{tmp / 'rendezvous'}", str(tmp / f"rank{k}.json"), str(spec)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for k in range(world)]
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
        out[world] = (stacks, [json.loads((tmp / f"rank{k}.json").read_text())
                               for k in range(world)])
    return out


def _hold(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert subspace_dist64(got, want) <= TOL
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("d,r", SHAPES)
@pytest.mark.parametrize("world", WORLDS)
def test_plain_round_matches_staged_oracle_and_pallas(worlds, world, d, r):
    stacks, res = worlds[world]
    vs = stacks[_key(d, r)]
    ref = jnp.asarray(vs[0])
    for j in range(world):
        rolled = jnp.asarray(_rolled(vs, j))
        got = res[j][_key(d, r)]["wrapper"]
        _hold(got, jref.fused_ring_round(rolled, ref))
        _hold(got, jpa.fused_ring_round(rolled, ref, interpret=True))
        np.testing.assert_array_equal(np.asarray(res[j][_key(d, r)]["ops"]), got)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree(worlds, world):
    _, res = worlds[world]
    for d, r in SHAPES:
        first = np.asarray(res[0][_key(d, r)]["wrapper"])
        for j in range(1, world):
            assert np.abs(np.asarray(res[j][_key(d, r)]["wrapper"]) - first).max() <= AGREE


@pytest.mark.parametrize("world", WORLDS)
def test_remote_ring_rounds_chain_the_rounds(worlds, world):
    """``remote_ring_rounds``: round k's output is round k+1's reference,
    from the first rank's basis; no launch on CPU tensors."""
    stacks, res = worlds[world]
    for d, r in SHAPES:
        vs = stacks[_key(d, r)]
        for j in range(world):
            rolled = jnp.asarray(_rolled(vs, j))
            want = jnp.asarray(vs[0])
            for _ in range(N_ROUNDS):
                want = jref.fused_ring_round(rolled, want)
            _hold(res[j][_key(d, r)]["rounds"], want)
    assert all(c == 0 for rk in res for c in rk["launches"].values())


def test_wrapper_refusals():
    """dtype, shape, contiguity and device are checked before any
    collective (no group is needed to be refused)."""
    v = torch.from_numpy(_stack(0, 1, 32, 3)[0])
    with pytest.raises(TypeError):
        tpa.fused_ring_round_remote(v.double(), v.double(), group=None)
    with pytest.raises(TypeError):
        tpa.fused_ring_round_remote(v.to(torch.bfloat16), v, group=None)
    with pytest.raises(ValueError, match=r"\(d, r\)"):
        tpa.fused_ring_round_remote(v[None], v[None], group=None)
    with pytest.raises(ValueError, match=r"\(d, r\)"):
        tpa.fused_ring_round_remote(v, v[:, :2].contiguous(), group=None)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.fused_ring_round_remote(v.T, v.T, group=None)
    with pytest.raises(ValueError, match="different devices"):
        tpa.fused_ring_round_remote(v, v.to("meta"), group=None)
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.fused_ring_round_remote(v.to("meta"), v.to("meta"), group=None)

"""On-card checks of the port's CUDA kernels (marker ``cuda``).

Skipped where there is no Hopper card; run them on one with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors at ragged shapes, the wrappers' refusals are checked, and every
launch is seen on its counter.  Tolerance: 4 eps sqrt(k) times the largest
plain entry for an f32 sum of k products in two orders; 1e-4 for the 24
Newton-Schulz steps and for the whole fused rounds (B5, B6), which are
also held at 1e-5 f64 subspace distance.  The cross-rank lanes run the
collective on the card: two ranks sharing one card over gloo, and two
ranks with a card each over NCCL (skipped below two cards; not yet run
on such a machine).
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core.metrics import subspace_dist64

from repro_torch import kernels
from repro_torch.kernels import covariance as tcov
from repro_torch.kernels import procrustes_align as tpa
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.cuda
EPS32 = 2.0 ** -23


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the port's kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _hold(got, want, k):
    tol = 4 * EPS32 * math.sqrt(k) * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol, (err, tol)


def _stack(dev, m, d, r, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.linalg.qr(torch.randn(d, r, generator=g, device=dev))[0]
    noise = torch.randn(m, d, r, generator=g, device=dev) * (0.1 / math.sqrt(d))
    return torch.linalg.qr(base[None] + noise)[0].contiguous()


@pytest.mark.parametrize("n,d", [(257, 205), (64, 64), (1000, 300), (0, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("symmetric", [False, True])
def test_gram_kernel(dev, n, d, dtype, symmetric):
    x = torch.randn(n, d, device=dev).to(dtype)
    before = tcov.gram.launches
    got = tcov.gram(x, symmetric=symmetric)
    torch.cuda.synchronize()
    assert tcov.gram.launches == before + 1
    _hold(got, tref.gram(x), max(n, 1))


def test_gram_kernel_stack(dev):
    x = torch.randn(3, 300, 129, device=dev)
    _hold(tcov.gram(x), tref.gram(x), 300)


@pytest.mark.parametrize("m,d,r", [(3, 205, 5), (1, 130, 3), (8, 1000, 128), (2, 96, 1)])
def test_procrustes_kernels(dev, m, d, r):
    vs = _stack(dev, m, d, r)
    ref = vs[0].contiguous()
    kernels.reset_launch_counts()
    _hold(tpa.batched_gram(vs, ref), tref.batched_gram(vs, ref), d)
    z = tpa.batched_gram_polar(vs, ref)
    assert (z - tref.batched_gram_polar(vs, ref)).abs().max().item() <= 1e-4
    out = tpa.align_average(vs, z)
    _hold(out, tref.align_average(vs, z), m * r)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "gram": 0, "batched_gram": 1, "batched_gram_polar": 1, "align_average": 1,
        "fused_round": 0, "fused_ring_round": 0,
    }


def test_gram_stage_and_apply_beyond_one_tile(dev):
    """r = 200 spans several 64-wide output tiles (no Newton-Schulz:
    above its shared-memory limit)."""
    vs = _stack(dev, 2, 300, 200)
    ref = vs[0].contiguous()
    _hold(tpa.batched_gram(vs, ref), tref.batched_gram(vs, ref), 300)
    zs = tref.batched_gram_polar(vs, ref)
    _hold(tpa.align_average(vs, zs), tref.align_average(vs, zs), 2 * 200)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    vs = _stack(dev, 2, 64, 4)
    with pytest.raises(TypeError):
        tcov.gram(torch.randn(8, 4, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        tcov.gram(torch.randn(4, 8, device=dev).T)  # not contiguous
    with pytest.raises(TypeError):
        tpa.batched_gram(vs.double(), vs[0].double())
    with pytest.raises(ValueError):
        tpa.batched_gram(vs, vs[0].T.contiguous())  # wrong shape
    with pytest.raises(ValueError):
        tpa.align_average(vs, torch.zeros(2, 4, 4, device=dev).mT)
    big = torch.zeros(1, 16, 140, device=dev)
    with pytest.raises(ValueError):
        tpa.batched_gram_polar(big, big[0])  # r above the shared-memory limit


def _hold_round(got, want):
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-4
    assert subspace_dist64(got, want) <= 1e-5


@pytest.mark.parametrize("m,d,r", [(3, 205, 5), (1, 130, 3), (4, 300, 136), (2, 96, 1)])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_fused_round_kernel(dev, m, d, r, n_iter):
    vs = _stack(dev, m, d, r)
    ref = vs[0].contiguous()
    kernels.reset_launch_counts()
    _hold_round(tpa.fused_round(vs, ref, n_iter=n_iter),
                tref.fused_round(vs, ref, n_iter=n_iter))
    assert kernels.launch_counts()["fused_round"] == n_iter


def test_fused_round_kernel_takes_the_shift(dev):
    """A zero last column in every basis: a zero pivot, the shifted retry
    in both CholeskyQR passes."""
    vs = _stack(dev, 3, 205, 5)
    vs[:, :, -1] = 0
    got = tpa.fused_round(vs, vs[0].contiguous())
    want = tref.fused_round(vs, vs[0].contiguous())
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    assert got[:, -1].abs().max().item() == 0.0


def _int8_wire(vs, seed=0):
    g = torch.Generator(device=vs.device).manual_seed(seed)
    scales = (vs.abs().amax(dim=1) / 127.0).contiguous()
    u = torch.rand(vs.shape, generator=g, device=vs.device)
    q = torch.clamp(torch.floor(vs / scales[:, None, :] + u), -127, 127)
    return q.to(torch.int8).contiguous(), scales


@pytest.mark.parametrize("m,d,r", [(3, 205, 5), (4, 96, 8), (1, 7, 3)])
@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("chunk", [None, 33, 1])
def test_fused_ring_round_kernel(dev, m, d, r, wire, chunk):
    vs = _stack(dev, m, d, r)
    ref = vs[0].contiguous()
    scales = None
    if wire == "bf16":
        vs = vs.to(torch.bfloat16)
    elif wire == "int8":
        vs, scales = _int8_wire(vs)
    before = tpa.fused_ring_round.launches
    got = tpa.fused_ring_round(vs, ref, scales, ring_chunk=chunk)
    assert tpa.fused_ring_round.launches == before + 1
    _hold_round(got, tref.fused_ring_round(vs, ref, scales))


def test_fused_wrappers_refuse_what_the_kernels_do_not_take(dev):
    vs = _stack(dev, 2, 64, 4)
    ref = vs[0].contiguous()
    with pytest.raises(TypeError):
        tpa.fused_round(vs.double(), ref.double())
    with pytest.raises(TypeError):
        tpa.fused_round(vs.to(torch.bfloat16), ref)
    with pytest.raises(ValueError):
        tpa.fused_round(vs, ref.T.contiguous())
    with pytest.raises(ValueError):
        tpa.fused_ring_round(vs.half(), ref)  # not a wire dtype
    with pytest.raises(ValueError):
        tpa.fused_ring_round(vs, ref, torch.ones(2, 4, device=dev))
    with pytest.raises(ValueError):
        tpa.fused_ring_round(vs.to(torch.int8), ref)
    with pytest.raises(TypeError):
        tpa.fused_ring_round(vs, ref.double())
    big = torch.zeros(1, 16, 140, device=dev)
    with pytest.raises(ValueError, match="136"):
        tpa.fused_round(big, big[0])
    with pytest.raises(ValueError, match="136"):
        tpa.fused_ring_round(big, big[0])


_WORKER = r"""
import json, sys
import torch
from repro_torch.core.distributed import procrustes_average_collective
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.mesh import make_aggregation_mesh

rank, world, init, out_path, stack_path = sys.argv[1:6]
rank, world = int(rank), int(world)
agg = make_aggregation_mesh(device="cuda", rank=rank, world_size=world,
                            local_rank=rank, local_world=world, init_method=init)
vs = torch.load(stack_path).to(agg.device)
res = {"backend": agg.backend}
for topo, bits in (("ring", 32), ("ring", 8), ("psum", 32)):
    reset_launch_counts()
    polar, orth = (("newton-schulz", "cholesky-qr2") if topo == "ring"
                   else ("svd", "qr"))
    out = procrustes_average_collective(
        vs[rank].contiguous(), group=agg.group, n_iter=2, backend="cuda",
        polar=polar, orth=orth, topology=topo, comm_bits=bits, ring_chunk=33)
    torch.cuda.synchronize()
    res[f"{topo}{bits}"] = {"out": out.cpu().tolist(), "launches": launch_counts()}
torch.distributed.destroy_process_group()
json.dump(res, open(out_path, "w"))
"""


def _cross_rank_lane(tmp_path, world, cards_needed):
    if torch.cuda.device_count() < cards_needed:
        pytest.skip(f"needs {cards_needed} CUDA cards")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    vs = _stack(torch.device("cuda", 0), world, 205, 5).cpu()
    torch.save(vs, tmp_path / "vs.pt")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": src}
    if cards_needed == 1:
        env["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(k), str(world), f"file://{tmp_path / 'rdv'}",
         str(tmp_path / f"r{k}.json"), str(tmp_path / "vs.pt")],
        env=env, stderr=subprocess.PIPE, text=True) for k in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    res = [json.loads((tmp_path / f"r{k}.json").read_text()) for k in range(world)]
    want = tref.fused_round(vs, vs[0].contiguous(), n_iter=2)
    for r in res:
        assert r["ring32"]["launches"]["fused_ring_round"] == 2
        assert r["psum32"]["launches"]["batched_gram"] == 2
        assert r["psum32"]["launches"]["align_average"] == 2
        assert subspace_dist64(torch.tensor(r["ring32"]["out"]), want) <= 1e-5
        assert subspace_dist64(torch.tensor(r["ring8"]["out"]), want) <= 0.25
        assert subspace_dist64(torch.tensor(r["psum32"]["out"]), want) <= 1e-5
    return res


def test_cross_rank_lane_two_ranks_one_card_gloo(dev, tmp_path):
    res = _cross_rank_lane(tmp_path, 2, 1)
    assert all(r["backend"] == "gloo" for r in res)


def test_cross_rank_lane_nccl_one_card_each(dev, tmp_path):
    """The NCCL lane: one rank per card.  Skips on a one-card machine."""
    res = _cross_rank_lane(tmp_path, 2, 2)
    assert all(r["backend"] == "nccl" for r in res)

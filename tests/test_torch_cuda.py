"""On-card checks of the port's CUDA kernels (marker ``cuda``).

Skipped where there is no Hopper card; run them on one with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(``-k "flash or align"`` for B8's and B4's alone).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors at ragged shapes, the wrappers' refusals are checked, and every
launch is seen on its counter.  B1 computes its upper tiles and mirrors
them: ``gram(x)`` and ``gram(x, symmetric=True)`` (the reference's option,
which changes nothing here) give the same bits and an exactly symmetric
result, and ptxas must report its kernels within 128 registers and
without spills (B8's wide kernel: without spills).  B3, B5, B6 and B7 also run at
r = 137, 192 and 256, where B5/B6's Newton-Schulz and Cholesky tiles live
in a global workspace and B3's and B7's grouped Newton-Schulz form streams
its iterate from L2; B8 at head_dim 136, 192 and 256 (its wide form);
and a subprocess makes one of B8's bounded waits run out and sees the
launch failure, then the wrapper's error.  B2 runs at the edges of its
128-wide tile and its clusters (m 1, 8, 17; d 1 .. 8192; r 1 .. 256); B2,
B3, B5 and B6 give the same bits on a second call; B5 and B6 run in each
Newton-Schulz form (grouped, one block a machine, workspace) and report
the one they ran; B3 runs its grouped form at ragged shapes, r up to 256
and m past the groups the grid holds, and reports its form; ptxas must
report no spills in B2, the round kernels, B3's Newton-Schulz kernel and
B7's hop kernel.  Tolerance: 4 eps sqrt(k) times the largest
plain entry for an f32 sum of k products in two orders; 1e-4 for the 24
Newton-Schulz steps and for the whole fused rounds (B5, B6), which are
also held at 1e-5 f64 subspace distance.  B4 also at the edges of its
64-row, 128-column block (r 1 .. 136, d 1 .. 8192, m 1 and 8), bit for
bit the same on a second call.  B8 (flash attention): 2e-5 in f32 and
3e-2 in bf16, the reference's own kernel-test bars, bf16 also per query
row (2^-7 max|want_row| + 1e-4), at the 128-row and 128-key tile edges,
every head_dim class, window edges, MQA, rows without keys and a batch
whose heads would show a read across a head's edge; the built library's
bf16 kernel is made of wgmma and TMA instructions (cuobjdump); a reduced
config served through B8 and through plain attention gives the same
greedy tokens in f32.  The cross-rank lanes run the
collective on the card: two ranks sharing one card over gloo, and two
ranks with a card each over NCCL (skipped below two cards; not yet run
on such a machine).  B7 (the remote-hop ring round) runs in worlds of
1, 2, 3 and 8 rank processes sharing one card, three rounds each on the
same mapped buffers, held like B5/B6 against its plain version and
against B6's plain version on the stack in each rank's hop order; a
world whose neighbour never signals raises after the wait bound; and
one rank per card over NVLink (skipped below two cards; not yet run).
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
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
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


@pytest.mark.parametrize("shape", [(257, 205), (64, 64), (1000, 300), (0, 17),
                                   (3, 300, 129), (300, 256), (130, 1000)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_symmetric_is_bit_identical(dev, shape, dtype):
    """``symmetric`` changes nothing: both calls give the same bits, and
    each mirrored tile equals its transpose exactly (one ascending sum over
    the rows per element, and fmaf is symmetric in its products)."""
    x = torch.randn(*shape, device=dev).to(dtype)
    full, sym = tcov.gram(x), tcov.gram(x, symmetric=True)
    torch.cuda.synchronize()
    assert torch.equal(full, sym)
    assert torch.equal(sym, sym.mT)


@pytest.mark.parametrize("sizes", [(1, 127, 129, 4096), (0, 300, 0, 77), (2, 3)],
                         ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_ingest_through_gram_kernel(dev, sizes, dtype):
    """The streaming accumulator's ingest under the cuda backend: one B1
    launch a non-empty chunk, none for an empty one (the state keeps its
    bits), an f32 state for a bf16 chunk, and the chunked state against
    the plain ingest (``gram_increment``) over the same chunks."""
    from repro_torch.core.covariance import gram_increment
    from repro_torch.stream import Accumulator

    d = 205
    acc = Accumulator(d, device=dev, backend="cuda")
    want = torch.zeros((d, d), device=dev)
    kernels.reset_launch_counts()
    for n in sizes:
        x = torch.randn(n, d, device=dev).to(dtype)
        before = acc.state["gram"].clone()
        acc.update(x)
        torch.cuda.synchronize()
        if n == 0:
            assert torch.equal(acc.state["gram"], before)
        want += gram_increment(x)
    assert kernels.launch_counts()["gram"] == sum(1 for n in sizes if n)
    assert acc.dtype == torch.float32 and int(acc.count) == sum(sizes)
    _hold(acc.state["gram"], want, max(sum(sizes), 1))


def test_stream_service_ingest_launches_gram_per_live_shard(dev):
    """The stacked service on the card: B1 once a live shard a step, none
    for a dead one, the bootstrap refresh through the plan's kernels."""
    from repro_torch.comm import Membership
    from repro_torch.stream import SubspaceService

    svc = SubspaceService(256, 4, shards=3, device=dev, cadence=10, backend="cuda",
                          membership=Membership.from_dead(3, [1]))
    kernels.reset_launch_counts()
    svc.observe(torch.randn(3, 300, 256, device=dev))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["gram"] == 2 and counts["batched_gram"] == 1
    assert int(svc.state["count"][1]) == 0 and svc.stats["refreshes"] == 1


def test_gram_kernel_has_no_spills(dev):
    """ptxas: every instance of the B1 kernel (f32 / bf16, 16-byte copies
    or plain loads) fits 128 registers, two blocks an SM, with no spills."""
    from repro_torch.kernels import _build

    usage = {k: u for k, u in _build.ptxas_usage("covariance.cu").items()
             if "gram_kernel" in k}
    assert len(usage) == 4, usage
    for name, u in usage.items():
        assert u["registers"] <= 128 and u["spill_stores"] == 0, (name, u)


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
        "fused_round": 0, "fused_ring_round": 0, "fused_ring_round_remote": 0,
        "flash_attention": 0,
    }


def test_gram_stage_and_apply_beyond_one_tile(dev):
    """r = 200 spans several 64-wide output tiles."""
    vs = _stack(dev, 2, 300, 200)
    ref = vs[0].contiguous()
    _hold(tpa.batched_gram(vs, ref), tref.batched_gram(vs, ref), 300)
    zs = tref.batched_gram_polar(vs, ref)
    _hold(tpa.align_average(vs, zs), tref.align_average(vs, zs), 2 * 200)


@pytest.mark.parametrize("r", [137, 192, 256])
def test_newton_schulz_kernels_past_shared_memory(dev, r):
    """Past r = 136 the Newton-Schulz and Cholesky tiles live in a global
    workspace: B3, B5 and B6 (every wire) held to their plain versions
    with the bars of r <= 136."""
    vs = _stack(dev, 3, 300, r)
    ref = vs[0].contiguous()
    kernels.reset_launch_counts()
    z = tpa.batched_gram_polar(vs, ref)
    torch.cuda.synchronize()
    assert (z - tref.batched_gram_polar(vs, ref)).abs().max().item() <= 1e-4
    _hold_round(tpa.fused_round(vs, ref, n_iter=2), tref.fused_round(vs, ref, n_iter=2))
    for wire in ("f32", "bf16", "int8"):
        w, scales = vs, None
        if wire == "bf16":
            w = vs.to(torch.bfloat16)
        elif wire == "int8":
            w, scales = _int8_wire(vs)
        _hold_round(tpa.fused_ring_round(w, ref, scales, ring_chunk=33),
                    tref.fused_ring_round(w, ref, scales))
    counts = kernels.launch_counts()
    assert (counts["batched_gram_polar"], counts["fused_round"],
            counts["fused_ring_round"]) == (1, 2, 3)


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("d", [1, 63, 64, 65, 8192])
@pytest.mark.parametrize("r", [1, 5, 127, 128, 130, 136])
def test_align_average_kernel_edges(dev, m, d, r):
    """B4 at the edges of its 64-row, 128-column block and its 16-deep
    slices: r below, at and above one column tile (and r % 4 != 0, the
    4-byte copy path), d below, at and past one row tile, one machine and
    eight.  Two calls give the same bits (a fixed summation order)."""
    g = torch.Generator(device=dev).manual_seed(m * 100003 + d * 131 + r)
    vs = torch.randn(m, d, r, generator=g, device=dev)
    zs = torch.linalg.qr(torch.randn(m, r, r, generator=g, device=dev))[0].contiguous()
    before = tpa.align_average.launches
    got = tpa.align_average(vs, zs)
    again = tpa.align_average(vs, zs)
    torch.cuda.synchronize()
    assert tpa.align_average.launches == before + 2
    assert got.shape == (d, r) and got.dtype == torch.float32
    _hold(got, tref.align_average(vs, zs), m * r)
    assert torch.equal(got, again)


@pytest.mark.parametrize("m", [1, 8, 17])
@pytest.mark.parametrize("d", [1, 63, 65, 8192])
@pytest.mark.parametrize("r", [1, 5, 127, 128, 129, 136, 137, 256])
def test_batched_gram_kernel_edges(dev, m, d, r):
    """B2 (one launch, the splits of d summed across a thread-block
    cluster) at the edges of its 128-wide tile and 32-row slices, with one
    block (d < 64) and clusters of several: r off the tile and off float4
    rows, d below and past one slice; two calls give the same bits."""
    g = torch.Generator(device=dev).manual_seed(m * 100003 + d * 131 + r)
    vs = torch.randn(m, d, r, generator=g, device=dev)
    ref = torch.randn(d, r, generator=g, device=dev)
    before = tpa.batched_gram.launches
    got = tpa.batched_gram(vs, ref)
    again = tpa.batched_gram(vs, ref)
    torch.cuda.synchronize()
    assert tpa.batched_gram.launches == before + 2
    assert got.shape == (m, r, r) and got.dtype == torch.float32
    _hold(got, tref.batched_gram(vs, ref), d)
    assert torch.equal(got, again)


def test_batched_gram_kernel_has_no_spills(dev):
    """ptxas: both B2 instances (16-byte copies or register fetches) and
    the six round instances (f32, bf16, int8 wires, each with 16-byte
    copies or register fetches) spill nothing."""
    from repro_torch.kernels import _build

    for source, kernel, count in (("procrustes_align.cu", "batched_gram_kernel", 2),
                                  ("fused_round.cu", "fused_round_kernel", 6)):
        usage = {k: u for k, u in _build.ptxas_usage(source).items() if kernel in k}
        assert len(usage) == count, usage
        for name, u in usage.items():
            assert u["spill_stores"] == 0 and u["spill_loads"] == 0, (name, u)


@pytest.mark.parametrize("m,d,r,form", [
    (8, 8192, 128, "grouped, 16 blocks a machine"),
    (3, 205, 5, "one block a machine, shared-memory tiles"),
    (33, 1000, 130, "grouped, 4 blocks a machine"),
    (200, 300, 16, "one block a machine, shared-memory tiles"),
    (3, 300, 137, "grouped, 9 blocks a machine, iterate streamed from L2"),
    (8, 1000, 192, "grouped, 12 blocks a machine, iterate streamed from L2"),
    (8, 333, 256, "grouped, 16 blocks a machine, iterate streamed from L2"),
    (40, 257, 255, "grouped, 3 blocks a machine, iterate streamed from L2"),
    (200, 300, 141, "one block a machine, iterate streamed from L2"),
])
def test_batched_gram_polar_grouped_forms(dev, m, d, r, form):
    """B3's Newton-Schulz pass on a group of blocks a machine at every r:
    the iterate staged in shared memory up to r = 136 and streamed from L2
    past it; r % 4 != 0 (plain loads), m beyond the groups the grid holds
    (the groups take the machines in turn), d off every tile.  Held to its
    plain version at 1e-4, the same bits on a second call, one launch a
    call, and the form it reports (for a 132-SM card)."""
    vs = _stack(dev, m, d, r)
    ref = vs[0].contiguous()
    before = tpa.batched_gram_polar.launches
    got = tpa.batched_gram_polar(vs, ref)
    again = tpa.batched_gram_polar(vs, ref)
    torch.cuda.synchronize()
    assert tpa.batched_gram_polar.launches == before + 2
    assert got.shape == (m, r, r) and bool(torch.isfinite(got).all())
    assert (got - tref.batched_gram_polar(vs, ref)).abs().max().item() <= 1e-4
    assert torch.equal(got, again)
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert tpa.batched_gram_polar.last_form == form
    else:
        assert tpa.batched_gram_polar.last_form.endswith(
            "iterate streamed from L2" if r > tpa.NS_SMEM_MAX_R else "a machine")


def test_newton_schulz_group_kernels_have_no_spills(dev):
    """ptxas: B3's Newton-Schulz kernel (both grouped forms in one
    instance) and both instances of B7's hop kernel spill nothing."""
    from repro_torch.kernels import _build

    for source, kernel, count in (("procrustes_align.cu", "ns_group_kernel", 1),
                                  ("fused_ring_remote.cu", "remote_hop_kernel", 2)):
        usage = {k: u for k, u in _build.ptxas_usage(source).items() if kernel in k}
        assert len(usage) == count, usage
        for name, u in usage.items():
            assert u["spill_stores"] == 0 and u["spill_loads"] == 0, (name, u)


def test_round_kernels_give_the_same_bits_twice(dev):
    """B2, B3, B5 and B6 (every wire) sum in a fixed order: a second call
    gives the same bits."""
    vs = _stack(dev, 8, 8192, 128)
    ref = vs[0].contiguous()
    w8, scales = _int8_wire(vs)
    calls = {
        "B2": lambda: tpa.batched_gram(vs, ref),
        "B3": lambda: tpa.batched_gram_polar(vs, ref),
        "B5": lambda: tpa.fused_round(vs, ref, n_iter=2),
        "B6 f32": lambda: tpa.fused_ring_round(vs, ref),
        "B6 bf16": lambda: tpa.fused_ring_round(vs.to(torch.bfloat16), ref),
        "B6 int8": lambda: tpa.fused_ring_round(w8, ref, scales),
    }
    for name, call in calls.items():
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second), name


@pytest.mark.parametrize("m,d,r,form", [
    (8, 8192, 128, "grouped, 16 blocks a machine"),
    (33, 1000, 128, "grouped, 4 blocks a machine"),
    (200, 300, 16, "one block a machine, shared-memory tiles"),
    (3, 205, 5, "one block a machine, shared-memory tiles"),
    (33, 1000, 137, "one block a machine, workspace tiles"),
    (8, 1000, 256, "one block a machine, workspace tiles"),
])
def test_fused_round_newton_schulz_forms(dev, m, d, r, form):
    """B5 and B6 (every wire) report the Newton-Schulz form they ran and
    hold their plain versions in each: a group of blocks a machine, one
    block a machine when m exceeds what the grid can group (the blocks
    take machines in turn), and the workspace tiles past r = 136.  The
    forms assume a 132-SM card (one round block an SM)."""
    vs = _stack(dev, m, d, r)
    ref = vs[0].contiguous()
    _hold_round(tpa.fused_round(vs, ref), tref.fused_round(vs, ref))
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert tpa.fused_round.last_form == form
    for wire in ("f32", "bf16", "int8"):
        w, scales = vs, None
        if wire == "bf16":
            w = vs.to(torch.bfloat16)
        elif wire == "int8":
            w, scales = _int8_wire(vs)
        _hold_round(tpa.fused_ring_round(w, ref, scales, ring_chunk=33),
                    tref.fused_ring_round(w, ref, scales))
        assert tpa.fused_ring_round.last_form == tpa.fused_round.last_form


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
    wide = torch.zeros(1, 8, tpa.NS_GROUP_MAX_R + 1, device=dev)
    with pytest.raises(ValueError):  # past the grouped Newton-Schulz form
        tpa.batched_gram_polar(wide, wide[0])


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


# ------------------------------------------------------------- B8 flash ----
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # tests/test_kernels.py


_EDGES = (127, 128, 129, 255, 257, 1000)
_FLASH_CASES = [
    (1, 4, 2, 96, 160, 64, None),     # ragged GQA, suffix queries
    (1, 2, 1, 160, 96, 32, None),     # s > t: rows without keys
    (2, 8, 1, 200, 200, 128, None),   # MQA
    (1, 2, 2, 300, 300, 128, 16),     # window
    (1, 4, 2, 130, 130, 16, 1024),    # reduced head_dim, window above s
    (1, 3, 3, 65, 65, 24, None),      # head_dim padded inside the kernel
    (1, 6, 2, 1, 70, 40, None),       # one query
    (2, 8, 1, 300, 170, 128, None),   # MQA with rows without keys
] + [
    # s and t at, below and past the bf16 kernel's 128-row query tile and
    # 128-key K/V tile (and s > t).
    (1, 4, 2, s, t, hd, None)
    for s, t in [(n, n) for n in _EDGES] + [(127, 1000), (129, 257), (255, 128), (1000, 129)]
    for hd in (64, 128)
] + [
    # Every head_dim class the wrapper takes: one 64-column TMA box
    # (hd <= 64) or two, zero-filled past hd inside the kernel.
    (2, 4, 2, 257, 257, hd, None) for hd in (16, 24, 40, 64, 80, 96, 128)
] + [
    # Window edges at the 128-key tile.
    (1, 4, 2, s, t, 128, window)
    for window in (127, 128, 129) for s, t in ((300, 300), (200, 457))
] + [
    # head_dim past 128: the wide kernel (both dtypes), causal and windowed,
    # ragged s and t, and s > t (rows without keys).
    case for hd in (136, 192, 256) for case in (
        (1, 4, 2, 130, 130, hd, None),
        (1, 4, 2, 200, 257, hd, 16),
        (2, 4, 1, 160, 96, hd, None),
    )
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hq,hkv,s,t,hd,window", _FLASH_CASES)
def test_flash_attention_kernel(dev, b, hq, hkv, s, t, hd, window, dtype):
    """FLASH_TOL over the whole output; bf16 also per query row,
    2^-7 max|want_row| + 1e-4 (one bf16 step of the row's largest value:
    both sides round the same f32 row to bf16 once)."""
    g = torch.Generator(device=dev).manual_seed(s * t + hd)
    q, k, v = (torch.randn(*sh, generator=g, device=dev).to(dtype)
               for sh in ((b, hq, s, hd), (b, hkv, t, hd), (b, hkv, t, hd)))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert tfa.flash_attention.last_form.startswith(
        "wide" if hd > 128 else "wgmma" if dtype == torch.bfloat16 else "f32")
    assert got.dtype == dtype and got.shape == q.shape
    want = tref.flash_attention(q, k, v, causal=True, window=window)
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= FLASH_TOL[dtype]
    if dtype == torch.bfloat16:
        bar = 2.0**-7 * want.abs().amax(-1) + 1e-4
        assert ((got - want).abs().amax(-1) <= bar).all()
    if s > t:
        assert bool((got[:, :, : s - t] == 0).all())


def test_flash_attention_heads_do_not_bleed(dev):
    """A multi-head batch with s and t off every tile edge, and every other
    KV head holding V = 1e3: a box or tile that read across a head's edge
    would carry 1e3 into a neighbour and fail that head's per-row bar."""
    b, hq, hkv, s, t, hd = 3, 8, 4, 200, 333, 80
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(*sh, generator=g, device=dev).to(torch.bfloat16)
               for sh in ((b, hq, s, hd), (b, hkv, t, hd), (b, hkv, t, hd)))
    v[:, 1::2] = 1e3
    got = tfa.flash_attention(q, k, v, causal=True)
    want = tref.flash_attention(q, k, v, causal=True)
    for h in range(hq):
        bar = 2.0**-7 * want[:, h].float().abs().amax(-1) + 1e-4
        err = (got[:, h].float() - want[:, h].float()).abs().amax(-1)
        assert (err <= bar).all(), h


def test_flash_attention_bf16_path_is_wgmma(dev):
    """The built library's bf16 kernel runs on the Hopper tensor-core
    instructions: HGMMA (wgmma) fed by UTMALDG (TMA loads), and no HMMA
    (the mma.sync of the kernel it replaced)."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        pytest.skip("no cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True,
                          text=True, check=True).stdout
    kernels_sass = sass.split("Function : ")
    flash = [k for k in kernels_sass if k.split("\n", 1)[0].find("flash_fwd_bf16") >= 0]
    assert len(flash) == 2  # head_dim padded to 64 and to 128
    for body in flash:
        assert "HGMMA" in body and "UTMALDG" in body and "HMMA" not in body


def test_flash_attention_wide_kernel_has_no_spills(dev):
    """ptxas: both instances of the wide kernel (hd 136..256) keep q and
    the K/V tiles in shared memory and spill nothing."""
    from repro_torch.kernels import _build

    usage = {k: u for k, u in _build.ptxas_usage("flash_attention.cu").items()
             if "flash_fwd_wide" in k}
    assert len(usage) == 2, usage
    for name, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0, (name, u)


def test_flash_attention_refusals(dev):
    q = torch.zeros(1, 4, 8, 64, device=dev, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros(1, 2, 8, 264, device=dev, dtype=torch.bfloat16)
        tfa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="head_dim"):
        odd = torch.zeros(1, 2, 8, 20, device=dev, dtype=torch.bfloat16)
        tfa.flash_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(torch.zeros(1, 3, 8, 64, device=dev, dtype=torch.bfloat16), kv, kv)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, kv.float(), kv)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), kv, kv)
    with pytest.raises(ValueError, match="one CUDA device"):
        tfa.flash_attention(q, kv.cpu(), kv)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, kv, kv, window=0)


_STALL_WORKER = r"""
import json, os, sys, time
import torch
from repro_torch.kernels import _build, flash_attention as fa

q = torch.zeros(1, 2, 8, 64, device="cuda", dtype=torch.bfloat16)
fa.flash_attention(q, q, q)  # a normal launch first
torch.cuda.synchronize()
lib = _build.load()
res = {"before": lib.rt_flash_status()}
t0 = time.monotonic()
res["launch"] = lib.rt_flash_stall_for_test(0, int(float(sys.argv[2]) * 1e9),
                                            _build.stream_of(q))
try:
    torch.cuda.synchronize()
    res["sync"] = None
except Exception as exc:
    res["sync"] = [isinstance(exc, RuntimeError), str(exc)]
res["seconds"] = time.monotonic() - t0
try:
    fa.flash_attention(q, q, q)
    res["call"] = None
except RuntimeError as exc:
    res["call"] = str(exc)
with open(sys.argv[1], "w") as f:
    json.dump(res, f)
os._exit(0)  # the context is dead: skip CUDA's teardown
"""


def test_flash_wait_runs_out_and_the_wrapper_raises(dev, tmp_path):
    """One of B8's bounded mbarrier waits runs out (the library's test-only
    entry arms a barrier for bytes that never arrive, bound 0.5 s): the
    trap surfaces as CUDA's launch failure at the next synchronisation,
    and the wrapper's next call raises with the wait that ran out.  In a
    subprocess: the trap ends its CUDA context."""
    script = tmp_path / "stall.py"
    script.write_text(_STALL_WORKER)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    proc = subprocess.run([sys.executable, str(script), str(tmp_path / "res.json"), "0.5"],
                          env={**os.environ, "PYTHONPATH": src}, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads((tmp_path / "res.json").read_text())
    assert res["before"] == 0 and res["launch"] == 0
    assert res["sync"] is not None and res["sync"][0], res
    assert 0.5 <= res["seconds"] < 60
    assert res["call"] is not None and "K/V stage to fill" in res["call"], res


def test_attention_dispatch_on_the_card(dev):
    """CUDA tensors: None launches B8 for s > 1 and keeps decode (s = 1)
    on the plain path; the kernel refuses inputs that need a gradient
    (it has no backward) rather than return an output without one."""
    q = torch.randn(1, 4, 32, 64, device=dev, dtype=torch.bfloat16)
    kv = torch.randn(1, 2, 32, 64, device=dev, dtype=torch.bfloat16)
    before = tfa.flash_attention.launches
    tops.attention(q, kv, kv)
    assert tfa.flash_attention.launches == before + 1
    tops.attention(q[:, :, -1:].contiguous(), kv, kv)
    assert tfa.flash_attention.launches == before + 1
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention(q.requires_grad_(), kv, kv)
    with torch.no_grad():
        tfa.flash_attention(q, kv, kv)
    assert tfa.flash_attention.launches == before + 2


def _greedy(model, prompts, gen, use_kernel):
    logits, cache = model.prefill(prompts, cache_len=prompts.shape[1] + gen,
                                  use_kernel=use_kernel)
    first = logits
    tok, out = logits.argmax(-1)[:, None], []
    for i in range(gen):
        out.append(tok[:, 0])
        logits, cache = model.decode_step(tok, cache, prompts.shape[1] + i)
        tok = logits.argmax(-1)[:, None]
    return first, torch.stack(out, 1)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-3-2b", "chatglm3-6b"])
def test_reduced_serve_kernel_matches_plain(dev, arch):
    """A reduced config served on the card: the prefill through B8 and
    through plain attention.  In f32 (f32 probabilities, the f32 kernel)
    the greedy tokens are equal; in bf16 the last-position logits agree
    within chip_smoke.py's serving bars (the kernel keeps ~16-bit
    probabilities, the plain path rounds them to bf16)."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build

    base = get_reduced_config(arch)
    prompts = torch.randint(0, base.vocab_size, (3, 50), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    cfg = dataclasses.replace(base, dtype="float32", attn_probs_bf16=False)
    model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    kernels.reset_launch_counts()
    _, toks_k = _greedy(model, prompts, 8, None)
    assert kernels.launch_counts()["flash_attention"] == cfg.num_layers
    _, toks_p = _greedy(model, prompts, 8, False)
    assert kernels.launch_counts()["flash_attention"] == cfg.num_layers
    assert torch.equal(toks_k, toks_p)
    model = build(base, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    lk, _ = _greedy(model, prompts, 2, None)
    lp, _ = _greedy(model, prompts, 2, False)
    lk, lp = lk[:, : base.vocab_size], lp[:, : base.vocab_size]
    assert ((lk - lp).norm() / lp.norm()).item() <= 0.05
    assert (lk - lp).abs().max().item() <= 0.08 * lp.abs().max().item()


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


# ------------------------------------------------------------ B7 remote ----
_REMOTE_WORKER = r"""
import json, sys, time
import torch
import torch.distributed as dist
from repro_torch.core.metrics import subspace_dist64
from repro_torch.kernels import procrustes_align as pa, ref as tref
from repro_torch.launch.mesh import make_aggregation_mesh

rank, world, init, out_path, spec = sys.argv[1:6]
rank, world, spec = int(rank), int(world), json.loads(spec)
agg = make_aggregation_mesh(device="cuda", rank=rank, world_size=world,
                            local_rank=rank, local_world=world, init_method=init)
dev, group = agg.device, agg.group
res = {"backend": agg.backend}
if spec["mode"] == "stall":
    # Rank 0 runs a round; rank 1 maps the buffers and never signals.
    d, r = spec["shape"]
    v = torch.linalg.qr(torch.randn(d, r, device=dev))[0].contiguous()
    if rank == 0:
        pa.REMOTE_WAIT_S = spec["wait_s"]
        t0 = time.monotonic()
        try:
            pa.fused_ring_round_remote(v, v, group=group)
            res["raised"] = None
        except RuntimeError as exc:
            res["raised"] = str(exc)
        res["seconds"] = time.monotonic() - t0
        pa.close_remote(group)
    else:
        pa._Exchange(group, d, r, dev).close()
else:
    for d, r in spec["shapes"]:
        g = torch.Generator().manual_seed(d * r)
        base = torch.linalg.qr(torch.randn(d, r, generator=g))[0]
        vs = torch.linalg.qr(base[None] + 0.1 / d ** 0.5 * torch.randn(world, d, r, generator=g))[0]
        vs = vs.to(dev).contiguous()
        v, ref = vs[rank].contiguous(), vs[0].contiguous()
        rolled = vs[[(rank - h) % world for h in range(world)]].contiguous()
        cell = []
        for k in range(spec["rounds"]):
            before = pa.fused_ring_round_remote.launches
            got = pa.fused_ring_round_remote(v, ref, group=group)
            launched = pa.fused_ring_round_remote.launches - before
            plain = pa.plain_remote(v, ref, group=group)
            staged = tref.fused_ring_round(rolled, ref)
            cell.append({
                "launched": launched,
                "err": (got - plain).abs().max().item(),
                "sd": subspace_dist64(got, plain),
                "sd_b6": subspace_dist64(got, staged),
                "finite": bool(torch.isfinite(got).all()),
                "out": got.cpu().tolist()})
            ref = got
        res[f"{d}x{r}"] = cell
    pa.close_remote(group)
dist.destroy_process_group()
json.dump(res, open(out_path, "w"))
"""


def _remote_world(tmp_path, world, spec, cards_needed=1):
    """Run _REMOTE_WORKER on ``world`` rank processes: on one card (gloo)
    or one card each (NCCL, skipped below ``cards_needed`` cards)."""
    if torch.cuda.device_count() < cards_needed:
        pytest.skip(f"needs {cards_needed} CUDA cards")
    script = tmp_path / "remote_worker.py"
    script.write_text(_REMOTE_WORKER)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": src}
    if cards_needed == 1:
        env["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(k), str(world), f"file://{tmp_path / 'rdv'}",
         str(tmp_path / f"r{k}.json"), json.dumps(spec)],
        env=env, stderr=subprocess.PIPE, text=True) for k in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [json.loads((tmp_path / f"r{k}.json").read_text()) for k in range(world)]


def _hold_remote(res, shapes, rounds):
    for d, r in shapes:
        for k in range(rounds):
            cells = [rk[f"{d}x{r}"][k] for rk in res]
            for c in cells:
                assert c["launched"] == 1 and c["finite"]
                assert c["err"] <= 1e-4 and c["sd"] <= 1e-5 and c["sd_b6"] <= 1e-5
            first = torch.tensor(cells[0]["out"])
            for c in cells[1:]:
                assert subspace_dist64(torch.tensor(c["out"]), first) <= 1e-5


@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_fused_ring_round_remote_kernel_one_card(dev, tmp_path, world):
    """B7 in a world of rank processes sharing one card (gloo for the
    plain version's hops, CUDA IPC for the kernel's): each rank's round
    against its plain version and against B6's plain version on the stack
    in its hop order, three rounds reusing the mapped buffers; at r = 128
    the hops' polar step runs on a group of blocks."""
    shapes = [(205, 5), (1000, 7), (1000, 128)]
    res = _remote_world(tmp_path, world, {"mode": "check", "shapes": shapes, "rounds": 3})
    _hold_remote(res, shapes, 3)


def test_fused_ring_round_remote_kernel_past_shared_memory(dev, tmp_path):
    """B7 at r = 137, 192 and 256 (the hops' polar step streams its
    iterate from L2, the Cholesky tiles live in the global workspace), 2
    ranks sharing the card, two rounds each."""
    shapes = [(300, 137), (300, 192), (300, 256)]
    res = _remote_world(tmp_path, 2, {"mode": "check", "shapes": shapes, "rounds": 2})
    _hold_remote(res, shapes, 2)


def test_fused_ring_round_remote_kernel_one_card_each(dev, tmp_path):
    """B7 over NVLink peer memory, one rank per card (NCCL).  Skips on a
    one-card machine; not yet run on a machine with two cards."""
    res = _remote_world(tmp_path, 2, {"mode": "check", "shapes": [(205, 5)], "rounds": 2},
                        cards_needed=2)
    assert all(r["backend"] == "nccl" for r in res)
    _hold_remote(res, [(205, 5)], 2)


def test_fused_ring_round_remote_times_out_rather_than_hangs(dev, tmp_path):
    """Rank 1 maps the buffers but never runs the round: rank 0's wait for
    its push runs out and the wrapper raises."""
    res = _remote_world(tmp_path, 2, {"mode": "stall", "shape": [96, 4], "wait_s": 2.0})
    assert "left neighbour's push" in res[0]["raised"]
    assert 2.0 <= res[0]["seconds"] < 60


def test_fused_ring_round_remote_refusals(dev):
    v = _stack(dev, 1, 64, 4)[0].contiguous()
    with pytest.raises(TypeError):
        tpa.fused_ring_round_remote(v.double(), v.double(), group=None)
    with pytest.raises(ValueError):
        tpa.fused_ring_round_remote(v[None], v[None], group=None)  # not (d, r)
    with pytest.raises(ValueError):
        tpa.fused_ring_round_remote(v, v.T.contiguous(), group=None)
    with pytest.raises(ValueError):
        tpa.fused_ring_round_remote(v.T, v.T, group=None)  # not contiguous
    with pytest.raises(ValueError):
        tpa.fused_ring_round_remote(v, v.cpu(), group=None)


@pytest.mark.parametrize("r", [128, 256])
def test_plan_auto_on_sm90_picks_a_cuda_cell_then_no_b5(dev, r):
    """On sm_90 the stacked plan at the paper-pca width is the B5 cell at
    r = 128 and no B5 cell at r = 256, where B5 runs one block a machine;
    the planned rounds run the picked cell's kernels and equal its run."""
    from repro_torch.core.eigenspace import refinement_rounds
    from repro_torch.plan import resolve_plan

    vs = _stack(dev, 8, 8192, r)
    pl = resolve_plan("auto", m=8, d=8192, r=r, n_iter=2, context="stacked",
                      tensor_device=dev)
    assert pl.device_kind == "h100" and pl.source == "planner"
    b5 = (pl.backend, pl.polar, pl.orth) == ("cuda", "newton-schulz", "cholesky-qr2")
    assert b5 == (r == 128)
    kernels.reset_launch_counts()
    got = refinement_rounds(vs, n_iter=2, plan="auto")
    counts = kernels.launch_counts()
    assert counts["fused_round"] == (2 if b5 else 0)
    want = refinement_rounds(vs, n_iter=2, backend=pl.backend, polar=pl.polar, orth=pl.orth)
    assert torch.equal(got, want)
    # A CPU-pinned call on this card still plans for the CPU.
    assert resolve_plan("auto", m=8, d=8192, r=r, n_iter=2, context="stacked",
                        tensor_device="cpu").device_kind == "cpu"

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
without spills (B8's kernels at head_dim 256: without spills).  B3, B5,
B6 and B7 also run at r = 137, 192 and 256, where their grouped
Newton-Schulz form streams its iterate from L2 and the round kernels'
CholeskyQR factor runs on the whole grid (B5/B6 also on rank-deficient
stacks, the guard's shifted factor, and refusing r past 2248); B8 at head_dim 136, 192, 200 and 256 (bf16: its
64-key-tile wgmma form, at those tile edges; f32: its wide form);
and a subprocess makes one of B8's bounded waits run out and sees the
launch failure, then the wrapper's error.  B2 runs at the edges of its
128-wide tile and its clusters (m 1, 8, 17; d 1 .. 8192; r 1 .. 256); B2,
B3, B5 and B6 give the same bits on a second call; B5 and B6 run in each
Newton-Schulz form (grouped, one block a machine, staged or streamed) and
report the one they ran; B3 runs its grouped form at ragged shapes, r up to 256
and m past the groups the grid holds, and reports its form; ptxas must
report no spills in B2, the round kernels, B3's Newton-Schulz kernel and
B7's hop kernel.  Tolerance: 4 eps sqrt(k) times the largest
plain entry for an f32 sum of k products in two orders; 1e-4 for the 24
Newton-Schulz steps and for the whole fused rounds (B5, B6), which are
also held at 1e-5 f64 subspace distance.  B4 also at the edges of its
64-row, 128-column block (r 1 .. 136, d 1 .. 8192, m 1 and 8), bit for
bit the same on a second call.  B8 (flash attention): 2e-5 in f32 and
3e-2 in bf16, the reference's own kernel-test bars, bf16 also per query
row (2^-7 max|want_row| + 1e-4), at the 128-row and 128-key tile edges
(64-key at head_dim 256), every head_dim class, window edges, MQA, rows
without keys and a batch whose heads would show a read across a head's
edge; the built library's three bf16 instances are made of wgmma and TMA
instructions (cuobjdump); a reduced
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
Training (A11-train): f32 master weights cast to bf16 at their use give
the bf16-stored model's logits bit for bit; remat's gradients within 1e-6
of the largest entry; AdamW in place on the card within 1e-6 relative of
the CPU over a clipped, an unclipped and a skipped step; the eigen refresh
on CUDA tensors launches B2 and B4 once per compressed leaf and its bases
agree with the CPU's within 1e-4 f64.
Recurrent families: the reduced recurrentgemma-2b and mamba2-370m on the
card against the CPU (f32, 1e-4 at every serving step); a hybrid prefill
at head_dim 256 launches B8 once per local attention block (8 of 26); the
RG-LRU doubling scan at S = 4096 against a sequential f64 loop.
Training them (A11-hybrid-train, A11-ssm-train): one full-width RG-LRU,
local attention (past its 2048 window) and SSD block in train mode at
S = 4096, f32, every gradient on the card within 1e-4 relative L2 of the
CPU's; the doubling scan's gradient at S = 4096 against the sequential
f64 loop's within 1e-5.
MoE family: the reduced qwen3-moe-30b-a3b and kimi-k2-1t-a32b on the card
against the CPU in both dispatch forms (f32, 1e-4 at every serving step,
the same greedy tokens); one MoE layer at qwen3's full width (d_model
2048, 128 experts top-8, d_ff 768) at (1, 512) tokens on the card against
the CPU in f32 (the same experts and drops, 1e-5 of the largest output);
qwen3's 48 blocks at head_dim 64 launch B8 48 times in one prefill.
Training it (A11-moe-train): the reduced LMs' loss and gradients on the
card against the CPU in both forms with drops (f32: loss 1e-5 relative,
every gradient 1e-4 relative L2, the same routing); one full-width MoE
block under remat in a train step routes its input the same in the
forward and in the backward's recompute (no decision changed).
VLM and encoder-decoder families: B8 bidirectional (``causal=False``)
against its plain version at s = t in {1, 17, 129, 1500} and s != t both
ways, head_dim 64 (groups 1 and 4) and 128, f32 and bf16; whisper's
encoder launches B8 once a layer under ``torch.no_grad()`` and never with
a gradient; the reduced internvl2-2b (with patches) and whisper-tiny
(with frames) on the card against the CPU in f32 (every serving step
within 1e-4, one AdamW step's loss within 1e-5 and parameters within
1e-4 relative L2).
"""

import copy
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
    """Past r = 136 the grouped Newton-Schulz form streams its iterate
    from L2 and the round kernels' factor runs on the whole grid: B3, B5
    and B6 (every wire) held to their plain versions with the bars of
    r <= 136."""
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
    every round instance (f32, bf16, int8 wires, each with 16-byte copies
    or register fetches; each holds both Newton-Schulz forms) and the
    CholeskyQR2 tail they call (both factor forms, one function a VEC
    value) spill nothing: every function of the two sources.  B7's hop
    instances: the test below."""
    from repro_torch.kernels import _build

    for source, kernel, count in (("procrustes_align.cu", "batched_gram_kernel", 2),
                                  ("fused_round.cu", "fused_round_kernel", 6)):
        usage = _build.ptxas_usage(source)
        assert len([k for k in usage if kernel in k]) == count, usage
        if source == "fused_round.cu":
            assert len([k for k in usage if "cholqr2_tail" in k]) == 2, usage
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
    instance), both instances of B7's hop kernel and the CholeskyQR2 tail
    they call (both factor forms) spill nothing: every function of
    fused_ring_remote.cu."""
    from repro_torch.kernels import _build

    for source, kernel, count in (("procrustes_align.cu", "ns_group_kernel", 1),
                                  ("fused_ring_remote.cu", "remote_hop_kernel", 2)):
        usage = _build.ptxas_usage(source)
        assert len([k for k in usage if kernel in k]) == count, usage
        if source == "fused_ring_remote.cu":
            assert len([k for k in usage if "cholqr2_tail" in k]) == 2, usage
            checked = usage
        else:
            checked = {k: u for k, u in usage.items() if kernel in k}
        for name, u in checked.items():
            assert u["spill_stores"] == 0 and u["spill_loads"] == 0, (name, u)


@pytest.mark.parametrize("r", [128, 256])
def test_round_kernels_give_the_same_bits_twice(dev, r):
    """B2, B3, B5 and B6 (every wire) sum in a fixed order: a second call
    gives the same bits, at r = 128 and past r = 136 (the streamed
    Newton-Schulz form and the grid factor)."""
    vs = _stack(dev, 8, 8192, r)
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
    (33, 1000, 137, "grouped, 4 blocks a machine, iterate streamed from L2"),
    (8, 1000, 256, "grouped, 16 blocks a machine, iterate streamed from L2"),
    (200, 300, 192, "one block a machine, iterate streamed from L2"),
])
def test_fused_round_newton_schulz_forms(dev, m, d, r, form):
    """B5 and B6 (every wire) report the Newton-Schulz form they ran and
    hold their plain versions in each: a group of blocks a machine, one
    block a machine when m exceeds what the grid can group (the blocks
    take machines in turn), the iterate staged in shared memory up to
    r = 136 and streamed from L2 past it (where the factor runs on the
    grid).  The forms assume a 132-SM card (one round block an SM)."""
    vs = _stack(dev, m, d, r)
    ref = vs[0].contiguous()
    _hold_round(tpa.fused_round(vs, ref), tref.fused_round(vs, ref))
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert tpa.fused_round.last_form == form
    assert tpa.fused_round.last_factor == tpa._factor_form(r)
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
    with pytest.raises(ValueError, match="grouped Newton-Schulz"):
        tpa.fused_round(wide, wide[0])
    for w in (wide, wide.to(torch.bfloat16)):
        with pytest.raises(ValueError, match="grouped Newton-Schulz"):
            tpa.fused_ring_round(w, wide[0])
    w8 = wide.to(torch.int8)
    with pytest.raises(ValueError, match="grouped Newton-Schulz"):
        tpa.fused_ring_round(w8, wide[0], torch.ones(1, tpa.NS_GROUP_MAX_R + 1, device=dev))


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


@pytest.mark.parametrize("m,d,r", [(3, 300, 137), (8, 1000, 256)])
def test_fused_rounds_take_the_shift_past_shared_memory(dev, m, d, r):
    """The grid factor's guard: a zero last column in every basis gives a
    zero pivot in the last panel; every block reads the verdict and the
    whole factor is redone shifted, in both passes.  B5 and B6 (every
    wire) held to their plain versions at the round bars, the last column
    exactly zero."""
    vs = _stack(dev, m, d, r)
    vs[:, :, -1] = 0
    ref = vs[0].contiguous()
    got = tpa.fused_round(vs, ref)
    _hold_round(got, tref.fused_round(vs, ref))
    assert got[:, -1].abs().max().item() == 0.0
    assert tpa.fused_round.last_factor == tpa._factor_form(r)
    for wire in ("f32", "bf16", "int8"):
        w, scales = vs, None
        if wire == "bf16":
            w = vs.to(torch.bfloat16)
        elif wire == "int8":
            w, scales = _int8_wire(vs)
        got = tpa.fused_ring_round(w, ref, scales)
        _hold_round(got, tref.fused_ring_round(w, ref, scales))
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
    # head_dim past 128 (bf16: the hd-256 wgmma kernel; f32: the wide
    # kernel), causal and windowed, ragged s and t, and s > t (rows without
    # keys).
    case for hd in (136, 192, 256) for case in (
        (1, 4, 2, 130, 130, hd, None),
        (1, 4, 2, 200, 257, hd, 16),
        (2, 4, 1, 160, 96, hd, None),
    )
] + [
    # The hd-256 kernel's 64-key K/V tile edges, its window edges, s > t,
    # MQA (recurrentgemma's 10 query heads on 1), and head_dims whose last
    # 64-column TMA box is zero-filled past hd.
    (1, 4, 2, t, t, 256, None) for t in (63, 64, 65, 127, 129)
] + [
    (1, 4, 2, 300, 300, 256, window) for window in (63, 64, 65)
] + [
    (1, 2, 1, 129, 64, 256, None),
    (1, 4, 2, 200, 65, 256, 64),
    (2, 10, 1, 200, 333, 256, None),
    (2, 10, 1, 200, 333, 256, 64),
    (1, 4, 2, 257, 257, 136, 65),
    (1, 4, 2, 257, 257, 200, None),
    (1, 4, 2, 100, 190, 200, 63),
]


def _flash_form(dtype, hd):
    """The kernel ``flash_attention.last_form`` should name."""
    if dtype == torch.bfloat16:
        return "wgmma (TMA, hd 256)" if hd > 128 else "wgmma (TMA)"
    return "wide (CUDA cores, f32)" if hd > 128 else "f32 (CUDA cores)"


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
    assert tfa.flash_attention.last_form == _flash_form(dtype, hd)
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


# B8 bidirectional (causal=False: the enc-dec encoder): s = t at 1, 17, 129
# and whisper's 1500 (11 full 128-row tiles and one of 92), s != t both
# ways, head_dim 64 with groups 1 (whisper) and 4, head_dim 128, and
# head_dim 256 (the 64-key-tile kernel) with a ragged last key tile.
_BIDIR_CASES = [
    (2, 6, 6, s, s, 64) for s in (1, 17, 129, 1500)
] + [
    (1, 4, 1, 96, 300, 64), (1, 4, 1, 300, 96, 64),
    (2, 8, 2, 129, 257, 128), (2, 8, 2, 257, 129, 128),
    (2, 10, 1, 129, 257, 256),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hq,hkv,s,t,hd", _BIDIR_CASES)
def test_flash_attention_bidirectional_kernel(dev, b, hq, hkv, s, t, hd, dtype):
    """B8 with ``causal=False`` against its plain version: FLASH_TOL over the
    whole output, bf16 also per query row (2^-7 max|want_row| + 1e-4);
    every row sees every key, so no row is zero where s > t."""
    g = torch.Generator(device=dev).manual_seed(s * t + hd + 1)
    q, k, v = (torch.randn(*sh, generator=g, device=dev).to(dtype)
               for sh in ((b, hq, s, hd), (b, hkv, t, hd), (b, hkv, t, hd)))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert tfa.flash_attention.last_form == _flash_form(dtype, hd)
    want = tref.flash_attention(q, k, v, causal=False)
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= FLASH_TOL[dtype]
    if dtype == torch.bfloat16:
        bar = 2.0**-7 * want.abs().amax(-1) + 1e-4
        assert ((got - want).abs().amax(-1) <= bar).all()
    assert bool((got.abs().amax(-1) > 0).all())
    causal = tfa.flash_attention(q.to(dtype), k.to(dtype), v.to(dtype), causal=True)
    if s > 1:  # the causal form differs: the mask is not ignored
        assert not torch.equal(causal.float(), got)


@pytest.mark.parametrize("hd", [80, 256])
def test_flash_attention_heads_do_not_bleed(dev, hd):
    """A multi-head batch with s and t off every tile edge, and every other
    KV head holding V = 1e3: a box or tile that read across a head's edge
    would carry 1e3 into a neighbour and fail that head's per-row bar (at
    head_dim 80 and 256, the 128- and 64-key-tile kernels)."""
    b, hq, hkv, s, t = 3, 8, 4, 200, 333
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
    assert len(flash) == 3  # head_dim padded to 64, 128 and 256
    for body in flash:
        assert "HGMMA" in body and "UTMALDG" in body and "HMMA" not in body


def test_flash_attention_wide_kernel_has_no_spills(dev):
    """ptxas: no B8 kernel spills: the f32 wide kernel (q and the K/V tiles
    in shared memory) and the three bf16 wgmma instances (head_dim padded to
    64, 128 and 256), whose consumer threads hold O, S and the P fragments
    in registers (at head_dim 256, O alone is 128 f32)."""
    from repro_torch.kernels import _build

    usage = {k: u for k, u in _build.ptxas_usage("flash_attention.cu").items()
             if "flash_fwd_wide" in k or "flash_fwd_bf16" in k}
    assert len(usage) == 4, usage
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


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-370m"])
def test_reduced_recurrent_lm_on_the_card_matches_the_cpu(dev, arch):
    """A reduced recurrent LM (the same seeded weights on both devices) in
    f32 with f32 probabilities: prefill of 40 tokens (window 16, SSD chunk
    16 with a padded last chunk) and 6 decode steps fed the CPU's tokens,
    logits within 1e-4 of the CPU's at every step.  The hybrid prefill
    launches B8 once per attention block (1 here) and decode never."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build

    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32",
                              attn_probs_bf16=False)
    models = {"cpu": build(cfg, device="cpu", generator=torch.Generator().manual_seed(0))}
    models["cuda"] = copy.deepcopy(models["cpu"]).to(dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                            generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    lc, cc = models["cpu"].prefill(prompts, cache_len=46)
    lg, cg = models["cuda"].prefill(prompts.to(dev), cache_len=46)
    torch.cuda.synchronize()
    blocks = models["cuda"].attention_blocks
    assert blocks == (1 if arch == "recurrentgemma-2b" else 0)
    assert kernels.launch_counts()["flash_attention"] == blocks
    for i in range(7):
        assert (lg.cpu() - lc).abs().max().item() <= 1e-4, i
        if i == 6:
            break
        tok = lc.argmax(-1)[:, None]
        lc, cc = models["cpu"].decode_step(tok, cc, 40 + i)
        lg, cg = models["cuda"].decode_step(tok.to(dev), cg, 40 + i)
    assert kernels.launch_counts()["flash_attention"] == blocks


def test_encoder_launches_b8_only_without_a_gradient(dev):
    """whisper's encoder (reduced, on the card): under ``torch.no_grad()``
    one B8 launch a layer (bidirectional), in train mode with a gradient
    none (plain attention, B8 has no backward), and the two agree; a
    prefill launches one B8 per encoder and per decoder layer, decode
    none."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build

    cfg = get_reduced_config("whisper-tiny")
    model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    frames = torch.randn(2, 300, cfg.d_model, device=dev, dtype=torch.bfloat16,
                         generator=torch.Generator(device=dev).manual_seed(1))
    kernels.reset_launch_counts()
    with torch.no_grad():
        served = model.encode(frames)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == cfg.num_encoder_layers
    trained = model.encode(frames)
    assert trained.requires_grad
    assert kernels.launch_counts()["flash_attention"] == cfg.num_encoder_layers
    rel = ((served.float() - trained.float()).norm() / trained.float().norm()).item()
    assert rel <= 0.05, rel
    tokens = torch.randint(0, cfg.vocab_size, (2, 20), device=dev)
    kernels.reset_launch_counts()
    logits, cache = model.prefill(frames, tokens, cache_len=24)
    assert kernels.launch_counts()["flash_attention"] == (cfg.num_encoder_layers
                                                         + cfg.num_layers)
    model.decode_step(logits.argmax(-1)[:, None], cache, 20)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == (cfg.num_encoder_layers
                                                         + cfg.num_layers)


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-tiny"])
def test_reduced_vlm_and_encdec_on_the_card_match_the_cpu(dev, arch):
    """The reduced VLM (patches ahead of the prompt) and encoder-decoder
    (frames into the encoder) in f32 with f32 probabilities, the same
    seeded weights on both devices: the prefill and 6 decode steps fed the
    CPU's tokens, logits within 1e-4 of the CPU's at every step; then one
    AdamW step from the same parameters, the loss within 1e-5 relative
    and every parameter within 1e-4 relative L2."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32",
                              attn_probs_bf16=False)
    models = {"cpu": build(cfg, device="cpu", param_dtype=torch.float32,
                           generator=torch.Generator().manual_seed(0))}
    models["cuda"] = copy.deepcopy(models["cpu"]).to(dev)
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (2, 40), generator=g)
    if cfg.is_encoder_decoder:
        stub = {"frames": torch.randn(2, 150, cfg.d_model, generator=g)}
    else:
        stub = {"patch_embeds": torch.randn(2, cfg.num_patches, cfg.patch_embed_dim,
                                            generator=g)}
    p = stub["patch_embeds"].shape[1] if "patch_embeds" in stub else 0

    def prefill(where):
        m, x = models[where], {k: v.to(dev if where == "cuda" else "cpu")
                               for k, v in stub.items()}
        toks = prompts.to(x[next(iter(x))].device)
        if "frames" in x:
            return m.prefill(x["frames"], toks, cache_len=46)
        return m.prefill(toks, patch_embeds=x["patch_embeds"], cache_len=p + 46)

    kernels.reset_launch_counts()
    lc, cc = prefill("cpu")
    lg, cg = prefill("cuda")
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == models["cuda"].attention_blocks
    for i in range(7):
        assert (lg.cpu() - lc).abs().max().item() <= 1e-4, i
        if i == 6:
            break
        tok = lc.argmax(-1)[:, None]
        lc, cc = models["cpu"].decode_step(tok, cc, p + 40 + i)
        lg, cg = models["cuda"].decode_step(tok.to(dev), cg, p + 40 + i)
    assert kernels.launch_counts()["flash_attention"] == models["cuda"].attention_blocks
    out = {}
    for where, m in models.items():
        params = dict(m.named_parameters())
        opt = adamw_init(params)
        w = dev if where == "cuda" else "cpu"
        batch = {"tokens": prompts.to(w), "labels": prompts.roll(-1, 1).to(w),
                 **{k: v.to(w) for k, v in stub.items()}}
        met = make_train_step(m, adamw_cfg=AdamWConfig(), schedule=lambda s: 1e-3)(opt, batch)
        out[where] = (float(met["loss"]), {k: v.detach().cpu() for k, v in params.items()})
    (l_c, p_c), (l_g, p_g) = out["cpu"], out["cuda"]
    assert abs(l_g - l_c) / abs(l_c) <= 1e-5
    assert max(((p_g[k] - p_c[k]).norm() / p_c[k].norm()).item() for k in p_c) <= 1e-4


def test_hybrid_prefill_launches_b8_per_local_block(dev):
    """recurrentgemma-2b's layer pattern at a narrow width (d_model 256,
    head_dim 256 as the full config's, 10 query heads, 1 KV head) with 8
    local attention blocks in 26: one prefill of 300 tokens past a window
    of 128 launches B8 exactly 8 times (its hd-256 wgmma form), and the kernel and
    plain prefills' last logits agree within chip_smoke.py's serving bars."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), d_model=2560, num_heads=10,
                              num_kv_heads=1, d_ff=512, lru_width=256, vocab_size=1024,
                              window_size=128)
    model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    assert model.attention_blocks == 8 and cfg.head_dim == 256
    prompts = torch.randint(0, cfg.vocab_size, (2, 300), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    kernels.reset_launch_counts()
    lk, cache = model.prefill(prompts)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 8
    assert tfa.flash_attention.last_form == "wgmma (TMA, hd 256)"
    assert cache[2]["k"].shape[2] == 128
    lp, _ = model.prefill(prompts, use_kernel=False)
    assert kernels.launch_counts()["flash_attention"] == 8
    lk, lp = lk[:, :cfg.vocab_size], lp[:, :cfg.vocab_size]
    assert ((lk - lp).norm() / lp.norm()).item() <= 0.05
    assert (lk - lp).abs().max().item() <= 0.08 * lp.abs().max().item()


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_reduced_moe_lm_on_the_card_matches_the_cpu(dev, arch, impl):
    """A reduced MoE LM (the same seeded weights on both devices) in f32
    with f32 probabilities and either dispatch form at capacity factor 0.5
    (so both forms drop pairs): prefill of 40 tokens and 6 decode steps
    fed the CPU's tokens, logits within 1e-4 of the CPU's and the same
    greedy token at every step; the prefill launches B8 once per block."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build

    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32",
                              attn_probs_bf16=False, moe_impl=impl, capacity_factor=0.5)
    models = {"cpu": build(cfg, device="cpu", generator=torch.Generator().manual_seed(0))}
    models["cuda"] = copy.deepcopy(models["cpu"]).to(dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                            generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    lc, cc = models["cpu"].prefill(prompts, cache_len=46)
    lg, cg = models["cuda"].prefill(prompts.to(dev), cache_len=46)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == cfg.num_layers
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(2))
    assert not models["cpu"].blocks[0].mlp.routing(x).keep.all()  # the form drops
    for i in range(7):
        assert (lg.cpu() - lc).abs().max().item() <= 1e-4, i
        assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)), i
        if i == 6:
            break
        tok = lc.argmax(-1)[:, None]
        lc, cc = models["cpu"].decode_step(tok, cc, 40 + i)
        lg, cg = models["cuda"].decode_step(tok.to(dev), cg, 40 + i)
    assert kernels.launch_counts()["flash_attention"] == cfg.num_layers


def test_moe_layer_at_full_width_on_the_card_matches_the_cpu(dev):
    """One MoE layer at qwen3-moe-30b-a3b's width (d_model 2048, 128
    experts top-8, expert d_ff 768) in f32 at (1, 512) tokens (capacity
    40): the card and the CPU route the same, drop the same pairs, and
    agree within 1e-5 of the largest output; the aux loss within 1e-6."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_layers=1,
                              vocab_size=256, dtype="float32")
    cpu = build(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).blocks[0].mlp
    card = copy.deepcopy(cpu).to(dev)
    x = torch.randn(1, 512, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, aux_c = cpu(x)
        got, aux_g = card(x.to(dev))
        rc, rg = cpu.routing(x), card.routing(x.to(dev))
    assert rc.cap == 40
    assert torch.equal(rg.experts.cpu(), rc.experts)
    assert torch.equal(rg.keep.cpu(), rc.keep)
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert abs(aux_g.item() - aux_c.item()) <= 1e-6


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_reduced_moe_gradients_on_the_card_match_the_cpu(dev, arch, impl):
    """The reduced MoE LM's training loss (CE + 0.01 aux) and every
    gradient in f32, at capacity factor 0.5 (both forms drop), 4 x 32
    tokens, the same seeded weights on both devices: the same experts and
    drops in every layer, the loss within 1e-5 relative, each gradient
    within 1e-4 relative L2 of the CPU's."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build, loss_fn

    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32",
                              attn_probs_bf16=False, moe_impl=impl, capacity_factor=0.5)
    cpu = build(cfg, device="cpu", param_dtype=torch.float32,
                generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
             for k in ("tokens", "labels")}
    out, routes = {}, {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        seen = routes.setdefault(name, [])
        hooks = [blk.mlp.register_forward_pre_hook(
            lambda m, i, seen=seen: seen.append(m.routing(i[0]))) for blk in model.blocks]
        b = {k: v.to(model.embed.device) for k, v in batch.items()}
        loss, _ = loss_fn(model, b)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        for h in hooks:
            h.remove()
        out[name] = (loss.item(), [g.cpu() for g in grads])
    assert any((~rt.keep).any() for rt in routes["cpu"])
    for rc, rg in zip(routes["cpu"], routes["cuda"]):
        assert torch.equal(rg.experts.cpu(), rc.experts) and torch.equal(rg.keep.cpu(), rc.keep)
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for (name, _), a, b in zip(cpu.named_parameters(), gc, gg):
        assert ((b - a).norm() / a.norm().clamp_min(1e-30)).item() <= 1e-4, name


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_moe_remat_recompute_routes_the_same_on_the_card(dev, impl):
    """One block of qwen3-moe-30b-a3b at full width (d_model 2048, 128
    experts top-8, bf16 compute on f32 masters, ``remat == "full"``) in a
    train step over 2 x 512 tokens: a pre-hook on the MoE layer routes its
    input at each call, the forward's and the backward's recompute; the
    two give the same experts and the same kept pairs, and the gradient
    is finite."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build, loss_fn

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_layers=1, vocab_size=1024,
                              moe_impl=impl)
    assert cfg.remat == "full"
    model = build(cfg, device=dev, param_dtype=torch.float32,
                  generator=torch.Generator(device=dev).manual_seed(0))
    calls = []
    model.blocks[0].mlp.register_forward_pre_hook(lambda m, i: calls.append(m.routing(i[0])))
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device=dev)
             for k in ("tokens", "labels")}
    loss, _ = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert len(calls) == 2
    assert torch.equal(calls[0].experts, calls[1].experts)
    assert torch.equal(calls[0].keep, calls[1].keep) and not calls[0].keep.all()
    assert all(torch.isfinite(g).all() for g in grads)


def test_moe_prefill_launches_b8_per_block_at_head_dim_64(dev):
    """qwen3-moe-30b-a3b's 48 blocks at head_dim 64 (d_model 2048, 32/4
    heads) with narrow experts (16, top-4, d_ff 64) and vocab 1024: one
    prefill of 300 tokens launches B8 exactly 48 times, and the kernel and
    plain prefills' last logits agree within chip_smoke.py's serving
    bars."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_experts=16,
                              num_experts_per_token=4, d_ff=64, vocab_size=1024)
    model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    assert model.attention_blocks == 48 and cfg.head_dim == 64
    prompts = torch.randint(0, cfg.vocab_size, (2, 300), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    kernels.reset_launch_counts()
    lk, _ = model.prefill(prompts)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 48
    lp, _ = model.prefill(prompts, use_kernel=False)
    assert kernels.launch_counts()["flash_attention"] == 48
    lk, lp = lk[:, :cfg.vocab_size], lp[:, :cfg.vocab_size]
    assert ((lk - lp).norm() / lp.norm()).item() <= 0.05
    assert (lk - lp).abs().max().item() <= 0.08 * lp.abs().max().item()


def test_doubling_scan_on_the_card_matches_sequential_f64(dev):
    """RG-LRU's doubling scan in f32 on the card at S = 4096 against a
    sequential loop in f64 (on the CPU), a in (0.5, 1): within 1e-5 of
    the largest state."""
    from repro_torch.models.layers import doubling_scan

    g = torch.Generator().manual_seed(0)
    a = torch.rand(2, 4096, 64, generator=g, dtype=torch.float64) * 0.5 + 0.5
    b = torch.randn(2, 4096, 64, generator=g, dtype=torch.float64)
    want, h = torch.empty_like(b), torch.zeros(2, 64, dtype=torch.float64)
    for t in range(4096):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = doubling_scan(a.float().to(dev), b.float().to(dev)).double().cpu()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


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
    the hops' polar step runs on a group of blocks, at r = 192 it streams
    its iterate from L2 and the last hop's factor runs on the grid."""
    shapes = [(205, 5), (1000, 7), (1000, 128), (300, 192)]
    res = _remote_world(tmp_path, world, {"mode": "check", "shapes": shapes, "rounds": 3})
    _hold_remote(res, shapes, 3)


def test_fused_ring_round_remote_kernel_past_shared_memory(dev, tmp_path):
    """B7 at r = 137, 192 and 256 (the hops' polar step streams its
    iterate from L2, the last hop's factor runs on the grid), 2 ranks
    sharing the card, two rounds each."""
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
    r = 128 and, since B5 runs its grouped forms past r = 136 as well, at
    r = 256 too; the planned rounds run the picked cell's kernels and
    equal its run."""
    from repro_torch.core.eigenspace import refinement_rounds
    from repro_torch.plan import resolve_plan

    vs = _stack(dev, 8, 8192, r)
    pl = resolve_plan("auto", m=8, d=8192, r=r, n_iter=2, context="stacked",
                      tensor_device=dev)
    assert pl.device_kind == "h100" and pl.source == "planner"
    b5 = (pl.backend, pl.polar, pl.orth) == ("cuda", "newton-schulz", "cholesky-qr2")
    assert b5
    kernels.reset_launch_counts()
    got = refinement_rounds(vs, n_iter=2, plan="auto")
    counts = kernels.launch_counts()
    assert counts["fused_round"] == (2 if b5 else 0)
    want = refinement_rounds(vs, n_iter=2, backend=pl.backend, polar=pl.polar, orth=pl.orth)
    assert torch.equal(got, want)
    # A CPU-pinned call on this card still plans for the CPU.
    assert resolve_plan("auto", m=8, d=8192, r=r, n_iter=2, context="stacked",
                        tensor_device="cpu").device_kind == "cpu"


def _train_cfg(arch="granite-3-2b", **kw):
    import dataclasses

    from repro_torch.configs import get_reduced_config

    return dataclasses.replace(get_reduced_config(arch), **kw)


def test_f32_master_weights_are_cast_at_use_on_the_card(dev):
    """Training keeps f32 master weights and casts each to the config's
    bf16 at its use: the train-mode logits equal those of the same draws
    stored in bf16 (serving's storage), and the gradients are f32."""
    from repro_torch.models import build
    from repro_torch.models.lm import loss_fn

    cfg = _train_cfg()
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    master = build(cfg, device=dev, param_dtype=torch.float32,
                   generator=torch.Generator(device=dev).manual_seed(0))
    stored = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    assert master.blocks[0].mixer.wq.dtype == torch.float32
    assert stored.blocks[0].mixer.wq.dtype == torch.bfloat16
    with torch.no_grad():
        a, _ = master(tokens, mode="train")
        b, _ = stored(tokens, mode="train")
    assert a.dtype == torch.float32 and torch.equal(a, b)
    loss, _ = loss_fn(master, {"tokens": tokens, "labels": tokens})
    grads = torch.autograd.grad(loss, list(master.parameters()))
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)


def test_remat_gives_the_same_gradients_on_the_card(dev):
    """cfg.remat == "full" (each block under torch.utils.checkpoint)
    recomputes the same forward in the backward: gradients within 1e-6 of
    the largest entry of each leaf's gradient without remat."""
    from repro_torch.models import build
    from repro_torch.models.lm import loss_fn

    grads = {}
    for remat in ("none", "full"):
        cfg = _train_cfg(remat=remat, dtype="float32")
        model = build(cfg, device=dev, param_dtype=torch.float32,
                      generator=torch.Generator(device=dev).manual_seed(0))
        tokens = torch.randint(0, cfg.vocab_size, (2, 32), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(1))
        loss, _ = loss_fn(model, {"tokens": tokens, "labels": tokens.roll(1, 1)})
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
    for a, b in zip(grads["none"], grads["full"]):
        assert (a - b).abs().max().item() <= 1e-6 * a.abs().max().item()


def test_adamw_in_place_on_the_card_matches_the_cpu(dev):
    """Three AdamW steps (clipped, unclipped, non-finite) on the card and on
    the CPU from the same tensors: the card's parameters and moments are
    updated in place (same storage) and agree within 1e-6 relative."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    gen = torch.Generator().manual_seed(0)
    shapes = {"w": (64, 96), "norm": (96,), "embed": (300, 64)}
    params = {k: torch.randn(*s, generator=gen) for k, s in shapes.items()}
    grads = [{k: torch.randn(*s, generator=gen) * sc for k, s in shapes.items()}
             for sc in (10.0, 0.01, 0.01)]
    grads[2]["norm"][0] = float("nan")
    cpu = {k: v.clone() for k, v in params.items()}
    card = {k: v.to(dev) for k, v in params.items()}
    ptrs = {k: v.data_ptr() for k, v in card.items()}
    s_cpu, s_card = adamw_init(cpu), adamw_init(card)
    cfg = AdamWConfig()
    decay = lambda name, p: name != "norm"
    for g in grads:
        m_cpu = adamw_update({k: v.clone() for k, v in g.items()}, s_cpu, cpu, lr=1e-3,
                             cfg=cfg, decays=decay)
        m_card = adamw_update({k: v.to(dev) for k, v in g.items()}, s_card, card, lr=1e-3,
                              cfg=cfg, decays=decay)
        assert m_cpu["step_skipped"] == m_card["step_skipped"]
    assert m_card["step_skipped"] == 1.0 and int(s_card["step"]) == 2
    assert {k: v.data_ptr() for k, v in card.items()} == ptrs
    for tree_cpu, tree_card in ((cpu, card), (s_cpu["m"], s_card["m"]), (s_cpu["v"], s_card["v"])):
        for k in shapes:
            a, b = tree_cpu[k], tree_card[k].cpu()
            assert (a - b).abs().max().item() <= 1e-6 * a.abs().max().item(), k


def _refresh_f64(grads, starts, r, iters):
    """The refresh of ``grads`` (one dict of leaf gradients a shard) in f64
    on the CPU: each shard's local solve, then the Procrustes average
    aligned to shard 0's basis.  Returns (local bases, refreshed basis)
    per leaf."""
    from repro_torch.core.eigenspace import refinement_rounds

    out = {}
    for n in grads[0]:
        local = []
        for g in grads:
            q, g64 = torch.linalg.qr(starts[n].double().cpu())[0], g[n].double().cpu()
            for _ in range(iters):
                q = torch.linalg.qr(g64 @ (g64.T @ q))[0]
            local.append(q)
        out[n] = (local, refinement_rounds(torch.stack(local), n_iter=1))
    return out


def test_eigen_refresh_on_the_card_launches_b2_and_b4_per_leaf(dev):
    """The stacked eigen refresh on CUDA tensors runs the rounds on the
    kernels: one B2 (batched_gram) and one B4 (align_average) launch per
    compressed leaf at n_iter = 1.  Every shard gets its own rows.  From
    the same parameters, batch and starts, each shard's gradients on the
    card agree with the CPU's within 1e-4 relative L2 (the CPU parity
    tests' bar), and each shard's local basis and every refreshed basis
    within max(1e-4, 4 x the CPU's f32 error against the same solve in
    f64) f64 subspace distance: the 4-step local solve amplifies the
    gradients' rounding (6e-7 became 2.2e-5 for one leaf on the H100).
    The embedding's refreshed basis is left out: on distinct rows its
    refresh is not defined (ROADMAP C7)."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import build
    from repro_torch.models.lm import loss_fn
    from repro_torch.optim import EigenCompressConfig
    from repro_torch.optim import eigen_compress as EC
    from repro_torch.optim.eigen_compress import draw_starts

    cfg = _train_cfg(dtype="float32", attn_probs_bf16=False)
    ecfg = EigenCompressConfig(rank=8, min_dim=64)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(1))
    got = {}
    for where in ("cpu", dev):
        model = build(cfg, device="cpu", param_dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0)).to(where)
        opt = tsteps.eigen_opt_init(model, ecfg, 4)
        batch = {"tokens": tokens.to(where), "labels": tokens.roll(1, 1).to(where)}
        starts = {k: v.to(where) for k, v in draw_starts(
            tsteps.start_shapes(opt), seed=1, step=0, device="cpu").items()}
        params = dict(model.named_parameters())
        names = sorted(opt["eigen"])
        grads = []
        for i in range(4):
            loss, _ = loss_fn(model, tsteps.shard_rows(batch, i, 4))
            grads.append(dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names]))))
        local = [{n: EC._local_basis(g[n], 8, ecfg.power_iters, starts[n]) for n in names}
                 for g in grads]
        kernels.reset_launch_counts()
        tsteps.make_eigen_refresh_step(model, ecfg=ecfg, shards=4)(opt, batch, starts)
        counts = {k: c for k, c in kernels.launch_counts().items() if c}
        want = {"batched_gram": len(names), "align_average": len(names)} if where != "cpu" else {}
        assert counts == want
        got[str(where)] = ([{n: g[n].cpu() for n in names} for g in grads],
                           [{n: v[n].cpu() for n in names} for v in local],
                           {n: opt["eigen"][n]["basis"].cpu() for n in names}, starts)
    (g_cpu, v_cpu, b_cpu, starts), (g_dev, v_dev, b_dev, _) = got["cpu"], got[str(dev)]
    exact = _refresh_f64(g_cpu, starts, 8, ecfg.power_iters)
    errs = {}
    for n in b_cpu:
        grad = max(((a[n] - b[n]).norm() / a[n].norm()).item() for a, b in zip(g_cpu, g_dev))
        loc = max(subspace_dist64(a[n], b[n]) / max(1e-4, 4 * subspace_dist64(a[n], e))
                  for a, b, e in zip(v_cpu, v_dev, exact[n][0]))
        ref = 0.0 if n == "embed" else subspace_dist64(b_cpu[n], b_dev[n]) / max(
            1e-4, 4 * subspace_dist64(b_cpu[n], exact[n][1]))
        errs[n] = (grad, loc, ref)
    bad = {n: e for n, e in errs.items() if not (e[0] <= 1e-4 and e[1] <= 1 and e[2] <= 1)}
    assert not bad, f"(grad rel L2, local basis / bar, refreshed basis / bar): {bad}"


def _full_block(arch, kind):
    """One block of ``arch``'s full config (its full width) in f32 with f32
    probabilities, as a one-block LM with a small vocab (the embeddings
    are not part of the block), weights from a seeded generator."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = dataclasses.replace(get_config(arch), num_layers=1, block_pattern=(kind,),
                              vocab_size=512, dtype="float32", attn_probs_bf16=False)
    return build(cfg, device="cpu", param_dtype=torch.float32,
                 generator=torch.Generator().manual_seed(0)).blocks[0]


@pytest.mark.parametrize("arch,kind", [("recurrentgemma-2b", "rglru"),
                                       ("recurrentgemma-2b", "local_attn"),
                                       ("mamba2-370m", "ssd")])
def test_recurrent_block_gradient_at_full_width_on_the_card_matches_the_cpu(dev, arch, kind):
    """Train mode through one full-width block at S = 4096, f32: an
    RG-LRU block (d_model 2560, its doubling scan over 4096 steps), a
    local attention block (window 2048, 10 query heads on 1 KV head at
    head_dim 256, so the window cuts the keys) and an SSD block (d_inner
    2048, 32 heads, chunk 128, 32 chunks).  The gradient of <out, cot>
    wrt the input and every parameter on the card within 1e-4 relative L2
    of the CPU's (the two devices sum the products in other orders)."""
    block = _full_block(arch, kind)
    g = torch.Generator().manual_seed(1)
    d = block.cfg.d_model
    x = torch.randn(1, 4096, d, generator=g)
    cot = torch.randn(1, 4096, d, generator=g)
    grads = {}
    for where in ("cpu", dev):
        blk = copy.deepcopy(block).to(where)
        xi = x.to(where).requires_grad_()
        out, _, _ = blk(xi, positions=torch.arange(4096, device=where), mode="train")
        params = dict(blk.named_parameters())
        gs = torch.autograd.grad((out * cot.to(where)).sum(), [xi, *params.values()])
        grads[str(where)] = dict(zip(["x", *params], (t.cpu() for t in gs)))
    errs = {k: ((grads[str(dev)][k] - v).norm() / v.norm()).item()
            for k, v in grads["cpu"].items()}
    assert all(math.isfinite(e) for e in errs.values()) and max(errs.values()) <= 1e-4, errs


def test_doubling_scan_gradient_on_the_card_matches_sequential_f64(dev):
    """The doubling scan's gradient wrt a and b in f32 on the card at
    S = 4096 against autograd through the sequential recurrence in f64 on
    the CPU, a in (0.5, 1): within 1e-5 relative L2."""
    from repro_torch.models.layers import doubling_scan

    g = torch.Generator().manual_seed(0)
    a = torch.rand(2, 4096, 64, generator=g, dtype=torch.float64) * 0.5 + 0.5
    b = torch.randn(2, 4096, 64, generator=g, dtype=torch.float64)
    cot = torch.randn(2, 4096, 64, generator=g, dtype=torch.float64)
    a64, b64 = a.clone().requires_grad_(), b.clone().requires_grad_()
    h, hs = torch.zeros(2, 64, dtype=torch.float64), []
    for t in range(4096):
        h = a64[:, t] * h + b64[:, t]
        hs.append(h)
    want = torch.autograd.grad((torch.stack(hs, dim=1) * cot).sum(), [a64, b64])
    a32, b32 = (t.float().to(dev).requires_grad_() for t in (a, b))
    got = torch.autograd.grad((doubling_scan(a32, b32) * cot.float().to(dev)).sum(), [a32, b32])
    for gt, w in zip(got, want):
        assert ((gt.double().cpu() - w).norm() / w.norm()).item() <= 1e-5


def test_sharded_one_rank_mesh_is_bit_for_bit_the_unsharded_model(dev):
    """A 2-layer llama (the reduced config, bf16) placed on a (1, 1) mesh
    by ``launch.sharding`` (every parameter and cache a DTensor) serves the
    same bits as the unsharded model: prefill logits through B8 (one
    launch a layer, through ``local_map``) and two decode steps."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build

    cfg = get_reduced_config("llama3.2-3b")
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    ref, model = build(cfg, device=dev, generator=gen()), build(cfg, device=dev, generator=gen())
    prompts = torch.randint(0, cfg.vocab_size, (2, 160), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    want, wcache = ref.prefill(prompts, cache_len=170)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        S.shard_model(model, cfg, mesh)
        assert all(isinstance(p, DTensor) for p in model.parameters())
        kernels.reset_launch_counts()
        with S.sharded(mesh):
            got, cache = model.prefill(S.shard_batch({"t": prompts}, mesh)["t"],
                                       cache_len=170)
            assert kernels.launch_counts()["flash_attention"] == cfg.num_layers
            assert torch.equal(got.full_tensor(), want)
            tok = want.argmax(-1)[:, None]
            for pos in (160, 161):
                w, wcache = ref.decode_step(tok, wcache, pos)
                g, cache = model.decode_step(S.shard_batch({"t": tok}, mesh)["t"], cache, pos)
                assert torch.equal(g.full_tensor(), w)
                tok = w.argmax(-1)[:, None]
        assert kernels.launch_counts()["flash_attention"] == cfg.num_layers
    finally:
        dist.destroy_process_group()


def _one_rank_world():
    """A gloo world of one rank (this process), for a (1, 1) mesh."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)


def test_sharded_adamw_step_on_a_one_rank_mesh_is_bit_for_bit(dev):
    """One AdamW step of the reduced llama3.2-3b (f32 masters, bf16
    compute) on a (1, 1) mesh (``launch.steps.make_train_step(mesh=)``:
    every parameter and moment a DTensor) gives the unsharded step's loss,
    parameters and moments bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_reduced_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.schedule import constant

    cfg = get_reduced_config("llama3.2-3b")
    mk = lambda: build(cfg, device=dev, param_dtype=torch.float32,  # noqa: E731
                       generator=torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.from_numpy(v).to(dev, torch.long)
             for k, v in TokenPipeline(cfg.vocab_size, 64, 4, seed=0).batch(0).items()}
    ref = mk()
    ropt = adamw_init(dict(ref.named_parameters()))
    want = make_train_step(ref, adamw_cfg=AdamWConfig(), schedule=constant(1e-3))(ropt, batch)
    _one_rank_world()
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        model = S.shard_model(mk(), cfg, mesh)
        opt = adamw_init(dict(model.named_parameters()))
        got = make_train_step(model, adamw_cfg=AdamWConfig(), schedule=constant(1e-3),
                              mesh=mesh)(opt, batch)
        assert all(isinstance(t, DTensor) for t in [*model.parameters(), *opt["m"].values()])
        assert torch.equal(S.whole(got["loss"]), want["loss"])
        for (n, p), q in zip(model.named_parameters(), ref.parameters()):
            assert torch.equal(S.whole(p.detach()), q.detach()), n
            assert torch.equal(S.whole(opt["m"][n]), ropt["m"][n]), n
            assert torch.equal(S.whole(opt["v"][n]), ropt["v"][n]), n
    finally:
        dist.destroy_process_group()


def test_dtensor_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A mesh trainer's state on the card (DTensor parameters, AdamW
    moments and the eigen state on a (1, 1) mesh) written by
    ``CheckpointManager`` and read back by ``restore_latest`` into the live
    tree: DTensors again, on the card, with the same bits."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import eigen_opt_init
    from repro_torch.models import build
    from repro_torch.optim import EigenCompressConfig

    cfg = get_reduced_config("llama3.2-3b")
    _one_rank_world()
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        model = S.shard_model(build(cfg, device=dev, param_dtype=torch.float32,
                                    generator=torch.Generator(device=dev).manual_seed(0)),
                              cfg, mesh, eigen=True)
        opt = eigen_opt_init(model, EigenCompressConfig(rank=8, min_dim=64), 1, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(1)
        for st in opt["eigen"].values():
            S.local(st["err"]).normal_(generator=gen)
        tree = {"params": dict(model.named_parameters()), "opt": opt}
        ck = CheckpointManager(str(tmp_path), every=1)
        ck.maybe_save(1, tree, force=True)
        ck.wait()
        step, got, _ = ck.restore_latest(tree)
        assert step == 1
        for key in ("params", "opt"):
            want_l = [t for t in _leaves(tree[key]) if isinstance(t, DTensor)]
            got_l = [t for t in _leaves(got[key]) if isinstance(t, DTensor)]
            assert len(got_l) == len(want_l) > 0
            for a, b in zip(got_l, want_l):
                assert a.device.type == "cuda" and a.placements == b.placements
                assert torch.equal(S.local(a), S.local(b))
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]

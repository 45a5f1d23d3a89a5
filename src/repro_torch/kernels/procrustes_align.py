"""Wrappers over the Procrustes-fixing CUDA kernels (B2-B7).

Replace the Pallas TPU kernels of ``repro/kernels/procrustes_align.py``:

  * ``batched_gram``       G_i = V_i^T ref               (m, r, r) f32
  * ``batched_gram_polar`` Z_i = NS-polar(V_i^T ref)     (m, r, r) f32
  * ``align_average``      (1/m) sum_i V_i Z_i           (d, r) f32
  * ``fused_round``        n_iter whole rounds, one launch each   (d, r)
  * ``fused_ring_round``   one whole round over a wire stack      (d, r) f32
  * ``fused_ring_round_remote``  one ring round, each rank holding only
                           its own basis, the hops peer writes  (d, r) f32

The TPU kernels walk d sequentially per machine.  On the card B2 splits
d across the blocks of a thread-block cluster, one cluster per (machine,
output tile), which sum their partial Grams through distributed shared
memory in one launch (``_gram_plan`` picks the rows a split and the
cluster size from the card's cluster occupancy).  The polar variant runs
B2 into an (m, r, r) Gram and then one cooperative launch in which each
machine's Newton-Schulz steps run on a group of blocks (``_polar_plan``:
the iterate staged in shared memory up to ``NS_SMEM_MAX_R``, streamed
from L2 past it, up to ``NS_GROUP_MAX_R``).  See
``csrc/procrustes_align.cu`` for the design notes.  The two round kernels
are one cooperative launch each (``csrc/fused_round.cu``) of the grid
``_round_plan`` gives: phases that reduce over d meet at grid-wide
barriers and hand over through scratch this module allocates once per
call, before the first launch; the Newton-Schulz phase spreads each
machine over a group of blocks (the iterate staged in shared memory up to
``NS_SMEM_MAX_R``, streamed from L2 past it, up to ``NS_GROUP_MAX_R``),
and each CholeskyQR factor runs on block 0 in shared memory up to
``NS_SMEM_MAX_R`` and on the whole grid in 32-column panels past it, its
trailing matrix in a global scratch (``_factor_scratch``).
``<wrapper>.last_form`` says which Newton-Schulz form ran (B3, B5, B6,
B7), ``<wrapper>.last_factor`` which factor form (B5, B6, B7).

Each wrapper sends a CUDA tensor to its kernel (or raises) and a CPU
tensor to the plain version in ``repro_torch.kernels.ref``; each counts
its launches in ``<wrapper>.launches`` (one per call, whatever the number
of passes; ``fused_round`` launches once per round).  The kernels take
float32 stacks, except ``fused_ring_round``, whose wire stack may also be
bfloat16 or int8 with per-column scales.

``fused_ring_round_remote`` (B7, ``csrc/fused_ring_remote.cu``) runs over
the ranks of a process group: each rank exports one exchange buffer of its
own (``cudaMalloc``, two (d, r) f32 slots and two sequence words), the
64-byte IPC handles are all-gathered once per (group, d, r, device), and
each rank maps its two neighbours' buffers (``_Exchange``, cached until
``close_remote``).  A round is one cooperative launch a hop
(``_hop_plan``), and the hop kernel writes its basis into the right
neighbour's slot and signals it there.  The waits for the neighbours'
words sit between the launches as stream memory operations, so a waiting
rank keeps no block on the card.  The wrapper watches the hops from the
host (``_watch``): a hop that waits ``REMOTE_WAIT_S`` releases the
round's stream and raises here.  ``fused_ring_round_remote.last_hops``
holds each hop's (wait, compute) ms of the last round, by CUDA events.
"""

from __future__ import annotations

import ctypes
import functools
import math
import time

import torch
import torch.distributed as dist

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = [
    "batched_gram",
    "batched_gram_polar",
    "align_average",
    "fused_round",
    "fused_ring_round",
    "fused_ring_round_remote",
    "close_remote",
    "REMOTE_WAIT_S",
]

DEFAULT_NS_ITERS = 24  # as repro_torch.core.procrustes.DEFAULT_NS_ITERS

_GRAM_TILE = 128  # output tile edge of the Gram tile (csrc gram::kBM)
_GRAM_SLICE = 32  # rows a slice of the Gram tile (csrc gram::kBK)
_AVG_ROWS = 64  # rows of d per align_average block (csrc apply::kBM)
_MAX_CLUSTER = 16  # B2's largest cluster (a non-portable size on Hopper)
_NS_GROUP_COLS = 8  # fewest iterate columns a block of a Newton-Schulz group owns
# Past NS_SMEM_MAX_R: the columns of M a block computes a pass of the
# streamed grouped form (csrc/ns_polar.cuh kWideCols), the fewest it owns.
_NS_WIDE_COLS = 16
# Largest r whose grouped Newton-Schulz form stages the whole iterate in
# the 227 KB of shared memory a block may use on Hopper (csrc/ns_polar.cuh
# kNsSmemMaxR): past it the grouped form streams the iterate from L2, and
# the round kernels' CholeskyQR factor leaves block 0's shared memory for
# the whole grid (B5-B7).
NS_SMEM_MAX_R = 136
# Largest r of the streamed grouped form: its 4-row slices, a block's M
# columns and partial sums in 227 KB (csrc/ns_polar.cuh kNsGroupMaxR).
# B3 and B5-B7 refuse a CUDA stack past it.
NS_GROUP_MAX_R = 2248
# Columns a panel of the grid factor past NS_SMEM_MAX_R (csrc/round_tiles.cuh
# kPanel).
_FACTOR_PANEL = 32
_MAX_GRID_YZ = 65535
# Most d-splits of a round's Gram phase over a wire stack: ring chunks are
# grouped into splits of whole chunks beyond this (bounds the scratch).
_MAX_RING_SPLITS = 64
_WIRE_ENTRY = {
    torch.float32: "rt_fused_round_f32",
    torch.bfloat16: "rt_fused_round_bf16",
    torch.int8: "rt_fused_round_i8",
}
_WIRE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _split_rows(d: int, m: int, r: int, blocks: int) -> tuple[int, int]:
    """(rows per split, splits) of a Gram phase over ``blocks`` blocks:
    about one (machine, 128 x 128 tile, split) unit a block, the splits
    covering all d rows."""
    tiles = math.ceil(r / _GRAM_TILE) ** 2
    rows = math.ceil(d / max(1, blocks // (m * tiles)))
    return rows, math.ceil(d / rows)


def _gram_plan(d: int, m: int, r: int, active) -> tuple[int, int]:
    """(rows per split, cluster size) of B2's one launch.  A (machine,
    tile) is one cluster of k blocks (k = 1, 2, 4, ..., ``_MAX_CLUSTER``,
    at most one per ``_GRAM_SLICE`` rows of d), block q owning rows
    q rows .. (q + 1) rows - 1; ``active(k)`` is how many clusters of k
    the card holds at once.  Takes the k with the least waves x rows (the
    smaller k on a tie)."""
    units = m * math.ceil(r / _GRAM_TILE) ** 2
    best = None
    k = 1
    while k <= min(_MAX_CLUSTER, math.ceil(d / _GRAM_SLICE)):
        held = active(k)
        if held >= 1:
            rows = math.ceil(d / k)
            cost = math.ceil(units / held) * rows
            if best is None or cost < best[0]:
                best = (cost, rows, k)
        k *= 2
    if best is None:
        raise RuntimeError("batched_gram: the card holds no cluster of its blocks")
    return best[1], best[2]


def _ns_cols(r: int, group: int) -> int:
    """Iterate columns a block of a Newton-Schulz group of ``group``
    blocks owns, as the device computes them (``csrc/ns_polar.cuh``):
    ceil(r / group), rounded up to 4 past NS_SMEM_MAX_R (aligned float4
    reads of the streamed slices)."""
    cols = math.ceil(r / group)
    return cols if r <= NS_SMEM_MAX_R else (cols + 3) // 4 * 4


def _ns_group(m: int, r: int, blocks: int) -> int:
    """Blocks a machine of the grouped Newton-Schulz form when ``m``
    machines share ``blocks`` blocks: as many as the grid gives each
    machine, each owning at least ``_NS_GROUP_COLS`` columns
    (``_NS_WIDE_COLS`` past NS_SMEM_MAX_R, where every block streams the
    whole iterate twice a step), and no block without columns."""
    fewest = _NS_GROUP_COLS if r <= NS_SMEM_MAX_R else _NS_WIDE_COLS
    want = max(1, min(blocks // m, math.ceil(r / fewest)))
    return math.ceil(r / _ns_cols(r, want))


def _polar_plan(m: int, r: int, coresident: int) -> tuple[int, int]:
    """(grid, group) of B3's Newton-Schulz launch on at most
    ``coresident`` blocks: ``_ns_group``'s blocks a machine, and as many
    whole groups as there are machines or the grid holds (the groups take
    the machines in turn when m exceeds them)."""
    group = _ns_group(m, r, coresident)
    return min(m, coresident // group) * group, group


def _round_plan(m: int, d: int, r: int, coresident: int,
                rows1: int | None = None) -> tuple[int, int, int, int, int, int]:
    """(grid, rows1, splits1, rows2, splits2, group) of one round launch on
    at most ``coresident`` blocks: the stack's Gram split (about one unit a
    block; a given ``rows1``, a ring's whole chunks, is divided evenly by
    the largest factor that keeps it within one unit a block), the S1 / S2
    split (about one unit a block), and the Newton-Schulz group
    (``_ns_group``, as B3's and B7's: g blocks a machine, each with its
    columns of the iterate; 1 when m exceeds the grid, and the blocks
    take machines in turn)."""
    tiles = math.ceil(r / _GRAM_TILE) ** 2
    if rows1 is None:
        rows1, splits1 = _split_rows(d, m, r, coresident)
    else:
        parts = max(1, coresident // (m * tiles * math.ceil(d / rows1)))
        while rows1 % parts:
            parts -= 1
        rows1 //= parts
        splits1 = math.ceil(d / rows1)
    rows2, splits2 = _split_rows(d, 1, r, coresident)
    group = _ns_group(m, r, coresident)
    units = max(m * tiles * splits1, tiles * splits2, m * group,
                math.ceil(d / _AVG_ROWS) * math.ceil(r / _GRAM_TILE))
    return min(coresident, units), rows1, splits1, rows2, splits2, group


def _hop_plan(d: int, r: int, coresident: int) -> tuple[int, int, int, int, int, int]:
    """(grid, rows1, splits1, rows2, splits2, group) of one B7 hop launch:
    the round's plan for one machine, with the hop's polar step on
    ``_ns_group`` blocks at every r."""
    grid, rows1, splits1, rows2, splits2, _ = _round_plan(1, d, r, coresident)
    return grid, rows1, splits1, rows2, splits2, _ns_group(1, r, grid)


def _check_stack(name: str, vs: torch.Tensor, other: torch.Tensor,
                 other_shape) -> tuple[int, int, int]:
    """Validate a CUDA (m, d, r) f32 stack and its partner, whose shape
    ``other_shape(m, d, r)`` gives; returns (m, d, r)."""
    if vs.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {vs.device}")
    for t in (vs, other):
        if t.device != vs.device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous inputs")
    if vs.dim() != 3:
        raise ValueError(f"{name}: vs must be (m, d, r), got {tuple(vs.shape)}")
    m, d, r = vs.shape
    if min(m, d, r) < 1 or m > _MAX_GRID_YZ:
        raise ValueError(f"{name}: unsupported stack shape {tuple(vs.shape)}")
    want = other_shape(m, d, r)
    if tuple(other.shape) != want:
        raise ValueError(f"{name}: expected shape {want}, got {tuple(other.shape)}")
    _build.require_sm90(vs)
    return m, d, r


def _factor_scratch(r: int, device: torch.device) -> torch.Tensor | None:
    """Global scratch of the round kernels' grid factor (B5/B6; B7's tail)
    past NS_SMEM_MAX_R: the trailing matrix and the substitution's
    right-hand sides (r x r each), tr(S) and a verdict word a panel
    (csrc/round_tiles.cuh factor_scratch_floats); else None (block 0's
    shared memory)."""
    if r <= NS_SMEM_MAX_R:
        return None
    panels = math.ceil(r / _FACTOR_PANEL)
    return torch.empty((2 * r * r + 1 + panels,), dtype=torch.float32, device=device)


def _factor_form(r: int) -> str:
    """The CholeskyQR factor form of the round kernels at edge r."""
    if r <= NS_SMEM_MAX_R:
        return "block 0, shared memory"
    return f"the grid, {math.ceil(r / _FACTOR_PANEL)} panels of {_FACTOR_PANEL} columns"


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


@functools.cache
def _cluster_slots(device_index: int) -> dict[int, int]:
    """Clusters of B2's blocks the card holds at once, by cluster size."""
    lib = _build.load()
    slots = {}
    k = 1
    while k <= _MAX_CLUSTER:
        held = ctypes.c_int(0)
        _build.check(lib.rt_batched_gram_clusters(device_index, k, ctypes.byref(held)),
                     "batched_gram: cluster occupancy")
        slots[k] = held.value
        k *= 2
    return slots


@functools.cache
def _round_coresident(device_index: int, dtype: torch.dtype, r: int) -> int:
    """Blocks of the round kernel for this wire dtype and r that fit on
    the card at once: the most a cooperative launch may have."""
    blocks = ctypes.c_int(0)
    _build.check(_build.load().rt_fused_round_coresident(
        device_index, _WIRE_CODE[dtype], r, ctypes.byref(blocks)),
        "fused round: occupancy")
    return blocks.value


@functools.cache
def _polar_coresident(device_index: int, r: int) -> int:
    """Blocks of B3's Newton-Schulz kernel at edge r that fit on the card
    at once: the most its cooperative launch may have."""
    blocks = ctypes.c_int(0)
    _build.check(_build.load().rt_batched_gram_polar_coresident(
        device_index, r, ctypes.byref(blocks)), "batched_gram_polar: occupancy")
    return blocks.value


def _check_group_r(name: str, r: int) -> None:
    if r > NS_GROUP_MAX_R:
        raise ValueError(f"{name}: r={r} past the grouped Newton-Schulz form's "
                         f"{NS_GROUP_MAX_R} (its slices no longer fit shared memory)")


def _gram_stage(name: str, vs: torch.Tensor, ref: torch.Tensor,
                ns_iters: int | None) -> torch.Tensor:
    m, d, r = _check_stack(name, vs, ref, lambda m, d, r: (d, r))
    rows, cluster = _gram_plan(d, m, r, _cluster_slots(vs.device.index).__getitem__)
    lib = _build.load()
    out = torch.empty((m, r, r), dtype=torch.float32, device=vs.device)
    stream = _build.stream_of(vs)
    if ns_iters is None:
        code = lib.rt_batched_gram(vs.device.index, vs.data_ptr(), ref.data_ptr(),
                                   out.data_ptr(), m, d, r, rows, cluster, stream)
    else:
        _check_group_r(name, r)
        grid, group = _polar_plan(m, r, _polar_coresident(vs.device.index, r))
        f32 = dict(dtype=torch.float32, device=vs.device)
        g = torch.empty((m, r, r), **f32)
        nsn = torch.empty((m, group), **f32)
        ctr = torch.empty((m,), dtype=torch.int32, device=vs.device)
        form = ctypes.c_int(0)
        code = lib.rt_batched_gram_polar(
            vs.device.index, vs.data_ptr(), ref.data_ptr(), g.data_ptr(),
            out.data_ptr(), nsn.data_ptr(), ctr.data_ptr(), m, d, r, rows, cluster,
            ns_iters, grid, group, ctypes.byref(form), stream)
    _build.check(code, name)
    if ns_iters is not None:
        batched_gram_polar.grid = grid
        batched_gram_polar.last_form = _ns_form(form.value)
    return out


def batched_gram(vs: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """G_i = V_i^T @ ref for vs (m, d, r), ref (d, r) -> (m, r, r) f32."""
    if vs.device.type == "cpu":
        return _ref.batched_gram(vs, ref)
    out = _gram_stage("batched_gram", vs, ref, None)
    batched_gram.launches += 1
    return out


def batched_gram_polar(
    vs: torch.Tensor, ref: torch.Tensor, *, ns_iters: int = DEFAULT_NS_ITERS
) -> torch.Tensor:
    """Z_i = polar(V_i^T @ ref) by ``ns_iters`` Newton-Schulz steps on the
    Frobenius-normalised Gram; vs (m, d, r), ref (d, r) -> (m, r, r) f32."""
    if vs.device.type == "cpu":
        return _ref.batched_gram_polar(vs, ref, ns_iters=ns_iters)
    out = _gram_stage("batched_gram_polar", vs, ref, ns_iters)
    batched_gram_polar.launches += 1
    return out


def align_average(vs: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """(1/m) sum_i V_i @ Z_i for vs (m, d, r), zs (m, r, r) -> (d, r) f32."""
    if vs.device.type == "cpu":
        return _ref.align_average(vs, zs)
    m, d, r = _check_stack("align_average", vs, zs, lambda m, d, r: (m, r, r))
    if math.ceil(d / _AVG_ROWS) > _MAX_GRID_YZ:
        raise ValueError(f"align_average: d={d} beyond the kernel's grid")
    lib = _build.load()
    out = torch.empty((d, r), dtype=torch.float32, device=vs.device)
    code = lib.rt_align_average(
        vs.device.index, vs.data_ptr(), zs.data_ptr(), out.data_ptr(),
        m, d, r, _build.stream_of(vs),
    )
    _build.check(code, "align_average")
    align_average.launches += 1
    return out


def _ns_form(group: int) -> str:
    """The Newton-Schulz form a kernel reports it ran: g blocks a machine
    with the iterate in shared memory, -g with it streamed from L2."""
    if group == 1:
        return "one block a machine, shared-memory tiles"
    if group == -1:
        return "one block a machine, iterate streamed from L2"
    if group < 0:
        return f"grouped, {-group} blocks a machine, iterate streamed from L2"
    return f"grouped, {group} blocks a machine"


def _round_launches(wrapper, vs, ref, scales, *, n_iter, rows1, ns_iters):
    """Launch ``n_iter`` rounds of the fused round kernel on the wire stack
    ``vs``; round k's (d, r) f32 output is round k+1's reference, with no
    torch op between launches (scratch and both output buffers are
    allocated first).  Counts one launch per round on ``wrapper`` and
    records its grid, Newton-Schulz form (``_ns_form``) and factor form
    (``_factor_form``)."""
    from repro_torch.core.orthonorm import cholqr_guard_coeffs

    m, d, r = vs.shape
    _check_group_r(wrapper.__name__, r)
    _build.require_sm90(vs)
    dev = vs.device
    grid, rows1, splits1, rows2, splits2, group = _round_plan(
        m, d, r, _round_coresident(dev.index, vs.dtype, r), rows1)
    pivot_c, shift_c = cholqr_guard_coeffs(d, r, torch.finfo(torch.float32).eps)
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty((max(m * splits1, splits2), r, r), **f32)
    zs = torch.empty((m, r, r), **f32)
    vbar = torch.empty((d, r), **f32)
    q1 = torch.empty((d, r), **f32)
    w = torch.empty((2, r, r), **f32)
    fs = _factor_scratch(r, dev)
    nsn = torch.empty((m, group), **f32)
    ctr = torch.empty((m,), dtype=torch.int32, device=dev)
    outs = (torch.empty((d, r), **f32), torch.empty((d, r), **f32))
    form = ctypes.c_int(-1)
    entry = getattr(_build.load(), _WIRE_ENTRY[vs.dtype])
    stream = _build.stream_of(vs)
    scales_ptr = None if scales is None else scales.data_ptr()
    cur = ref
    for k in range(max(n_iter, 1)):
        out = outs[k % 2]
        code = entry(
            dev.index, vs.data_ptr(), scales_ptr, cur.data_ptr(),
            out.data_ptr(), part.data_ptr(), zs.data_ptr(), vbar.data_ptr(),
            q1.data_ptr(), w.data_ptr(), _ptr(fs), nsn.data_ptr(), ctr.data_ptr(),
            m, d, r, rows1, splits1, rows2, splits2, ns_iters, grid, group,
            pivot_c, shift_c, ctypes.addressof(form), stream,
        )
        _build.check(code, wrapper.__name__)
        wrapper.launches += 1
        cur = out
    wrapper.grid = grid
    wrapper.last_form = _ns_form(form.value)
    wrapper.last_factor = _factor_form(r)
    return cur


def fused_round(
    vs: torch.Tensor,
    ref: torch.Tensor,
    *,
    n_iter: int = 1,
    ns_iters: int = DEFAULT_NS_ITERS,
) -> torch.Tensor:
    """``n_iter`` whole Algorithm-1 rounds, one launch each: Gram, NS polar,
    aligned average and both guarded CholeskyQR passes; vs (m, d, r) f32,
    ref (d, r) f32 -> (d, r) f32 (vs.dtype)."""
    if vs.device.type == "cpu":
        return _ref.fused_round(vs, ref, n_iter=n_iter, ns_iters=ns_iters)
    _check_stack("fused_round", vs, ref, lambda m, d, r: (d, r))
    return _round_launches(
        fused_round, vs, ref, None, n_iter=n_iter, rows1=None,
        ns_iters=ns_iters,
    )


def fused_ring_round(
    vs: torch.Tensor,
    ref: torch.Tensor,
    scales: torch.Tensor | None = None,
    *,
    ring_chunk: int | None = None,
    ns_iters: int = DEFAULT_NS_ITERS,
) -> torch.Tensor:
    """One whole round over a staged (m', d, r) wire stack: f32, bf16, or
    int8 with (m', r) f32 per-column ``scales`` (required exactly for
    int8), decoded as the kernel loads it.  ``ring_chunk`` rows (any
    value; need not divide d) are the granularity of the Gram phase's
    d-splits (whole chunks, ``ring_split_rows``, divided evenly where too
    few fill the card) and do not change the result beyond summation
    order.  ref (d, r) f32 -> (d, r) f32."""
    if vs.dtype not in _WIRE_ENTRY:
        raise ValueError(
            f"fused_ring_round expects a wire-dtype stack (f32/bf16/int8), "
            f"got {vs.dtype}"
        )
    if (scales is not None) != (vs.dtype == torch.int8):
        raise ValueError(
            "scales must be passed iff the stack is int8 "
            f"(dtype={vs.dtype}, scales={'set' if scales is not None else None})"
        )
    if vs.device.type == "cpu":
        return _ref.fused_ring_round(
            vs, ref, scales, ring_chunk=ring_chunk, ns_iters=ns_iters
        )
    if vs.device.type != "cuda":
        raise ValueError(f"fused_ring_round: unsupported device {vs.device}")
    if vs.dim() != 3 or min(vs.shape) < 1 or not vs.is_contiguous():
        raise ValueError(
            f"fused_ring_round: vs must be a contiguous non-empty (m, d, r) "
            f"stack, got {tuple(vs.shape)}"
        )
    m, d, r = vs.shape
    for name, t, shape in (("ref", ref, (d, r)), ("scales", scales, (m, r))):
        if t is None:
            continue
        if t.device != vs.device or t.dtype != torch.float32:
            raise TypeError(f"fused_ring_round: {name} must be float32 on {vs.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fused_ring_round: {name} must be contiguous {shape}, "
                f"got {tuple(t.shape)}"
            )
    return _round_launches(
        fused_ring_round, vs, ref, scales, n_iter=1,
        rows1=ring_split_rows(d, ring_chunk), ns_iters=ns_iters,
    )


def ring_split_rows(d: int, ring_chunk: int | None) -> int:
    """Rows per d-split of the ring round's Gram phase: whole ring chunks
    (``comm.ring.chunk_spans``), grouped so that there are at most
    ``_MAX_RING_SPLITS`` splits."""
    from repro_torch.comm.ring import DEFAULT_RING_CHUNK, chunk_spans

    chunk = DEFAULT_RING_CHUNK if ring_chunk is None else int(ring_chunk)
    chunk = max(1, min(chunk, d))
    return chunk * math.ceil(len(chunk_spans(d, chunk)) / _MAX_RING_SPLITS)


# Wall-clock bound of each of B7's hops, its waits (a neighbour's push,
# or its release of the slot a push fills) included; a hop that runs out
# raises.  Read at every call, so a caller (or a test) may set it.
REMOTE_WAIT_S = 60.0
_WATCH_PAUSE_S = 1e-4  # the host's pause between polls of a hop's event
_IPC_HANDLE_BYTES = 64  # sizeof(cudaIpcMemHandle_t)
_TIMED_OUT = {1: "the left neighbour's push", 2: "the right neighbour's release of a slot"}


class _Exchange:
    """This rank's B7 exchange buffer, exported, and its two neighbours'
    buffers mapped into this process; ``calls`` counts the rounds run on
    it (every rank of the group makes the same calls in the same order,
    which keeps the hop sequence numbers in step)."""

    def __init__(self, group, d: int, r: int, device: torch.device):
        lib = _build.load()
        self.group, self.device, self.calls = group, device, 0
        ptr = ctypes.c_void_p()
        handle = (ctypes.c_ubyte * _IPC_HANDLE_BYTES)()
        _build.check(lib.rt_remote_alloc(
            device.index, lib.rt_remote_exchange_bytes(d, r), ctypes.byref(ptr),
            ctypes.addressof(handle)), "fused_ring_round_remote: export")
        self.mine = ptr.value
        from repro_torch.comm import transport

        mine = torch.tensor(list(handle), dtype=torch.uint8, device=device)
        handles = transport.all_gather(mine, group=group).cpu()
        me, m = dist.get_rank(group), dist.get_world_size(group)
        self.peers = {}
        for k in dict.fromkeys(((me - 1) % m, (me + 1) % m)):
            peer = (ctypes.c_ubyte * _IPC_HANDLE_BYTES)(*handles[k].tolist())
            p = ctypes.c_void_p()
            _build.check(lib.rt_remote_open(
                device.index, ctypes.addressof(peer), ctypes.byref(p)),
                f"fused_ring_round_remote: map rank {k}'s buffer")
            self.peers[k] = p.value
        self.left, self.right = self.peers[(me - 1) % m], self.peers[(me + 1) % m]

    def close(self) -> None:
        """Unmap the neighbours' buffers, wait until every rank of the
        group has unmapped this one, then free it (collective)."""
        from repro_torch.comm import transport

        lib = _build.load()
        torch.cuda.synchronize(self.device)
        for p in self.peers.values():
            _build.check(lib.rt_remote_close(self.device.index, p),
                         "fused_ring_round_remote: unmap")
        transport.barrier(group=self.group)
        _build.check(lib.rt_remote_free(self.device.index, self.mine),
                     "fused_ring_round_remote: free")


_EXCHANGES: dict[tuple, _Exchange] = {}


def close_remote(group=None) -> None:
    """Release every B7 exchange of ``group`` (collective over it: each
    rank unmaps its neighbours' buffers before any rank frees its own)."""
    for key in [k for k in _EXCHANGES if k[0] == id(group)]:
        _EXCHANGES.pop(key).close()


def _check_basis(name: str, v: torch.Tensor, ref: torch.Tensor) -> None:
    """B7 takes one contiguous (d, r) f32 basis and a reference of the same
    shape, on one CPU or CUDA device."""
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {v.device}")
    if ref.device != v.device:
        raise ValueError(f"{name}: inputs on different devices")
    for t in (v, ref):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 (the 32-bit wire), got {t.dtype}")
    if v.dim() != 2 or min(v.shape) < 1 or tuple(ref.shape) != tuple(v.shape):
        raise ValueError(
            f"{name}: v_local and ref must be (d, r) of one shape, got "
            f"{tuple(v.shape)} and {tuple(ref.shape)}"
        )
    if not (v.is_contiguous() and ref.is_contiguous()):
        raise ValueError(f"{name} needs contiguous inputs")


def plain_remote(v_local, ref, *, group, ns_iters=DEFAULT_NS_ITERS):
    """B7's plain version over ``group``: each hop a
    ``transport.ring_shift`` to the right neighbour."""
    from repro_torch.comm import transport

    ranks = tuple(range(dist.get_world_size(group)))
    return _ref.fused_ring_round_remote(
        v_local, ref, m=len(ranks), ns_iters=ns_iters,
        hop=lambda x: transport.ring_shift([x], ranks=ranks, group=group)[0],
    )


@functools.cache
def _hop_coresident(device_index: int, r: int) -> int:
    """Blocks of B7's hop kernel at edge r that fit on the card at once."""
    blocks = ctypes.c_int(0)
    _build.check(_build.load().rt_fused_ring_remote_coresident(
        device_index, r, ctypes.byref(blocks)), "fused_ring_round_remote: occupancy")
    return blocks.value


def _watch(done, wait_s: float, clock=time.monotonic, pause: float = _WATCH_PAUSE_S):
    """Wait on the host for the hops' completion events ``done`` (in stream
    order), polling them with ``query()`` (never a blocking call): hop k
    may take ``wait_s`` from the moment hop k - 1 was seen done (hop 0:
    from the call).  Returns the index of the first hop that ran out, or
    None once every hop is done."""
    k, deadline = 0, clock() + wait_s
    while k < len(done):
        if done[k].query():
            k += 1
            deadline = clock() + wait_s
        elif clock() > deadline:
            return k
        else:
            time.sleep(pause)
    return None


def fused_ring_round_remote(
    v_local: torch.Tensor,
    ref: torch.Tensor,
    *,
    group,
    ns_iters: int = DEFAULT_NS_ITERS,
) -> torch.Tensor:
    """One fused ring round over the m ranks of ``group``, each rank holding
    only its own (d, r) f32 basis: m hops, hop i on the basis of rank
    (me - i) mod m (the right neighbour gets each basis by a peer write),
    Gram against ``ref``, Newton-Schulz polar and V-bar += x Z, then
    CholeskyQR2(V-bar / m).  32-bit wire only.  Every rank of the group
    calls it with the same (d, r) and ``ref``; returns (d, r) f32 once the
    round is done.  CPU tensors take the plain version (``plain_remote``);
    a world of one rank makes no IPC call."""
    name = "fused_ring_round_remote"
    _check_basis(name, v_local, ref)
    if v_local.device.type == "cpu":
        return plain_remote(v_local, ref, group=group, ns_iters=ns_iters)
    from repro_torch.core.orthonorm import cholqr_guard_coeffs

    d, r = v_local.shape
    _check_group_r(name, r)
    _build.require_sm90(v_local)
    dev = v_local.device
    m = dist.get_world_size(group)
    ex = None
    key = (id(group), d, r, dev.index)
    if m > 1:
        ex = _EXCHANGES.get(key)
        if ex is None:
            ex = _EXCHANGES[key] = _Exchange(group, d, r, dev)
    grid, rows1, splits1, rows2, splits2, ngroup = _hop_plan(
        d, r, _hop_coresident(dev.index, r))
    pivot_c, shift_c = cholqr_guard_coeffs(d, r, torch.finfo(torch.float32).eps)
    f32 = dict(dtype=torch.float32, device=dev)
    out, vbar, q1 = (torch.empty((d, r), **f32) for _ in range(3))
    part = torch.empty((max(splits1, splits2), r, r), **f32)
    z = torch.empty((r, r), **f32)
    w = torch.empty((2, r, r), **f32)
    fs = _factor_scratch(r, dev)
    nsn = torch.empty((ngroup,), **f32)
    ctr = torch.empty((1,), dtype=torch.int32, device=dev)
    status = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev)
    seq0 = 0 if ex is None else ex.calls * m
    mine, right, left = (None, None, None) if ex is None else (ex.mine, ex.right, ex.left)
    start = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    hops = []
    for i in range(m):
        g = seq0 + i
        if ex is not None:
            _build.check(lib.rt_remote_wait(
                dev.index, mine, g + 1 if i > 0 else 0, g if i < m - 1 else 0,
                stream.cuda_stream), f"{name}: wait")
        ready, done = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ready.record(stream)
        _build.check(lib.rt_remote_hop(
            dev.index, v_local.data_ptr(), ref.data_ptr(), out.data_ptr(),
            part.data_ptr(), z.data_ptr(), vbar.data_ptr(), q1.data_ptr(),
            w.data_ptr(), _ptr(fs), nsn.data_ptr(), ctr.data_ptr(), mine, right,
            left, status.data_ptr(), seq0, m, d, r, rows1, splits1, rows2, splits2,
            ns_iters, grid, ngroup, i, pivot_c, shift_c, stream.cuda_stream), name)
        done.record(stream)
        hops.append((ready, done))
    fused_ring_round_remote.launches += 1
    fused_ring_round_remote.grid = grid
    fused_ring_round_remote.last_form = _ns_form(-ngroup if r > NS_SMEM_MAX_R else ngroup)
    fused_ring_round_remote.last_factor = _factor_form(r)
    if ex is not None:
        ex.calls += 1
    if ex is None:  # one rank: nothing to wait for
        hops[-1][1].synchronize()
        stuck = None
    else:
        stuck = _watch([done for _, done in hops], REMOTE_WAIT_S)
    if stuck is not None:
        code = ctypes.c_int(0)
        _build.check(lib.rt_remote_release(
            dev.index, mine, status.data_ptr(), seq0 + stuck + 1 if stuck > 0 else 0,
            ctypes.byref(code)), f"{name}: release")
        _EXCHANGES.pop(key).close()
        raise RuntimeError(
            f"{name}: rank {dist.get_rank(group)} waited {REMOTE_WAIT_S} s for "
            f"{_TIMED_OUT[code.value]}; the ring of {m} ranks is stuck"
        )
    before = [start] + [done for _, done in hops[:-1]]
    fused_ring_round_remote.last_hops = [
        (prev.elapsed_time(ready), ready.elapsed_time(done))
        for prev, (ready, done) in zip(before, hops)]
    return out


batched_gram.launches = 0
batched_gram_polar.launches = 0
align_average.launches = 0
fused_round.launches = 0
fused_ring_round.launches = 0
fused_ring_round_remote.launches = 0
fused_round.grid = 0
fused_ring_round.grid = 0
fused_ring_round_remote.grid = 0
batched_gram_polar.grid = 0
fused_round.last_form = None
fused_ring_round.last_form = None
batched_gram_polar.last_form = None
fused_ring_round_remote.last_form = None
fused_round.last_factor = None
fused_ring_round.last_factor = None
fused_ring_round_remote.last_factor = None
fused_ring_round_remote.last_hops = []

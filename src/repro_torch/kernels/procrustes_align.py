"""Wrappers over the Procrustes-fixing CUDA kernels (B2-B7).

Replace the Pallas TPU kernels of ``repro/kernels/procrustes_align.py``:

  * ``batched_gram``       G_i = V_i^T ref               (m, r, r) f32
  * ``batched_gram_polar`` Z_i = NS-polar(V_i^T ref)     (m, r, r) f32
  * ``align_average``      (1/m) sum_i V_i Z_i           (d, r) f32
  * ``fused_round``        n_iter whole rounds, one launch each   (d, r)
  * ``fused_ring_round``   one whole round over a wire stack      (d, r) f32
  * ``fused_ring_round_remote``  one ring round, each rank holding only
                           its own basis, the hops peer writes  (d, r) f32

The TPU kernels walk d sequentially per machine.  On the card the Gram
stages split d across blocks instead (``_split_rows``): pass 1 writes
partial Grams into an (m, splits, r, r) f32 scratch allocated here, pass 2
reduces them in a fixed order (and, for the polar variant, runs the
Newton-Schulz steps on the r x r tile in shared memory).  See
``csrc/procrustes_align.cu`` for the design notes.  The two round kernels
are one cooperative launch each (``csrc/fused_round.cu``): phases that
reduce over d meet at grid-wide barriers and hand over through scratch
this module allocates once per call, before the first launch.

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
``close_remote``).  The kernel writes each hop's basis into the right
neighbour's slot and signals it there; every wait is bounded by
``REMOTE_WAIT_S`` and one that runs out raises here.
"""

from __future__ import annotations

import ctypes
import math

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

_GRAM_TILE = 64  # output tile edge of the Gram pass (csrc kBM)
_AVG_ROWS = 64  # rows of d per align_average block (csrc kAvgBM)
_GRAM_ROWS = 16  # rows per shared-memory slice of the Gram pass (csrc kBK)
_BLOCKS_PER_SM = 2  # pass-1 blocks aimed at per SM
# Largest r whose Newton-Schulz working set (3 padded r x r f32 tiles)
# fits the 227 KB of shared memory a block may use on Hopper.
NS_MAX_R = 136
_MAX_GRID_YZ = 65535
# Most d-splits of a round's Gram phase over a wire stack: ring chunks are
# grouped into splits of whole chunks beyond this (bounds the scratch).
_MAX_RING_SPLITS = 64
_WIRE_ENTRY = {
    torch.float32: "rt_fused_round_f32",
    torch.bfloat16: "rt_fused_round_bf16",
    torch.int8: "rt_fused_round_i8",
}


def _split_rows(d: int, m: int, r: int, sms: int) -> tuple[int, int]:
    """(rows per split, splits) of the Gram pass: enough (machine, tile,
    split) blocks for ``_BLOCKS_PER_SM`` per SM, each split a whole number
    of ``_GRAM_ROWS`` slices, the splits covering all d rows."""
    tiles = math.ceil(r / _GRAM_TILE) ** 2
    want = max(1, math.ceil(_BLOCKS_PER_SM * sms / (m * tiles)))
    rows = max(_GRAM_ROWS, math.ceil(math.ceil(d / want) / _GRAM_ROWS) * _GRAM_ROWS)
    return rows, math.ceil(d / rows)


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


def _gram_stage(name: str, vs: torch.Tensor, ref: torch.Tensor,
                ns_iters: int | None) -> torch.Tensor:
    m, d, r = _check_stack(name, vs, ref, lambda m, d, r: (d, r))
    if ns_iters is not None and r > NS_MAX_R:
        raise ValueError(
            f"{name}: r={r} exceeds the in-shared-memory Newton-Schulz "
            f"limit r <= {NS_MAX_R}"
        )
    sms = torch.cuda.get_device_properties(vs.device).multi_processor_count
    rows, splits = _split_rows(d, m, r, sms)
    lib = _build.load()
    part = torch.empty((m, splits, r, r), dtype=torch.float32, device=vs.device)
    out = torch.empty((m, r, r), dtype=torch.float32, device=vs.device)
    args = [vs.device.index, vs.data_ptr(), ref.data_ptr(), part.data_ptr(),
            out.data_ptr(), m, d, r, rows, splits]
    if ns_iters is None:
        code = lib.rt_batched_gram(*args, _build.stream_of(vs))
    else:
        code = lib.rt_batched_gram_polar(*args, ns_iters, _build.stream_of(vs))
    _build.check(code, name)
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


def _round_launches(wrapper, vs, ref, scales, *, n_iter, rows1, ns_iters):
    """Launch ``n_iter`` rounds of the fused round kernel on the wire stack
    ``vs``; round k's (d, r) f32 output is round k+1's reference, with no
    torch op between launches (scratch and both output buffers are
    allocated first).  Counts one launch per round on ``wrapper``."""
    from repro_torch.core.orthonorm import cholqr_guard_coeffs

    m, d, r = vs.shape
    if r > NS_MAX_R:
        raise ValueError(
            f"{wrapper.__name__}: r={r} exceeds the in-shared-memory "
            f"Newton-Schulz and Cholesky limit r <= {NS_MAX_R}"
        )
    _build.require_sm90(vs)
    dev = vs.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits1 = math.ceil(d / rows1)
    rows2, splits2 = _split_rows(d, 1, r, sms)
    pivot_c, shift_c = cholqr_guard_coeffs(d, r, torch.finfo(torch.float32).eps)
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty((max(m * splits1, splits2), r, r), **f32)
    zs = torch.empty((m, r, r), **f32)
    vbar = torch.empty((d, r), **f32)
    q1 = torch.empty((d, r), **f32)
    w = torch.empty((2, r, r), **f32)
    outs = (torch.empty((d, r), **f32), torch.empty((d, r), **f32))
    grid = ctypes.c_int(0)
    entry = getattr(_build.load(), _WIRE_ENTRY[vs.dtype])
    stream = _build.stream_of(vs)
    scales_ptr = None if scales is None else scales.data_ptr()
    cur = ref
    for k in range(max(n_iter, 1)):
        out = outs[k % 2]
        code = entry(
            dev.index, vs.data_ptr(), scales_ptr, cur.data_ptr(),
            out.data_ptr(), part.data_ptr(), zs.data_ptr(), vbar.data_ptr(),
            q1.data_ptr(), w.data_ptr(), m, d, r, rows1, splits1, rows2,
            splits2, ns_iters, pivot_c, shift_c, ctypes.addressof(grid),
            stream,
        )
        _build.check(code, wrapper.__name__)
        wrapper.launches += 1
        cur = out
    wrapper.grid = grid.value
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
    m, d, r = _check_stack("fused_round", vs, ref, lambda m, d, r: (d, r))
    rows1, _ = _split_rows(d, m, r, torch.cuda.get_device_properties(
        vs.device).multi_processor_count)
    return _round_launches(
        fused_round, vs, ref, None, n_iter=n_iter, rows1=rows1,
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
    d-splits and do not change the result.  ref (d, r) f32 -> (d, r) f32."""
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


# Wall-clock bound of each wait inside B7 (a neighbour's push, or its
# release of the slot a push fills); a wait that runs out raises.  Read at
# every call, so a caller (or a test) may set it.
REMOTE_WAIT_S = 60.0
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
    calls it with the same (d, r) and ``ref``; returns (d, r) f32.  CPU
    tensors take the plain version (``plain_remote``); a world of one
    rank makes no IPC call."""
    name = "fused_ring_round_remote"
    _check_basis(name, v_local, ref)
    if v_local.device.type == "cpu":
        return plain_remote(v_local, ref, group=group, ns_iters=ns_iters)
    from repro_torch.core.orthonorm import cholqr_guard_coeffs

    d, r = v_local.shape
    if r > NS_MAX_R:
        raise ValueError(
            f"{name}: r={r} exceeds the in-shared-memory Newton-Schulz and "
            f"Cholesky limit r <= {NS_MAX_R}"
        )
    _build.require_sm90(v_local)
    dev = v_local.device
    m = dist.get_world_size(group)
    ex = None
    if m > 1:
        key = (id(group), d, r, dev.index)
        ex = _EXCHANGES.get(key)
        if ex is None:
            ex = _EXCHANGES[key] = _Exchange(group, d, r, dev)
    rows, splits = _split_rows(
        d, 1, r, torch.cuda.get_device_properties(dev).multi_processor_count)
    pivot_c, shift_c = cholqr_guard_coeffs(d, r, torch.finfo(torch.float32).eps)
    f32 = dict(dtype=torch.float32, device=dev)
    out, vbar, q1 = (torch.empty((d, r), **f32) for _ in range(3))
    part = torch.empty((splits, r, r), **f32)
    z = torch.empty((r, r), **f32)
    w = torch.empty((2, r, r), **f32)
    status = torch.zeros(1, dtype=torch.int32, device=dev)
    seq0 = 0 if ex is None else ex.calls * m
    grid = ctypes.c_int(0)
    code = _build.load().rt_fused_ring_remote(
        dev.index, v_local.data_ptr(), ref.data_ptr(), out.data_ptr(),
        part.data_ptr(), z.data_ptr(), vbar.data_ptr(), q1.data_ptr(),
        w.data_ptr(), ex and ex.mine, ex and ex.right, ex and ex.left,
        status.data_ptr(), seq0, int(REMOTE_WAIT_S * 1e9), m, d, r, rows,
        splits, rows, splits, ns_iters, pivot_c, shift_c,
        ctypes.addressof(grid), _build.stream_of(v_local),
    )
    _build.check(code, name)
    fused_ring_round_remote.launches += 1
    fused_ring_round_remote.grid = grid.value
    if ex is not None:
        ex.calls += 1
    timed_out = int(status.item())  # waits for the round
    if timed_out:
        raise RuntimeError(
            f"{name}: rank {dist.get_rank(group)} waited {REMOTE_WAIT_S} s for "
            f"{_TIMED_OUT[timed_out]}; the ring of {m} ranks is stuck"
        )
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

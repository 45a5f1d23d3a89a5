"""Ring schedule: consume each neighbour's basis as it arrives (port of
``repro/comm/ring.py``).

``ring_rounds``: every rank's (d, r) basis circulates the ring of
(surviving) ranks in d-chunks, m'-1 hops a round, each hop one
``batch_isend_irecv`` to the right neighbour (one message per chunk).  On
every hop the receiving rank aligns the arrival to the reference and adds
it to the running V̄, so the (m, d, r) stack is never held: three (d, r)
buffers per rank.  Under ``backend="cuda"`` each arrival is aligned by the
Gram (+ polar) and apply kernels (``kops.align_one``).

``fused_ring_rounds``: the cuda backend's (newton-schulz, cholesky-qr2)
cell.  Every round's wire payload is staged before the first launch (an
all-gather of the payloads, plus the int8 scales), then each round is one
launch of the fused ring-round kernel (B6) over the staged (m', d, r)
stack, with nothing between launches.  The error-feedback recurrence
reads only the local basis and the previous residual, never a round's
output, which is what lets the staging come first.

Wire precision (``comm_bits``): a lossy round quantizes once and the
payload circulates verbatim (receivers decode for compute and forward
the original), with the encoding residual carried into the next round's
send.  Under a degraded ``membership`` the ring links the survivors only;
``ring_rounds`` then broadcasts the first survivor's answer to every rank.
Core imports are function-level: this module sits below
``repro_torch.core``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.comm import transport
from repro_torch.comm.membership import Membership, resolve_membership
from repro_torch.comm.quantize import get_codec, shard_generator, wire_broadcast

__all__ = [
    "DEFAULT_RING_CHUNK",
    "chunk_spans",
    "ring_rounds",
    "fused_ring_rounds",
]

# Salt of the ring's per-rank stochastic-rounding streams ("RING").
_RING_SALT = 0x52494E47

# Rows per circulating chunk (the transfer granularity), as the reference.
DEFAULT_RING_CHUNK = 2048


def chunk_spans(d: int, chunk: int) -> list[tuple[int, int]]:
    """[start, end) row spans tiling d; the last span may be short.  The
    one home of the ring's chunk geometry (the hops here and the fused
    ring-round kernel's d-splits)."""
    chunk = max(1, min(chunk, d))
    return [(s, min(s + chunk, d)) for s in range(0, d, chunk)]


def _reference(v_local, codec, mem, group, rank):
    """Default reference: the first survivor's basis, broadcast at wire
    precision (decoded to f32 on the lossy tiers)."""
    gen = (shard_generator(_RING_SALT, rank, 0, v_local.device)
           if codec.stochastic else None)
    return wire_broadcast(v_local, codec, src=mem.first_active, group=group,
                          generator=gen)


def ring_rounds(
    v_local: torch.Tensor,
    ref: torch.Tensor | None = None,
    *,
    group,
    n_iter: int = 1,
    polar: str = "svd",
    orth: str = "qr",
    chunk: int = DEFAULT_RING_CHUNK,
    comm_bits: int = 32,
    membership: Membership | None = None,
    backend: str = "torch",
) -> torch.Tensor:
    """``n_iter`` Algorithm-1 rounds over the process group by the ring
    schedule.  ``ref`` defaults to the first survivor's basis (one
    wire-precision broadcast); each round costs m'-1 hop messages of
    ``message_bits(d, r, comm_bits)``.  Returns the (d, r) round output in
    ``v_local.dtype`` on every rank."""
    from repro_torch.core.orthonorm import orthonormalize, resolve_orth
    from repro_torch.core.procrustes import resolve_polar
    from repro_torch.kernels.ops import align_for_backend as align

    resolve_polar(polar)
    resolve_orth(orth)
    codec = get_codec(comm_bits)
    rank = dist.get_rank(group)
    mem = resolve_membership(membership, dist.get_world_size(group))
    if ref is None:
        ref = _reference(v_local, codec, mem, group, rank)
    spans = chunk_spans(v_local.shape[0], chunk)
    out = ref
    err = torch.zeros(v_local.shape, dtype=torch.float32,
                      device=v_local.device) if codec.lossy else None
    for k in range(max(n_iter, 1)):
        ref32 = out.to(torch.float32).contiguous()
        if codec.lossy:
            gen = (shard_generator(_RING_SALT, rank, k + 1, v_local.device)
                   if codec.stochastic else None)
            send = v_local.to(torch.float32) + err
            data, scale = codec.encode(send, gen)
            err = codec.residual(send, data, scale)
        else:
            data, scale = v_local.to(torch.float32), None
        acc = align(codec.decode(data, scale), ref32, polar=polar,
                    backend=backend)
        bufs = [data[s:e] for s, e in spans]
        for _ in range(mem.m_active - 1):
            bufs = transport.ring_shift(bufs, ranks=mem.indices, group=group)
            if scale is not None:
                scale = transport.ring_shift([scale], ranks=mem.indices,
                                             group=group)[0]
            arrived = codec.decode(torch.cat(bufs), scale)
            acc = acc + align(arrived, ref32, polar=polar, backend=backend)
        out = orthonormalize(acc / mem.m_active, orth=orth).to(v_local.dtype)
    if not mem.is_full:
        # Dead ranks took no hops; hand them the survivors' answer (one
        # exact d·r broadcast, the cost model's degraded-ring sync term).
        from repro_torch.comm.topology import broadcast_from

        out = broadcast_from(out, src=mem.first_active, group=group)
    return out


def fused_ring_rounds(
    v_local: torch.Tensor,
    ref: torch.Tensor | None = None,
    *,
    group,
    n_iter: int = 1,
    chunk: int = DEFAULT_RING_CHUNK,
    comm_bits: int = 32,
    membership: Membership | None = None,
) -> torch.Tensor:
    """``n_iter`` rounds of the fused ring cell: all rounds' wire payloads
    staged by all-gather (at 32 bits the payload is the same every round
    and is gathered once), then one B6 launch per round; round k's (d, r)
    f32 output is round k+1's reference.  Every rank, dead ones included,
    decodes the same m' payloads, so no resync is needed.  Returns the
    (d, r) output in ``v_local.dtype``."""
    from repro_torch.kernels import ops as kops

    codec = get_codec(comm_bits)
    rank = dist.get_rank(group)
    mem = resolve_membership(membership, dist.get_world_size(group))
    if ref is None:
        ref = _reference(v_local, codec, mem, group, rank)
    idx = (None if mem.is_full
           else torch.tensor(mem.indices, device=v_local.device))

    def stage(data, scale):
        g = transport.all_gather(data, group=group)
        gs = None if scale is None else transport.all_gather(scale, group=group)
        if idx is not None:
            g = g.index_select(0, idx)
            gs = None if gs is None else gs.index_select(0, idx)
        return g, gs

    n = max(n_iter, 1)
    if codec.lossy:
        payloads = []
        err = torch.zeros(v_local.shape, dtype=torch.float32,
                          device=v_local.device)
        for k in range(n):
            gen = (shard_generator(_RING_SALT, rank, k + 1, v_local.device)
                   if codec.stochastic else None)
            send = v_local.to(torch.float32) + err
            data, scale = codec.encode(send, gen)
            err = codec.residual(send, data, scale)
            payloads.append(stage(data, scale))
    else:
        payloads = [stage(v_local.to(torch.float32), None)] * n
    out = ref.to(torch.float32).contiguous()
    for g, gs in payloads:
        out = kops.fused_ring_round(g, out, scales=gs, ring_chunk=chunk,
                                    use_kernel=True)
    return out.to(v_local.dtype)

"""Two-level aggregation over (pod, local) process groups (port of
``repro/comm/hier.py``).

The ranks form p pods of ``local`` ranks each, pod-major: global rank
q·local + l is slot l of pod q.  Each rank belongs to two groups: its
pod's *local* group (the fast link) and the *pod* group of its slot
(ranks l, local + l, ..., the slow link).  Each refinement round of
``hier_rounds``

  1. aligns the local basis to the shared reference (the psum schedule's
     per-rank body, ``kernels.ops.align_for_backend``: the Gram (+ polar)
     and apply kernels under ``backend="cuda"``);
  2. sums the aligned bases over the local group, one exact f32
     all-reduce, so every slot of pod q holds the pod sum (dead ranks add
     exact zeros);
  3. circulates only the p pod sums around a ring over the pod group at
     ``comm_bits`` (``_ring_psum``): the contributions are already aligned,
     so hops accumulate with no per-hop Procrustes;
  4. orthonormalizes the mean over the m' live ranks into the next
     reference.

``comm_bits`` applies to the inter-pod wire only (the ring hops and the
reference's pod-level broadcast); the intra-pod sums are exact, so every
slot of a pod encodes the same pod sum.  The 8-bit streams are therefore
keyed by *pod*, not rank (``_HIER_SALT``, round): every slot of pod q
draws the same rounding and the pod's slots stay replicas.  A fully dead
pod takes no hops; one exact broadcast from the first live pod hands it
the answer after the rounds.  Core imports are function-level: this
module sits below ``repro_torch.core``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.comm import transport
from repro_torch.comm.membership import Membership, pod_membership, resolve_membership
from repro_torch.comm.quantize import get_codec, shard_generator, wire_broadcast
from repro_torch.comm.ring import DEFAULT_RING_CHUNK, chunk_spans
from repro_torch.comm.topology import broadcast_from

__all__ = ["hier_rounds"]

# Salt of the inter-pod stochastic-rounding streams ("HIER"), keyed by pod.
_HIER_SALT = 0x48494552


def _ring_psum(x, *, group, pod_mem: Membership, chunk: int, codec, err,
               generator):
    """Sum ``x`` over the live pods of the pod ``group`` by a chunked ring at
    wire precision; returns ``(total, err)``.  The payload is quantized
    once (error feedback in ``err``) and circulates verbatim; every live
    pod decodes the same p' payloads, its own included.  A rank of a dead
    pod moves nothing and its total is discarded by the caller's resync."""
    spans = chunk_spans(x.shape[0], chunk)
    if codec.lossy:
        send = x.to(torch.float32) + err
        data, scale = codec.encode(send, generator)
        err = codec.residual(send, data, scale)
        bufs = [data[s:e] for s, e in spans]
    else:
        scale = None
        bufs = [x[s:e].to(torch.float32) for s, e in spans]
    acc = [codec.decode(b, scale) for b in bufs]
    for _ in range(pod_mem.m_active - 1):
        bufs = transport.ring_shift(bufs, ranks=pod_mem.indices, group=group)
        if scale is not None:
            scale = transport.ring_shift([scale], ranks=pod_mem.indices,
                                         group=group)[0]
        acc = [a + codec.decode(b, scale) for a, b in zip(acc, bufs)]
    return torch.cat(acc), err


def hier_rounds(
    v_local: torch.Tensor,
    ref: torch.Tensor | None = None,
    *,
    local_group,
    pod_group,
    n_iter: int = 1,
    backend: str = "torch",
    polar: str = "svd",
    orth: str = "qr",
    chunk: int = DEFAULT_RING_CHUNK,
    comm_bits: int = 32,
    membership: Membership | None = None,
) -> torch.Tensor:
    """``n_iter`` Algorithm-1 rounds over the (pod, local) groups.

    ``v_local``: this rank's (d, r) basis.  ``ref`` defaults to the first
    live rank's basis, broadcast in two stages: exact over the local
    group, then at wire precision over the pod group.  Each round costs
    one exact d·r all-reduce over the local group and p'-1 inter-pod hop
    messages of ``message_bits(d, r, comm_bits)``.  ``membership`` is over
    the pod-major flattening (rank q·local + l) and applies per level.
    Returns the (d, r) output in ``v_local.dtype`` on every rank."""
    from repro_torch.core.orthonorm import orthonormalize, resolve_orth
    from repro_torch.core.procrustes import resolve_polar
    from repro_torch.kernels.ops import align_for_backend

    resolve_polar(polar)
    resolve_orth(orth)
    codec = get_codec(comm_bits)
    p = dist.get_world_size(pod_group)
    local = dist.get_world_size(local_group)
    pod, slot = dist.get_rank(pod_group), dist.get_rank(local_group)
    mem = resolve_membership(membership, p * local)
    pmem = pod_membership(mem, p)
    dev = v_local.device

    def gen(k):
        return (shard_generator(_HIER_SALT, pod, k, dev)
                if codec.stochastic else None)

    src_pod, src_slot = divmod(mem.first_active, local)
    if ref is None:
        ref = (broadcast_from(v_local, src=src_slot, group=local_group)
               if local > 1 else v_local)
        if p > 1:
            ref = wire_broadcast(ref, codec, src=src_pod, group=pod_group,
                                 generator=gen(0)).to(v_local.dtype)
    alive = mem.active[pod * local + slot]
    err = (torch.zeros(v_local.shape, dtype=torch.float32, device=dev)
           if codec.lossy and p > 1 else None)
    out = ref
    for k in range(max(n_iter, 1)):
        aligned = align_for_backend(v_local, out, polar=polar, backend=backend)
        contrib = aligned.to(torch.float32)
        if not alive:
            contrib = torch.zeros_like(contrib)
        pod_sum = (transport.all_reduce(contrib.contiguous(), group=local_group)
                   if local > 1 else contrib)
        if p > 1:
            total, err = _ring_psum(pod_sum, group=pod_group, pod_mem=pmem,
                                    chunk=chunk, codec=codec, err=err,
                                    generator=gen(k + 1))
        else:
            total = pod_sum
        vbar = (total / mem.m_active).to(v_local.dtype)
        out = orthonormalize(vbar, orth=orth).to(v_local.dtype)
    if p > 1 and not pmem.is_full:
        # Dead pods took no hops: one exact d·r broadcast from the first
        # live pod (the cost model's resync term).
        out = broadcast_from(out, src=pmem.first_active, group=pod_group)
    return out

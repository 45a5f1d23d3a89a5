"""The port's only calls into ``torch.distributed``.

Every collective of the comm layer goes through the functions here, each
on an explicit ``ProcessGroup`` (ranks are group ranks):

  * ``all_reduce``  (sum or max, in place)
  * ``broadcast``   (in place, from a group rank)
  * ``all_gather``  (one tensor per rank -> a (world, ...) stack)
  * ``gather``      (the same stack on one rank only, in host memory)
  * ``ring_shift``  (send to the right neighbour and receive from the left
                     one over an ordered list of ranks, by
                     ``batch_isend_irecv``)
  * ``barrier``

Staging: gloo's support for CUDA tensors is uneven (no all-gather or
send/recv), and it is the only backend when several ranks share one card
(NCCL refuses two ranks on one device).  So under gloo every CUDA tensor
is copied to host memory, moved there, and copied back; the bytes copied
in both directions are counted in ``staged_bytes()``.  Under NCCL and for
CPU tensors nothing is staged.

``handed_bytes()`` tallies the payload bytes this rank hands to
``torch.distributed``, by kind (``all_reduce``, ``broadcast``,
``all_gather``, ``gather``, ``send``): the wire a device puts on per
step, which the dry run (``launch/counting.py``) holds against
``comm_cost(...).bits``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "all_reduce",
    "broadcast",
    "all_gather",
    "gather",
    "ring_shift",
    "barrier",
    "staged_bytes",
    "reset_staged_bytes",
    "handed_bytes",
    "reset_handed_bytes",
]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
_staged = [0]
_handed: dict[str, int] = {}


def staged_bytes() -> int:
    """Bytes copied between device and host memory for gloo so far."""
    return _staged[0]


def reset_staged_bytes() -> None:
    _staged[0] = 0


def handed_bytes() -> dict[str, int]:
    """Payload bytes handed to ``torch.distributed`` so far, by kind."""
    return dict(_handed)


def reset_handed_bytes() -> None:
    _handed.clear()


def _hand(kind: str, t: torch.Tensor) -> None:
    _handed[kind] = _handed.get(kind, 0) + t.numel() * t.element_size()


def _staged_for(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    _staged[0] += t.numel() * t.element_size()
    return t.cpu()


def _back(dst: torch.Tensor, host: torch.Tensor) -> torch.Tensor:
    _staged[0] += host.numel() * host.element_size()
    return dst.copy_(host)


def _global(group, rank: int) -> int:
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def _in_place(t: torch.Tensor, group, op) -> torch.Tensor:
    """Run ``op`` on a contiguous (and, under gloo, host) copy of ``t``
    where needed, and write the result back into ``t``: the backends move
    raw memory, so a strided tensor (a QR factor is column-major) would
    arrive in another rank's layout."""
    if _staged_for(t, group):
        h = _to_host(t.contiguous())
        op(h)
        return _back(t, h)
    work = t if t.is_contiguous() else t.contiguous()
    op(work)
    return t if work is t else t.copy_(work)


def all_reduce(t: torch.Tensor, *, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` over the group in place (``op`` "sum" or "max")."""
    _hand("all_reduce", t)
    return _in_place(
        t, group, lambda w: dist.all_reduce(w, op=_OPS[op], group=group))


def broadcast(t: torch.Tensor, *, src: int, group) -> torch.Tensor:
    """Overwrite ``t`` on every rank with group rank ``src``'s ``t``."""
    _hand("broadcast", t)
    return _in_place(
        t, group, lambda w: dist.broadcast(w, src=_global(group, src), group=group))


def all_gather(t: torch.Tensor, *, group) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order: (world, *t.shape)."""
    world = dist.get_world_size(group)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    t = t.contiguous()
    _hand("all_gather", t)
    flat = (world * t.shape[0], *t.shape[1:])  # gloo wants the flat form
    if _staged_for(t, group):
        out = torch.empty(flat, dtype=t.dtype)
        gather(out, _to_host(t), group=group)
        dev = torch.empty(flat, dtype=t.dtype, device=t.device)
        return _back(dev, out).reshape(world, *t.shape)
    out = torch.empty(flat, dtype=t.dtype, device=t.device)
    gather(out, t, group=group)
    return out.reshape(world, *t.shape)


def gather(t: torch.Tensor, *, dst: int = 0, group):
    """Every rank's ``t`` stacked in rank order on group rank ``dst``, in
    host memory ((world, *t.shape): a checkpoint's copy); None
    elsewhere."""
    world = dist.get_world_size(group)
    t = t.contiguous()
    _hand("gather", t)
    mine = dist.get_rank(group) == dst
    src = _to_host(t) if _staged_for(t, group) else t
    parts = [torch.empty_like(src) for _ in range(world)] if mine else None
    dist.gather(src, parts, dst=_global(group, dst), group=group)
    return torch.stack(parts).cpu() if mine else None


def ring_shift(
    chunks: list[torch.Tensor], *, ranks: tuple[int, ...], group
) -> list[torch.Tensor]:
    """One ring hop over the ordered group ranks ``ranks``: this rank sends
    its ``chunks`` to its right neighbour and returns the left neighbour's
    (one message per chunk, all posted together).  A rank outside
    ``ranks``, or a ring of one, moves nothing and gets its own back."""
    me = dist.get_rank(group)
    if me not in ranks or len(ranks) < 2:
        return chunks
    pos = ranks.index(me)
    right = _global(group, ranks[(pos + 1) % len(ranks)])
    left = _global(group, ranks[pos - 1])
    staged = _staged_for(chunks[0], group)
    for c in chunks:
        _hand("send", c)
    sends = [_to_host(c.contiguous()) if staged else c.contiguous() for c in chunks]
    recvs = [torch.empty_like(s) for s in sends]
    ops = [dist.P2POp(dist.isend, s, right, group=group) for s in sends]
    ops += [dist.P2POp(dist.irecv, r, left, group=group) for r in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if not staged:
        return recvs
    return [_back(torch.empty_like(c), r) for c, r in zip(chunks, recvs)]


def barrier(*, group) -> None:
    """Return once every rank of the group has called it."""
    dist.barrier(group=group)

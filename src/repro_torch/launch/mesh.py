"""Process-group set-up for the aggregation collectives (port of
``repro/launch/mesh.py::make_aggregation_mesh``).

The reference builds a 1-D device mesh over its data axis; here the
machines are the ranks of a ``torch.distributed`` process group, one
process per shard, started by ``torchrun`` (rank and world from its
environment) or by a caller that names them.

Transport rule, explicit and printed by the launcher:

  * ``nccl`` when the ranks work on CUDA devices and every rank of a host
    has a card of its own;
  * ``gloo`` otherwise: for CPU work, and when several ranks share one
    card (NCCL refuses two ranks on one device).  Compute stays on the
    card either way; under gloo the comm layer stages CUDA tensors
    through host memory and counts the bytes
    (``repro_torch.comm.transport``).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

__all__ = ["AggregationGroup", "transport_rule", "make_aggregation_mesh"]


@dataclasses.dataclass(frozen=True)
class AggregationGroup:
    """The process group one estimate aggregates over, and where it runs."""

    group: dist.ProcessGroup
    rank: int
    world: int
    device: torch.device
    backend: str
    rule: str


def transport_rule(device_type: str, local_world: int, cards: int) -> tuple[str, str]:
    """(backend, reason) for ``local_world`` ranks of one host working on
    ``device_type`` with ``cards`` visible CUDA devices."""
    if device_type != "cuda":
        return "gloo", "CPU tensors: gloo"
    if cards >= local_world:
        return "nccl", f"{local_world} rank(s) on {cards} card(s), one card each: nccl"
    return "gloo", (
        f"{local_world} ranks share {cards} card(s) and NCCL refuses two ranks "
        "on one device: gloo, CUDA tensors staged through host memory"
    )


def make_aggregation_mesh(
    *,
    device: str = "cuda",
    rank: int | None = None,
    world_size: int | None = None,
    local_rank: int | None = None,
    local_world: int | None = None,
    init_method: str | None = None,
) -> AggregationGroup:
    """Join (or start) the default process group and pick this rank's
    device.  Ranks and sizes come from the arguments, else from
    ``torchrun``'s environment (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE; ``init_method`` then defaults to ``env://``).
    ``device`` "cuda" puts rank ``local_rank`` on card
    ``local_rank % cards``; the backend is ``transport_rule``'s."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    if local_world is None:
        local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        cards = torch.cuda.device_count()
        if cards < 1:
            raise RuntimeError(
                "device='cuda' requested but torch finds no CUDA device; pass "
                "device='cpu' to aggregate CPU tensors over gloo"
            )
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    else:
        cards = 0
        dev = torch.device(dev_type)
    chosen, rule = transport_rule(dev_type, local_world, cards)
    if not dist.is_initialized():
        dist.init_process_group(
            chosen, init_method=init_method or "env://", rank=rank,
            world_size=world_size,
        )
    return AggregationGroup(
        group=dist.group.WORLD, rank=dist.get_rank(), world=dist.get_world_size(),
        device=dev, backend=dist.get_backend(), rule=rule,
    )

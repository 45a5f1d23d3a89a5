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

``pods=p`` adds the two-level (pod, local) groups of the hier topology,
pod-major (rank q·local + l is slot l of pod q): each pod's local group
and each slot's pod group, created by every rank in the same order.

The model meshes (``make_production_mesh``, ``make_mesh``,
``make_host_mesh``, ``data_axes``; ``repro/launch/mesh.py:22-84``) are
``torch.distributed.device_mesh.DeviceMesh``es over the process group
that is already up (``torchrun``'s, a gloo world, or the dry run's fake
group): the same shapes, axis names and factorisation rules as the
reference's.  They are functions, and importing this module starts no
process group.

The eigen-compressed step runs its data axes by hand, as the
reference's ``shard_map`` does (manual data, automatic model):
``data_group`` is the process group its data-axis collectives go over
('data', or pod x data flattened as the reference's ``axis = dax``), and
``model_submesh`` the 1-D mesh its parameters live on.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

__all__ = ["AggregationGroup", "transport_rule", "make_aggregation_mesh", "under_torchrun",
           "DATA_AXIS", "MODEL_AXIS", "POD_AXIS", "make_production_mesh", "make_mesh",
           "make_host_mesh", "data_axes", "data_group", "data_rank", "data_size",
           "model_submesh", "parse_mesh_shape"]

# The reference's mesh-axis names (``repro/comm/topology.py``).
DATA_AXIS, MODEL_AXIS, POD_AXIS = "data", "model", "pod"


@dataclasses.dataclass(frozen=True)
class AggregationGroup:
    """The process group one estimate aggregates over, and where it runs.
    With ``pods``: ``local_groups[q]`` holds pod q's ranks, ``pod_groups[l]``
    slot l of every pod, and ``local_group`` / ``pod_group`` are this
    rank's two (the hier topology's ``group`` and ``pod_group``)."""

    group: dist.ProcessGroup
    rank: int
    world: int
    device: torch.device
    backend: str
    rule: str
    pods: int | None = None
    local_groups: tuple = ()
    pod_groups: tuple = ()

    @property
    def local_group(self):
        return self.local_groups[self.rank // (self.world // self.pods)] if self.pods else None

    @property
    def pod_group(self):
        return self.pod_groups[self.rank % (self.world // self.pods)] if self.pods else None


def under_torchrun() -> bool:
    """True in a process that ``torchrun`` started (its RANK and
    WORLD_SIZE are in the environment): the launchers then run the
    collective form, one shard a rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


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
    pods: int | None = None,
) -> AggregationGroup:
    """Join (or start) the default process group and pick this rank's
    device.  Ranks and sizes come from the arguments, else from
    ``torchrun``'s environment (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE; ``init_method`` then defaults to ``env://``).
    ``device`` "cuda" puts rank ``local_rank`` on card
    ``local_rank % cards``; the backend is ``transport_rule``'s.  ``pods``
    (which must tile the world) also creates the hier topology's groups."""
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
    if pods is not None and (pods < 1 or world_size % pods):
        raise ValueError(f"pods={pods} does not tile {world_size} ranks into equal pods")
    if not dist.is_initialized():
        dist.init_process_group(
            chosen, init_method=init_method or "env://", rank=rank,
            world_size=world_size,
        )
    world = dist.get_world_size()
    local_groups = pod_groups = ()
    if pods is not None:
        local = world // pods
        local_groups = tuple(dist.new_group([q * local + l for l in range(local)])
                             for q in range(pods))
        pod_groups = tuple(dist.new_group([q * local + l for q in range(pods)])
                           for l in range(local))
    return AggregationGroup(
        group=dist.group.WORLD, rank=dist.get_rank(), world=world,
        device=dev, backend=dist.get_backend(), rule=rule, pods=pods,
        local_groups=local_groups, pod_groups=pod_groups,
    )


def _mesh_device(device: str | None) -> str:
    if device is not None:
        return torch.device(device).type
    return "cuda" if dist.get_backend() == "nccl" or (
        torch.cuda.is_available() and dist.get_backend() != "fake") else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    default process group (which must be up and hold ``prod(shape)``
    ranks), row-major as the reference's ``jax.make_mesh``.  ``device``
    is the mesh's device type: default "cuda" when the group runs on
    cards, else "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start one first "
                           "(torchrun, make_aggregation_mesh, or the dry run's fake group)")
    return init_device_mesh(_mesh_device(device), tuple(int(x) for x in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str | None = None):
    """The target deployment mesh: (16, 16) over ``(data, model)``, or two
    pods (2, 16, 16) with a leading ``pod`` axis; needs 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = (POD_AXIS, DATA_AXIS, MODEL_AXIS) if multi_pod else (DATA_AXIS, MODEL_AXIS)
    return make_mesh(shape, axes, device=device)


def host_mesh_shape(n: int, *, model: int | None = None,
                    data: int | None = None) -> tuple[int, int]:
    """(data, model) of ``make_host_mesh`` over ``n`` ranks: model 8, 4 or
    2, whichever first divides n (1 for one rank), data the rest."""
    if model is None:
        model = 1
        for cand in (8, 4, 2):
            if n % cand == 0 and cand <= n:
                model = cand
                break
        if n == 1:
            model = 1
    data = data or (n // model)
    if data * model != n:
        raise ValueError(f"data {data} x model {model} is not the world of {n} ranks")
    return data, model


def make_host_mesh(*, model: int | None = None, data: int | None = None,
                   device: str | None = None):
    """Best-effort (data, model) mesh over every rank of the default group
    (``host_mesh_shape``), data-major."""
    shape = host_mesh_shape(dist.get_world_size(), model=model, data=data)
    return make_mesh(shape, (DATA_AXIS, MODEL_AXIS), device=device)


def data_axes(mesh) -> tuple[str, ...]:
    """The axes carrying batch parallelism (``pod`` included when present).
    ``mesh`` is a ``DeviceMesh`` or a {axis name: size} mapping."""
    names = tuple(mesh) if isinstance(mesh, dict) else tuple(mesh.mesh_dim_names)
    return tuple(a for a in (POD_AXIS, DATA_AXIS) if a in names)


def data_group(mesh):
    """The process group over the mesh's data axes, this rank's slice of
    the model axis fixed: ``mesh.get_group('data')``, or with a pod axis
    the (pod, data) submesh flattened into one group, pod-major (the
    reference's ``psum`` over ``('pod', 'data')``)."""
    dax = data_axes(mesh)
    if len(dax) == 1:
        return mesh.get_group(dax[0])
    return mesh[dax]._flatten("_".join(dax)).get_group()


def data_size(mesh) -> int:
    """Ranks along the data axes (pod x data)."""
    names = list(mesh.mesh_dim_names)
    size = 1
    for a in data_axes(mesh):
        size *= mesh.size(names.index(a))
    return size


def data_rank(mesh) -> int:
    """This rank's index along the data axes, pod-major (its shard of the
    global batch)."""
    names = list(mesh.mesh_dim_names)
    idx = 0
    for a in data_axes(mesh):
        i = names.index(a)
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def model_submesh(mesh):
    """The 1-D ``model`` submesh through this rank: where the parameters
    live when the data axes are run by hand (the eigen step)."""
    return mesh[MODEL_AXIS]


def parse_mesh_shape(text: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"D,M"`` -> ((D, M), (data, model)); ``"P,D,M"`` adds the pod axis."""
    shape = tuple(int(x) for x in text.split(","))
    if len(shape) == 2:
        return shape, (DATA_AXIS, MODEL_AXIS)
    if len(shape) == 3:
        return shape, (POD_AXIS, DATA_AXIS, MODEL_AXIS)
    raise ValueError(f"--mesh-shape {text!r}: give D,M or P,D,M")

"""Logical-axis -> mesh placement rules (port of
``repro/launch/sharding.py``: MaxText-style, divisibility-checked).

Every parameter of the reference carries logical axis names; the port
reads them from ``interop.reference_leaves(cfg)``, which holds each port
leaf's reference leaf.  The rules map them to mesh axes:

  vocab / heads / kv_heads / mlp / experts -> 'model'   (TP / EP)
  embed                                    -> 'data'    (FSDP, if cfg.fsdp)
  layers / head_dim / state dims           -> replicated

applied greedily left to right: a dim shards only if its size divides by
the axis size and the axis is not taken by an earlier dim of the same
tensor (else it stays replicated, e.g. llama3.2's 24 heads on a 16-way
model axis).  The two serving layouts of the MoE configs
(``serve_ep_over_data``, ``serve_mlp_over_data``) are the reference's.

A spec is the reference's ``PartitionSpec`` as a tuple of entries, each
None, a mesh-axis name or a tuple of names (the batch over
``('pod', 'data')``), trailing Nones dropped.  The reference stacks a
stage's layers into one leaf with a leading ``layers`` axis; a port leaf
is one layer, so that axis is dropped (its entry is always None:
``layers`` has no rule).  ``placements`` turns a spec into DTensor
``Shard`` / ``Replicate`` placements of the port tensor: the attention's
(d, h, hd) / (h, hd, d) reference leaves are the port's (d, h*hd) /
(h*hd, d) matrices, and head_dim never shards, so a sharded head axis is
a ``Shard`` of the merged dim (contiguous blocks of whole heads).

``shard_model`` puts every parameter of a port model in place with
``distribute_tensor`` (each rank slices its block of its own full copy:
every rank builds the same weights from the same seed), ``shard_cache``
a serving cache, and ``shard_batch`` a batch.  ``mesh`` is a
``DeviceMesh`` or, for the spec functions alone, a {axis: size} mapping.

Training (``shardings_for_train``, ``jit_eigen_steps``): AdamW's ``m``
and ``v`` are placed as their parameters (``adamw_init`` of DTensor
parameters).  The eigen step runs its data axes by hand, as the
reference's ``shard_map`` does: ``shard_model(..., eigen=True)`` places
the parameters on the model submesh with FSDP off (the reference's
``cfg_nofsdp``; its ``_manual_only_spec`` leaves the model axis to the
compiler), and ``place_eigen_state`` puts the optimizer state there as
the reference's ``os_`` does: every leaf replicated, ``err`` this data
rank's own (the reference shards its leading shard axis over data).
``whole``, ``local`` and ``block_of`` move between a DTensor, its local
block and its whole value.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.interop import reference_leaves
from repro_torch.launch.mesh import DATA_AXIS, MODEL_AXIS, data_axes

__all__ = ["DEFAULT_RULES", "rules_for", "spec_for_axes", "param_specs", "param_placements",
           "batch_spec", "batch_placements", "cache_logical_axes", "cache_specs",
           "cache_placements", "replicated", "placements", "port_dims", "shard_model",
           "shard_cache", "shard_batch", "local_bytes", "sharded", "place_eigen_state",
           "whole", "local", "block_of"]

# logical name -> preferred mesh axis (single-axis entries; 'batch' special)
DEFAULT_RULES: Dict[str, str] = {
    "vocab": MODEL_AXIS,
    "heads": MODEL_AXIS,
    "kv_heads": MODEL_AXIS,
    "mlp": MODEL_AXIS,
    "experts": MODEL_AXIS,
    "embed": DATA_AXIS,  # FSDP; dropped when cfg.fsdp is False
}

Spec = tuple


def _sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, in the mesh's axis order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def rules_for(cfg, mesh) -> Dict[str, Any]:
    rules = dict(DEFAULT_RULES)
    if cfg is not None and not cfg.fsdp:
        rules.pop("embed")
    if cfg is not None and getattr(cfg, "serve_ep_over_data", False):
        # Serving layout: experts across 'data' (full EP sharding without
        # FSDP all-gathers), dense TP dims stay on 'model'.
        rules["experts"] = DATA_AXIS
        rules.pop("embed", None)
    if cfg is not None and getattr(cfg, "serve_mlp_over_data", False):
        # Serving layout v2: EP(model) x expert-ff(data), the expert
        # weights sharded over both axes and stationary.
        rules["experts"] = MODEL_AXIS
        rules["mlp"] = DATA_AXIS
        rules.pop("embed", None)
    names = _sizes(mesh)
    return {k: v for k, v in rules.items() if v in names}


def _strip(entries: list) -> Spec:
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_for_axes(shape: Sequence[int], axes: Sequence[Optional[str]], mesh,
                  rules: Dict[str, str]) -> Spec:
    """The spec of one tensor, greedy with divisibility checks."""
    sizes = _sizes(mesh)
    entries, used = [], set()
    for dim, name in zip(shape, axes):
        mesh_axis = rules.get(name) if name else None
        if mesh_axis is not None and mesh_axis not in used and dim % sizes[mesh_axis] == 0:
            entries.append(mesh_axis)
            used.add(mesh_axis)
        else:
            entries.append(None)
    return _strip(entries)


def param_specs(cfg, mesh) -> Dict[str, Spec]:
    """Port leaf name -> the reference's spec of its leaf, in the
    reference leaf's dims with the stacked ``layers`` axis dropped."""
    rules = rules_for(cfg, mesh)
    out = {}
    for name, leaf in reference_leaves(cfg).items():
        spec = spec_for_axes(leaf.shape, leaf.axes, mesh, rules)
        if leaf.layer is not None:
            if spec and spec[0] is not None:
                raise AssertionError(f"{name}: the layers axis sharded ({spec})")
            spec = spec[1:]
        out[name] = spec
    return out


def port_dims(leaf) -> tuple[int, ...]:
    """For each dim of the reference leaf's one-layer slice, the port
    tensor's dim it lies in (``interop._port_shape``: the attention's head
    axes are merged into one)."""
    axes = leaf.axes[1:] if leaf.layer is not None else leaf.axes
    if axes[-1] == "head_dim":  # wq / wk / wv (d, h, hd) -> (d, h*hd)
        return (0, 1, 1)
    if axes[-2:] == ("head_dim", "embed"):  # wo (h, hd, d) -> (h*hd, d)
        return (0, 0, 1)
    return tuple(range(len(axes)))


def placements(spec: Spec, mesh, dims: Optional[Sequence[int]] = None) -> list:
    """DTensor placements (one per mesh axis, in the mesh's order) of a
    tensor whose spec is ``spec``: ``Shard(d)`` on each mesh axis an entry
    names (several axes of one entry shard the dim in their order, as a
    ``PartitionSpec`` tuple does), ``Replicate()`` elsewhere.  ``dims``
    maps the spec's dims to the tensor's (``port_dims``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(_sizes(mesh))
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        dim = i if dims is None else dims[i]
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = Shard(dim)
    return out


def param_placements(model, cfg, mesh) -> Dict[str, list]:
    """Port parameter name -> its DTensor placements on ``mesh``."""
    leaves = reference_leaves(cfg)
    specs = param_specs(cfg, mesh)
    return {name: placements(specs[name], mesh, port_dims(leaves[name]))
            for name, _ in model.named_parameters()}


def replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in _sizes(mesh)]


# ------------------------------------------------------------------ batch --
def _batch_axis(mesh):
    da = data_axes(mesh)
    return da if len(da) > 1 else da[0]


def batch_spec(mesh, ndim: int = 2, leading_dim: Optional[int] = None) -> Spec:
    """Batch tensors shard their leading dim over ('pod', 'data') when the
    global batch divides the data-parallel world (long_500k's batch of 1
    stays replicated and relies on model parallelism alone).  Returns the
    full ``ndim`` entries, as the reference's ``P(da, None, ...)``."""
    sizes = _sizes(mesh)
    n_data = math.prod(sizes[a] for a in data_axes(mesh))
    if leading_dim is not None and leading_dim % n_data != 0:
        return (None,) * ndim
    return (_batch_axis(mesh),) + (None,) * (ndim - 1)


def batch_placements(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, list]:
    return {k: placements(batch_spec(mesh, v.dim(), leading_dim=v.shape[0]), mesh)
            for k, v in batch.items()}


# ------------------------------------------------------------------ cache --
def cache_logical_axes(cfg) -> list:
    """Logical axes of the port's cache, one dict per block (the
    reference's stacked leaves' axes with the layer axis dropped); an
    encoder-decoder's per decoder layer, self and cross."""
    ax = ("batch", "kv_heads", None, None)
    if cfg.is_encoder_decoder:
        return [{"self": {"k": ax, "v": ax}, "cross": {"k": ax, "v": ax}}
                for _ in range(cfg.num_layers)]

    def block_axes(kind: str):
        if kind in ("attn", "local_attn"):
            return {"k": ax, "v": ax}
        if kind == "rglru":
            return {"h": ("batch", "mlp"), "conv": ("batch", None, "mlp")}
        if kind == "ssd":
            return {"s": ("batch", "heads", None, None), "conv": ("batch", None, "mlp")}
        raise ValueError(kind)

    return [block_axes(kind) for pattern, count in cfg.stages()
            for _ in range(count) for kind in pattern]


def _cache_spec(shape, axes, mesh) -> Spec:
    """The reference's ``cache_shardings`` rule for one leaf: batch over
    the data axes, heads / kv_heads / mlp over 'model', when divisible."""
    sizes = _sizes(mesh)
    rules = {"batch": _batch_axis(mesh), "kv_heads": MODEL_AXIS, "heads": MODEL_AXIS,
             "mlp": MODEL_AXIS}
    entries, used = [], set()
    for dim, name in zip(shape, axes):
        ax = rules.get(name) if name else None
        if ax is None:
            entries.append(None)
            continue
        size = math.prod(sizes[x] for x in ((ax,) if isinstance(ax, str) else ax))
        key = ax if isinstance(ax, str) else "+".join(ax)
        if key not in used and dim % size == 0:
            entries.append(ax)
            used.add(key)
        else:
            entries.append(None)
    return _strip(entries)


def _walk(cache, axes, fn):
    if isinstance(cache, dict):
        return {k: _walk(v, axes[k], fn) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return [_walk(c, a, fn) for c, a in zip(cache, axes)]
    return None if cache is None else fn(cache, axes)


def cache_specs(cache, cfg, mesh):
    """The cache's structure with each tensor's spec in its place."""
    return _walk(cache, cache_logical_axes(cfg),
                 lambda t, a: _cache_spec(t.shape, a, mesh))


def cache_placements(cache, cfg, mesh):
    return _walk(cache, cache_logical_axes(cfg),
                 lambda t, a: placements(_cache_spec(t.shape, a, mesh), mesh))


# -------------------------------------------------------------- placement --
def _distribute(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """``distribute_tensor`` of this rank's full copy ``t`` (no data moves
    between ranks: each keeps its block)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, place, src_data_rank=None)


@torch.no_grad()
def shard_model(model, cfg, mesh, *, eigen: bool = False):
    """Replace every parameter of ``model`` by a DTensor placed by
    ``param_placements`` (in place; returns the model).  ``eigen``: on
    the model submesh of ``mesh``, FSDP off (the eigen step's layout)."""
    import dataclasses

    from torch import nn

    from repro_torch.launch.mesh import model_submesh

    if eigen:
        cfg, mesh = dataclasses.replace(cfg, fsdp=False), model_submesh(mesh)
    places = param_placements(model, cfg, mesh)
    # One parameter at a time: each full copy is released as its block
    # takes its place (a list of them all would hold every one to the end).
    for name in places:
        p = model.get_parameter(name)
        owner = model.get_submodule(name.rpartition(".")[0]) if "." in name else model
        dt = _distribute(p.detach(), mesh, places[name])
        setattr(owner, name.rpartition(".")[2], nn.Parameter(dt, requires_grad=p.requires_grad))
    return model


def shard_cache(cache, cfg, mesh):
    """The serving cache with each tensor a DTensor placed by
    ``cache_placements`` (a new structure holding copies of this rank's
    blocks; the blocks write into it)."""
    from torch.distributed.tensor import DTensor

    def place(t, axes):
        dt = _distribute(t, mesh, placements(_cache_spec(t.shape, axes, mesh), mesh))
        return DTensor.from_local(dt.to_local().clone(), mesh, dt.placements,
                                  run_check=False, shape=dt.shape, stride=dt.stride())

    return _walk(cache, cache_logical_axes(cfg), place)


def shard_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Each array of ``batch`` a DTensor, batch-sharded (``batch_spec``)."""
    places = batch_placements(batch, mesh)
    return {k: _distribute(v, mesh, places[k]) for k, v in batch.items()}


def _is_dt(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def whole(t):
    """A DTensor's whole value (gathered: every rank of its mesh takes
    part); any other tensor itself."""
    return t.full_tensor() if _is_dt(t) else t


def local(t):
    """A DTensor's local block (under ``no_grad`` its storage, so in-place
    writes reach the DTensor); any other tensor itself."""
    return t.to_local() if _is_dt(t) else t


def block_of(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's block of the whole tensor ``full`` as ``like`` (a
    DTensor) is placed: a slice, no communication.  ``full`` itself when
    ``like`` is not a DTensor."""
    if not _is_dt(like):
        return full
    return _distribute(full, like.device_mesh, list(like.placements)).to_local()


@torch.no_grad()
def place_eigen_state(opt: dict, mesh) -> dict:
    """The eigen optimizer state of one data rank (plain tensors, ``err``
    without a shard axis) placed on the model submesh of ``mesh``, every
    tensor replicated (the reference's ``os_``); ``initialized`` and
    ``step`` stay host scalars.  In place; returns ``opt``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import model_submesh

    sub = model_submesh(mesh)
    rep = replicated(sub)

    def put(t):
        return DTensor.from_local(t, sub, rep, run_check=False)

    for key in ("full_m", "full_v"):
        opt[key] = {n: put(t) for n, t in opt[key].items()}
    for st in opt["eigen"].values():
        for f in ("basis", "m", "v", "err"):
            st[f] = put(st[f])
    return opt


def local_bytes(tensors) -> int:
    """Bytes of this rank's blocks of ``tensors`` (DTensors' local shards,
    plain tensors whole)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tensors:
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


@contextlib.contextmanager
def sharded(mesh):
    """Run a sharded model's forward: the activation constraints of
    ``models.sharding_ctx`` on ``mesh`` (the batch over its data axes),
    and plain tensors made inside the model (positions, masks) taken as
    replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.sharding_ctx import activation_sharding

    with activation_sharding(mesh, data_axes(mesh)), implicit_replication():
        yield

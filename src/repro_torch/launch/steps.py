"""Train steps of the port (port of ``repro/launch/steps.py``): the AdamW
step, and the eigen-compressed train and refresh steps (the paper's
technique, role R2).

A step is a closure over the model: it takes the optimizer state and the
global batch (tokens and labels, (B, S) on the model's device), updates
the model's parameters and the state in place, and returns its metrics.
Nothing is traced or compiled, so the reference's ``jit_*`` functions,
shardings and ``shard_map`` have no counterpart.

Two forms:

  * stacked (``shards=m``, one process): the baseline step runs the whole
    batch.  The eigen steps run shard i's rows [i b/m, (i+1) b/m) one
    shard at a time; after each shard's backward the train step folds
    ``Pᵀ(G_i + err_i)`` into the sum and updates ``err_i`` in place, so
    one full gradient is alive at a time;
  * collective (``group=``, one shard a rank): rank i takes rows
    [i b/m, (i+1) b/m) of the global batch, as the reference's data axis
    slices it on one host.  The baseline step all-reduces every gradient
    and the loss; the eigen step all-reduces the (r, n) coordinates of
    each compressed leaf (``eigen_compress.compress_and_reduce``), every
    uncompressed gradient and the loss, each divided by m.

The eigen train step has no clip and no NaN guard, and decays every
compressed leaf, as the reference's.  Weight decay of the other leaves
and compressibility follow the reference's leaf (``interop.decays``,
``compressed_paths``).

The steps train every family: dense, MoE (both dispatch forms, the
Switch aux loss in the loss), hybrid (RG-LRU + local attention), SSM
(Mamba2 SSD), VLM and audio (encoder-decoder), whose gradients are held
against the reference's.  The batch carries a VLM's optional
``patch_embeds`` (B, P, patch_embed_dim) or an encoder-decoder's
``frames`` (B, S_enc, d_model) beside its tokens and labels; the model's
loss takes them (``models.registry.loss``) and ``shard_rows`` splits them
with the rows.  A leaf the batch does not reach (a VLM's ``patch_proj``
on a text batch) gets a zero gradient, as the reference's ``jax.grad``
gives: AdamW then only decays it, and the eigen refresh takes its local
basis of a zero matrix.  An MoE layer's gradient reaches its router
through the renormalised gates and the aux loss's mean probabilities,
and its experts through the kept pairs only; its expert leaves (L, E, d,
f) / (L, E, f, d) are never compressed (``compressed_paths``), its
router (L, d, e) is where e >= rank, as the reference's.

On a ``(data, model)`` mesh (``mesh=``, the reference's ``jit_train_step``
/ ``jit_eigen_steps``), the model's parameters are DTensors
(``launch.sharding.shard_model``) and the batch is the global one:

  * the baseline step places the batch over the data axes
    (``shard_batch``) and runs under ``sharding.sharded(mesh)``: DTensor
    inserts the data-axis reductions, as XLA does from the reference's
    in/out shardings;
  * the eigen steps run the data axes by hand, as the reference's
    ``shard_map``: parameters on the model submesh with FSDP off
    (``shard_model(..., eigen=True)``), each data rank its rows, the
    activation constraints suspended (the reference's ``per_shard``), and
    every data-axis collective explicit over ``mesh.data_group``
    through ``comm.transport``: the coordinates, the uncompressed
    gradients, the loss, the refresh's rounds.  A compressed leaf's
    gradient is gathered whole over 'model' first: its error feedback is
    whole on every model rank (the reference's ``os_`` replicates it), and
    ``err <- (G + err) - P Pᵀ(G + err)`` touches every element of it.  So
    the data axis carries the whole (r, n) coordinates, r n words a leaf,
    and the model axis (within a host) a d n gather.  An uncompressed
    gradient is all-reduced over data as its local block, then gathered
    for its whole moments (replicated, as the reference's).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.comm import transport
from repro_torch.interop import decays, reference_leaves
from repro_torch.launch import sharding as S
from repro_torch.models import EncDec, LM
from repro_torch.models.registry import loss as loss_fn
from repro_torch.optim import eigen_compress as EC
from repro_torch.optim.grad_utils import host_value
from repro_torch.optim.adamw import (
    AdamWConfig,
    adam_direction,
    adam_leaf,
    adam_moments_,
    adamw_update,
    apply_update_,
    bias_corrections,
)

__all__ = [
    "make_train_step",
    "compressed_paths",
    "eigen_opt_init",
    "make_eigen_train_step",
    "make_eigen_refresh_step",
    "shard_rows",
    "start_shapes",
]

Batch = Dict[str, torch.Tensor]

Model = LM | EncDec


def _grads(loss: torch.Tensor, leaves: list) -> tuple:
    """d loss / d leaves, zeros for a leaf the loss does not reach."""
    return torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)


def shard_rows(batch: Batch, shard: int, m: int) -> Batch:
    """Rows [shard b/m, (shard + 1) b/m) of every array of ``batch``
    (tokens, labels, and patch embeddings or frames)."""
    b = batch["tokens"].shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} shards")
    lo, hi = shard * b // m, (shard + 1) * b // m
    return {k: v[lo:hi] for k, v in batch.items()}


def _world(shards: Optional[int], group) -> tuple[int, list[int]]:
    """(m, the shards this process runs)."""
    if group is not None:
        return dist.get_world_size(group), [dist.get_rank(group)]
    m = shards or 1
    return m, list(range(m))


def _mean_loss(losses: list, m: int, group) -> torch.Tensor:
    total = torch.stack([S.whole(x) for x in losses]).sum().reshape(1)
    if group is not None:
        transport.all_reduce(total, group=group)
    return total[0] / m


# ----------------------------------------------------------- baseline step --
def make_train_step(model: Model, *, adamw_cfg: AdamWConfig, schedule, group=None,
                    mesh=None):
    """AdamW train step (clip, decay by the reference leaf, NaN guard).
    With ``group`` each rank runs its rows and the gradients and loss are
    all-reduced / m: the data-parallel baseline the eigen step
    compresses.  With ``mesh`` (a model placed by ``shard_model``) the
    global batch is placed over the data axes and DTensor reduces."""
    params = dict(model.named_parameters())
    decay = decays(model.cfg)

    def train_step(opt_state, batch: Batch) -> dict:
        with S.sharded(mesh) if mesh is not None else contextlib.nullcontext():
            m, mine = _world(None, group)
            if mesh is not None:
                b = S.shard_batch(batch, mesh)
            else:
                b = batch if group is None else shard_rows(batch, mine[0], m)
            loss, metrics = loss_fn(model, b)
            grads = dict(zip(params, _grads(loss, list(params.values()))))
            if group is not None:
                for g in grads.values():
                    transport.all_reduce(g, group=group).div_(m)
            loss = _mean_loss([loss.detach()], m, group)
            lr = schedule(int(host_value(opt_state["step"])))
            om = adamw_update(grads, opt_state, params, lr=lr, cfg=adamw_cfg, decays=decay)
        return {"loss": loss, "lr": lr, "aux": S.whole(metrics["aux"].detach()), **om}

    return train_step


# ----------------------------------------------- eigen-compressed training --
def compressed_paths(cfg, ecfg: EC.EigenCompressConfig) -> Dict[str, tuple]:
    """Port leaf name -> its (d, n) matmul view, for the leaves the
    reference compresses (``repro/launch/steps.py::compressed_paths`` on
    the reference's leaf): 2-D and stacked 3-D weights by their last two
    dims, 4-D attention weights through the view that merges the head
    dims, (L, d, h, hd) -> (L, d, h hd) for wq and (L, h, hd, d) ->
    (L, h hd, d) for wo (wk / wv, whose axes name kv_heads, are not
    compressed); then d >= min_dim, n >= rank and d >= rank.  The port's
    tensors are those views already.  Like the reference's trainer it
    reads no config flag: whisper-tiny's ``eigen_compress=False`` changes
    nothing, and its embeddings, the three attentions' wq / wo and the
    MLPs are compressed."""
    out = {}
    for name, leaf in reference_leaves(cfg).items():
        shape, axes = leaf.shape, leaf.axes
        if len(shape) == 4:
            if axes[-3:] == ("embed", "heads", "head_dim"):
                d, n = shape[1], shape[2] * shape[3]
            elif axes[-3:] == ("heads", "head_dim", "embed"):
                d, n = shape[1] * shape[2], shape[3]
            else:
                continue
        elif len(shape) in (2, 3):
            d, n = shape[-2], shape[-1]
        else:
            continue
        if d >= ecfg.min_dim and n >= ecfg.rank and d >= ecfg.rank:
            if leaf.layer is not None and len(shape) == 2:
                raise NotImplementedError(
                    f"{leaf.path} {shape}: the reference would compress this stacked "
                    "vector as one matrix across layers (its layer count reaches "
                    "min_dim); the port compresses per-layer matrices only")
            out[name] = (d, n)
    return out


def eigen_opt_init(model: Model, ecfg: EC.EigenCompressConfig, n_data_shards: int, *,
                   group=None, mesh=None) -> dict:
    """Optimizer state: full f32 Adam moments for the uncompressed leaves,
    the low-rank state for the compressed ones (``err`` with a leading
    shard axis of ``n_data_shards`` in the stacked form, this rank's
    alone with ``group`` or ``mesh``).  With ``mesh`` every tensor is
    replicated on the model submesh (``sharding.place_eigen_state``)."""
    comp = compressed_paths(model.cfg, ecfg)
    own = group is not None or mesh is not None
    full_m, full_v, eigen = {}, {}, {}
    for name, p in model.named_parameters():
        dev = S.local(p).device
        if name in comp:
            d, n = comp[name]
            eigen[name] = EC.init_state(d, n, ecfg, err_lead=() if own else (n_data_shards,),
                                        device=dev)
        else:
            full_m[name] = torch.zeros(p.shape, dtype=torch.float32, device=dev)
            full_v[name] = torch.zeros(p.shape, dtype=torch.float32, device=dev)
    opt = {"full_m": full_m, "full_v": full_v, "eigen": eigen,
           "step": torch.zeros((), dtype=torch.int32)}
    return opt if mesh is None else S.place_eigen_state(opt, mesh)


def _eigen_form(shards, group, mesh):
    """(group, rows, context) of the eigen steps: the data group the
    collectives go over; ``rows(batch, i, m)``, shard i's rows (on a mesh
    replicated on the model submesh); the context the forward runs in (on
    a mesh: the activation constraints suspended, as the reference's
    ``per_shard``, and the model's own plain tensors taken as
    replicated)."""
    if mesh is None:
        return group, shard_rows, contextlib.nullcontext
    if group is not None or shards is not None:
        raise ValueError("give mesh= alone: its data group is the eigen step's group")
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import data_group, model_submesh
    from repro_torch.models.sharding_ctx import no_activation_sharding

    sub = model_submesh(mesh)

    def rows(batch, i, m):
        return {k: DTensor.from_local(v, sub, S.replicated(sub), run_check=False)
                for k, v in shard_rows(batch, i, m).items()}

    @contextlib.contextmanager
    def manual():
        with no_activation_sharding(), implicit_replication():
            yield

    return data_group(mesh), rows, manual


def _summed_whole(g: torch.Tensor, p: torch.Tensor, group) -> torch.Tensor:
    """An uncompressed gradient summed over the data group: a DTensor's
    local block (placed as its parameter) all-reduced, then gathered
    whole over 'model' for the whole moments."""
    from torch.distributed.tensor import DTensor

    if not isinstance(g, DTensor):
        return transport.all_reduce(g, group=group)
    gl = g.redistribute(p.device_mesh, p.placements).to_local().contiguous()
    transport.all_reduce(gl, group=group)
    return DTensor.from_local(gl, p.device_mesh, p.placements, run_check=False,
                              shape=p.shape, stride=p.stride()).full_tensor()


def make_eigen_train_step(
    model: Model,
    *,
    adamw_cfg: AdamWConfig,
    schedule,
    shards: Optional[int] = None,
    group=None,
    mesh=None,
):
    """The compressed train step, on the bases and error feedback of the
    optimizer state.  Collectives per step (collective and mesh forms):
    an all-reduce of r n words per compressed leaf (d n in the baseline),
    of every uncompressed gradient, and of the loss."""
    params = dict(model.named_parameters())
    decay = decays(model.cfg)
    group, rows, ctx = _eigen_form(shards, group, mesh)

    def train_step(opt_state, batch: Batch) -> dict:
        m, mine = _world(shards, group)
        eig = opt_state["eigen"]
        low: Dict[str, torch.Tensor] = {}
        full: Dict[str, torch.Tensor] = {}
        losses = []
        for i in mine:
            with ctx():
                loss, _ = loss_fn(model, rows(batch, i, m))
                grads = _grads(loss, list(params.values()))
            losses.append(loss.detach())
            with torch.no_grad():
                for name, g in zip(params, grads):
                    if name in eig:
                        st = {k: S.local(t) for k, t in eig[name].items()}
                        if group is not None:
                            low[name] = EC.compress_and_reduce(S.whole(g), st, group=group)
                            continue
                        c = EC.compress(g, st, st["err"][i])
                        low[name] = c if name not in low else low[name].add_(c)
                    elif group is not None:
                        full[name] = _summed_whole(g, params[name], group)
                    else:
                        full[name] = g if name not in full else full[name].add_(g)
            del grads
        if group is None:
            for t in low.values():
                t.div_(m)
        loss = _mean_loss(losses, m, group)
        step = int(host_value(opt_state["step"])) + 1
        lr = schedule(step - 1)
        c1, c2 = bias_corrections(step, adamw_cfg.b1, adamw_cfg.b2)
        wd = adamw_cfg.weight_decay
        with torch.no_grad():
            for name, p in params.items():
                if name in eig:
                    st = {k: S.local(t) for k, t in eig[name].items()}
                    adam_moments_(st["m"], st["v"], low[name], adamw_cfg)
                    delta = st["basis"] @ adam_direction(st["m"], st["v"], c1, c2,
                                                         adamw_cfg.eps)
                    apply_update_(S.local(p), S.block_of(delta, p), lr=lr, weight_decay=wd)
                else:
                    fm, fv = S.local(opt_state["full_m"][name]), S.local(opt_state["full_v"][name])
                    adam_moments_(fm, fv, full[name].div_(m).to(torch.float32), adamw_cfg)
                    delta = adam_direction(fm, fv, c1, c2, adamw_cfg.eps)
                    apply_update_(S.local(p), S.block_of(delta, p), lr=lr,
                                  weight_decay=wd if decay(name) else 0.0)
        opt_state["step"].fill_(step)
        return {"loss": loss, "lr": lr, "aux": torch.zeros(())}

    return train_step


def make_eigen_refresh_step(
    model: Model,
    *,
    ecfg: EC.EigenCompressConfig,
    shards: Optional[int] = None,
    group=None,
    mesh=None,
):
    """The refresh: each shard's gradient of its rows, its local top-r
    basis of every compressed leaf (``power_iters`` subspace steps from
    ``starts[name]``; on a mesh from the gradient gathered whole over
    'model'), then per leaf the Procrustes-fixed average
    (``eigen_compress.refresh_basis``), and the low-rank moments rotated
    into the new basis with R = P_newᵀ P_old: m <- R m, v <- |R|^2 v."""
    params = dict(model.named_parameters())
    group, rows, ctx = _eigen_form(shards, group, mesh)

    def refresh_step(opt_state, batch: Batch, starts: Dict[str, torch.Tensor]) -> dict:
        m, mine = _world(shards, group)
        eig = opt_state["eigen"]
        names = sorted(eig)
        local: Dict[str, list] = {n: [] for n in names}
        for i in mine:
            with ctx():
                loss, _ = loss_fn(model, rows(batch, i, m))
                grads = _grads(loss, [params[n] for n in names])
            with torch.no_grad():
                for name, g in zip(names, grads):
                    r = eig[name]["basis"].shape[1]
                    local[name].append(
                        EC._local_basis(S.whole(g), r, ecfg.power_iters, starts[name]))
            del grads
        with torch.no_grad():
            for name in names:
                st = {k: S.local(t) for k, t in eig[name].items()}
                v_loc = torch.stack(local.pop(name)) if group is None else local.pop(name)[0]
                new = EC.refresh_basis(v_loc, st["basis"], bool(st["initialized"]),
                                       cfg=ecfg, group=group)
                rot = new.T @ st["basis"]
                st["m"].copy_(rot @ st["m"])
                st["v"].copy_(rot.square() @ st["v"])  # variance transport approx
                st["basis"].copy_(new)
                st["initialized"].fill_(True)
        return opt_state

    return refresh_step


def start_shapes(opt_state) -> Dict[str, tuple]:
    """(d, r) of each compressed leaf's basis: the start bases a refresh
    takes (``eigen_compress.draw_starts``)."""
    return {name: tuple(st["basis"].shape) for name, st in opt_state["eigen"].items()}


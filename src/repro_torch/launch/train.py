"""Training entry point of the port: ``python -m repro_torch.launch.train
--arch <id> [...]`` (port of ``repro/launch/train.py``).

Production behaviours wired in, as the reference's:
  * checkpoint/restart: async ``CheckpointManager`` and resume from the
    latest checkpoint,
  * fault tolerance: ``FailureInjector`` (``--fail-at``) and resume from
    the latest checkpoint after a ``SimulatedPreemption``,
  * NaN guard: the AdamW step skips non-finite steps,
  * straggler monitor: a step-time EMA whose escalation forces a
    checkpoint,
  * eigen-compressed data-parallel gradients (the paper's technique,
    ``--eigen``).

The model keeps f32 master weights and computes in the config's dtype,
with per-block remat where the config asks for it; data come from the
seeded ``TokenPipeline``.  One process holds ``--shards`` data-parallel
shards stacked; under ``torchrun`` each rank is one shard
(``launch.mesh.make_aggregation_mesh``) and takes its rows of the global
batch.  With ``mesh=`` (``--mesh-shape D,M`` under ``torchrun``) the
model trains on a ``(data, model)`` mesh, as the reference's
``train(mesh=)``: parameters and AdamW's moments DTensors placed by the
reference's rules (``launch.sharding``); under ``--eigen`` the
parameters sit on the model submesh with FSDP off, the data axis run by
hand (``launch.steps``), and ``err`` is this data rank's own.  Without
``--mesh-shape`` the launcher keeps the one-shard-a-rank form: the
reference's launcher always takes ``make_host_mesh()``, which puts 2-8
ranks on the model axis, and on one card that needs gloo's all-gather on
CUDA tensors, which crashes (ROADMAP C).  A checkpoint of a mesh run
holds whole arrays and the gathered error feedback: the stacked form's
files, which restore onto another mesh or into the stacked trainer.
Runs on the card unless ``--device cpu``; without a card it refuses to
start.  The dense, MoE, hybrid, SSM and VLM families train;
a VLM (internvl2-2b) trains on the pipeline's text batches, as the
reference's launcher trains it (its pipeline gives no patch embeddings,
so ``patch_proj`` gets a zero gradient and is only decayed).  An MoE
config (qwen3-moe-30b-a3b, kimi-k2-1t-a32b) trains in its config's
dispatch form, its loss the CE plus 0.01 times the layers' aux loss.  An
encoder-decoder (whisper-tiny) is refused: the pipeline gives no frames,
which its loss needs, and the reference's launcher fails on it too
(``KeyError: 'frames'``); ``launch.steps`` trains it on batches that
carry frames.  Examples::

    python -m repro_torch.launch.train --device cpu --arch granite-3-2b --steps 8
    python -m repro_torch.launch.train --device cpu --arch granite-3-2b --steps 8 \\
        --eigen --shards 4
    python -m repro_torch.launch.train --device cpu --arch mamba2-370m --steps 8 --eigen
    python -m repro_torch.launch.train --device cpu --arch internvl2-2b --steps 8 --eigen
    python -m repro_torch.launch.train --device cpu --arch qwen3-moe-30b-a3b --steps 8 --eigen
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
        --arch granite-3-2b --steps 8 --eigen
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
        --arch llama3.2-3b --steps 8 --mesh-shape 2,2 --eigen
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
        --arch recurrentgemma-2b --steps 8 --mesh-shape 2,2
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpoint import StackRow
from repro_torch.comm import transport
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.interop import resolve_device, strict_fp32
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import (
    MODEL_AXIS,
    data_group,
    data_rank,
    data_size,
    make_aggregation_mesh,
    make_mesh,
    parse_mesh_shape,
    under_torchrun,
)
from repro_torch.launch.steps import (
    eigen_opt_init,
    make_eigen_refresh_step,
    make_eigen_train_step,
    make_train_step,
    start_shapes,
)
from repro_torch.models import build, param_count
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.eigen_compress import EigenCompressConfig, draw_starts
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.fault import FailureInjector, SimulatedPreemption
from repro_torch.runtime.straggler import StepTimer, StragglerMonitor

__all__ = ["train", "main", "refuse_encdec"]

log = logging.getLogger("repro_torch.train")


def refuse_encdec(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for an encoder-decoder config: the token
    pipeline has no frames (see the module docstring)."""
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: the launcher's token pipeline gives "
            "no frames, which its loss needs (the reference's launcher fails on it "
            "with KeyError: 'frames'); train it through repro_torch.launch.steps on "
            "batches that carry frames")


def _device_batch(batch: dict, dev: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device=dev, dtype=torch.long)
            for k, v in batch.items()}


def _copy_into(dst, src) -> None:
    """Copy a restored tree into the live one in place (a rank's row of the
    gathered error feedback, ``StackRow``'s; a DTensor its block)."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
        return
    if isinstance(src, np.ndarray):  # this rank's row of a gathered err
        src = S.block_of(torch.from_numpy(src).to(S.local(dst).device), dst)
    S.local(dst).copy_(S.local(src))


def train(
    arch: str | ModelConfig,
    *,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    warmup: int = 20,
    reduced: bool = True,
    eigen: bool = False,
    eigen_rank: int = 32,
    eigen_refresh: int = 25,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    resume: bool = True,
    fail_at: tuple = (),
    seed: int = 0,
    log_every: int = 10,
    device: str | torch.device = "cuda",
    shards: Optional[int] = None,
    group=None,
    mesh=None,
):
    """Returns (model, final optimizer state, losses).

    ``arch`` is an arch id (its reduced config unless ``reduced=False``)
    or a ``ModelConfig``.  ``shards`` stacks that many data-parallel
    shards in this process (default 1); ``group`` runs one shard a rank
    of a process group instead; ``mesh`` (a ``(data, model)`` or
    ``(pod, data, model)`` ``DeviceMesh`` over every rank) trains on it
    (see the module docstring).  Weights are drawn from ``seed``; each
    refresh's start bases from a generator seeded by (seed + 1, step),
    the same on every shard and after a resume."""
    cfg = arch if isinstance(arch, ModelConfig) else (
        get_reduced_config(arch) if reduced else get_config(arch))
    refuse_encdec(cfg)
    dev = resolve_device(device)
    strict_fp32()
    if sum(x is not None for x in (shards, group, mesh)) > 1:
        raise ValueError("give one of shards= (stacked), group= (one shard a rank) "
                         "and mesh= (a (data, model) mesh)")
    model = build(cfg, device=dev, param_dtype=torch.float32,
                  generator=torch.Generator(device=dev).manual_seed(seed))
    # dgroup: the data axis's collectives; sync: the ranks that checkpoint
    # together; writer: the rank that writes the files.
    dgroup, sync, writer = group, group, True
    if mesh is not None:
        S.shard_model(model, cfg, mesh, eigen=eigen)
        dgroup, sync = data_group(mesh), torch.distributed.group.WORLD
        m, rank = data_size(mesh), data_rank(mesh)
        writer = torch.distributed.get_rank() == 0
    else:
        m = torch.distributed.get_world_size(group) if group is not None else (shards or 1)
        rank = torch.distributed.get_rank(group) if group is not None else 0
        writer = rank == 0
    params = dict(model.named_parameters())
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, seed=seed)

    adamw_cfg = AdamWConfig()
    sched = warmup_cosine(lr, warmup, steps)
    if eigen:
        ecfg = EigenCompressConfig(rank=eigen_rank, refresh_every=eigen_refresh, min_dim=64)
        train_step = make_eigen_train_step(model, adamw_cfg=adamw_cfg, schedule=sched,
                                           shards=shards, group=group, mesh=mesh)
        refresh_step = make_eigen_refresh_step(model, ecfg=ecfg, shards=shards, group=group,
                                               mesh=mesh)
        opt = eigen_opt_init(model, ecfg, m, group=group, mesh=mesh)
    else:
        ecfg = refresh_step = None
        train_step = make_train_step(model, adamw_cfg=adamw_cfg, schedule=sched, group=group,
                                     mesh=mesh)
        opt = adamw_init(params)

    # The writer's data group gathers the error feedback to its rank 0 (the
    # writer); the mesh's other model ranks hold the same err and skip it.
    gathers = dgroup is not None and eigen and (
        mesh is None or mesh.get_local_rank(MODEL_AXIS) == 0)

    def ckpt_tree() -> dict:
        """The checkpointed state: the collective and mesh forms gather
        every data rank's error feedback to the writer, so the files are
        the stacked form's."""
        o = opt
        if dgroup is not None and eigen:
            o = {**opt, "eigen": {n: {**st, "err": transport.gather(
                S.local(st["err"]), group=dgroup) if gathers else None}
                for n, st in opt["eigen"].items()}}
        return {"params": params, "opt": o}

    def like_tree() -> dict:
        if dgroup is None or not eigen:
            return {"params": params, "opt": opt}
        o = {**opt, "eigen": {n: {**st, "err": StackRow((m, *st["err"].shape), rank)}
                              for n, st in opt["eigen"].items()}}
        return {"params": params, "opt": o}

    ckpt = CheckpointManager(checkpoint_dir, every=checkpoint_every) if checkpoint_dir else None

    saved = [None]  # the step last saved: the final save does not write it again

    def save(step: int, force: bool = False) -> None:
        if ckpt is None or not (force or ckpt.due(step)) or step == saved[0]:
            return
        tree = ckpt_tree()
        if writer or mesh is not None:  # a mesh's DTensors gather on every rank
            ckpt.maybe_save(step, tree, force=True, writer=writer)
        saved[0] = step

    def restore() -> Optional[int]:
        ckpt.wait()
        if sync is not None:
            transport.barrier(group=sync)
        got_step, tree, _ = ckpt.restore_latest(like_tree())
        if got_step is not None:
            with torch.no_grad():
                _copy_into({"params": params, "opt": opt}, tree)
        return got_step

    start_step = 0
    if ckpt is not None and resume:
        got = restore()
        if got is not None:
            start_step = got
            log.info("resumed from step %d", start_step)

    injector = FailureInjector(fail_at_steps=tuple(fail_at))
    escalated = [False]
    monitor = StragglerMonitor(on_escalate=lambda s, dt: escalated.__setitem__(0, True))
    timer = StepTimer(device=dev)
    losses = []

    step = start_step
    while step < steps:
        try:
            injector.check(step)
            b = _device_batch(pipe.batch(step), dev)
            if eigen and step % ecfg.refresh_every == 0:
                refresh_step(opt, b, draw_starts(start_shapes(opt), seed=seed + 1,
                                                 step=step, device=dev))
            metrics = train_step(opt, b)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = timer.lap()
            monitor.record(step, dt)
            if step % log_every == 0:
                log.info("step %d loss %.4f (%.3fs, %.0f tok/s)", step, loss, dt,
                         batch * seq / max(dt, 1e-9))
            if ckpt is not None:
                force = escalated[0]
                if sync is not None:  # every rank saves together
                    flag = torch.tensor([float(force)], device=dev)
                    force = bool(transport.all_reduce(flag, group=sync, op="max")[0])
                escalated[0] = False
                save(step + 1, force=force)
            step += 1
        except SimulatedPreemption:
            log.warning("preempted at step %d; resuming from latest checkpoint", step)
            if ckpt is not None:
                got = restore()
                if got is not None:
                    step = got
            # without a checkpoint dir we continue with in-memory state

    if ckpt is not None:
        save(step, force=True)
        ckpt.wait()
    return model, opt, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--eigen", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    ap.add_argument("--shards", type=int, default=None,
                    help="data-parallel shards stacked in this process (not under torchrun)")
    ap.add_argument("--mesh-shape", default=None, metavar="D,M",
                    help="under torchrun: train on a (data, model) mesh of the ranks "
                         "(default: one data-parallel shard a rank)")
    args = ap.parse_args(argv)
    try:
        refuse_encdec(get_config(args.arch))
    except ValueError as err:
        ap.error(str(err))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    group, mesh, device, rank = None, None, args.device, 0
    if args.mesh_shape is not None and not under_torchrun():
        ap.error("--mesh-shape needs torchrun (one process a rank)")
    if under_torchrun():
        if args.shards is not None:
            raise SystemExit("--shards stacks shards in one process; under torchrun "
                             "each rank is one shard")
        agg = make_aggregation_mesh(device=args.device)
        device, rank = agg.device, agg.rank
        if args.mesh_shape is None:
            group = agg.group
        else:
            try:
                shape, axes = parse_mesh_shape(args.mesh_shape)
            except ValueError as err:
                ap.error(str(err))
            if int(np.prod(shape)) != agg.world:
                ap.error(f"--mesh-shape {args.mesh_shape} is not the world of {agg.world} ranks")
            mesh = make_mesh(shape, axes, device=agg.device.type)
    resolve_device(device)
    t0 = time.perf_counter()
    model, _, losses = train(
        args.arch,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        lr=args.lr,
        reduced=not args.full_config,
        eigen=args.eigen,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=not args.no_resume,
        fail_at=tuple(args.fail_at),
        device=device,
        shards=args.shards,
        group=group,
        mesh=mesh,
    )
    wall = time.perf_counter() - t0
    if rank == 0:
        print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")
        dev = torch.device(device)
        print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
        print(f"config: {model.cfg.name} ({param_count(model.cfg)} parameters)")
        shards = (torch.distributed.get_world_size(group) if group is not None
                  else data_size(mesh) if mesh is not None else args.shards or 1)
        print(f"shards: {shards}")
        if mesh is not None:
            print(f"mesh: {tuple(mesh.shape)} {mesh.mesh_dim_names}")
        print(f"eigen: {args.eigen}")
        print(f"final_loss_exact: {losses[-1]!r}")
        print(f"losses: {len(losses)}")
        print(f"wall_s: {wall:.3f}")
    if under_torchrun():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

"""Checkpoints of DTensor state (``checkpoint/checkpoint.py`` under
``launch/train.py::train(mesh=)``): a mesh run's files are the stacked
form's (whole arrays, the error feedback gathered over the data axis into
its leading shard axis), and they restore onto whatever mesh the resumed
run has, or into the stacked trainer (the reference's
``load_checkpoint(..., shardings=)``: elastic resume).

One 4-rank gloo CPU world, the reduced llama3.2-3b in f32, 4 steps,
checkpoints every 2:

  * the eigen trainer (rank 8, a refresh every 2) on the (2, 2) mesh,
    preempted at step 3 and resumed from its step-2 checkpoint, ends at the
    straight run's final loss within 1e-6;
  * the eigen trainer with one refresh (at step 0): its step-2 checkpoint
    written on (2, 2) restores into the stacked trainer (``shards=2``),
    which ends at the (2, 2) run's final loss within 1e-6.  One refresh,
    since a refresh after the checkpoint would average the embedding's
    local bases, whose refresh is ill-posed on distinct rows (ROADMAP C8):
    two summation orders give two bases there;
  * the eigen checkpoint refuses a mesh of another data width ((4, 1):
    its error feedback holds 2 data shards), by a ValueError naming the
    leaf;
  * AdamW: the step-2 checkpoint of a (2, 2) run (FSDP over 'data')
    restores onto (4, 1) and into the unsharded trainer, and both end at
    the (2, 2) run's final loss within 1e-6;
  * the reduced recurrentgemma-2b under AdamW on (2, 2), preempted at
    step 3 and resumed, and its step-2 checkpoint restored into the
    unsharded trainer, both end at the straight run's final loss within
    ``T4_BAR`` (1e-5 relative);
  * the files: whole parameter shapes, ``err`` (2, d, n);
  * the host copy of a DTensor leaf is a snapshot (ROADMAP C: the save
    thread must not see later writes);
  * the launcher under ``torchrun`` with ``--mesh-shape 2,2 --eigen``
    trains the MoE family and, preempted, ends at the straight run's
    final loss; ``--mesh-shape`` without ``torchrun`` exits 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import SRC

TRAIN = dict(steps=4, batch=4, seq=16, lr=1e-3, warmup=2, log_every=100,
             checkpoint_every=2, device="cpu")
EIGEN = dict(eigen=True, eigen_rank=8, eigen_refresh=2)
T4_BAR = 1e-5  # chip_smoke.py's bar on a resumed run's final loss

WORKER = r'''
import dataclasses, json, os, shutil, sys
import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, {tests!r})
import test_torch_sharded_ckpt as SC
from repro_torch.checkpoint.checkpoint import host_tree
from repro_torch.configs import get_reduced_config
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import train

rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
cfg = dataclasses.replace(get_reduced_config("llama3.2-3b"), dtype="float32",
                          attn_probs_bf16=False)
m22 = make_mesh((2, 2), ("data", "model"), device="cpu")
m41 = make_mesh((4, 1), ("data", "model"), device="cpu")
res = {{}}


def d(name):
    return os.path.join(tmp, name)


def step2(src, dst):
    """A fresh checkpoint dir holding only ``src``'s step-2 checkpoint."""
    if rank == 0:
        shutil.copytree(os.path.join(d(src), "step_00000002"),
                        os.path.join(d(dst), "step_00000002"))
    dist.barrier()
    return d(dst)


# Eigen, preempted at step 3 on (2, 2).
_, _, straight = train(cfg, mesh=m22, checkpoint_dir=d("e"), **SC.EIGEN, **SC.TRAIN)
_, _, resumed = train(cfg, mesh=m22, checkpoint_dir=d("ef"), fail_at=(3,), **SC.EIGEN,
                      **SC.TRAIN)
res["preempted"] = {{"straight": straight, "resumed": resumed}}
if rank == 0:
    with np.load(os.path.join(d("e"), "step_00000004", "host_0.npz")) as f:
        res["files"] = {{k: list(f[k].shape) for k in f.files
                        if k in ("params/embed", "params/blocks.0.mixer.wq",
                                 "opt/eigen/embed/err", "opt/eigen/embed/basis")}}

# Eigen with one refresh: (2, 2) -> stacked.
one = dict(SC.EIGEN, eigen_refresh=SC.TRAIN["steps"])
_, _, straight1 = train(cfg, mesh=m22, checkpoint_dir=d("e1"), **one, **SC.TRAIN)
stacked = step2("e1", "e1s")
if rank == 0:  # one process, no group
    _, _, into_stacked = train(cfg, shards=2, checkpoint_dir=stacked, **one, **SC.TRAIN)
    res["into_stacked"] = {{"straight": straight1, "resumed": into_stacked}}
try:
    train(cfg, mesh=m41, checkpoint_dir=step2("e1", "e1w"), **one, **SC.TRAIN)
    res["wider"] = None
except ValueError as err:
    res["wider"] = str(err)

# AdamW: (2, 2) -> (4, 1) and -> unsharded.
_, _, straight2 = train(cfg, mesh=m22, checkpoint_dir=d("a"), **SC.TRAIN)
_, _, onto41 = train(cfg, mesh=m41, checkpoint_dir=step2("a", "a41"), **SC.TRAIN)
res["adamw"] = {{"straight": straight2, "onto41": onto41}}
one_dir = step2("a", "a1")
if rank == 0:
    _, _, res["adamw"]["unsharded"] = train(cfg, checkpoint_dir=one_dir, **SC.TRAIN)

# The hybrid family (RG-LRU and local attention): AdamW on (2, 2),
# preempted at step 3 and resumed from its step-2 checkpoint.
hcfg = dataclasses.replace(get_reduced_config("recurrentgemma-2b"), dtype="float32",
                           attn_probs_bf16=False)
_, _, straight_h = train(hcfg, mesh=m22, checkpoint_dir=d("h"), **SC.TRAIN)
_, _, resumed_h = train(hcfg, mesh=m22, checkpoint_dir=d("hf"), fail_at=(3,), **SC.TRAIN)
res["hybrid"] = {{"straight": straight_h, "resumed": resumed_h}}
hybrid_one = step2("h", "h1")
if rank == 0:  # its step-2 checkpoint into the unsharded trainer
    _, _, res["hybrid"]["unsharded"] = train(hcfg, checkpoint_dir=hybrid_one, **SC.TRAIN)

# The host copy of a DTensor leaf does not follow later writes.
t = S._distribute(torch.arange(8.0).reshape(4, 2), m22, S.replicated(m22))
snap = host_tree({{"t": t}})["t"].copy()
with torch.no_grad():
    S.local(t).add_(1.0)
res["snapshot"] = bool(np.array_equal(host_tree({{"t": t}})["t"], snap + 1)
                       and np.array_equal(snap, np.arange(8.0).reshape(4, 2)))

with open(os.path.join(tmp, f"out.{{rank}}"), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded-ckpt")
    (tmp / "worker.py").write_text(WORKER.format(tests=os.path.dirname(os.path.abspath(__file__))))
    init = f"file://{tmp / 'rdv'}"
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(k), "4", init,
                               str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for k in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    return [json.loads((tmp / f"out.{k}").read_text()) for k in range(4)]


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-6 * abs(b)


def test_mesh_resume_after_preemption_ends_at_the_straight_run(ranks):
    for got in ranks:
        run = got["preempted"]
        assert len(run["resumed"]) > len(run["straight"])  # steps 2-3 ran twice
        assert _close(run["resumed"][-1], run["straight"][-1]), run


def test_hybrid_adamw_mesh_resume_after_preemption_ends_at_the_straight_run(ranks):
    for got in ranks:
        run = got["hybrid"]
        assert len(run["resumed"]) > len(run["straight"])  # steps 2-3 ran twice
        assert abs(run["resumed"][-1] - run["straight"][-1]) <= T4_BAR * abs(
            run["straight"][-1]), run
    run = ranks[0]["hybrid"]  # the step-2 checkpoint restored unsharded: steps 2, 3
    assert len(run["unsharded"]) == 2
    assert abs(run["unsharded"][-1] - run["straight"][-1]) <= T4_BAR * abs(
        run["straight"][-1]), run


def test_mesh_checkpoint_restores_into_the_stacked_trainer(ranks):
    run = ranks[0]["into_stacked"]
    assert len(run["resumed"]) == 2  # steps 2 and 3, from the step-2 files
    assert _close(run["resumed"][-1], run["straight"][-1]), run


def test_eigen_checkpoint_refuses_a_mesh_of_another_data_width(ranks):
    for got in ranks:
        assert got["wider"] is not None and "err" in got["wider"], got["wider"]


@pytest.mark.parametrize("where", ["onto41", "unsharded"])
def test_adamw_checkpoint_restores_onto_another_mesh(ranks, where):
    for got in ranks if where == "onto41" else ranks[:1]:  # the unsharded run: rank 0
        run = got["adamw"]
        assert len(run[where]) == 2
        assert _close(run[where][-1], run["straight"][-1]), run


def test_mesh_checkpoint_files_are_the_stacked_forms(ranks):
    assert ranks[0]["files"] == {
        "params/embed": [512, 96], "params/blocks.0.mixer.wq": [96, 96],
        "opt/eigen/embed/err": [2, 512, 96], "opt/eigen/embed/basis": [512, 8]}


def test_dtensor_host_copy_is_a_snapshot(ranks):
    assert all(got["snapshot"] for got in ranks)


def _launch(args, tmp_path, torchrun=True):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    pre = ([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "4"] if torchrun else [sys.executable])
    return subprocess.run([*pre, "-m", "repro_torch.launch.train", "--device", "cpu", *args],
                          env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)


def test_launcher_trains_the_moe_family_on_a_mesh_and_resumes(tmp_path):
    """``torchrun ... launch.train --mesh-shape 2,2 --eigen`` on 4 CPU ranks
    trains the reduced qwen3-moe-30b-a3b, and preempted at step 3 with
    checkpoints every 2 it ends at the straight run's final loss."""
    common = ["--arch", "qwen3-moe-30b-a3b", "--steps", "4", "--mesh-shape", "2,2", "--eigen",
              "--batch", "4", "--seq", "32"]
    runs = {}
    for label, extra in (("straight", []), ("preempted", [
            "--fail-at", "3", "--checkpoint-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "2"])):
        proc = _launch(common + extra, tmp_path)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs[label] = dict(line.split(": ", 1) for line in proc.stdout.splitlines()
                           if ": " in line)
    for got in runs.values():
        assert got["mesh"] == "(2, 2) ('data', 'model')" and got["shards"] == "2"
    assert runs["straight"]["losses"] == "4" and runs["preempted"]["losses"] == "5"
    assert _close(float(runs["preempted"]["final_loss_exact"]),
                  float(runs["straight"]["final_loss_exact"]))


def test_mesh_shape_needs_torchrun(tmp_path):
    proc = _launch(["--arch", "llama3.2-3b", "--steps", "1", "--mesh-shape", "1,1"], tmp_path,
                   torchrun=False)
    assert proc.returncode == 2 and "--mesh-shape needs torchrun" in proc.stderr

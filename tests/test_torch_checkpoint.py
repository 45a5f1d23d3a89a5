"""The port's checkpointing (A11-ckpt), the trainer's resume, the train
launcher and the training examples, on the CPU.

* ``save_checkpoint`` / ``load_checkpoint``: the reference's layout
  (``step_%08d/host_<i>.npz`` + ``manifest.json``, published by renaming a
  temp dir), every leaf back bit for bit in its dtype (bf16 included) on
  the caller's device, and a structure or shape mismatch refused with
  ``ValueError``, as ``repro/checkpoint/checkpoint.py``; ``latest_step``
  skips unpublished temp dirs; ``CheckpointManager`` saves on its
  schedule on a background thread, writes the state of the step it was
  asked to save though the caller updates its tensors in place after,
  and keeps ``gc_keep`` steps.
* Resume: a run preempted at step 5 (``fail_at``) and resumed from its
  step-4 checkpoint ends at the uninterrupted run's final loss within
  1e-5, the reference's own bar (``tests/test_fault_tolerance.py:208``),
  for the baseline trainer, the eigen trainer stacked on 4 shards (its
  refresh at step 4 draws the same start bases again) and the eigen
  trainer on 4 gloo ranks under ``torchrun`` (one gathered checkpoint);
  a stacked run resumes the rank world's checkpoint.
* The launcher: ``--device cpu`` with ``--eigen --shards 4``; without
  ``--device`` it refuses to start where there is no card.
* ``repro_torch.examples.train_lm`` (``--small``) and ``serve_lm`` at a
  small setting.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.launch.train import train

TRAIN = dict(steps=8, batch=4, seq=16, lr=1e-3, warmup=2, log_every=100, device="cpu")


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {
        "params": {"blocks.0.mixer.wq": torch.randn(4, 6, generator=gen),
                   "embed": torch.randn(5, 4, generator=gen).to(torch.bfloat16)},
        "opt": {"step": torch.tensor(3, dtype=torch.int32),
                "eigen": {"embed": {"initialized": torch.tensor(True),
                                    "err": torch.randn(2, 5, 4, generator=gen)}},
                "lst": [torch.arange(3), np.float32(1.5)]},
    }


def _leaves(tree, out=None, prefix=""):
    out = {} if out is None else out
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            _leaves(v, out, f"{prefix}{k}/")
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_save_and_load_round_trip(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    assert os.path.basename(path) == "step_00000007"
    assert sorted(os.listdir(path)) == ["host_0.npz", "manifest.json"]
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    assert "params/blocks.0.mixer.wq" in manifest["keys"] and "opt/lst/1" in manifest["keys"]
    assert latest_step(str(tmp_path)) == 7
    got, _ = load_checkpoint(str(tmp_path), 7, _tree(), device="cpu")
    want, back = _leaves(tree), _leaves(got)
    assert set(want) == set(back)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert back[k].dtype == v.dtype and back[k].device.type == "cpu"
            assert torch.equal(back[k], v), k
        else:
            assert np.array_equal(back[k], v)


def test_load_refuses_structure_and_shape_mismatch(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    missing = _tree()
    missing["params"]["unembed"] = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(str(tmp_path), 1, missing)
    extra = _tree()
    del extra["opt"]["eigen"]
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(str(tmp_path), 1, extra)
    shape = _tree()
    shape["params"]["embed"] = torch.zeros(6, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(str(tmp_path), 1, shape)


def test_latest_step_skips_unpublished_and_manager_keeps_gc_keep(tmp_path):
    save_checkpoint(str(tmp_path), 2, _tree())
    (tmp_path / "step_00000009.tmp0").mkdir()  # a save cut mid-way
    (tmp_path / "step_00000008").mkdir()  # no manifest
    assert latest_step(str(tmp_path)) == 2
    assert latest_step(str(tmp_path / "absent")) is None
    d = tmp_path / "mgr"
    mgr = CheckpointManager(str(d), every=2, gc_keep=2)
    saved = [s for s in range(1, 9) if mgr.maybe_save(s, _tree())]
    mgr.wait()
    assert saved == [2, 4, 6, 8]
    assert sorted(os.listdir(d)) == ["step_00000006", "step_00000008"]
    step, tree, manifest = mgr.restore_latest(_tree())
    assert step == 8 and manifest["step"] == 8
    assert torch.equal(tree["opt"]["step"], torch.tensor(3, dtype=torch.int32))
    assert CheckpointManager(str(tmp_path / "none")).restore_latest(_tree()) == (None, None, None)


def test_async_save_holds_its_steps_state(tmp_path, monkeypatch):
    """The manager's save thread writes the tree as it was when the save
    was asked for, though the caller goes on updating its tensors in
    place (the trainers' step counters, and on the CPU every parameter):
    the host copy shares no memory with a CPU tensor.  The thread is held
    until the caller has moved on."""
    import threading

    from repro_torch.checkpoint import checkpoint as ckpt_mod

    go = threading.Event()
    real = ckpt_mod.save_checkpoint

    def held(*a, **kw):
        go.wait(timeout=60)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", held)
    tree = _tree()
    want = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in _leaves(tree).items()}
    mgr = CheckpointManager(str(tmp_path), every=2)
    assert mgr.maybe_save(2, tree)
    tree["opt"]["step"].fill_(4)
    tree["params"]["blocks.0.mixer.wq"].add_(1.0)
    tree["opt"]["eigen"]["embed"]["err"].zero_()
    go.set()
    mgr.wait()
    _, got, _ = mgr.restore_latest(_tree())
    for k, v in _leaves(got).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, want[k]), k


EIGEN_STACKED = {"eigen": True, "eigen_rank": 8, "eigen_refresh": 2, "shards": 4}


@pytest.fixture
def one_thread():
    """The reduced shapes are tiny: one intra-op thread, so that the
    suite's other workers' threads do not stall these many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch,kw", [("granite-3-2b", {}), ("granite-3-2b", EIGEN_STACKED),
                                     ("mamba2-370m", EIGEN_STACKED),
                                     ("internvl2-2b", EIGEN_STACKED),
                                     ("qwen3-moe-30b-a3b", {}),
                                     ("qwen3-moe-30b-a3b", EIGEN_STACKED)],
                         ids=["baseline", "eigen-stacked", "mamba2-eigen-stacked",
                              "internvl2-eigen-stacked", "moe-baseline", "moe-eigen-stacked"])
def test_resume_after_preemption_reproduces_the_run(tmp_path, arch, kw, one_thread):
    """Preempted at step 5, resumed from the step-4 checkpoint, the run
    ends at the straight run's loss: the dense family, the SSM family
    (the tied embedding's error feedback, the SSD leaves' moments), the
    VLM on text batches (``patch_proj``'s zero-gradient state) and the MoE
    family (the experts' 4-D moments; at rank 8 the router (64, 8) is
    compressed)."""
    _, _, straight = train(arch, checkpoint_dir=str(tmp_path / "a"),
                           checkpoint_every=2, **TRAIN, **kw)
    _, opt, crashed = train(arch, checkpoint_dir=str(tmp_path / "b"),
                            checkpoint_every=2, fail_at=(5,), **TRAIN, **kw)
    # the crashed run redoes steps 4 and 5 from its step-4 checkpoint
    assert len(crashed) == len(straight) + 1
    assert abs(straight[-1] - crashed[-1]) < 1e-5
    assert int(opt["step"]) == TRAIN["steps"]
    assert latest_step(str(tmp_path / "b")) == TRAIN["steps"]


def _launch(args, *, torchrun=False, timeout=300):
    cmd = [sys.executable, "-m"]
    if torchrun:
        cmd += ["torch.distributed.run", "--standalone", "--nproc-per-node", "4", "-m"]
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    return subprocess.run(cmd + ["repro_torch.launch.train", *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def _stats(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(line.split(": ", 1) for line in proc.stdout.splitlines() if ": " in line)


def test_launcher_stacked_and_torchrun_with_resume(tmp_path):
    common = ["--device", "cpu", "--arch", "granite-3-2b", "--steps", "8", "--batch", "4",
              "--seq", "16", "--eigen"]
    stacked = _stats(_launch(common + ["--shards", "4"]))
    assert stacked["shards"] == "4" and stacked["eigen"] == "True"
    ranks = _stats(_launch(common + ["--checkpoint-dir", str(tmp_path / "ck"),
                                     "--checkpoint-every", "2", "--fail-at", "5"],
                           torchrun=True))
    assert ranks["shards"] == "4"
    # one shard a rank runs what the stacked shards run, preempted or not
    assert abs(float(ranks["final_loss_exact"]) - float(stacked["final_loss_exact"])) < 1e-5
    # the rank world's checkpoint (its error feedback gathered) resumes stacked
    resumed = _launch(common + ["--shards", "4", "--steps", "10", "--checkpoint-dir",
                                str(tmp_path / "ck")])
    assert _stats(resumed)["losses"] == "2"
    assert "resumed from step 8" in resumed.stderr


def test_launcher_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would run on it")
    proc = _launch(["--arch", "granite-3-2b", "--steps", "1"], timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_train_lm_and_serve_lm_examples():
    env = {**os.environ, "PYTHONPATH": SRC}
    run = lambda *a: subprocess.run([sys.executable, "-m", *a], env=env, capture_output=True,
                                    text=True, timeout=300)
    proc = run("repro_torch.examples.train_lm", "--small", "--steps", "12",
               "--device", "cpu", "--ckpt", "")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "model: lm-small" in proc.stdout and "loss: " in proc.stdout
    proc = run("repro_torch.examples.serve_lm", "--arch", "granite-3-2b", "--batch", "2",
               "--prompt-len", "8", "--gen", "4", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "generated (2, 4) tokens" in proc.stdout

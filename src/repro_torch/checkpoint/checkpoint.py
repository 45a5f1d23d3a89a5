"""Checkpointing: per-host npz shards + JSON manifest, async save,
restore onto the caller's device (port of
``repro/checkpoint/checkpoint.py``).

Layout:  <dir>/step_<N>/host_<i>.npz  +  <dir>/step_<N>/manifest.json

A tree is nested dicts (and lists or tuples) of tensors, numpy arrays or
Python scalars.  Leaves are addressed by their path of keys joined with
"/" (``params/blocks.0.mixer.wq``, ``opt/m/embed``, ``opt/step``: the
port's leaf names under the tree's keys), so structure changes are
detected at load: a missing or extra key, or a leaf of another shape,
raises ``ValueError``.  Writes go to a temp dir renamed into place, so a
crash mid-save never corrupts the latest complete checkpoint; ``gc_keep``
bounds disk usage.  ``CheckpointManager`` copies the tree to host memory
on the caller's thread and serialises it on a background thread, so the
train loop never waits on the filesystem.  bf16 leaves are written
widened to f32 (numpy has no bf16) and cast back on load: the same bits.

DTensor state (a model and optimizer on a mesh): the host copy gathers
each DTensor leaf whole (``full_tensor``: every rank of its mesh takes
part, so every rank calls ``host_tree`` / ``maybe_save`` and only the
writer writes), and the files hold whole arrays, as a one-process run's.
On load, a leaf whose like leaf is a DTensor is placed as that live
leaf is: each rank keeps its block of the whole array, on whatever mesh
it has now (the reference's ``shardings=``: elastic resume).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "latest_step", "load_checkpoint", "CheckpointManager",
           "StackRow"]

_MANIFEST = "manifest.json"
_SEP = "/"


@dataclasses.dataclass(frozen=True)
class StackRow:
    """A like leaf standing for row ``row`` of a stacked array of
    ``shape``: ``load_checkpoint`` checks the whole array's shape and
    returns that row alone (a rank's slice of the gathered error
    feedback), so no process holds the whole stack after the load."""

    shape: tuple
    row: int


def _items(node):
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _leafdict(tree, prefix: str = "") -> Dict[str, Any]:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_leafdict(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return out


def _rebuild(like, leaves: Dict[str, Any], prefix: str = ""):
    items = _items(like)
    if items is None:
        return leaves[prefix]
    built = [(k, _rebuild(v, leaves, f"{prefix}{_SEP}{k}" if prefix else k))
             for k, v in items]
    if isinstance(like, dict):
        return {orig: val for orig, (_, val) in zip(like, built)}
    return type(like)(val for _, val in built)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _place_like(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` (a whole tensor) placed as the DTensor ``like``: this rank's
    block, nothing moved between ranks."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, like.device_mesh, list(like.placements), src_data_rank=None)


def _host(x) -> np.ndarray:
    """A host copy of ``x`` that shares no memory with it: a CPU tensor is
    copied too, since the save thread reads it while the train loop goes
    on updating the tensor in place."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if _is_dtensor(x):
            x = x.full_tensor()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def host_tree(tree):
    """``tree`` with every leaf copied to a host numpy array."""
    return _rebuild(tree, {k: _host(v) for k, v in _leafdict(tree).items()})


def save_checkpoint(
    directory: str,
    step: int,
    tree,
    *,
    extra: Optional[Dict[str, Any]] = None,
    process_index: int = 0,
    num_hosts: int = 1,
) -> str:
    """Synchronous save of this host's leaves as ``host_<process_index>.npz``."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{process_index}"
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: _host(v) for k, v in _leafdict(tree).items()}
    np.savez(os.path.join(tmp, f"host_{process_index}.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "time": time.time(),
        "num_hosts": num_hosts,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    # Atomic publish (one writing host; several would barrier here).
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest complete (manifest written) step under ``directory``."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp" not in name:
            if os.path.exists(os.path.join(directory, name, _MANIFEST)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def load_checkpoint(
    directory: str,
    step: int,
    like_tree,
    *,
    device: Optional[str | torch.device] = None,
    process_index: int = 0,
):
    """Restore into the structure of ``like_tree``: returns (tree,
    manifest).  Each tensor leaf of ``like_tree`` comes back as a tensor
    of its dtype on ``device`` (default: the like leaf's device), a
    DTensor leaf as a DTensor placed as it is; other leaves come back as
    numpy arrays."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    want = _leafdict(like_tree)
    with np.load(os.path.join(path, f"host_{process_index}.npz")) as data:
        missing = sorted(set(want) - set(data.files))
        extra_keys = sorted(set(data.files) - set(want))
        if missing or extra_keys:
            raise ValueError(
                f"checkpoint structure mismatch: missing={missing[:5]} "
                f"extra={extra_keys[:5]}"
            )
        out = {}
        for k, like in want.items():
            arr = data[k]
            shape = tuple(like.shape) if hasattr(like, "shape") else np.shape(like)
            if arr.shape != tuple(shape):
                raise ValueError(f"shape mismatch at {k}: checkpoint {arr.shape}, "
                                 f"expected {tuple(shape)}")
            if isinstance(like, torch.Tensor):
                dev = like.device if device is None else torch.device(device)
                t = torch.from_numpy(arr).to(device=dev, dtype=like.dtype)
                out[k] = _place_like(t, like) if _is_dtensor(like) else t
            elif isinstance(like, StackRow):
                out[k] = arr[like.row].copy()
            else:
                out[k] = arr
    return _rebuild(like_tree, out), manifest


class CheckpointManager:
    """Async checkpointing: the host copy on the caller's thread,
    serialisation and disk IO on a background thread.  ``gc_keep`` prunes
    old steps."""

    def __init__(self, directory: str, *, every: int = 100, gc_keep: int = 3):
        self.directory = directory
        self.every = every
        self.gc_keep = gc_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def due(self, step: int) -> bool:
        return self.every > 0 and step % self.every == 0

    def maybe_save(self, step: int, tree, *, extra=None, force=False,
                   writer: bool = True) -> bool:
        """Copy ``tree`` to the host and, on the ``writer``, write it on the
        background thread.  With DTensor leaves every rank calls this (the
        copy gathers them) and one is the writer; another rank's other
        leaves are not read (None stands for a leaf only the writer holds)."""
        if not force and not self.due(step):
            return False
        self.wait()
        if not writer:  # its part in the DTensor leaves' gathers, in leaf order
            for v in _leafdict(tree).values():
                if _is_dtensor(v):
                    v.full_tensor()
            return True
        host = host_tree(tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host, extra=extra)
                self._gc()
            except Exception as e:  # re-raised by wait() on the caller
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self):
        """Block until the save in flight is on disk; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and "." not in n
        )
        for s in steps[: -self.gc_keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True
            )

    def restore_latest(self, like_tree, *, device=None):
        """(step, tree, manifest) of the newest checkpoint, or (None, None,
        None) when there is none."""
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        tree, manifest = load_checkpoint(self.directory, step, like_tree, device=device)
        return step, tree, manifest

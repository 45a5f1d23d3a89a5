"""What one device does in a dry run of the port: the counterpart of
``repro/launch/hlo_analysis.py``.

The reference compiles each cell and reads the partitioned HLO (XLA's
cost analysis, ``memory_analysis`` and the collectives' operand shapes).
The port has no HLO, so it counts what it runs, under ``FakeTensorMode``
on a fake process group (``launch/dryrun.py``), rank 0's share:

  * **FLOPs a device** (``LocalFlops``): the local ops.  A dispatch mode
    sees a DTensor op with its global shapes first (``FlopCounterMode``
    would count the whole product there); ``LocalFlops`` hands DTensor
    ops on to DTensor (``NotImplemented``), so it counts the ops DTensor
    runs on this rank's local blocks, with ``torch.utils.flop_counter``'s
    formulas, the kernels' own (``kernels.library``: the operations their
    bounds count) included.  Backward ops count too.
  * **HBM argument bytes a device** (``launch.sharding.local_bytes``):
    this rank's blocks of the parameters, the optimizer state and the
    batch.
  * **Peak bytes a device** (``peak_bytes``): ``MemTracker``'s peak over
    the step.
  * **Collective bytes a device, by kind** (``LocalComms``): each
    collective DTensor issues, with the bytes of its local operand
    (``CommDebugMode`` gives the counts).  The paper's path counts the
    payloads it hands to ``torch.distributed`` through
    ``comm/transport.py``'s own tally (``transport.handed_bytes``), as its
    CPU tests do.

DTensor derives a new op's output shape by running the op once more on
fake tensors of the global shapes
(``ShardingPropagator._propagate_tensor_meta_non_cached``).  That shadow
op is no work of any rank, so ``unseen_shadow_ops`` runs it with the
counting modes (and ``MemTracker``) set aside.

The reference's HLO-only outputs (``generated_code_size_bytes``,
``lower_s``, ``compile_s``) have no counterpart (``dryrun.HLO_REFUSED``).
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["COLLECTIVE_KINDS", "LocalFlops", "LocalComms", "peak_bytes", "unseen_shadow_ops"]

# The reference's collective kinds, by the op names DTensor issues.
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _is_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


class LocalFlops(TorchDispatchMode):
    """Counts the FLOPs of the local ops run under it (see the module
    docstring); ``total`` and ``by_op``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = dict(flop_registry)
        self.total = 0
        self.by_op: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor(types):
            return NotImplemented
        out = func(*args, **kwargs)
        formula = self.registry.get(getattr(func, "_overloadpacket", None))
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.total += n
            self.by_op[str(func._overloadpacket)] += n
        return out


class LocalComms(TorchDispatchMode):
    """Bytes of the local operand of each collective DTensor issues under
    it, by the reference's kinds (``by_kind``), their counts, and with
    ``axes`` ({process-group name: label}) by the labelled group
    (``by_axis``).  Collectives a caller issues itself through
    ``comm/transport.py`` are counted there (``handed_bytes``), not
    here."""

    def __init__(self, axes: Dict[str, str] | None = None):
        super().__init__()
        self.axes = dict(axes or {})
        self.by_kind: Counter = Counter()
        self.counts: Counter = Counter()
        self.by_axis: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor(types):
            return NotImplemented
        name = getattr(func, "__name__", "").split(".")[0]
        ns = getattr(func, "namespace", "")
        if ns == "_c10d_functional" and name in COLLECTIVE_KINDS:
            kind = COLLECTIVE_KINDS[name]
            first = args[0][0] if isinstance(args[0], (list, tuple)) else args[0]
            if isinstance(first, (list, tuple)):
                first = first[0]
            size = first.numel() * first.element_size()
            self.by_kind[kind] += size
            self.counts[kind] += 1
            group = next((a for a in args if isinstance(a, str) and a in self.axes), None)
            if group is not None:
                self.by_axis[self.axes[group]] += size
        return func(*args, **kwargs)


@contextlib.contextmanager
def peak_bytes(*tracked):
    """Track memory under the block with ``MemTracker`` (``tracked``:
    modules and optimizer-state tensors held before it); yields a dict
    whose ``"peak"`` holds this device's peak bytes afterwards."""
    from torch.distributed._tools.mem_tracker import MemTracker

    out: Dict[str, int] = {}
    mt = MemTracker()
    mt.track_external(*tracked)
    with mt:
        yield out
    snap = mt.get_tracker_snapshot("peak")
    out["peak"] = max((d.get("Total", 0) for d in snap.values()), default=0)
    out["by_device"] = {str(k): int(v.get("Total", 0)) for k, v in snap.items()}


@contextlib.contextmanager
def unseen_shadow_ops():
    """Within the block, DTensor's global-shape shape propagation runs with
    every dispatch mode set aside, so the counters see local work only."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    name = "_propagate_tensor_meta_non_cached"
    orig = ShardingPropagator.__dict__.get(name)
    if orig is None:
        raise RuntimeError(f"this torch's DTensor has no ShardingPropagator.{name}: "
                           "the dry run's counts would include its shadow ops")

    def unseen(self, *args, **kwargs):
        with _disable_current_modes():
            return orig(self, *args, **kwargs)

    setattr(ShardingPropagator, name, unseen)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)

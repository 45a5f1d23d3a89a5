"""Learning-rate schedules, step -> lr (port of ``repro/optim/schedule.py``).

Each schedule is an f32 function of the step, returned as a Python float
(the f32 value): the optimizer takes it as a scalar operand, which costs
no host-to-device copy.  The trainers evaluate it at the step before the
increment (``opt_state["step"]``), as the reference's ``train_step``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["warmup_cosine", "constant"]

_f32 = np.float32


def warmup_cosine(
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    *,
    end_frac: float = 0.1,
):
    """Linear warmup then cosine decay to ``end_frac * peak_lr``."""
    peak, end = _f32(peak_lr), _f32(end_frac)
    warm_len = _f32(max(warmup_steps, 1))
    decay_len = _f32(max(total_steps - warmup_steps, 1))

    def schedule(step) -> float:
        s = _f32(int(step))
        if s < warmup_steps:
            return float(peak * s / warm_len)
        t = np.clip((s - _f32(warmup_steps)) / decay_len, _f32(0.0), _f32(1.0))
        cos = _f32(np.cos(_f32(np.pi) * t))
        return float(peak * (end + (_f32(1.0) - end) * _f32(0.5) * (_f32(1.0) + cos)))

    return schedule


def constant(lr: float):
    return lambda step: float(_f32(lr))

"""Straggler detection: a step-time EMA monitor with slow-step escalation
(port of ``repro/runtime/straggler.py``).

Collectives synchronise everyone to the slowest participant, so a
straggler shows on every rank as a longer step.  The monitor keeps an EMA
and variance of step times, flags steps more than ``threshold`` sigmas
slow, and after ``patience`` slow steps in a row calls ``on_escalate``
(the elastic runner re-plans there).  ``StepTimer`` synchronises the card
before it reads the clock, so the monitor sees rounds, not launch times.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

__all__ = ["StragglerMonitor", "StepTimer"]

log = logging.getLogger("repro_torch.straggler")


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.05        # EMA smoothing
    threshold: float = 4.0     # sigmas above mean -> slow
    patience: int = 5          # consecutive slow steps before escalation
    warmup: int = 10           # ignore the first steps
    on_escalate: Optional[Callable[[int, float], None]] = None

    _mean: float = 0.0
    _var: float = 0.0
    _m2: float = 0.0
    _n: int = 0
    _slow_run: int = 0
    escalations: int = 0

    def record(self, step: int, dt: float) -> bool:
        """Record one step duration; True if the step was slow."""
        self._n += 1
        if self._n <= self.warmup:
            # Welford running mean/variance over the warm-up window; the
            # EMA variance starts from it.
            delta = dt - self._mean
            self._mean += delta / self._n
            self._m2 += delta * (dt - self._mean)
            if self._n == self.warmup:
                self._var = self._m2 / self.warmup
            return False
        delta = dt - self._mean
        self._mean += self.alpha * delta
        self._var = (1 - self.alpha) * (self._var + self.alpha * delta * delta)
        sigma = max(self._var**0.5, 1e-9)
        slow = dt > self._mean + self.threshold * sigma and dt > 1.5 * self._mean
        if slow:
            self._slow_run += 1
            log.warning("slow step %d: %.4fs (mean %.4fs, sigma %.4fs)",
                        step, dt, self._mean, sigma)
            if self._slow_run >= self.patience:
                self.escalations += 1
                self._slow_run = 0
                if self.on_escalate:
                    self.on_escalate(step, dt)
        else:
            self._slow_run = 0
        return slow

    @property
    def mean_step_time(self) -> float:
        return self._mean


class StepTimer:
    """Wall time between laps.  On a CUDA ``device`` each reading first
    waits for the card (``torch.cuda.synchronize``): the port's calls
    return once their work is queued."""

    def __init__(self, device: torch.device | str | None = None):
        self._device = None if device is None else torch.device(device)
        self._t0 = self._now()

    def _now(self) -> float:
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return time.perf_counter()

    def lap(self) -> float:
        t = self._now()
        dt = t - self._t0
        self._t0 = t
        return dt

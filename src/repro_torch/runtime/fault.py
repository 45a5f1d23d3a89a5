"""Fault tolerance: failure injection and the retry policy (port of
``repro/runtime/fault.py``).

``FailureInjector`` schedules faults at two granularities: steps
(``check`` raises ``SimulatedPreemption``) and (shard, round) events that
the elastic runner (``repro_torch.runtime.elastic``) folds into a
per-round ``Membership``: a dead shard is masked out of the collectives,
not crashed, which is how a preempted host looks to the survivors.
``with_retries`` retries transient failures with bounded, jittered
exponential backoff.  Process start-up across hosts is
``torch.distributed.init_process_group`` (``launch.mesh``).
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, Tuple

from repro_torch.comm.membership import Membership

__all__ = ["SimulatedPreemption", "FailureInjector", "with_retries"]

log = logging.getLogger("repro_torch.fault")


class SimulatedPreemption(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Deterministic fault schedule.

    Steps: ``fail_at_steps`` + ``check(step)`` raise ``SimulatedPreemption``
    at the chosen steps (once each by default).  Collectives: ``fail_at`` /
    ``recover_at`` are (shard, round) pairs, "shard k dies (rejoins) before
    round t", read through ``membership_at``; nothing raises there.
    """

    fail_at_steps: tuple = ()
    fail_once: bool = True
    fail_at: Tuple[Tuple[int, int], ...] = ()
    recover_at: Tuple[Tuple[int, int], ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and (
            not self.fail_once or step not in self._fired
        ):
            self._fired.add(step)
            raise SimulatedPreemption(f"injected failure at step {step}")

    @staticmethod
    def parse_fail_spec(spec: str) -> Tuple[Tuple[int, int], ...]:
        """Parse the launcher's ``--fail-at "k:t,k:t"`` (shard:round)."""
        pairs = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                shard, rnd = part.split(":")
                pairs.append((int(shard), int(rnd)))
            except ValueError:
                raise ValueError(
                    f"bad --fail-at entry {part!r}: expected shard:round "
                    "(e.g. '2:1' = shard 2 dies before round 1)"
                ) from None
        return tuple(pairs)

    def dead_shards(self, round_index: int) -> frozenset:
        """Shards dead entering ``round_index``: events at round t apply to
        round t; a recovery at the same (shard, round) as a kill wins."""
        events = sorted(
            [(t, 0, s) for s, t in self.fail_at]
            + [(t, 1, s) for s, t in self.recover_at]
        )
        dead = set()
        for t, kind, s in events:
            if t > round_index:
                break
            (dead.discard if kind else dead.add)(s)
        return frozenset(dead)

    def membership_at(self, round_index: int, m: int) -> Membership:
        """The mask in force for ``round_index`` over m shards."""
        return Membership.from_dead(m, self.dead_shards(round_index))


def with_retries(
    fn: Callable,
    *,
    max_retries: int = 3,
    backoff_s: float = 0.1,
    max_backoff_s: float = 30.0,
    jitter: float = 0.25,
    retryable=(SimulatedPreemption,),
    sleep: Callable[[float], None] = time.sleep,
    rng: Callable[[], float] = random.random,
):
    """Retry ``retryable`` failures with exponential backoff and jitter:
    attempt k sleeps ``min(backoff_s * 2**k, max_backoff_s)`` stretched by
    up to ``jitter``; re-raises once the budget is spent.  ``sleep`` and
    ``rng`` are injectable for tests."""

    def wrapped(*args, **kwargs):
        for attempt in range(max_retries + 1):
            try:
                return fn(*args, **kwargs)
            except retryable as e:
                if attempt == max_retries:
                    raise
                delay = min(backoff_s * (2.0 ** attempt), max_backoff_s)
                delay *= 1.0 + jitter * rng()
                log.warning("transient failure (%s); retry %d in %.3fs",
                            e, attempt + 1, delay)
                sleep(delay)

    return wrapped

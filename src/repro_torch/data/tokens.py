"""Deterministic synthetic LM token pipeline with background prefetch
(port of ``repro/data/tokens.py``).

Each host materialises only its slice of the global batch; batches are a
pure function of (seed, step, host_id), so restart and elastic resume
reproduce the exact stream with no data state in the checkpoint.  Tokens
follow a Zipf-ish marginal with a Markov overlay, so the LM loss has
learnable structure.  The arithmetic is the reference's, in numpy, so the
batches are bit-equal to its for every (seed, step, host_id).  Batches
are numpy int32 arrays; the trainers move them to their device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

__all__ = ["TokenPipeline"]


class TokenPipeline:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        *,
        seed: int = 0,
        num_hosts: int = 1,
        host_id: int = 0,
    ):
        if global_batch % num_hosts:
            raise ValueError(f"global_batch {global_batch} does not split over "
                             f"{num_hosts} hosts")
        self.vocab = vocab_size
        self.seq = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        # Markov overlay: each token deterministically biases the next
        # toward (t * A + B) mod V with prob q -- learnable structure.
        self._a, self._b, self._q = 31, 7, 0.35

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Materialise this host's slice of global batch ``step``."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        b, s, v = self.local_batch, self.seq, self.vocab
        # Zipf-ish marginal via exponential transform of uniforms.
        base = (np.floor(v * rng.random((b, s + 1)) ** 3)).astype(np.int64)
        follow = (base[:, :-1] * self._a + self._b) % v
        use = rng.random((b, s)) < self._q
        seq = np.where(use, follow, base[:, 1:])
        tokens = np.concatenate([base[:, :1], seq[:, :-1]], axis=1)
        labels = seq
        return {
            "tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32),
        }

    def iterator(
        self, start_step: int = 0, prefetch: int = 2
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Background-thread prefetching iterator (overlaps host data work
        with device compute).  The thread stops when the iterator is
        closed or collected."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

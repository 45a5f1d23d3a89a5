"""Graph data and HOPE node embeddings for the paper's §3.6 experiment
(a numpy copy of ``repro/data/graphs.py``; the port imports nothing of
the reference).

Wikipedia/PPI are not available offline; the examples substitute
stochastic block-model graphs and say so.  HOPE (Katz proximity
S = (I - beta A)^{-1} beta A factorised by SVD) is implemented in full,
with the censored-graph observation model of the paper.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["sbm_graph", "censor_graph", "hope_embedding"]


def sbm_graph(
    rng: np.random.Generator,
    n_nodes: int = 300,
    n_blocks: int = 6,
    p_in: float = 0.12,
    p_out: float = 0.01,
) -> Tuple[np.ndarray, np.ndarray]:
    """Adjacency matrix + block labels of a stochastic block model."""
    labels = rng.integers(0, n_blocks, size=n_nodes)
    probs = np.where(labels[:, None] == labels[None, :], p_in, p_out)
    upper = rng.random((n_nodes, n_nodes)) < probs
    adj = np.triu(upper, 1)
    adj = (adj | adj.T).astype(np.float64)
    return adj, labels


def censor_graph(rng: np.random.Generator, adj: np.ndarray, p: float) -> np.ndarray:
    """Hide each edge independently with probability p (paper's model)."""
    mask = np.triu(rng.random(adj.shape) >= p, 1)
    return adj * (mask | mask.T)


def hope_embedding(adj: np.ndarray, dim: int, beta: float = 0.1) -> np.ndarray:
    """HOPE (Ou et al. 2016) with Katz proximity: the source embedding
    U_s sqrt(Sig) (n, dim), defined up to the orthogonal ambiguity the
    paper exploits."""
    n = adj.shape[0]
    s = np.linalg.solve(np.eye(n) - beta * adj, beta * adj)
    u, sig, _ = np.linalg.svd(s)
    return u[:, :dim] * np.sqrt(sig[:dim])[None, :]

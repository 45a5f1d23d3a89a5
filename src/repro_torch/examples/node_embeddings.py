"""Paper §3.6: distributed node embeddings with Procrustes averaging (port
of ``examples/node_embeddings.py``).

Each of m machines sees a censored copy of a graph (edges hidden with
probability p), computes HOPE embeddings locally, and the coordinator
combines them with Algorithm 1.  Wikipedia/PPI are unavailable offline, so
this uses a stochastic block model (documented substitution); a logistic
"one-vs-rest" block classifier evaluates embedding quality like the
paper's macro-F1 table.  The graphs and embeddings are numpy; the
alignment runs on ``--device``.

Run:  PYTHONPATH=src python -m repro_torch.examples.node_embeddings [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import align
from repro_torch.data.graphs import censor_graph, hope_embedding, sbm_graph
from repro_torch.interop import resolve_device


def f1_macro_logistic(z: np.ndarray, labels: np.ndarray, seed=0) -> float:
    """Tiny hand-rolled multinomial logistic regression (no sklearn offline)."""
    rng = np.random.default_rng(seed)
    n, d = z.shape
    k = labels.max() + 1
    z = (z - z.mean(0)) / (z.std(0) + 1e-9)
    idx = rng.permutation(n)
    tr, te = idx[: int(0.75 * n)], idx[int(0.75 * n):]
    w = np.zeros((d, k))
    y = np.eye(k)[labels]
    for _ in range(300):
        p = np.exp(z[tr] @ w)
        p /= p.sum(1, keepdims=True)
        g = z[tr].T @ (p - y[tr]) / len(tr) + 1e-3 * w
        w -= 0.5 * g
    pred = (z[te] @ w).argmax(1)
    f1s = []
    for c in range(k):
        tp = np.sum((pred == c) & (labels[te] == c))
        fp = np.sum((pred == c) & (labels[te] != c))
        fn = np.sum((pred != c) & (labels[te] == c))
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1s.append(2 * prec * rec / max(prec + rec, 1e-9))
    return float(np.mean(f1s))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    adj, labels = sbm_graph(rng, n_nodes=240, n_blocks=5)
    dim, p_censor, m = 32, 0.1, 8
    print(f"SBM graph: {adj.shape[0]} nodes, censoring p={p_censor}, m={m} machines")

    z_central = hope_embedding(adj, dim)
    zs = [hope_embedding(censor_graph(rng, adj, p_censor), dim) for _ in range(m)]

    z_naive = np.mean(zs, axis=0)
    ref = torch.as_tensor(zs[0], device=dev)
    aligned = [align(torch.as_tensor(z, device=dev), ref).cpu().numpy() for z in zs]
    z_avg = np.mean(aligned, axis=0)

    def q(z):
        return np.linalg.norm(z @ z.T - z_central @ z_central.T) / np.linalg.norm(
            z_central @ z_central.T)

    print(f"gram-distance to central: naive={q(z_naive):.4f} aligned={q(z_avg):.4f}")
    f_c = f1_macro_logistic(z_central, labels)
    f_a = f1_macro_logistic(z_avg, labels)
    f_n = f1_macro_logistic(z_naive, labels)
    print(f"macro-F1: central={f_c:.3f} aligned={f_a:.3f} naive={f_n:.3f}")
    print(f"relative F1 loss (aligned vs central): {100 * (f_c - f_a) / max(f_c, 1e-9):.2f}%")


if __name__ == "__main__":
    main()

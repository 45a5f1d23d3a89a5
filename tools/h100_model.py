"""Measure the constants of the planner's H100 device model, and the
stacked rounds the planner chooses between, on the card.

    PYTHONPATH=src python3 tools/h100_model.py [--out FILE]

Prints one JSON object (and writes it to ``--out`` if given):

* ``launch_latency_s``: host wall time per call of the port's smallest
  kernel launch (B4 ``align_average`` through its wrapper on a (1, 8, 8)
  stack), 2000 back-to-back calls, then one synchronise;
* ``op_latency_s``: host wall time per sequential small torch op (an
  (8, 8) matmul chained 2000 times);
* ``svd_s`` / ``qr_s`` by r: one ``torch.linalg.svd`` of an (8, r, r)
  Gram stack and one ``torch.linalg.qr`` of a (8192, r) basis, the
  round's two LAPACK-style calls (median of 7, each synchronised);
  ``lapack_latency_s`` is their mean at r = 128;
* ``cells``: ``refinement_rounds`` on a fixed (8, 8192, r) f32 stack, 2
  rounds, for every cell of {torch, cuda} x {svd, newton-schulz} x {qr,
  cholesky-qr2} at r = 128 and 256 (``time_cells``: CUDA events, one
  warm-up call, median of 5);
* ``wide_round``: B5 (the cuda, newton-schulz, cholesky-qr2 cell's
  kernel) past ``NS_SMEM_MAX_R``, 2 rounds on the same stacks at r = 192
  and 256: its ms (CUDA events, median of 5), the FLOP/s of the round's
  work (the Grams, applies and Newton-Schulz steps the smoke's bound
  counts) and the forms it ran.  The planner prices these cells at the
  card's peak, as it does up to ``NS_SMEM_MAX_R``; this is what that
  pricing is checked against.

Needs a CUDA card; TF32 stays off (``interop.strict_fp32``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

M, D, N_ITER = 8, 8192, 2
CELL_RS = (128, 256)
WIDE_RS = (192, 256)
BACKENDS = ("torch", "cuda")
POLARS = ("svd", "newton-schulz")
ORTHS = ("qr", "cholesky-qr2")


def stack(torch, m, d, r, seed=0, device="cuda"):
    """Noisy orthonormal copies of one subspace, (m, d, r) f32 contiguous."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.linalg.qr(torch.randn(d, r, generator=gen, device=device))[0]
    noise = torch.randn(m, d, r, generator=gen, device=device) * (0.1 / d ** 0.5)
    return torch.linalg.qr(base[None] + noise)[0].contiguous()


def event_ms(torch, fn, reps=5):
    """Median over ``reps`` single calls of ``fn``, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_cells(torch, r, *, m=M, d=D, n_iter=N_ITER, reps=5):
    """ms of ``refinement_rounds`` (``n_iter`` rounds) on one (m, d, r) f32
    stack for every (backend, polar, orth) cell, in the planner's
    enumeration order: {(backend, polar, orth): ms}."""
    from repro_torch.core.eigenspace import refinement_rounds

    vs = stack(torch, m, d, r)
    out = {}
    for b in BACKENDS:
        for p in POLARS:
            for o in ORTHS:
                out[(b, p, o)] = event_ms(torch, lambda: refinement_rounds(
                    vs, n_iter=n_iter, backend=b, polar=p, orth=o), reps)
    return out


def wall_per_call(torch, fn, calls=2000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls


def synced_s(torch, fn, reps=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def measure(torch) -> dict:
    from repro_torch.interop import strict_fp32
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import _build
    from repro_torch.kernels import procrustes_align as pa

    strict_fp32()
    _build.build()
    _build.load()
    dev = torch.device("cuda", 0)
    tiny = stack(torch, 1, 8, 8)
    zs = torch.eye(8, device=dev)[None].contiguous()
    launch = wall_per_call(torch, lambda: kops.align_average(tiny, zs, use_kernel=True))
    a = torch.randn(8, 8, device=dev)
    state = {"x": torch.eye(8, device=dev)}

    def op():
        state["x"] = state["x"] @ a * 0.1

    op_s = wall_per_call(torch, op)
    svd_s, qr_s = {}, {}
    for r in (128, 192, 256):
        g = torch.randn(M, r, r, device=dev)
        v = torch.randn(D, r, device=dev)
        svd_s[r] = synced_s(torch, lambda: torch.linalg.svd(g, full_matrices=False))
        qr_s[r] = synced_s(torch, lambda: torch.linalg.qr(v, mode="reduced"))
    cells = {r: time_cells(torch, r) for r in CELL_RS}
    wide = {}
    for r in WIDE_RS:
        vs = stack(torch, M, D, r)
        ms = event_ms(torch, lambda: kops.fused_round(vs, vs[0].contiguous(),
                                                      n_iter=N_ITER, use_kernel=True))
        flops = 4.0 * M * D * r * r + 8.0 * D * r * r + 24 * M * 4.0 * r ** 3
        wide[r] = {"ms": ms, "flops_per_s": N_ITER * flops / (ms * 1e-3),
                   "newton_schulz_form": pa.fused_round.last_form,
                   "factor_form": pa.fused_round.last_factor}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    return {
        "card": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "launch_latency_s": launch,
        "op_latency_s": op_s,
        "svd_s": svd_s, "qr_s": qr_s,
        "lapack_latency_s": (svd_s[128] + qr_s[128]) / 2,
        "cells_ms": {str(r): {"/".join(k): v for k, v in c.items()}
                     for r, c in cells.items()},
        "wide_round": {str(r): w for r, w in wide.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("h100_model: no CUDA device", file=sys.stderr)
        return 2
    rec = measure(torch)
    text = json.dumps(rec, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

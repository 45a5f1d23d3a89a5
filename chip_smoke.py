#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card, ``nvcc`` and this checkout; imports nothing
of JAX or of the reference package.  Phases, each ending in
``torch.cuda.synchronize()``; any failure raises and exits non-zero:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and print
   the build time and the card's name and power limit.
2. Hold each kernel (B1 gram, B2 batched_gram, B3 batched_gram_polar,
   B4 align_average) against its plain PyTorch version on the card, at the
   main path's shapes and at a ragged shape, max error beside tolerance.
3. Drive the main path, ``distributed_pca`` at the production width of
   ``repro/configs/paper_pca.py`` (d = 8192, r = 128, 65536 samples per
   shard, 2 rounds, 30 subspace-iteration steps) with m = 8 shards on the
   card, in two lanes (polar svd and newton-schulz, orth qr, backend
   cuda, topology gather).  Each lane zeroes the launch counters first and
   reads them after: B1 must launch once per shard, B2 or B3 and B4 once
   per round.  The estimate must be finite, orthonormal and within
   dist_2 < 0.15 of the centralized estimate; a small run must agree with
   the plain backend.  The launcher runs once on the card as well.
4. Time each kernel at the main path's shapes (CUDA events) beside its
   bound, its plain version and one PyTorch call computing the same
   function.
5. Print ``{"kernels": [...]}``, then, last, ``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --profile`` instead builds, draws the same data
and runs each main-path lane once more under ``torch.profiler`` after a
warm-up lane: it prints the lane's wall time, the device's busy share
and the kernels that took the most device time.

TF32 is off throughout: the reference computes in float32.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# Production width of the paper-pca config (src/repro/configs/paper_pca.py).
D, R, N_PER_SHARD, SHARDS, N_ITER, ITERS = 8192, 128, 65536, 8, 2, 30
DELTA = 0.2
SEED = 0
# Ragged shape of the reference's kernel tests: block-misaligned d, r < 8.
RAGGED_M, RAGGED_D, RAGGED_R, RAGGED_N = 3, 205, 5, 257
DIST_BAR = 0.15  # README quickstart: distributed within 0.15 of central
NS_TOL = 1e-4  # 24 Newton-Schulz steps amplify summation order
EPS32 = 2.0 ** -23

# FP32 CUDA-core peak and memory rate (NVIDIA data sheets), by card name.
PEAKS = (
    ("PCIe", "H100 PCIe", 51.2e12, 2.0e12),
    ("NVL", "H100 NVL", 60.0e12, 3.9e12),
    ("", "H100 SXM", 67.0e12, 3.35e12),
)

KERNELS = {
    "gram": ("src/repro_torch/kernels/csrc/covariance.cu",
             "src/repro/kernels/covariance.py:60"),
    "batched_gram": ("src/repro_torch/kernels/csrc/procrustes_align.cu",
                     "src/repro/kernels/procrustes_align.py:141"),
    "batched_gram_polar": ("src/repro_torch/kernels/csrc/procrustes_align.cu",
                           "src/repro/kernels/procrustes_align.py:155"),
    "align_average": ("src/repro_torch/kernels/csrc/procrustes_align.cu",
                      "src/repro/kernels/procrustes_align.py:198"),
}


def sum_tol(k: int, scale: float) -> float:
    """Tolerance for an f32 sum of k products taken in two orders:
    4 eps sqrt(k) times the largest entry of the plain result."""
    return 4.0 * EPS32 * math.sqrt(k) * scale


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def profile_lanes(torch, distributed_pca, samples, dev) -> None:
    """Each main-path lane under torch.profiler: wall, device busy share
    (kernel time over wall) and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(shards=SHARDS, device=dev, n_iter=N_ITER, solver="subspace",
              iters=ITERS, backend="cuda", orth="qr", topology="gather")
    distributed_pca(samples, R, polar="svd", **kw)  # warm-up lane
    torch.cuda.synchronize()
    for polar in ("svd", "newton-schulz"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            distributed_pca(samples, R, polar=polar, **kw)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")]
        busy_us = sum(e.self_device_time_total for e in kernels)
        print(f"[profile] polar={polar}: wall {wall_us / 1e3:.1f} ms under the "
              f"profiler, device busy {busy_us / 1e3:.1f} ms "
              f"({100 * busy_us / wall_us:.1f} %), {len(kernels)} kernel names")
        if not kernels:
            print("[profile] the profiler saw no device time: not measured")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"[profile]   {e.self_device_time_total / 1e3:10.2f} ms "
                  f"{100 * e.self_device_time_total / max(busy_us, 1):5.1f} % "
                  f"x{e.count:<5d} {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile the two main-path lanes instead of the checks")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    from repro_torch import kernels
    from repro_torch.core import (
        central_estimate,
        dist_2,
        distributed_pca,
        empirical_covariance,
        subspace_dist64,
    )
    from repro_torch.data import synthetic as syn
    from repro_torch.interop import strict_fp32
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.covariance import gram
    from repro_torch.kernels.procrustes_align import (
        align_average,
        batched_gram,
        batched_gram_polar,
    )

    strict_fp32()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- phase 1: build, card --------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw, peak_row = next(
        (f, b, row) for key, row, f, b in PEAKS if key in name
    )
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| bounds from the {peak_row} data sheet: "
          f"{peak_flops / 1e12:.1f} TFLOP/s FP32, {peak_bw / 1e12:.2f} TB/s")

    # -- set-up: the main path's data, drawn on the card -------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tau = syn.spectrum_m1(D, R, delta=DELTA, device=dev)
    _, u, factor = syn.covariance_from_spectrum(tau, generator=gen)
    v_true = u[:, :R].contiguous()
    del u
    samples = syn.sample_gaussian(factor, SHARDS * N_PER_SHARD, generator=gen)
    del factor
    xs = samples.reshape(SHARDS, N_PER_SHARD, D)
    torch.cuda.synchronize()
    print(f"[data] samples {tuple(samples.shape)} f32 "
          f"({samples.numel() * 4 / 1e9:.1f} GB) in {time.perf_counter() - t0:.1f} s")
    if args.profile:
        profile_lanes(torch, distributed_pca, samples, dev)
        return 0

    def noisy_stack(m, d, r):
        """Noisy copies of one subspace (the paper's setting): an (m, d, r)
        stack of orthonormal bases, contiguous."""
        base = torch.linalg.qr(torch.randn(d, r, generator=gen, device=dev))[0]
        noise = torch.randn(m, d, r, generator=gen, device=dev) * (0.1 / math.sqrt(d))
        return torch.linalg.qr(base[None] + noise)[0].contiguous()

    # -- phase 2: each kernel against its plain version --------------------
    results = {k: {"errs": {}} for k in KERNELS}

    def hold(kernel, label, got, want, tol):
        err = (got - want).abs().max().item()
        ok = math.isfinite(err) and err <= tol
        print(f"[check] {kernel:<18} {label:<34} max_abs_err {err:.3e} "
              f"tol {tol:.3e} {'ok' if ok else 'FAIL'}")
        results[kernel]["errs"][label] = (err, tol)
        require(ok, f"{kernel} disagrees with its plain version at {label}")

    x0 = xs[0]
    x_rag = torch.randn(RAGGED_N, RAGGED_D, generator=gen, device=dev)
    for label, x in (("main (65536, 8192) f32", x0),
                     ("main (65536, 8192) bf16", x0.to(torch.bfloat16)),
                     ("ragged (257, 205) f32", x_rag),
                     ("ragged (257, 205) bf16", x_rag.to(torch.bfloat16))):
        want = ref.gram(x)
        tol = sum_tol(x.shape[0], want.abs().max().item())
        hold("gram", label, gram(x), want, tol)
        hold("gram", label + " symmetric", gram(x, symmetric=True), want, tol)
        del want
    x_stack = torch.randn(2, RAGGED_N, RAGGED_D, generator=gen, device=dev)
    want = ref.gram(x_stack)
    hold("gram", "ragged stack (2, 257, 205)", gram(x_stack), want,
         sum_tol(RAGGED_N, want.abs().max().item()))

    stacks = {
        "main (8, 8192, 128)": noisy_stack(SHARDS, D, R),
        "ragged (3, 205, 5)": noisy_stack(RAGGED_M, RAGGED_D, RAGGED_R),
    }
    for label, vs in stacks.items():
        m, d, r = vs.shape
        rf = vs[0].contiguous()
        g_want = ref.batched_gram(vs, rf)
        hold("batched_gram", label, batched_gram(vs, rf), g_want,
             sum_tol(d, g_want.abs().max().item()))
        hold("batched_gram_polar", label, batched_gram_polar(vs, rf),
             ref.batched_gram_polar(vs, rf), NS_TOL)
        zs = ref.batched_gram_polar(vs, rf)
        a_want = ref.align_average(vs, zs)
        hold("align_average", label, align_average(vs, zs), a_want,
             sum_tol(m * r, a_want.abs().max().item()))
    torch.cuda.synchronize()

    # -- phase 3: the main path --------------------------------------------
    covs = torch.stack([empirical_covariance(x, backend="torch") for x in xs])
    v_cent, _ = central_estimate(covs, R)  # plain cuBLAS covariance + eigh
    del covs
    torch.cuda.synchronize()
    print(f"[central] dist_2(central, truth) {dist_2(v_cent, v_true).item():.4e}")
    launches = {k: 0 for k in KERNELS}
    lanes = (("svd", {"gram": SHARDS, "batched_gram": N_ITER,
                      "batched_gram_polar": 0, "align_average": N_ITER}),
             ("newton-schulz", {"gram": SHARDS, "batched_gram": 0,
                                "batched_gram_polar": N_ITER,
                                "align_average": N_ITER}))
    for polar, expected in lanes:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        v = distributed_pca(
            samples, R, shards=SHARDS, device=dev, n_iter=N_ITER,
            solver="subspace", iters=ITERS, backend="cuda", polar=polar,
            orth="qr", topology="gather",
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        for k in KERNELS:
            launches[k] += counts[k]
        d_cent = dist_2(v, v_cent).item()
        ortho = (v.mT @ v - torch.eye(R, device=dev)).abs().max().item()
        print(f"[main] polar={polar} orth=qr backend=cuda topology=gather "
              f"m={SHARDS} n={N_PER_SHARD} d={D} r={R}: wall {wall:.2f} s, "
              f"launches {counts}, dist_2(v, central) {d_cent:.4e}, "
              f"dist_2(v, truth) {dist_2(v, v_true).item():.4e}, "
              f"|V^T V - I|max {ortho:.2e}")
        require(counts == expected,
                f"lane {polar}: launches {counts}, expected {expected}")
        require(tuple(v.shape) == (D, R) and bool(torch.isfinite(v).all()),
                f"lane {polar}: non-finite or misshapen estimate")
        require(ortho < 1e-4, f"lane {polar}: estimate not orthonormal")
        require(d_cent < DIST_BAR,
                f"lane {polar}: dist_2(v, central) {d_cent} >= {DIST_BAR}")
    del samples, xs, x0

    # A small input through both backends: the kernels' path must give the
    # plain path's estimate (f64 subspace distance; f32 covariance order
    # passes through an eigensolve, amplified by 1/gap).
    _, _, f_small = syn.covariance_from_spectrum(
        syn.spectrum_m1(256, 8, delta=DELTA, device=dev), generator=gen)
    small = syn.sample_gaussian(f_small, 4 * 2048, generator=gen)
    for polar in ("svd", "newton-schulz"):
        a = distributed_pca(small, 8, shards=4, device=dev, n_iter=2,
                            solver="eigh", backend="torch", polar=polar)
        b = distributed_pca(small, 8, shards=4, device=dev, n_iter=2,
                            solver="eigh", backend="cuda", polar=polar)
        sd = subspace_dist64(a, b)
        print(f"[parity] small (4 x 2048, 256) r=8 polar={polar}: "
              f"subspace_dist64(cuda, torch) {sd:.3e} (tol 1e-4)")
        require(sd <= 1e-4, f"small parity {polar}: {sd}")

    # The launcher, once on the card, in its own process.
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.eigen", "--device", "cuda",
         "--d", "512", "--r", "8", "--n-per-shard", "4096", "--shards", "8",
         "--polar", "newton-schulz"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC},
    )
    require(cli.returncode == 0, f"launcher failed:\n{cli.stderr[-4000:]}")
    stats = dict(line.split(": ", 1) for line in cli.stdout.strip().splitlines())
    print(f"[cli] repro_torch.launch.eigen --device cuda --d 512 --r 8: "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("backend", "dist_aligned", "dist_central", "dist_naive")))
    require(stats["backend"] == "cuda"
            and float(stats["dist_aligned"]) < float(stats["dist_naive"]),
            "launcher: kernels not used or estimate no better than naive")
    torch.cuda.synchronize()

    # -- phase 4: times at the main path's shapes ---------------------------
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
        return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    x = torch.randn(N_PER_SHARD, D, generator=gen, device=dev)
    vs = stacks["main (8, 8192, 128)"]
    rf = vs[0].contiguous()
    zs = ref.batched_gram_polar(vs, rf)
    m, d, r = vs.shape
    stack_bytes = 4 * (m * d * r + d * r)
    timing = {
        "gram": (lambda: gram(x), lambda: ref.gram(x), lambda: x.T @ x, 3,
                 bound(2.0 * N_PER_SHARD * D * D, 4 * (N_PER_SHARD * D + D * D))),
        "batched_gram": (lambda: batched_gram(vs, rf),
                         lambda: ref.batched_gram(vs, rf),
                         lambda: torch.einsum("mdr,ds->mrs", vs, rf), 50,
                         bound(2.0 * m * d * r * r, stack_bytes + 4 * m * r * r)),
        "batched_gram_polar": (lambda: batched_gram_polar(vs, rf),
                               lambda: ref.batched_gram_polar(vs, rf), None, 20,
                               bound(2.0 * m * d * r * r + 24 * m * 4.0 * r ** 3,
                                     stack_bytes + 4 * m * r * r)),
        "align_average": (lambda: align_average(vs, zs),
                          lambda: ref.align_average(vs, zs),
                          lambda: torch.einsum("mdr,mrs->ds", vs, zs) / m, 50,
                          bound(2.0 * m * d * r * r,
                                4 * (m * d * r + m * r * r + d * r))),
    }
    rows = []
    for k, (kern, plain, lib, reps, (bound_ms, bound_by)) in timing.items():
        k_ms = time_ms(kern, reps)
        p_ms = time_ms(plain, reps)
        l_ms = time_ms(lib, reps) if lib is not None else None
        errs = results[k]["errs"]
        main_err = max(e for lbl, (e, _) in errs.items() if lbl.startswith("main"))
        rag_err = max(e for lbl, (e, _) in errs.items() if lbl.startswith("ragged"))
        tol = max(t for lbl, (_, t) in errs.items() if lbl.startswith("main"))
        print(f"[time] {k:<18} kernel_ms {k_ms:.4f} launches/run {launches[k]} "
              f"bound_ms {bound_ms:.4f} ({bound_by}) plain_ms {p_ms:.4f} "
              f"library_ms {'-' if l_ms is None else f'{l_ms:.4f}'}")
        src, replaces = KERNELS[k]
        rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": main_err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": l_ms, "tol": tol, "ragged_max_abs_err": rag_err,
            "verdict": "pass",
        })
    torch.cuda.synchronize()
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

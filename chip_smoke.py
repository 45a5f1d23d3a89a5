#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card, ``nvcc`` and this checkout; imports nothing
of JAX or of the reference package.  Phases, each ending in
``torch.cuda.synchronize()``; any failure raises and exits non-zero:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and print
   the build time and the card's name and power limit.
2. Hold each kernel (B1 gram, B2 batched_gram, B3 batched_gram_polar,
   B4 align_average, B5 fused_round, B6 fused_ring_round with f32, bf16
   and int8 wire stacks) against its plain PyTorch version on the card, at
   the main path's shapes and at a ragged shape, max error beside
   tolerance (B5/B6 also the f64 subspace distance; B5 on a rank-deficient
   stack that forces the shifted Cholesky).
3. Drive the main path at the production width of
   ``repro/configs/paper_pca.py`` (d = 8192, r = 128, 65536 samples per
   shard, 2 rounds, 30 subspace-iteration steps), m = 8 shards, shard k
   drawn from the generator seeded from (seed, k):
   * three stacked lanes (``distributed_pca``, one process, topology
     gather, backend cuda): polar svd / newton-schulz with orth qr, and
     newton-schulz with cholesky-qr2, whose rounds are B5 launches;
   * three cross-rank lanes (``distributed_pca_collective``), 8 ranks on
     the one card over gloo, each on its own shard: the fused ring at 32
     and at 8 wire bits (B6 launches), and psum (svd, qr) at 16384
     samples per shard (B2 and B4 per round);
   each lane zeroes the launch counters first and reads them after (the
   counts must be exact), its estimate must be finite, orthonormal and
   within dist_2 < 0.15 of the centralized estimate, the 32-bit ring must
   agree with the B5 lane to 1e-4 f64 subspace distance and the 8-bit ring
   with the 32-bit one to PARITY_TOL[8].  A small run must agree with the
   plain backend, and the launcher runs on the card, once in one process
   and once under ``torchrun`` with 8 ranks on the ring at d = 8192,
   r = 128 and 16384 samples per shard.
4. Time each kernel at the main path's shapes (CUDA events) beside its
   bound, its plain version and one PyTorch call computing the same
   function (none for B3, B5, B6).
5. Print ``{"kernels": [...]}`` (``launches``: every lane of phase 3, the
   cross-rank lanes summed over ranks), then, last, ``{"ok": true,
   "device": ...}``.

``python3 chip_smoke.py --profile`` instead builds, draws the same data
and runs each stacked lane once more under ``torch.profiler`` after a
warm-up lane: it prints the lane's wall time, the device's busy share
and the kernels that took the most device time.  ``--rank K`` is the
cross-rank lanes' worker, started by phase 3.

TF32 is off throughout: the reference computes in float32.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
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
# A whole round (B5/B6) against its plain version: Newton-Schulz's
# summation-order noise, then two CholeskyQR passes of a well-conditioned
# V-bar; and the f64 column-span distance of the two outputs.
ROUND_TOL, ROUND_SD_TOL = 1e-4, 1e-5
STACK_TOL = 1e-4  # ring lane vs the stacked B5 lane (f64 subspace distance)
EPS32 = 2.0 ** -23
# Cross-rank lanes: ranks sharing the card, the psum lane's shard size, and
# ring chunks that do not divide d.
WORLD, N_PSUM = 8, 16384
RING_CHUNK_MAIN, RING_CHUNK_RAGGED = 1000, 33

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
    "fused_round": ("src/repro_torch/kernels/csrc/fused_round.cu",
                    "src/repro/kernels/procrustes_align.py:425"),
    "fused_ring_round": ("src/repro_torch/kernels/csrc/fused_round.cu",
                         "src/repro/kernels/procrustes_align.py:593"),
}
STACKED_LANES = (("svd", "qr"), ("newton-schulz", "qr"),
                 ("newton-schulz", "cholesky-qr2"))
# (name, knobs, samples per shard, launches per rank).
CROSS_LANES = (
    ("ring-32", dict(topology="ring", comm_bits=32, polar="newton-schulz",
                     orth="cholesky-qr2"), N_PER_SHARD,
     {"gram": 1, "fused_ring_round": N_ITER}),
    ("ring-8", dict(topology="ring", comm_bits=8, polar="newton-schulz",
                    orth="cholesky-qr2"), N_PER_SHARD,
     {"gram": 1, "fused_ring_round": N_ITER}),
    ("psum-32", dict(topology="psum", comm_bits=32, polar="svd", orth="qr"),
     N_PSUM, {"gram": 1, "batched_gram": N_ITER, "align_average": N_ITER}),
)


def expected_counts(nonzero: dict) -> dict:
    return {k: nonzero.get(k, 0) for k in KERNELS}


def lane_factor(torch, syn, dev):
    """The main path's covariance factor, drawn from the seed (every
    process that regenerates it gets the same one)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tau = syn.spectrum_m1(D, R, delta=DELTA, device=dev)
    _, u, factor = syn.covariance_from_spectrum(tau, generator=gen)
    return gen, u[:, :R].contiguous(), factor


def rank_worker(rank: int, init: str, out: str) -> int:
    """One rank of the cross-rank lanes: its own shard of the data rule,
    ``distributed_pca_collective`` per lane, counters zeroed before each
    lane; writes its launch counts, walls, staged bytes and estimates."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.comm import transport
    from repro_torch.core import distributed_pca_collective
    from repro_torch.data import synthetic as syn
    from repro_torch.launch.mesh import make_aggregation_mesh

    agg = make_aggregation_mesh(device="cuda", rank=rank, world_size=WORLD,
                                local_rank=rank, local_world=WORLD,
                                init_method=init)
    _, _, factor = lane_factor(torch, syn, agg.device)
    report = {"rule": agg.rule, "backend": agg.backend, "lanes": {}}
    shards = {}
    for name, knobs, n, _ in CROSS_LANES:
        if n not in shards:
            shards = {n: syn.sample_shard(factor, n, seed=SEED, shard=rank)}
        dist.barrier()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        transport.reset_staged_bytes()
        t0 = time.perf_counter()
        v = distributed_pca_collective(
            shards[n], R, group=agg.group, device=agg.device, n_iter=N_ITER,
            solver="subspace", iters=ITERS, backend="cuda",
            ring_chunk=RING_CHUNK_MAIN, **knobs)
        torch.cuda.synchronize()
        report["lanes"][name] = {
            "wall": time.perf_counter() - t0,
            "launches": kernels.launch_counts(),
            "staged_bytes": transport.staged_bytes(),
        }
        torch.save(v.cpu(), os.path.join(out, f"{name}-{rank}.pt"))
    dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(out: str) -> None:
    """Start the WORLD rank workers on this card, wait, and stop them all
    (kill the rest if one fails or the time runs out)."""
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(k),
         "--init", init, "--out", out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(WORLD)]
    logs = []
    try:
        deadline = time.monotonic() + 600
        for p in procs:
            log, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(log)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(k, p.returncode, logs[k][-3000:]) for k, p in enumerate(procs)
           if p.returncode]
    require(not bad, f"rank workers failed: {bad}")


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
              iters=ITERS, backend="cuda", topology="gather")
    distributed_pca(samples, R, polar="svd", orth="qr", **kw)  # warm-up lane
    torch.cuda.synchronize()
    for polar, orth in STACKED_LANES:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            distributed_pca(samples, R, polar=polar, orth=orth, **kw)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")]
        busy_us = sum(e.self_device_time_total for e in kernels)
        print(f"[profile] polar={polar} orth={orth}: wall {wall_us / 1e3:.1f} ms under the "
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
                    help="profile the stacked main-path lanes instead of the checks")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
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
    if args.rank is not None:
        return rank_worker(args.rank, args.init, args.out)
    sys.path.insert(0, SRC)

    from repro_torch import kernels
    from repro_torch.comm import PARITY_TOL, get_codec, shard_generator
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
    from repro_torch.kernels.procrustes_align import DEFAULT_NS_ITERS
    from repro_torch.kernels.covariance import gram
    from repro_torch.kernels.procrustes_align import (
        align_average,
        batched_gram,
        batched_gram_polar,
        fused_ring_round,
        fused_round,
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
    gen, v_true, factor = lane_factor(torch, syn, dev)
    samples = syn.sample_shards(factor, N_PER_SHARD, seed=SEED, shards=SHARDS)
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

    def hold_round(kernel, label, got, want):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        sd = subspace_dist64(got, want)
        ok = (math.isfinite(err) and err <= ROUND_TOL and sd <= ROUND_SD_TOL
              and bool(torch.isfinite(got).all()))
        print(f"[check] {kernel:<18} {label:<34} max_abs_err {err:.3e} tol "
              f"{ROUND_TOL:.0e} subspace_dist64 {sd:.3e} tol {ROUND_SD_TOL:.0e} "
              f"{'ok' if ok else 'FAIL'}")
        results[kernel]["errs"][label] = (err, ROUND_TOL)
        require(ok, f"{kernel} disagrees with its plain version at {label}")

    def int8_wire(vs):
        """Each machine's basis through the port's int8 codec."""
        codec = get_codec(8)
        enc = [codec.encode(v, shard_generator(1, i, 0, dev)) for i, v in enumerate(vs)]
        return (torch.stack([q for q, _ in enc]).contiguous(),
                torch.stack([s for _, s in enc]).contiguous())

    wires = {}
    for (label, vs), chunk in zip(stacks.items(), (RING_CHUNK_MAIN, RING_CHUNK_RAGGED)):
        rf = vs[0].contiguous()
        for n_iter in (1, 2):
            hold_round("fused_round", f"{label} n_iter={n_iter}",
                       fused_round(vs, rf, n_iter=n_iter),
                       ref.fused_round(vs, rf, n_iter=n_iter))
        if label.startswith("main"):
            print(f"[check] fused_round grid: {fused_round.grid} blocks "
                  f"(cooperative, co-resident)")
            deficient = vs.clone()
            deficient[:, :, -1] = 0  # V-bar of rank r - 1: the shifted factor
            hold_round("fused_round", f"{label} rank-deficient",
                       fused_round(deficient, deficient[0].contiguous()),
                       ref.fused_round(deficient, deficient[0].contiguous()))
        q, sc = int8_wire(vs)
        wires[label] = {"f32": (vs, None), "bf16": (vs.to(torch.bfloat16), None),
                        "int8": (q, sc)}
        for wire, (w, sc) in wires[label].items():
            hold_round("fused_ring_round", f"{label} {wire} chunk={chunk}",
                       fused_ring_round(w, rf, sc, ring_chunk=chunk),
                       ref.fused_ring_round(w, rf, sc))
    torch.cuda.synchronize()

    # -- phase 3: the main path --------------------------------------------
    covs = torch.stack([empirical_covariance(x, backend="torch") for x in xs])
    v_cent, _ = central_estimate(covs, R)  # plain cuBLAS covariance + eigh
    del covs
    torch.cuda.synchronize()
    print(f"[central] dist_2(central, truth) {dist_2(v_cent, v_true).item():.4e}")
    launches = {k: 0 for k in KERNELS}
    estimates = {}
    for polar, orth in STACKED_LANES:
        expected = expected_counts({
            "gram": SHARDS,
            **({"fused_round": N_ITER} if orth == "cholesky-qr2" else
               {"batched_gram" if polar == "svd" else "batched_gram_polar": N_ITER,
                "align_average": N_ITER}),
        })
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        v = distributed_pca(
            samples, R, shards=SHARDS, device=dev, n_iter=N_ITER,
            solver="subspace", iters=ITERS, backend="cuda", polar=polar,
            orth=orth, topology="gather",
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        for k in KERNELS:
            launches[k] += counts[k]
        estimates[(polar, orth)] = v
        d_cent = dist_2(v, v_cent).item()
        ortho = (v.mT @ v - torch.eye(R, device=dev)).abs().max().item()
        print(f"[main] polar={polar} orth={orth} backend=cuda topology=gather "
              f"m={SHARDS} n={N_PER_SHARD} d={D} r={R}: wall {wall:.2f} s, "
              f"launches { {k: c for k, c in counts.items() if c} }, "
              f"dist_2(v, central) {d_cent:.4e}, "
              f"dist_2(v, truth) {dist_2(v, v_true).item():.4e}, "
              f"|V^T V - I|max {ortho:.2e}")
        lane = f"lane {polar}/{orth}"
        require(counts == expected, f"{lane}: launches {counts}, expected {expected}")
        require(tuple(v.shape) == (D, R) and bool(torch.isfinite(v).all()),
                f"{lane}: non-finite or misshapen estimate")
        require(ortho < 1e-4, f"{lane}: estimate not orthonormal")
        require(d_cent < DIST_BAR,
                f"{lane}: dist_2(v, central) {d_cent} >= {DIST_BAR}")
    v_b5 = estimates[("newton-schulz", "cholesky-qr2")]
    del samples, xs, x0

    # The cross-rank lanes: WORLD ranks on this card over gloo, each on its
    # own shard; the psum lane's centralized estimate from its own data.
    covs = torch.stack([
        empirical_covariance(syn.sample_shard(factor, N_PSUM, seed=SEED, shard=k),
                             backend="torch")
        for k in range(WORLD)])
    v_cent_psum, _ = central_estimate(covs, R)
    del covs
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        run_ranks(out)
        print(f"[ranks] {WORLD} rank processes on {name} done in "
              f"{time.perf_counter() - t0:.1f} s")
        reports = []
        for k in range(WORLD):
            with open(os.path.join(out, f"rank{k}.json")) as f:
                reports.append(json.load(f))
        ests = {lane: [torch.load(os.path.join(out, f"{lane}-{k}.pt")).to(dev)
                       for k in range(WORLD)] for lane, *_ in CROSS_LANES}
    print(f"[ranks] transport: {reports[0]['backend']} ({reports[0]['rule']})")
    for lane, knobs, n, nonzero in CROSS_LANES:
        expected = expected_counts(nonzero)
        lane_reps = [rep["lanes"][lane] for rep in reports]
        for k, rep in enumerate(lane_reps):
            require(rep["launches"] == expected,
                    f"{lane} rank {k}: launches {rep['launches']}, expected {expected}")
            for kern, c in rep["launches"].items():
                launches[kern] += c
        v = ests[lane][0]
        spread = max(subspace_dist64(e, v) for e in ests[lane][1:])
        cent = v_cent_psum if lane.startswith("psum") else v_cent
        d_cent = dist_2(v, cent).item()
        ortho = (v.mT @ v - torch.eye(R, device=dev)).abs().max().item()
        extra = ""
        if lane == "ring-32":
            sd = subspace_dist64(v, v_b5)
            extra = f", subspace_dist64(v, B5 lane) {sd:.3e} (tol {STACK_TOL:.0e})"
            require(sd <= STACK_TOL, f"{lane}: {sd} from the stacked B5 lane")
        elif lane == "ring-8":
            sd = subspace_dist64(v, ests["ring-32"][0])
            extra = (f", subspace_dist64(v, ring-32) {sd:.3e} "
                     f"(tol PARITY_TOL[8] = {PARITY_TOL[8]})")
            require(sd <= PARITY_TOL[8], f"{lane}: {sd} from the 32-bit ring")
        print(f"[ranks] {lane} {knobs['polar']}/{knobs['orth']} backend=cuda "
              f"m={WORLD} n={n} d={D} r={R}: wall {max(r['wall'] for r in lane_reps):.2f} s "
              f"(slowest rank), launches/rank { {k: c for k, c in expected.items() if c} }, "
              f"staged {lane_reps[0]['staged_bytes'] / 1e6:.1f} MB/rank, "
              f"rank spread {spread:.1e}, dist_2(v, central) {d_cent:.4e}, "
              f"|V^T V - I|max {ortho:.2e}{extra}")
        require(bool(torch.isfinite(v).all()) and ortho < 1e-4,
                f"{lane}: non-finite or non-orthonormal estimate")
        require(spread <= ROUND_SD_TOL, f"{lane}: ranks disagree by {spread}")
        require(d_cent < DIST_BAR, f"{lane}: dist_2(v, central) {d_cent} >= {DIST_BAR}")
    del ests, factor

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

    # The launcher under torchrun: WORLD ranks on this card, the fused ring,
    # at the production width with N_PSUM samples per shard.  The width
    # flags take their long spellings: some torchrun versions read "--d"
    # and "--r" as prefixes of their own options.
    run_cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.eigen",
               "--device", "cuda", "--topology", "ring", "--polar",
               "newton-schulz", "--orth", "cholesky-qr2", "--dim", str(D),
               "--subspace-rank", str(R), "--n-per-shard", str(N_PSUM)]
    t0 = time.monotonic()
    cli = subprocess.run(run_cmd, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": SRC})
    require(cli.returncode == 0, f"torchrun launcher failed:\n{cli.stderr[-4000:]}")
    stats = dict(line.split(": ", 1) for line in cli.stdout.strip().splitlines()
                 if ": " in line)
    print(f"[cli] torchrun --nproc-per-node {WORLD} repro_torch.launch.eigen "
          f"--topology ring --polar newton-schulz --orth cholesky-qr2 --dim {D} "
          f"--subspace-rank {R} --n-per-shard {N_PSUM} ({time.monotonic() - t0:.1f} s): "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("ranks", "d", "r", "backend", "topology", "transport",
                       "staged_bytes", "dist_aligned", "dist_central",
                       "dist_naive", "wall_s")))
    require(stats["backend"] == "cuda" and stats["topology"] == "ring"
            and stats["ranks"] == str(WORLD)
            and (stats["d"], stats["r"]) == (str(D), str(R)),
            "torchrun launcher: wrong lane or width")
    require(float(stats["dist_aligned"]) < min(DIST_BAR, float(stats["dist_naive"])),
            "torchrun launcher: estimate not within the bar or no better than naive")
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
    round_flops = (4.0 * m * d * r * r + 8.0 * d * r * r
                   + DEFAULT_NS_ITERS * m * 4.0 * r ** 3)
    wire = wires["main (8, 8192, 128)"]
    timing["fused_round"] = (
        lambda: fused_round(vs, rf), lambda: ref.fused_round(vs, rf), None, 20,
        bound(round_flops, stack_bytes + 4 * d * r))
    ring_ms = {}
    for wname, (w, sc) in wire.items():
        wbytes = w.numel() * w.element_size() + 4 * 2 * d * r + (
            0 if sc is None else sc.numel() * 4)
        ring_ms[wname] = (
            time_ms(lambda: fused_ring_round(w, rf, sc), 20),
            time_ms(lambda: ref.fused_ring_round(w, rf, sc), 20),
            bound(round_flops, wbytes))
        print(f"[time] fused_ring_round {wname:<5} kernel_ms {ring_ms[wname][0]:.4f} "
              f"bound_ms {ring_ms[wname][2][0]:.4f} ({ring_ms[wname][2][1]}) "
              f"plain_ms {ring_ms[wname][1]:.4f}")
    w32, _ = wire["f32"]
    timing["fused_ring_round"] = (
        lambda: fused_ring_round(w32, rf), lambda: ref.fused_ring_round(w32, rf),
        None, 20, ring_ms["f32"][2])
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
        if k == "fused_ring_round":
            rows[-1]["by_wire"] = {
                wname: {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2][0],
                        "bound_by": t[2][1]} for wname, t in ring_ms.items()}
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

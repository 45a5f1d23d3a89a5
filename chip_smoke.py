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
   stack that forces the shifted Cholesky).  B7 fused_ring_round_remote
   needs a world of ranks: the rank processes of phase 3 hold it against
   its plain version first, at 8 ranks x (8192, 128) and on a subgroup
   of 3 ranks at (1000, 7), and the ranks' outputs must agree.  B1 must
   give the same bits with the reference's ``symmetric`` option as
   without (the kernel always mirrors its upper tiles); B3 and B5 are also
   held at r = 192 and 256, where their Newton-Schulz and Cholesky tiles
   live in a global workspace.  B2 (one launch, the splits of d summed
   across a thread-block cluster; B3's first pass) must give the same bits
   on a second call, and prints its plan (rows a split, cluster size);
   B5 and B6 print the Newton-Schulz form they ran (a group of blocks a
   machine up to r = 136).
3. Drive the main path at the production width of
   ``repro/configs/paper_pca.py`` (d = 8192, r = 128, 65536 samples per
   shard, 2 rounds, 30 subspace-iteration steps), m = 8 shards, shard k
   drawn from the generator seeded from (seed, k):
   * three stacked lanes (``distributed_pca``, one process, topology
     gather, backend cuda): polar svd / newton-schulz with orth qr, and
     newton-schulz with cholesky-qr2, whose rounds are B5 launches;
   * a fourth stacked lane (newton-schulz, qr) on the psum lanes' data,
     16384 samples per shard, which the hier lanes are held to;
   * six cross-rank lanes, 8 ranks on the one card over gloo, each on its
     own shard: the fused ring at 32 and at 8 wire bits (B6 launches);
     remote-32, the local basis and the 32-bit reference into 2 rounds of
     B7 (``comm.ring.remote_ring_rounds``; hops by CUDA IPC peer writes),
     run again with rank 3's first launch delayed 2 s by a host sleep; and
     at 16384 samples per shard psum (svd, qr; B2 and B4 per round) and
     hier-32 / hier-8 over 2 pods x 4 ranks (newton-schulz, qr; B3 and B4
     per round), whose bytes handed to ``torch.distributed`` per level
     must equal ``comm_cost(...).levels``;
   each lane zeroes the launch counters first and reads them after (the
   counts must be exact), its estimate must be finite, orthonormal and
   within dist_2 < 0.15 of the centralized estimate, the 32-bit ring must
   agree with the B5 lane to 1e-4 f64 subspace distance, the 8-bit ring
   with the 32-bit one to PARITY_TOL[8], remote-32 (skewed or not) with
   the 32-bit ring to 1e-4, and hier-32 / hier-8 with their stacked lane
   to 1e-4 / PARITY_TOL[8].  A small run must agree with the plain
   backend, and the launcher runs on the card, once in one process and
   twice under ``torchrun`` with 8 ranks at d = 8192, r = 128 and 16384
   samples per shard: on the ring, and on hier with 2 pods.
   Then the serving lane, with the PCA data freed first: B8
   (``flash_attention``) against its plain version at the serving shape
   (b 4, hq 24, hkv 8, s = t = 4096, hd 128, bf16, causal) and at ragged
   ones (GQA s 96 / t 160 in bf16 and f32, s > t with its zero rows,
   windows 16 and 1024, MQA, and s, t and windows at the bf16 kernel's
   128-row and 128-key tile edges, and head_dim 136, 192 and 256 through
   the wide kernel; each check names the kernel form that the library
   reports it launched; bf16 also
   per query row, see ``FLASH_ROW_REL``); then the serve lane
   (``repro_torch.launch.serve``'s ``load`` and ``generate``, which
   ``serve`` is made of) at the full
   ``llama3.2-3b`` config (28 layers, d_model 3072), 4 prompts of 4096
   tokens and 32 greedy tokens each, weights from a seeded generator on
   the card: exactly 28 flash launches in the prefill and none in
   decode; the served model and prompts prefilled again through the
   kernel and through plain attention must give
   last-position logits within ``SERVE_REL_L2`` / ``SERVE_MAX_ABS``; and
   the serve launcher once in its own process at the full config with a
   short prompt.
4. Time each kernel at the main path's shapes (CUDA events) beside its
   bound, its plain version and one PyTorch call computing the same
   function (none for B3, B5, B6, B7; the einsum for B2 and B4; SDPA for
   B8); B8 also the TFLOP/s
   it reaches on its MMA work (S, and PV for p_hi and p_lo).  B1 beside
   the bound of the work the function needs (n d (d + 1) FLOP), the full
   product's (2 n d^2) and ``x.T @ x``, with its TFLOP/s; B3 and B5 at
   r = 192 and 256; B8's wide kernel at recurrentgemma-2b's local
   attention shape (b 4, hq 10, hkv 1, s = t = 4096, hd 256, window
   2048, bf16).  B7 is
   timed in the rank world, per round on every rank, against the bound
   of the 8 ranks' work on the one card.
5. Print ``{"kernels": [...]}`` (``launches``: every lane of phase 3, the
   cross-rank lanes summed over ranks, B8's the serve call), then, last,
   ``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --profile`` instead builds, draws the same data
and runs each stacked lane once more under ``torch.profiler`` after a
warm-up lane, then one full-width ``llama3.2-3b`` prefill (and a few
decode steps) after a warm-up prefill: it prints each run's wall time,
the device's busy share and the kernels that took the most device
time.  ``--rank K`` is the
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
# The hier lanes' pods (2 pods x 4 local ranks); B7's ragged check (odd m on
# a subgroup of ranks, d and r off every tile); the remote lane's delayed
# rank and its host sleep before its first launch; B7's timed rounds.
PODS = 2
B7_RAGGED = (3, 1000, 7)
SKEW_RANK, SKEW_S = 3, 2.0
B7_REPS, B7_PLAIN_REPS = 10, 3

# FP32 CUDA-core peak, memory rate and dense bf16 tensor-core peak (NVIDIA
# data sheets), by card name.
PEAKS = (
    ("PCIe", "H100 PCIe", 51.2e12, 2.0e12, 756e12),
    ("NVL", "H100 NVL", 60.0e12, 3.9e12, 835e12),
    ("", "H100 SXM", 67.0e12, 3.35e12, 989e12),
)

# The serving lane: llama3.2-3b at its full config, 4 requests of 4096
# prompt tokens, 32 greedy tokens each.
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "llama3.2-3b", 4, 4096, 32
# B3 / B5 past the shared-memory Newton-Schulz tiles (r > 136).
WIDE_RS = (192, 256)
# B8's wide kernel timed at recurrentgemma-2b's local attention shape.
FLASH_WIDE = ((4, 10, 1, 4096, 4096, 256), "bfloat16", 2048)
# B8 checks: (label, (b, hq, hkv, s, t, hd), dtype, window).  Causal all.
FLASH_CHECKS = (
    ("main (4, 24/8, 4096x4096, 128) bf16", (4, 24, 8, 4096, 4096, 128), "bfloat16", None),
    ("ragged (1, 4/2, 96x160, 64) bf16", (1, 4, 2, 96, 160, 64), "bfloat16", None),
    ("ragged (1, 4/2, 96x160, 64) f32", (1, 4, 2, 96, 160, 64), "float32", None),
    ("ragged s>t (1, 2/1, 160x96, 32) f32", (1, 2, 1, 160, 96, 32), "float32", None),
    ("ragged s>t (1, 2/1, 160x96, 32) bf16", (1, 2, 1, 160, 96, 32), "bfloat16", None),
    ("ragged window 16 (2, 8/2, 300x300, 128) bf16", (2, 8, 2, 300, 300, 128), "bfloat16", 16),
    ("ragged window 16 (1, 4/2, 200x200, 64) f32", (1, 4, 2, 200, 200, 64), "float32", 16),
    ("ragged window 1024 (1, 8/2, 2500x2500, 128) bf16", (1, 8, 2, 2500, 2500, 128), "bfloat16", 1024),
    ("ragged MQA (2, 8/1, 200x200, 64) bf16", (2, 8, 1, 200, 200, 64), "bfloat16", None),
    # At the bf16 kernel's 128-row query tile and 128-key K/V tile edges.
    ("ragged edge (1, 4/2, 128x128, 128) bf16", (1, 4, 2, 128, 128, 128), "bfloat16", None),
    ("ragged edge (1, 4/2, 129x257, 128) bf16", (1, 4, 2, 129, 257, 128), "bfloat16", None),
    ("ragged edge (2, 8/4, 127x1000, 80) bf16", (2, 8, 4, 127, 1000, 80), "bfloat16", None),
    ("ragged edge s>t (1, 4/2, 257x129, 64) bf16", (1, 4, 2, 257, 129, 64), "bfloat16", None),
    ("ragged edge window 128 (1, 4/2, 300x300, 128) bf16", (1, 4, 2, 300, 300, 128),
     "bfloat16", 128),
    ("ragged edge window 129 (1, 4/2, 300x300, 128) bf16", (1, 4, 2, 300, 300, 128),
     "bfloat16", 129),
    # head_dim past 128: the wide kernel, both dtypes.
    ("ragged hd 136 (1, 4/2, 300x300) bf16", (1, 4, 2, 300, 300, 136), "bfloat16", None),
    ("ragged hd 192 window 16 (1, 4/2, 200x457) f32", (1, 4, 2, 200, 457, 192),
     "float32", 16),
    ("ragged hd 256 (2, 10/1, 1000x1000) bf16", (2, 10, 1, 1000, 1000, 256), "bfloat16", None),
    ("ragged hd 256 window 128 (1, 4/2, 300x300) f32", (1, 4, 2, 300, 300, 256),
     "float32", 128),
    ("ragged hd 256 s>t (1, 2/1, 160x96) bf16", (1, 2, 1, 160, 96, 256), "bfloat16", None),
)
# The reference's own kernel-test bars (tests/test_kernels.py:122, :146).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# bf16 outputs are also held per query row to a bar scaled to that row:
# max|got - want| <= 2^-7 max|want_row| + 1e-4.  Both sides round the same
# f32 row to bf16 once, which moves an element by at most one step,
# 2^-7 of its magnitude.  At the serving shape a causal row i averages
# ~i keys, so |out| falls as ~1/sqrt(i) and 3e-2 is as large as a typical
# long-row value; a key tile dropped or stale on the long rows (error
# ~8/i) stays under 3e-2 but fails the row bar.
FLASH_ROW_REL, FLASH_ROW_ABS = 2.0**-7, 1e-4
# Kernel prefill vs plain-attention prefill, last-position logits, bf16 at
# 28 layers.  The paths differ in the probabilities (the kernel keeps ~16
# bits, the plain path rounds them to bf16, attn_probs_bf16) and hence in
# the bf16 rounding of every layer's output.  At 28 layers on the CPU
# (tests/test_torch_lm.py::test_full_depth_flash_path_within_serving_bars,
# d_model 256, 256 tokens) the gap is ~1.4 % relative L2 and ~1.5 % of
# the largest logit; the bars leave 3-5x for the full width.
SERVE_REL_L2, SERVE_MAX_ABS = 0.05, 0.08

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
    "fused_ring_round_remote": ("src/repro_torch/kernels/csrc/fused_ring_remote.cu",
                                "src/repro/kernels/procrustes_align.py:744"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:122"),
}
STACKED_LANES = (("svd", "qr"), ("newton-schulz", "qr"),
                 ("newton-schulz", "cholesky-qr2"))
# (name, knobs, samples per shard, launches per rank); remote-32 has no
# knobs: its rounds are B7 launches (``comm.ring.remote_ring_rounds``).
CROSS_LANES = (
    ("ring-32", dict(topology="ring", comm_bits=32, polar="newton-schulz",
                     orth="cholesky-qr2"), N_PER_SHARD,
     {"gram": 1, "fused_ring_round": N_ITER}),
    ("ring-8", dict(topology="ring", comm_bits=8, polar="newton-schulz",
                    orth="cholesky-qr2"), N_PER_SHARD,
     {"gram": 1, "fused_ring_round": N_ITER}),
    ("remote-32", None, N_PER_SHARD, {"gram": 1, "fused_ring_round_remote": N_ITER}),
    ("psum-32", dict(topology="psum", comm_bits=32, polar="svd", orth="qr"),
     N_PSUM, {"gram": 1, "batched_gram": N_ITER, "align_average": N_ITER}),
    ("hier-32", dict(topology="hier", comm_bits=32, polar="newton-schulz", orth="qr"),
     N_PSUM, {"gram": 1, "batched_gram_polar": N_ITER, "align_average": N_ITER}),
    ("hier-8", dict(topology="hier", comm_bits=8, polar="newton-schulz", orth="qr"),
     N_PSUM, {"gram": 1, "batched_gram_polar": N_ITER, "align_average": N_ITER}),
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


def noisy_stack(torch, gen, m, d, r, dev):
    """Noisy copies of one subspace (the paper's setting): an (m, d, r)
    stack of orthonormal bases, contiguous."""
    base = torch.linalg.qr(torch.randn(d, r, generator=gen, device=dev))[0]
    noise = torch.randn(m, d, r, generator=gen, device=dev) * (0.1 / math.sqrt(d))
    return torch.linalg.qr(base[None] + noise)[0].contiguous()


def count_handed(dist) -> dict:
    """Wrap the collectives of ``torch.distributed`` to count the payload
    bytes this process hands them, by group id; returns the live dict."""
    handed = {}

    def add(group, t):
        handed[id(group)] = handed.get(id(group), 0) + t.numel() * t.element_size()

    def counting(fn, pos):
        def call(*args, **kw):
            add(kw.get("group"), args[pos])
            return fn(*args, **kw)
        return call

    gather = "all_gather_single" if hasattr(dist, "all_gather_single") else "all_gather_into_tensor"
    for name, pos in (("all_reduce", 0), ("broadcast", 0), (gather, 1)):
        setattr(dist, name, counting(getattr(dist, name), pos))
    p2p = dist.batch_isend_irecv

    def batch(ops):
        for op in ops:
            if getattr(op.op, "__name__", "") == "isend":
                add(op.group, op.tensor)
        return p2p(ops)

    dist.batch_isend_irecv = batch
    return handed


def rank_worker(rank: int, init: str, out: str) -> int:
    """One rank of the cross-rank lanes.  Phase 2: B7 against its plain
    version (main and ragged shapes).  Phase 3: each lane of CROSS_LANES on
    this rank's shard of the data rule, counters zeroed before each lane,
    plus the remote lane again with rank SKEW_RANK's launch delayed.
    Phase 4: B7's time per round.  Writes its report and estimates."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.comm import transport
    from repro_torch.comm.ring import remote_ring_rounds
    from repro_torch.comm.topology import broadcast_from
    from repro_torch.core import (
        distributed_pca_collective,
        empirical_covariance,
        local_eigenbasis,
        subspace_dist64,
    )
    from repro_torch.data import synthetic as syn
    from repro_torch.interop import strict_fp32
    from repro_torch.kernels import procrustes_align as pa
    from repro_torch.launch.mesh import make_aggregation_mesh

    strict_fp32()
    agg = make_aggregation_mesh(device="cuda", rank=rank, world_size=WORLD,
                                local_rank=rank, local_world=WORLD,
                                init_method=init, pods=PODS)
    dev, world = agg.device, agg.group
    handed = count_handed(dist)
    levels = {"intra": id(agg.local_group), "inter": id(agg.pod_group)}
    report = {"rule": agg.rule, "backend": agg.backend, "lanes": {}, "b7": {}}

    # Phase 2: B7 against its plain version (comparison launches).
    def hold_b7(label, v, ref, group):
        got = pa.fused_ring_round_remote(v, ref, group=group)
        want = pa.plain_remote(v, ref, group=group)
        torch.cuda.synchronize()
        report["b7"][label] = {
            "err": (got - want).abs().max().item(), "sd": subspace_dist64(got, want),
            "finite": bool(torch.isfinite(got).all()),
            "grid": pa.fused_ring_round_remote.grid}
        return got

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    vs = noisy_stack(torch, gen, WORLD, D, R, dev)
    v_b7, ref_b7 = vs[rank].contiguous(), vs[0].contiguous()
    got = hold_b7(f"main ({WORLD} ranks, {D}, {R})", v_b7, ref_b7, world)
    torch.save(got.cpu(), os.path.join(out, f"b7-main-{rank}.pt"))
    m_rag, d_rag, r_rag = B7_RAGGED
    sub = dist.new_group(list(range(m_rag)))
    rag = noisy_stack(torch, gen, m_rag, d_rag, r_rag, dev)
    if rank < m_rag:
        hold_b7(f"ragged ({m_rag} ranks, {d_rag}, {r_rag})", rag[rank].contiguous(),
                rag[0].contiguous(), sub)
    dist.barrier()

    # Phase 3: the lanes.
    _, _, factor = lane_factor(torch, syn, dev)
    shards = {}
    for name, knobs, n, _ in CROSS_LANES:
        if n not in shards:
            shards = {n: syn.sample_shard(factor, n, seed=SEED, shard=rank)}
        dist.barrier()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        transport.reset_staged_bytes()
        handed.clear()
        t0 = time.perf_counter()
        if knobs is None:
            v = local_eigenbasis(empirical_covariance(shards[n], backend="cuda"), R,
                                 method="subspace", iters=ITERS)[0]
            est = remote_ring_rounds(v, group=world, n_iter=N_ITER)
        else:
            hier = knobs["topology"] == "hier"
            est = distributed_pca_collective(
                shards[n], R, group=agg.local_group if hier else world,
                pod_group=agg.pod_group if hier else None, device=dev,
                n_iter=N_ITER, solver="subspace", iters=ITERS, backend="cuda",
                ring_chunk=RING_CHUNK_MAIN, **knobs)
        torch.cuda.synchronize()
        report["lanes"][name] = {
            "wall": time.perf_counter() - t0,
            "launches": kernels.launch_counts(),
            "staged_bytes": transport.staged_bytes(),
            "handed": {lv: handed.get(g, 0) for lv, g in levels.items()},
        }
        torch.save(est.cpu(), os.path.join(out, f"{name}-{rank}.pt"))
        if knobs is None:
            # The same rounds on the same basis, rank SKEW_RANK's first
            # launch delayed by a host sleep: its neighbours' kernels wait.
            ref = broadcast_from(v, src=0, group=world)
            dist.barrier()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            if rank == SKEW_RANK:
                time.sleep(SKEW_S)
            est = remote_ring_rounds(v, ref, group=world, n_iter=N_ITER)
            torch.cuda.synchronize()
            report["lanes"]["remote-32 skewed"] = {
                "wall": time.perf_counter() - t0, "launches": kernels.launch_counts()}
            torch.save(est.cpu(), os.path.join(out, f"remote-32 skewed-{rank}.pt"))
    del shards

    # Phase 4: B7 per round at the main shape, CUDA events around B7_REPS
    # rounds on every rank (each round waits for its status word), and the
    # host clock from a common barrier.
    def per_round(fn, reps):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, 1e3 * (time.perf_counter() - t0) / reps

    report["b7_time"] = {
        "kernel": per_round(lambda: pa.fused_ring_round_remote(v_b7, ref_b7, group=world),
                            B7_REPS),
        "plain": per_round(lambda: pa.plain_remote(v_b7, ref_b7, group=world),
                           B7_PLAIN_REPS),
    }
    pa.close_remote(world)
    pa.close_remote(sub)
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


def print_profile(label, prof, wall_us, top=12) -> None:
    """Wall, device busy share (kernel time over wall) and the kernels
    that took the most device time, from one profiled window."""
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms under the profiler, "
          f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f} %), "
          f"{len(kernels)} kernel names")
    if not kernels:
        print("[profile] the profiler saw no device time: not measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile]   {e.self_device_time_total / 1e3:10.2f} ms "
              f"{100 * e.self_device_time_total / max(busy_us, 1):5.1f} % "
              f"x{e.count:<5d} {e.key[:90]}")


def profiled(torch, fn):
    """Run ``fn`` under torch.profiler; returns (profile, wall in us)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return prof, wall_us


def profile_lanes(torch, distributed_pca, samples, dev) -> None:
    """Each stacked main-path lane under torch.profiler, after a warm-up."""
    kw = dict(shards=SHARDS, device=dev, n_iter=N_ITER, solver="subspace",
              iters=ITERS, backend="cuda", topology="gather")
    distributed_pca(samples, R, polar="svd", orth="qr", **kw)  # warm-up lane
    torch.cuda.synchronize()
    for polar, orth in STACKED_LANES:
        prof, wall_us = profiled(
            torch, lambda: distributed_pca(samples, R, polar=polar, orth=orth, **kw))
        print_profile(f"polar={polar} orth={orth}", prof, wall_us)


def profile_serving(torch, dev) -> None:
    """The serving lane's device time: one full-width prefill and 8 decode
    steps of SERVE_ARCH under torch.profiler, after a warm-up prefill."""
    from repro_torch.launch.serve import load

    model, prompts = load(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                          reduced=False, device=dev, seed=SEED)
    cache_len = SERVE_PROMPT + 8
    model.prefill(prompts, cache_len=cache_len)  # warm-up
    torch.cuda.synchronize()
    out = []
    prof, wall_us = profiled(
        torch, lambda: out.append(model.prefill(prompts, cache_len=cache_len)))
    print_profile(f"{SERVE_ARCH} prefill {SERVE_BATCH} x {SERVE_PROMPT}", prof, wall_us, top=16)
    logits, cache = out[0]

    def decode():
        tok = logits.argmax(-1)[:, None]
        for i in range(8):
            step, _ = model.decode_step(tok, cache, SERVE_PROMPT + i)
            tok = step.argmax(-1)[:, None]

    prof, wall_us = profiled(torch, decode)
    print_profile(f"{SERVE_ARCH} 8 decode steps, batch {SERVE_BATCH}", prof, wall_us)


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
    from repro_torch.comm import PARITY_TOL, comm_cost, get_codec, shard_generator
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
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate, load
    from repro_torch.kernels import procrustes_align as pa
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
    peak_flops, peak_bw, peak_bf16, peak_row = next(
        (f, b, t, row) for key, row, f, b, t in PEAKS if key in name
    )
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| bounds from the {peak_row} data sheet: "
          f"{peak_flops / 1e12:.1f} TFLOP/s FP32, {peak_bf16 / 1e12:.0f} TFLOP/s "
          f"bf16 dense, {peak_bw / 1e12:.2f} TB/s")

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
        del samples, xs
        torch.cuda.empty_cache()
        profile_serving(torch, dev)
        return 0

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
        full, sym = gram(x), gram(x, symmetric=True)
        hold("gram", label, full, want, tol)
        same = torch.equal(full, sym)
        print(f"[check] {'gram':<18} {label:<34} same bits with symmetric=True "
              f"{same} {'ok' if same else 'FAIL'}")
        require(same, f"gram: symmetric=True changed the bits at {label}")
        del want, full, sym
    x_stack = torch.randn(2, RAGGED_N, RAGGED_D, generator=gen, device=dev)
    want = ref.gram(x_stack)
    hold("gram", "ragged stack (2, 257, 205)", gram(x_stack), want,
         sum_tol(RAGGED_N, want.abs().max().item()))

    stacks = {
        "main (8, 8192, 128)": noisy_stack(torch, gen, SHARDS, D, R, dev),
        "ragged (3, 205, 5)": noisy_stack(torch, gen, RAGGED_M, RAGGED_D, RAGGED_R, dev),
    }
    gram_plan = {}
    for label, vs in stacks.items():
        m, d, r = vs.shape
        rf = vs[0].contiguous()
        g_want = ref.batched_gram(vs, rf)
        g_got = batched_gram(vs, rf)
        hold("batched_gram", label, g_got, g_want, sum_tol(d, g_want.abs().max().item()))
        rows, cluster = gram_plan[label] = pa._gram_plan(
            d, m, r, pa._cluster_slots(dev.index).__getitem__)
        same = torch.equal(g_got, batched_gram(vs, rf))
        print(f"[check] {'batched_gram':<18} {label:<34} one launch, clusters of "
              f"{cluster} x {rows} rows (clusters the card holds at once, by "
              f"size: {pa._cluster_slots(dev.index)}); same bits on a second "
              f"call {same} {'ok' if same else 'FAIL'}")
        require(same, f"batched_gram: a second call changed the bits at {label}")
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

    # B3 and B5 past r = 136: Newton-Schulz and Cholesky tiles in the
    # global workspace.
    wide_stacks = {}
    for r in WIDE_RS:
        vs = noisy_stack(torch, gen, SHARDS, D, r, dev)
        rf = vs[0].contiguous()
        hold("batched_gram_polar", f"wide ({SHARDS}, {D}, {r})",
             batched_gram_polar(vs, rf), ref.batched_gram_polar(vs, rf), NS_TOL)
        hold_round("fused_round", f"wide ({SHARDS}, {D}, {r})", fused_round(vs, rf),
                   ref.fused_round(vs, rf))
        wide_stacks[r] = vs

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
                  f"(cooperative, co-resident); Newton-Schulz {fused_round.last_form}")
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
        print(f"[check] fused_ring_round {label}: Newton-Schulz "
              f"{fused_ring_round.last_form}")
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

    # The psum and hier lanes' data (N_PSUM samples per shard): its
    # centralized estimate, and the stacked lane the hier lanes are held to.
    samples = torch.cat([syn.sample_shard(factor, N_PSUM, seed=SEED, shard=k)
                         for k in range(WORLD)])
    covs = torch.stack([empirical_covariance(x, backend="torch")
                        for x in samples.reshape(WORLD, N_PSUM, D)])
    v_cent_psum, _ = central_estimate(covs, R)
    del covs
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    v_stack_psum = distributed_pca(
        samples, R, shards=WORLD, device=dev, n_iter=N_ITER, solver="subspace",
        iters=ITERS, backend="cuda", polar="newton-schulz", orth="qr",
        topology="gather")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    expected = expected_counts({"gram": WORLD, "batched_gram_polar": N_ITER,
                                "align_average": N_ITER})
    for k in KERNELS:
        launches[k] += counts[k]
    d_cent = dist_2(v_stack_psum, v_cent_psum).item()
    print(f"[main] polar=newton-schulz orth=qr backend=cuda topology=gather "
          f"m={WORLD} n={N_PSUM} d={D} r={R} (the hier lanes' stacked lane): wall "
          f"{time.perf_counter() - t0:.2f} s, launches { {k: c for k, c in counts.items() if c} }, "
          f"dist_2(v, central) {d_cent:.4e}")
    require(counts == expected, f"stacked N_PSUM lane: launches {counts}, expected {expected}")
    require(d_cent < DIST_BAR, f"stacked N_PSUM lane: dist_2(v, central) {d_cent}")
    del samples
    torch.cuda.empty_cache()

    # The cross-rank lanes: WORLD ranks on this card over gloo, each on its
    # own shard (B7's kernels map each other's buffers by CUDA IPC).
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        run_ranks(out)
        print(f"[ranks] {WORLD} rank processes on {name} done in "
              f"{time.perf_counter() - t0:.1f} s")
        reports = []
        for k in range(WORLD):
            with open(os.path.join(out, f"rank{k}.json")) as f:
                reports.append(json.load(f))
        lanes = [lane for lane, *_ in CROSS_LANES] + ["remote-32 skewed"]
        ests = {lane: [torch.load(os.path.join(out, f"{lane}-{k}.pt")).to(dev)
                       for k in range(WORLD)] for lane in lanes}
        b7_main = [torch.load(os.path.join(out, f"b7-main-{k}.pt")) for k in range(WORLD)]
    print(f"[ranks] transport: {reports[0]['backend']} ({reports[0]['rule']})")

    # Phase 2's B7 checks, made in the rank world.
    for label in reports[0]["b7"]:
        cells = [rep["b7"][label] for rep in reports if label in rep["b7"]]
        err = max(c["err"] for c in cells)
        sd = max(c["sd"] for c in cells)
        ok = (all(c["finite"] for c in cells) and err <= ROUND_TOL and sd <= ROUND_SD_TOL)
        extra = ""
        if label.startswith("main"):
            spread = max(subspace_dist64(b, b7_main[0]) for b in b7_main[1:])
            ok = ok and spread <= ROUND_SD_TOL
            extra = f" rank spread {spread:.1e}"
        print(f"[check] {'fused_ring_round_remote':<18} {label:<34} max_abs_err {err:.3e} "
              f"tol {ROUND_TOL:.0e} subspace_dist64 {sd:.3e} tol {ROUND_SD_TOL:.0e}"
              f"{extra} over {len(cells)} ranks, grid {cells[0]['grid']} blocks "
              f"{'ok' if ok else 'FAIL'}")
        results["fused_ring_round_remote"]["errs"][label] = (err, ROUND_TOL)
        require(ok, f"fused_ring_round_remote disagrees with its plain version at {label}")
    del b7_main

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
        cent = v_cent if n == N_PER_SHARD else v_cent_psum
        d_cent = dist_2(v, cent).item()
        ortho = (v.mT @ v - torch.eye(R, device=dev)).abs().max().item()
        polar, orth = (knobs["polar"], knobs["orth"]) if knobs else ("newton-schulz",
                                                                     "cholesky-qr2")
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
        elif lane == "remote-32":
            sd = subspace_dist64(v, ests["ring-32"][0])
            skew = reports[SKEW_RANK]["lanes"]["remote-32 skewed"]
            skew_counts = [rep["lanes"]["remote-32 skewed"]["launches"] for rep in reports]
            sd_skew = max(subspace_dist64(e, ests["ring-32"][0])
                          for e in ests["remote-32 skewed"])
            same = all(torch.equal(a, b) for a, b in
                       zip(ests["remote-32 skewed"], ests["remote-32"]))
            extra = (f", subspace_dist64(v, ring-32) {sd:.3e} (tol {STACK_TOL:.0e}); "
                     f"rank {SKEW_RANK} started {SKEW_S} s late: slowest rank "
                     f"{max(rep['lanes']['remote-32 skewed']['wall'] for rep in reports):.2f} s "
                     f"(delayed rank {skew['wall']:.2f} s), worst rank's "
                     f"subspace_dist64(v, ring-32) {sd_skew:.3e}, bitwise equal to the "
                     f"unskewed run {same}")
            require(sd <= STACK_TOL, f"{lane}: {sd} from the staged ring-32 lane")
            require(sd_skew <= STACK_TOL, f"{lane} skewed: {sd_skew} from ring-32")
            require(all(c == expected_counts({"fused_ring_round_remote": N_ITER})
                        for c in skew_counts), f"{lane} skewed: launches {skew_counts}")
        elif lane.startswith("hier"):
            bits = knobs["comm_bits"]
            tol = STACK_TOL if bits == 32 else PARITY_TOL[8]
            sd = subspace_dist64(v, v_stack_psum)
            cost = comm_cost("hier", m=WORLD, d=D, r=R, n_iter=N_ITER,
                             comm_bits=bits, pods=PODS)
            want = {lv: sum(kinds.values()) for lv, kinds in cost.levels.items()}
            got = [{lv: 8 * b for lv, b in rep["handed"].items()} for rep in lane_reps]
            extra = (f", subspace_dist64(v, stacked lane) {sd:.3e} (tol {tol:.0e}); "
                     f"handed bits per rank intra {got[0]['intra']} inter {got[0]['inter']} "
                     f"vs comm_cost levels intra {want['intra']} inter {want['inter']} "
                     f"({cost.levels})")
            require(sd <= tol, f"{lane}: {sd} from the stacked lane")
            require(all(g == want for g in got), f"{lane}: handed {got}, levels {want}")
        print(f"[ranks] {lane} {polar}/{orth} backend=cuda "
              f"m={WORLD} n={n} d={D} r={R}: wall {max(r['wall'] for r in lane_reps):.2f} s "
              f"(slowest rank), launches/rank { {k: c for k, c in expected.items() if c} }, "
              f"staged {lane_reps[0]['staged_bytes'] / 1e6:.1f} MB/rank, "
              f"rank spread {spread:.1e}, dist_2(v, central) {d_cent:.4e}, "
              f"|V^T V - I|max {ortho:.2e}{extra}")
        require(bool(torch.isfinite(v).all()) and ortho < 1e-4,
                f"{lane}: non-finite or non-orthonormal estimate")
        require(spread <= ROUND_SD_TOL, f"{lane}: ranks disagree by {spread}")
        require(d_cent < DIST_BAR, f"{lane}: dist_2(v, central) {d_cent} >= {DIST_BAR}")
    b7_time = [rep["b7_time"] for rep in reports]
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

    # Once more under torchrun: the hier topology, PODS pods.
    run_cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.eigen",
               "--device", "cuda", "--topology", "hier", "--pods", str(PODS),
               "--polar", "newton-schulz", "--dim", str(D), "--subspace-rank",
               str(R), "--n-per-shard", str(N_PSUM)]
    t0 = time.monotonic()
    cli = subprocess.run(run_cmd, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": SRC})
    require(cli.returncode == 0, f"torchrun hier launcher failed:\n{cli.stderr[-4000:]}")
    stats = dict(line.split(": ", 1) for line in cli.stdout.strip().splitlines()
                 if ": " in line)
    print(f"[cli] torchrun --nproc-per-node {WORLD} repro_torch.launch.eigen "
          f"--topology hier --pods {PODS} --polar newton-schulz --dim {D} "
          f"--subspace-rank {R} --n-per-shard {N_PSUM} ({time.monotonic() - t0:.1f} s): "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("ranks", "pods", "d", "r", "backend", "topology", "transport",
                       "staged_bytes", "dist_aligned", "dist_central",
                       "dist_naive", "wall_s")))
    require(stats["backend"] == "cuda" and stats["topology"] == "hier"
            and stats["pods"] == str(PODS) and stats["ranks"] == str(WORLD)
            and (stats["d"], stats["r"]) == (str(D), str(R)),
            "torchrun hier launcher: wrong lane or width")
    require(float(stats["dist_aligned"]) < min(DIST_BAR, float(stats["dist_naive"])),
            "torchrun hier launcher: estimate not within the bar or no better than naive")
    torch.cuda.synchronize()

    # -- the serving lane (B8): the PCA data is gone, free its cache --------
    torch.cuda.empty_cache()
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def qkv(shape, dtype):
        b, hq, hkv, s_, t_, hd = shape
        return tuple(torch.randn(*sh, generator=gen, device=dev).to(dtypes[dtype])
                     for sh in ((b, hq, s_, hd), (b, hkv, t_, hd), (b, hkv, t_, hd)))

    row_ratio = {}
    for label, shape, dtype, window in FLASH_CHECKS:
        q, k, v = qkv(shape, dtype)
        got = flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        label = f"{label} [{flash_attention.last_form}]"
        want = ref.flash_attention(q, k, v, causal=True, window=window)
        got, want = got.float(), want.float()
        hold("flash_attention", label, got, want, FLASH_TOL[dtype])
        if dtype == "bfloat16":
            row_bar = FLASH_ROW_REL * want.abs().amax(-1) + FLASH_ROW_ABS
            ratio = ((got - want).abs().amax(-1) / row_bar).max().item()
            print(f"[check] {'flash_attention':<18} {label:<34} worst row: error "
                  f"{ratio:.3f} of its bar 2^-7 max|want_row| + 1e-4 "
                  f"{'ok' if ratio <= 1 else 'FAIL'}")
            row_ratio[label] = ratio
            require(ratio <= 1, f"flash_attention disagrees with its plain "
                                f"version on some query row at {label}")
        s_, t_ = shape[3], shape[4]
        if s_ > t_:
            require(bool((got[:, :, : s_ - t_] == 0).all()),
                    f"flash_attention {label}: rows without keys are not zero")
        del q, k, v, got, want
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model, prompts = load(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                          reduced=False, device="cuda", seed=SEED)
    toks, st = generate(model, prompts, gen=SERVE_GEN)
    serve_cfg = model.cfg
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches["flash_attention"] += counts["flash_attention"]
    layers = serve_cfg.num_layers
    print(f"[serve] {SERVE_ARCH} full config (layers {layers}, d_model "
          f"{serve_cfg.d_model}, heads {serve_cfg.num_heads}/{serve_cfg.num_kv_heads}, "
          f"vocab {serve_cfg.vocab_size}), batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
          f"gen {SERVE_GEN}: prefill_s {st['prefill_s']:.4f}, decode_s {st['decode_s']:.4f} "
          f"({st['decode_s'] / SERVE_GEN * 1e3:.2f} ms/step), prefill "
          f"{SERVE_BATCH * SERVE_PROMPT / st['prefill_s']:.0f} tok/s, decode "
          f"{SERVE_BATCH * SERVE_GEN / st['decode_s']:.1f} tok/s, peak memory "
          f"{peak_gb:.2f} GB, wall with weight init {serve_wall:.2f} s, "
          f"flash launches {st['flash_launches']}")
    require(st["flash_launches"] == {"prefill": layers, "decode": 0},
            f"serve: flash launches {st['flash_launches']}, expected "
            f"{layers} in the prefill and none in decode")
    require(counts == expected_counts({"flash_attention": layers}),
            f"serve: launches {counts}")
    require(tuple(toks.shape) == (SERVE_BATCH, SERVE_GEN)
            and 0 <= int(toks.min()) and int(toks.max()) < serve_cfg.vocab_size,
            f"serve: token matrix {tuple(toks.shape)} out of range")

    # The served model and prompts, prefilled again through the kernel
    # and through plain attention.
    def timed_prefill(use_kernel):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.prefill(prompts, use_kernel=use_kernel)
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t0

    lk, t_kernel = timed_prefill(None)
    lp, t_plain = timed_prefill(False)
    vocab = serve_cfg.vocab_size
    lk, lp = lk[:, :vocab], lp[:, :vocab]
    rel_l2 = ((lk - lp).norm() / lp.norm()).item()
    max_abs = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    print(f"[serve] kernel vs plain prefill, last-position logits: rel L2 {rel_l2:.3e} "
          f"(bar {SERVE_REL_L2}), max abs {max_abs:.3e} = {max_abs / scale:.3e} of the "
          f"largest logit {scale:.3f} (bar {SERVE_MAX_ABS}), argmax agree "
          f"{(lk.argmax(-1) == lp.argmax(-1)).sum().item()}/{SERVE_BATCH}, "
          f"first served token from the kernel prefill "
          f"{bool((lk.argmax(-1).cpu() == toks[:, 0]).all())}; warm prefill "
          f"through the kernel {t_kernel:.4f} s, through plain attention {t_plain:.4f} s")
    require(bool(torch.isfinite(lk).all()) and rel_l2 <= SERVE_REL_L2
            and max_abs <= SERVE_MAX_ABS * scale,
            "serve: kernel and plain prefill disagree")
    require(bool((lk.argmax(-1).cpu() == toks[:, 0]).all()),
            "serve: the served first tokens are not the kernel prefill's argmax")
    del model, lk, lp, prompts
    torch.cuda.empty_cache()

    # The serve launcher, once in its own process, at the full config.
    t0 = time.monotonic()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", SERVE_ARCH,
         "--full-config", "--batch", "2", "--prompt-len", "256", "--gen", "8",
         "--device", "cuda"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": SRC},
    )
    require(cli.returncode == 0, f"serve launcher failed:\n{cli.stderr[-4000:]}")
    lines = cli.stdout.strip().splitlines()
    stats = dict(line.split(": ", 1) for line in lines[2:])
    print(f"[cli] repro_torch.launch.serve --arch {SERVE_ARCH} --full-config --batch 2 "
          f"--prompt-len 256 --gen 8 ({time.monotonic() - t0:.1f} s): {lines[0]}; "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("config", "prefill_tokens_per_s", "decode_tokens_per_s",
                       "flash_launches_prefill", "flash_launches_decode")))
    require(lines[0] == "generated token matrix: (2, 8)"
            and stats["flash_launches_prefill"] == str(layers)
            and stats["flash_launches_decode"] == "0",
            "serve launcher: wrong token matrix or flash launches")
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
    # B1: the function needs n d (d + 1) FLOP (each of the d (d + 1) / 2
    # distinct entries, n FMAs); the whole product's bound, 2 n d^2, is
    # printed beside it.
    gram_bytes = 4 * (N_PER_SHARD * D + D * D)
    timing = {
        "gram": (lambda: gram(x), lambda: ref.gram(x), lambda: x.T @ x, 3,
                 bound(1.0 * N_PER_SHARD * D * (D + 1), gram_bytes)),
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
    # B8 at the serving shape: bf16 tensor-core peak; operations counted
    # over the visible keys (the kernel skips the rest).  Its MMA work is
    # S, then PV twice (p_hi and p_lo).
    _, (b, hq, hkv, s_, t_, hd), _, _ = FLASH_CHECKS[0]
    q, k_, v_ = qkv(FLASH_CHECKS[0][1], "bfloat16")
    visible = sum(min(t_, t_ - s_ + i + 1) for i in range(s_))
    fa_flops = 4.0 * b * hq * hd * visible
    fa_bytes = 2 * (2 * b * hq * s_ * hd + 2 * b * hkv * t_ * hd)
    fa_bound = (1e3 * max(fa_flops / peak_bf16, fa_bytes / peak_bw),
                "operations" if fa_flops / peak_bf16 >= fa_bytes / peak_bw else "bytes")
    timing["flash_attention"] = (
        lambda: flash_attention(q, k_, v_), lambda: ref.flash_attention(q, k_, v_),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_, v_, is_causal=True, enable_gqa=True), 10, fa_bound)
    fa_mma_flops = 1.5 * fa_flops
    gram_full_bound, _ = bound(2.0 * N_PER_SHARD * D * D, gram_bytes)
    tiles = -(-D // 128)
    gram_tile_flops = tiles * (tiles + 1) // 2 * 2.0 * 128 * 128 * N_PER_SHARD
    rows = []
    for k, (kern, plain, lib, reps, (bound_ms, bound_by)) in timing.items():
        k_ms = time_ms(kern, reps)
        p_ms = time_ms(plain, reps)
        l_ms = time_ms(lib, reps) if lib is not None else None
        errs = results[k]["errs"]
        main_err = max(e for lbl, (e, _) in errs.items() if lbl.startswith("main"))
        rag_err = max(e for lbl, (e, _) in errs.items() if lbl.startswith("ragged"))
        tol = max(t for lbl, (_, t) in errs.items() if lbl.startswith("main"))
        mma = (f" mma_tflops {fa_mma_flops / (k_ms * 1e9):.1f} ({fa_mma_flops / 1e12:.3f} "
               f"TFLOP: S and PV with p_hi and p_lo)") if k == "flash_attention" else ""
        print(f"[time] {k:<18} kernel_ms {k_ms:.4f} launches/run {launches[k]} "
              f"bound_ms {bound_ms:.4f} ({bound_by}) plain_ms {p_ms:.4f} "
              f"library_ms {'-' if l_ms is None else f'{l_ms:.4f}'}{mma}")
        src, replaces = KERNELS[k]
        rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": main_err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": l_ms, "tol": tol, "ragged_max_abs_err": rag_err,
            "verdict": "pass",
        })
        if k == "flash_attention":
            rows[-1]["row_err_over_bar"] = max(
                r for lbl, r in row_ratio.items() if lbl.startswith("main"))
            rows[-1]["mma_tflops"] = fa_mma_flops / (k_ms * 1e9)
        if k == "gram":
            rows[-1].update(full_bound_ms=gram_full_bound,
                            tflops=N_PER_SHARD * D * (D + 1) / (k_ms * 1e9),
                            tile_tflops=gram_tile_flops / (k_ms * 1e9))
            print(f"[time] gram kernel_ms {k_ms:.4f} vs bound {bound_ms:.4f} ms "
                  f"(n d (d + 1) FLOP) and {gram_full_bound:.4f} ms (the whole "
                  f"product's 2 n d^2): {rows[-1]['tflops']:.2f} TFLOP/s of the needed "
                  f"work, {rows[-1]['tile_tflops']:.2f} of the upper tiles' "
                  f"{gram_tile_flops / 1e12:.3f} TFLOP; x.T @ x {l_ms:.4f} ms")
        if k == "batched_gram":
            g_rows, g_cluster = gram_plan["main (8, 8192, 128)"]
            rows[-1].update(cluster=g_cluster, rows_per_split=g_rows)
        if k in ("fused_round", "fused_ring_round"):
            rows[-1]["newton_schulz_form"] = (fused_round if k == "fused_round"
                                              else fused_ring_round).last_form
        if k == "fused_ring_round":
            rows[-1]["by_wire"] = {
                wname: {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2][0],
                        "bound_by": t[2][1]} for wname, t in ring_ms.items()}
    # B3 and B5 past r = 136 (tiles in the global workspace).
    by_name = {row["name"]: row for row in rows}
    for r_w in WIDE_RS:
        vs_w = wide_stacks[r_w]
        rf_w = vs_w[0].contiguous()
        for k, kern, plain, flops in (
            ("batched_gram_polar", lambda: batched_gram_polar(vs_w, rf_w),
             lambda: ref.batched_gram_polar(vs_w, rf_w),
             2.0 * SHARDS * D * r_w * r_w + DEFAULT_NS_ITERS * SHARDS * 4.0 * r_w ** 3),
            ("fused_round", lambda: fused_round(vs_w, rf_w),
             lambda: ref.fused_round(vs_w, rf_w),
             4.0 * SHARDS * D * r_w * r_w + 8.0 * D * r_w * r_w
             + DEFAULT_NS_ITERS * SHARDS * 4.0 * r_w ** 3),
        ):
            w_ms, w_plain = time_ms(kern, 5), time_ms(plain, 5)
            w_bound, w_by = bound(flops, 4 * (SHARDS * D * r_w + 2 * D * r_w))
            print(f"[time] {k:<18} wide r={r_w} (tiles in the workspace) kernel_ms "
                  f"{w_ms:.4f} bound_ms {w_bound:.4f} ({w_by}) plain_ms {w_plain:.4f}")
            by_name[k].setdefault("wide_r", {})[r_w] = {
                "ms": w_ms, "plain_ms": w_plain, "bound_ms": w_bound, "bound_by": w_by}
    # B8's wide kernel at recurrentgemma-2b's local attention shape.
    (b, hq, hkv, s_, t_, hd), wdt, win = FLASH_WIDE
    q, k_, v_ = qkv(FLASH_WIDE[0], wdt)
    visible = sum(min(t_ - s_ + i + 1, win) for i in range(s_))
    w_flops = 4.0 * b * hq * hd * visible
    w_bound = 1e3 * max(w_flops / peak_bf16, 2 * (2 * b * hq * s_ * hd + 2 * b * hkv * t_ * hd)
                        / peak_bw)
    qpos = torch.arange(s_, device=dev)[:, None] + (t_ - s_)
    kpos = torch.arange(t_, device=dev)[None, :]
    mask = (kpos <= qpos) & (qpos - kpos < win)
    w_ms = time_ms(lambda: flash_attention(q, k_, v_, window=win), 5)
    w_plain = time_ms(lambda: ref.flash_attention(q, k_, v_, window=win), 3)
    w_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_, v_, attn_mask=mask, enable_gqa=True), 5)
    print(f"[time] flash_attention wide {FLASH_WIDE} [{flash_attention.last_form}] kernel_ms "
          f"{w_ms:.4f} bound_ms {w_bound:.4f} (operations, bf16 peak) plain_ms {w_plain:.4f} "
          f"library_ms {w_lib:.4f} (SDPA, boolean window mask); "
          f"{w_flops / (w_ms * 1e9):.2f} TFLOP/s")
    by_name["flash_attention"]["wide_hd256"] = {
        "shape": list(FLASH_WIDE[0]), "window": win, "ms": w_ms, "plain_ms": w_plain,
        "bound_ms": w_bound, "library_ms": w_lib}
    del q, k_, v_, mask
    # B7, timed in the rank world (phase 3's processes): WORLD ranks share
    # the card, so the world's bound is WORLD ranks' work; each rank does
    # B6's operations and writes WORLD - 1 hops of d r f32 to its neighbour.
    rank_bound, _ = bound(round_flops, 4 * (3 + WORLD - 1) * d * r)
    world_bound, b7_by = bound(WORLD * round_flops, WORLD * 4 * (3 + WORLD - 1) * d * r)
    b7_ms = max(t["kernel"][0] for t in b7_time)
    b7_wall = max(t["kernel"][1] for t in b7_time)
    b7_plain = max(t["plain"][0] for t in b7_time)
    errs = results["fused_ring_round_remote"]["errs"]
    print(f"[time] fused_ring_round_remote kernel_ms {b7_ms:.4f} (slowest of {WORLD} ranks "
          f"sharing the card, CUDA events, {B7_REPS} rounds; the world's host wall "
          f"{b7_wall:.4f} ms a round) launches/run {launches['fused_ring_round_remote']} "
          f"bound_ms {world_bound:.4f} ({b7_by}; the world: {WORLD} x {rank_bound:.4f} "
          f"per rank) plain_ms {b7_plain:.4f} library_ms none (no one PyTorch call "
          f"computes a ring round)")
    src, replaces = KERNELS["fused_ring_round_remote"]
    rows.append({
        "name": "fused_ring_round_remote", "route": "cuda", "source": src,
        "replaces": replaces, "launches": launches["fused_ring_round_remote"],
        "max_abs_err": max(e for lbl, (e, _) in errs.items() if lbl.startswith("main")),
        "ms": b7_ms, "plain_ms": b7_plain, "bound_ms": world_bound, "bound_by": b7_by,
        "library_ms": None, "tol": ROUND_TOL,
        "ragged_max_abs_err": max(e for lbl, (e, _) in errs.items()
                                  if lbl.startswith("ragged")),
        "verdict": "pass", "ranks_sharing_card": WORLD, "rank_bound_ms": rank_bound,
        "world_wall_ms": b7_wall,
        "per_rank": [{"ms": t["kernel"][0], "plain_ms": t["plain"][0]} for t in b7_time],
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

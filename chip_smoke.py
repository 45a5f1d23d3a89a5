#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --ranks-witness   # [sharded-ranks]' hybrid alone, 2 cards

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
   without (the kernel always mirrors its upper tiles); B3, B5 and B6 (f32,
   bf16 and int8 wires) are also held at r = 192 and 256, where the
   grouped Newton-Schulz form streams its iterate from L2 and B5/B6's
   CholeskyQR factor runs on the whole grid in 32-column panels, B5 also
   on a rank-deficient stack there (the grid factor's shifted retry).  B2
   (one launch, the splits of d summed across a thread-block cluster;
   B3's first pass) must give the same bits on a second call, and prints
   its plan (rows a split, cluster size); B3, B5, B6 and B7 print the
   Newton-Schulz form they ran (a group of blocks a machine at every r),
   B5/B6 also their factor form.
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
   to 1e-4 / PARITY_TOL[8].  The planner (``repro_torch.plan``) prints
   its resolved plan and scored table at m = 8, d = 8192, r = 128 in the
   stacked and the collective context, and the planned stacked lane
   (``distributed_pca(plan="auto")``) must equal, bit for bit and launch
   for launch, the stacked lane of the cell it picks.  The elastic lane
   (``runtime.elastic.elastic_pca_collective``, plan "auto", in the rank
   world on the psum lanes' data) loses shard 3 before round 1: one
   initial and one failure event, one re-plan priced at m' = 7, and its
   estimate within 1e-4 f64 of the composed stacked oracle from the same
   local bases (round 0 over all 8, round 1 over the 7 survivors from the
   round-0 basis).  A small run must agree with the plain backend, and
   the launcher runs on the card, twice in one process (the second at
   d = 8192, r = 128 with ``--plan auto --explain``) and three times
   under ``torchrun`` with 8 ranks at d = 8192, r = 128 and 16384 samples
   per shard: on the ring, on hier with 2 pods, and with ``--plan auto
   --fail-at 3:1`` (the elastic runtime).
   The streaming lanes (``repro_torch.stream.SubspaceService``, plan
   "auto", the subspace solver): the stacked service fed the main data,
   16 steps of 4096 rows a shard, a refresh every 4 steps (B1 a live shard
   a step, the planned rounds at every refresh; the launch counts exact):
   each shard's state against the plain ingest over the same chunks and
   against one B1 call over its rows (``sum_tol``), refreshes after steps
   1, 5, 9, 13 and 16, every refresh-over-refresh jump under JUMP_BAR, a
   re-refresh on the same state within the local bases' spread squared,
   the final basis closer (f64) to the one-shot B5 lane than that lane is
   to the central estimate, and the queries (``project``) equal to the
   plain product with no ``torch.distributed`` call; the same lane with
   shard 3 dead from step 8 (one re-plan, m' = 7, within STACK_TOL of the
   serial oracle over the survivors' full-stream local bases); in the
   rank world each rank streams its 16384 rows in 8 steps, cadence 2,
   shard 3 dead at step 4, held at STACK_TOL to the stacked service fed
   the same rows and schedule, with the same stats.  Then ``serve
   --subspace`` at d = 8192, r = 128 in its own process (4096 queries in
   batches of 256), the launcher's ``--stream 8 --cadence 2 --fail-at
   3:4`` under ``torchrun`` on 8 ranks, and the quadratic-sensing spectral
   initialization
   (``repro_torch.optim``; d = 1024, r = 8, 8 machines, n = r d .. 8 r d
   rows a machine), whose error must fall as n grows.
   Then the serving lane, with the PCA data freed first: B8
   (``flash_attention``) against its plain version at the serving shapes
   (b 4, hq 24, hkv 8, s = t = 4096, hd 128, bf16, causal; qwen3-moe-
   30b-a3b's b 4, hq 32, hkv 4, hd 64) and at ragged
   ones (GQA s 96 / t 160 in bf16 and f32, s > t with its zero rows,
   windows 16 and 1024, MQA, and s, t and windows at the bf16 kernel's
   128-row and 128-key tile edges, and head_dim 136, 192, 200 and 256:
   bf16 through the 64-key-tile wgmma kernel, at its tile and window
   edges, s > t and MQA, f32 through the wide kernel; each check names
   the kernel form that the library
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
   short prompt (started with the hybrid's and whisper's launchers side by
   side; those two are checked after their own lanes).
   Then the sharded lanes (``sharded_lanes``): [sharded] serves the same
   model, prompts and traffic through ``launch.sharding`` on a (1, 1)
   mesh (a world of one over gloo; every parameter and cache a DTensor,
   B8 through ``local_map``): exactly 28 flash launches in the prefill and
   none in decode, the unsharded lane's tokens, last-position logits
   within the serving bars of the unsharded kernel prefill's, prefill_s,
   decode ms a step and peak beside the unsharded lane's;
   [sharded-ranks] runs the same model on SHARD_RANKS rank processes
   (``--shard-rank K``) over a (1, 2) mesh: NCCL with a card a rank, or
   gloo with the card shared.  Each rank first probes every collective
   kind through DTensor on CUDA tensors and names any that is refused (a
   rank process that dies in a probe names it too); below two cards a
   refusal the layout needs prints ``skipped: needs 2 cards (gloo refuses
   ... on CUDA)``.  Otherwise each rank's B8 runs on (4, 12/4, 4096, 128),
   28 launches a rank, the rank-0 logits within the serving bars, and the
   collectives a rank with their bytes are printed.  [dryrun], after the
   MoE training lanes, joins the dry run started in DRYRUN_PARTS processes
   of its own right after the sharded lanes, at the lowest priority
   (``launch/dryrun.py`` on fake process groups: paper-pca at (16, 16) on
   the ring and as a 4-step stream, and at (2, 16, 16) on hier, backend
   cuda; llama3.2-3b x {train_4k, prefill_32k, decode_32k},
   qwen3-moe-30b-a3b x train_4k, recurrentgemma-2b and mamba2-370m x
   {train_4k, prefill_32k, decode_32k, long_500k} and whisper-tiny x
   {train_4k, prefill_32k, decode_32k} at 256 ranks, and the train_4k
   cells of llama3.2-3b, qwen3-moe-30b-a3b, recurrentgemma-2b and
   mamba2-370m again with ``--eigen``: the eigen train step, its
   data-axis bytes beside the baseline cell's) and prints one line a
   record; paper-pca's collective bytes a device must equal
   ``comm_cost(...).bits / 8`` and the stream query's be 0; the numbers
   are reckoned on fake tensors, not card times.
   Then the recurrent serving lane (``recurrent_lanes``): recurrentgemma-2b
   (26 blocks: 18 RG-LRU, 8 local attention with window 2048, head_dim
   256, 10 query heads on 1 KV head, through B8's hd-256 wgmma form) and
   mamba2-370m (48 SSD blocks) at their full configs with the same
   traffic: exactly 8 / 0 flash launches in the prefill and none in
   decode; kernel vs plain prefill, and a prefill of the first 4095
   tokens plus one decode step (the ring, the RG-LRU / SSD states and
   the conv tails carried on the card; mamba2's chunk padded), against
   the 4096-token prefill's last-position logits within the serving
   bars; B8's device time in one profiled hybrid prefill.  After each
   arch's lane, [sharded-recur] serves the same model and prompts again
   through ``launch.sharding`` on a (1, 1) mesh (``sharded_serve``: every
   parameter and cache a DTensor, the SSD's scan through its ``local_map``
   region): exactly 8 / 0 flash launches in the prefill and none in
   decode, the unsharded lane's tokens, a sharded kernel prefill's last
   logits within the serving bars of the unsharded one's, prefill_s,
   decode ms a step and generate's peak above the memory held before it
   beside the unsharded lane's (each peak reset just before its
   ``generate``); then
   [sharded-ranks] runs the hybrid on a (1, SHARD_RANKS) mesh over NCCL
   (5 query heads a rank over its one KV head through B8's head_dim-256
   form, the RG-LRU's gate products reduced over 'model'), held as the
   llama lane, and below two cards prints its skip at once
   (``--ranks-witness`` runs that lane alone, built in bf16 and in f32,
   each against rank 0's own unsharded prefill of the same weights: a gap
   of bf16 rounding shrinks by orders in f32, a fault does not).  Then the
   serve launcher's run with ``--arch recurrentgemma-2b --full-config`` is
   checked.
   Then the MoE serving lane (``moe_lane``): qwen3-moe-30b-a3b at its
   full config (48 blocks, head_dim 64 through B8's wgmma form, 128
   experts top-8; 30,079,649,792 parameters, 60.16 GB in bf16) with the
   same traffic: exactly 48 flash launches in the prefill and none in
   decode; the pairs each layer drops (forward hooks that route the
   layer's input again); kernel vs plain prefill (the plain side one
   prompt row at a time) within the serving bars, with the routing
   decisions that differ between the two; a 4095-token prefill plus one
   decode step against the 4096-token prefill: the K/V caches' first 4095
   slots within the bars, and the logits of every row whose last token
   kept its pairs in every layer (a dropped last token makes the two
   another function); B8's share of one profiled prefill; the serve
   launcher once with ``--arch qwen3-moe-30b-a3b --full-config``.
   Then the VLM and encoder-decoder serving lanes (``vlm_whisper_lanes``,
   ``[vlm]`` / ``[whisper]`` lines): internvl2-2b at its full config (24
   layers, d_model 2048, head_dim 128; 1,891,244,032 parameters) with the
   other lanes' traffic after its 256 stub patch embeddings (B8 causal at
   (4, 16/8, 4352, 4352, 128)): exactly 24 flash launches in the prefill
   and none in decode; whisper-tiny at its full config through
   ``EncDec.prefill`` / ``decode_step`` at 32 requests of 1500 frames
   (whisper's 30-s window after its conv stack) and a 64-token decoder
   prompt, 32 greedy tokens: exactly 4 bidirectional launches in the
   encoder (B8 ``causal=False`` at (32, 6/6, 1500, 1500, 64)) and 4 causal
   in the decoder's prefill, none in decode; for each, kernel vs plain
   prefill and a (prompt - 1) prefill plus one decode step against the
   whole prefill within the serving bars; [sharded-encdec] serves
   whisper-tiny's model, frames and prompts again on a (1, 1) mesh as
   [sharded-recur] does (4 + 4 / 0 launches, the unsharded tokens, the
   logits within the bars, every cache tensor a DTensor); the
   serve launcher's run with ``--arch whisper-tiny --full-config`` (frames
   = prompt length, the reference's semantics) is checked.  Phase 2's B8
   checks include internvl2-2b's prefill shape and the bidirectional form
   (``FLASH_BIDIR_CHECKS``).
   Then the training lanes (``train_lanes``; constants T1_* .. T4_*):
   T1 trains ``llama3.2-3b`` at its full config (3.61 B parameters, f32
   master weights, bf16 compute, remat per block) with AdamW on 8 x 512
   tokens a step from the seeded pipeline for 8 steps (finite losses, no
   skipped step, the loss falling; parameters, peak memory, ms a step,
   tokens/s); T1c takes 3 AdamW steps on the card and on the CPU from the
   same parameters and batches; B2 and B4 are held against their plain
   versions at the eigen refresh's shapes; T2 runs the eigen-compressed
   trainer over 4 stacked shards at 16 of the 28 layers (one B2 and one
   B4 launch a compressed leaf a refresh, exactly; the all-reduce words
   a step, compressed and not; the error feedback's bytes); T3 runs it
   on 4 rank processes of this card (``--train-rank K``) at 2 layers in
   f32, each shard its own rows, held to its stacked run (losses, each
   refresh's bases but the embedding's, the error feedback and moments
   after the last step, the bytes handed to ``torch.distributed`` a
   step); T4 runs the train launcher
   in its own process, preempted at step 5 and resumed from its
   checkpoint, against the straight run, both deterministic (the two
   processes side by side).  The sharded
   training lanes ([sharded-train]): T1s runs T1 through
   ``launch.train.train(mesh=)`` on a (1, 1) mesh (every parameter and
   both AdamW moments a DTensor) for 4 steps, its losses held to T1's
   (bit for bit, else T1S_LOSS), its ms a step and peak beside T1's; T3s
   runs T3 on a (4, 1) mesh in T3's rank processes (parameters on the
   model submesh, the data axis by hand over gloo), held to T3's stacked
   run at T3's bars, with B2 and B4 launched on every refresh of every
   rank and the bytes handed a step exact; in the same processes the
   reduced llama3.2-3b (T3S_CK) trains on that mesh straight, and
   checkpointed every 2 steps and preempted at T3S_FAIL, and its step-2
   checkpoint is restored into the stacked trainer: both end within
   T4_BAR of the straight mesh run's final loss.  [sharded-train-ranks]
   (``--shard-train-rank K``) trains T3's model on a (2, 2) mesh of 4
   ranks over NCCL, a card each (AdamW and the eigen step, held to the
   unsharded and stacked runs at T3's bars, the collectives a rank by
   kind and bytes); below 4 cards it prints its skip.
   Then the recurrent training lanes (``recurrent_train_lanes``, on
   ``[train-recur]`` lines; constants R1_* .. R2_*): R1 trains
   recurrentgemma-2b (26 blocks, 3.55 B parameters) and mamba2-370m (48
   blocks, a tied embedding) at their full configs with T1's AdamW
   traffic and checks, and no kernel launched (train mode takes plain
   attention); R1c holds each family's reduced config, 3 AdamW steps on
   the card against the CPU; B2 and B4 are held at R2's refresh shapes
   (leading dims 256000, 7680, 2560, 50432, 2048, 1024); R2 runs the
   eigen trainer as T2 does on mamba2 whole and on the hybrid at 11 of
   its blocks (one B2 and one B4 a compressed leaf a refresh, exactly;
   the words a step; the error feedback's bytes).  After each R1, R1s
   ([sharded-train], ``mesh_adamw_lane``) runs the same AdamW lane through
   ``launch.train.train(mesh=)`` on a (1, 1) mesh for 4 steps, its losses
   held to R1's first 4 as T1s holds T1's, its ms a step and peak beside
   R1's.
   Then the VLM and encoder-decoder training lanes
   (``vlm_whisper_train_lanes``, ``[train-vlm]`` / ``[train-whisper]``;
   constants V1_*): V1, T1's AdamW at internvl2-2b's full config on text
   batches (the launcher's path: ``patch_proj`` only decayed) plus one
   step with 256 patch embeddings a row, and at whisper-tiny's on 8 x
   (1500 frames + 448 tokens); V1c, both reduced configs with their stub
   inputs, card vs CPU; V1s, whisper-tiny's V1 on a (1, 1) mesh through
   ``launch.steps.make_train_step(mesh=)`` on the same batches with
   frames, held to V1's first 4 losses as R1s; V2, T2's eigen trainer
   stacked on internvl2-2b uncut (``launch.train.train``) and on
   whisper-tiny with frames
   (``launch.steps``' step functions: the launcher refuses an encoder-decoder),
   one B2 and one B4 a compressed leaf a refresh, exactly.
   Then the MoE training lanes (``moe_train_lanes``, ``[train-moe]``;
   constants M1_* .. M2_*): M1, T1's AdamW at qwen3-moe-30b-a3b's full
   width (d_model 2048, 128 experts top-8, vocab 151936, the einsum form)
   at 6 of its 48 layers, then one step more whose pre-hooks give each
   layer's drop share and the routing decisions the remat recompute
   changed (none allowed); M1c, both MoE archs' reduced configs in both
   forms, card vs CPU; M2, T2's eigen trainer stacked at 4 layers, one B2
   and one B4 a compressed leaf a refresh, exactly, and the words a step
   at that depth and reckoned at 48 layers.
4. Time each kernel at the main path's shapes (CUDA events) beside its
   bound, its plain version and one PyTorch call computing the same
   function (none for B3, B5, B6, B7; the einsum for B2 and B4; SDPA for
   B8); B1 also at the stream lanes' ingest chunk (4096, 8192), and one
   local solve of an (8192, 8192) covariance (subspace iteration and
   eigh); B8 also the TFLOP/s
   it reaches on its MMA work (S, and PV for p_hi and p_lo).  B1 beside
   the bound of the work the function needs (n d (d + 1) FLOP), the full
   product's (2 n d^2) and ``x.T @ x``, with its TFLOP/s; B3, B5 and B6
   (each wire) at r = 192 and 256; B8's hd-256 wgmma form at recurrentgemma-2b's local
   attention shape (b 4, hq 10, hkv 1, s = t = 4096, hd 256, window
   2048, bf16) and at qwen3-moe-30b-a3b's prefill shape (b 4, hq 32, hkv
   4, s = t = 4096, hd 64, bf16, causal) beside SDPA; B8 also
   bidirectional at whisper-tiny's encoder shape and causal at
   internvl2-2b's prefill shape, each beside SDPA.  B7 is
   timed in the rank world, per round on every rank, against the bound
   of the 8 ranks' work on the one card, with each round split into the
   time its hops waited between launches and the time they computed (the
   wrapper's CUDA events).  Then the planner held to the card:
   ``tools/h100_model.py``, in a process of its own, measures the H100
   model's latency constants again and times the stacked rounds alone
   (``refinement_rounds`` on a fixed (8, 8192, r) f32 stack, 2 rounds,
   CUDA events, warm, median of 5) for every cell of {torch, cuda} x
   {svd, newton-schulz} x {qr, cholesky-qr2} at r = 128 and 256; each
   cell's prediction is printed beside its time, the planner's pick must
   be within 1.3x of the fastest measured cell, and the table is printed
   again calibrated from these timings (``Calibration.from_records``,
   platform "h100").
5. Print ``{"kernels": [...]}`` (``launches``: every lane of phase 3, the
   cross-rank lanes summed over ranks, B8's the serve calls: llama3.2-3b's,
   the sharded lanes' (summed over ranks), the recurrent lane's and its
   (1, 1)-mesh serve's, the MoE lane's and the VLM and whisper lanes'
   and whisper's (1, 1)-mesh serve's),
   then, last,
   ``{"ok": true, "device": ...}``.

The launcher's checks under ``torchrun`` run at (CLI_D, CLI_R) = (1024,
16), where their own compute is under a second; phase 3's in-process
[ranks] lanes hold those paths at (D, R).

``python3 chip_smoke.py --profile`` instead builds, draws the same data
and runs each stacked lane once more under ``torch.profiler`` after a
warm-up lane, then one full-width ``llama3.2-3b`` prefill (and a few
decode steps) after a warm-up prefill, the same for ``recurrentgemma-2b``,
``qwen3-moe-30b-a3b``, ``internvl2-2b`` (256 patches + 4096 tokens) and
``whisper-tiny`` (32 x 1500 frames + 64 tokens), then one T1 train step after a
warm-up step, one R1 step of recurrentgemma-2b and of mamba2-370m, and
one M1 step of qwen3-moe-30b-a3b (6 layers):
it prints each run's wall time, the device's busy share
and the kernels that took the most device time.  ``--rank K``,
``--train-rank K``, ``--shard-rank K`` and ``--shard-train-rank K`` are
the cross-rank lanes' workers, started by phase 3.

TF32 is off throughout: the reference computes in float32.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# Production width of the paper-pca config (src/repro_torch/configs/paper_pca.py,
# a copy of the reference's), read in place when the checkout is beside
# this script; SHARDS machines.
SHARDS = 8


def _pca_config():
    sys.path.insert(0, SRC)
    try:
        from repro_torch.configs.paper_pca import CONFIG
    except ImportError:  # not beside a checkout: main() refuses to run
        return 8192, 128, 65536, 2, 30
    finally:
        sys.path.remove(SRC)
    return CONFIG.d, CONFIG.r, CONFIG.n_per_shard, CONFIG.n_iter, CONFIG.solver_iters


D, R, N_PER_SHARD, N_ITER, ITERS = _pca_config()
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
# The launcher's checks under torchrun ([cli]) run at this width, where each
# rank's own compute takes under a second: their process start-up is the
# cost, and the in-process [ranks] phase holds these paths at (D, R).
CLI_D, CLI_R = 1024, 16
RING_CHUNK_MAIN, RING_CHUNK_RAGGED = 1000, 33
# The hier lanes' pods (2 pods x 4 local ranks); B7's ragged check (odd m on
# a subgroup of ranks, d and r off every tile); the remote lane's delayed
# rank and its host sleep before its first launch; B7's timed rounds.
PODS = 2
B7_RAGGED = (3, 1000, 7)
SKEW_RANK, SKEW_S = 3, 2.0
B7_REPS, B7_PLAIN_REPS = 10, 3
# The elastic lane (rank world, N_PSUM samples a shard): shard ELASTIC_DEAD
# dies before round ELASTIC_ROUND, plan "auto"; its estimate is held to the
# composed stacked oracle from the same local bases at ELASTIC_TOL.
ELASTIC_DEAD, ELASTIC_ROUND, ELASTIC_TOL = 3, 1, 1e-4
# The streaming lanes (A9, phase 3): the stacked service at the main width
# fed each shard's N_PER_SHARD rows in STREAM_STEPS chunks, refreshing every
# STREAM_CADENCE steps under plan "auto", then again with shard STREAM_DEAD
# dead from step STREAM_DEAD_AT; in the rank world each rank streams its
# N_PSUM rows in RANK_STREAM_STEPS chunks, cadence RANK_STREAM_CADENCE,
# shard STREAM_DEAD dead from step RANK_STREAM_DEAD_AT, held to the stacked
# service fed the same rows and schedule at STACK_TOL.  A refresh-over-
# refresh jump above JUMP_BAR is a flip or a broken reference chain (the
# reference test's bar).  A re-refresh on the same state moves the served
# basis only through the rounds' reference dependence, which is second
# order in the local bases' spread: its bar is
# eps^2 = mean_i ||(I - v v^T) V_i||_F^2 over the local bases V_i and the
# served v, measured in the lane (a flip moves the basis by >= 2).
STREAM_STEPS, STREAM_CADENCE = 16, 4
STREAM_CHUNK = N_PER_SHARD // STREAM_STEPS
STREAM_DEAD, STREAM_DEAD_AT = 3, 8
RANK_STREAM_STEPS, RANK_STREAM_CADENCE, RANK_STREAM_DEAD_AT = 8, 2, 4
JUMP_BAR = 0.5
# The serve --subspace lane's queries and batch; the spectral-init lane
# (quadratic sensing, SPECTRAL_M machines, n = i r d rows a machine).
SERVE_QUERIES, SERVE_QBATCH = 4096, 256
SPECTRAL_D, SPECTRAL_R, SPECTRAL_M, SPECTRAL_ITER = 1024, 8, 8, 10
SPECTRAL_SCALES = (1, 2, 4, 8)
# The planner held to the card (phase 4): the stacked rounds at these r
# (tools/h100_model.py's CELL_RS), every cell, 2 rounds; the planner's
# pick must be within PLAN_SLACK of the fastest measured cell.
PLAN_RS, PLAN_SLACK = (128, 256), 1.3

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
# The recurrent serving lane: each arch at its full config with the same
# traffic (SERVE_BATCH x SERVE_PROMPT prompt tokens, SERVE_GEN greedy
# tokens), its attention blocks (the prefill's flash launches), and the
# dtype of its continuation check.  mamba2-370m's is f32: at its full
# width (48 blocks, random weights) the bf16 model's last logits are set
# by where it rounds as much as by the tokens (the lane prints how far
# they move when only the SSD chunk changes, 128 -> 64, and how far they
# sit from the same weights in f32), so its bf16 continuation is printed
# and the check holds the served weights widened to f32, where the two
# forms agree to f32 rounding.
RECURRENT_ARCHS = (("recurrentgemma-2b", 8, "bfloat16"), ("mamba2-370m", 0, "float32"))
# B3 / B5 / B6 past the shared-memory Newton-Schulz tiles (r > 136).
WIDE_RS = (192, 256)
# B8 at head_dim 256 (bf16: the 64-key-tile wgmma form) timed at
# recurrentgemma-2b's local attention shape.
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
    # qwen3-moe-30b-a3b's prefill shape (the MoE lane): head_dim 64.
    ("main qwen3 (4, 32/4, 4096x4096, 64) bf16", (4, 32, 4, 4096, 4096, 64), "bfloat16",
     None),
    # internvl2-2b's prefill shape (the VLM lane): 256 patches + 4096 tokens.
    ("main internvl2 (4, 16/8, 4352x4352, 128) bf16", (4, 16, 8, 4352, 4352, 128),
     "bfloat16", None),
    # head_dim past 128: bf16 through the 64-key-tile wgmma kernel (its
    # tile and window edges, s > t, MQA, the last TMA box zero-filled past
    # hd), f32 through the wide kernel.
    ("ragged hd 136 (1, 4/2, 300x300) bf16", (1, 4, 2, 300, 300, 136), "bfloat16", None),
    ("ragged hd 200 window 65 (1, 4/2, 257x257) bf16", (1, 4, 2, 257, 257, 200),
     "bfloat16", 65),
    ("ragged edge hd 256 (1, 4/2, 65x65) bf16", (1, 4, 2, 65, 65, 256), "bfloat16", None),
    ("ragged edge hd 256 (1, 4/2, 129x129) bf16", (1, 4, 2, 129, 129, 256), "bfloat16",
     None),
    ("ragged edge hd 256 window 64 (1, 4/2, 300x300) bf16", (1, 4, 2, 300, 300, 256),
     "bfloat16", 64),
    ("ragged edge hd 256 window 65 (1, 4/2, 300x300) bf16", (1, 4, 2, 300, 300, 256),
     "bfloat16", 65),
    ("ragged hd 256 MQA (2, 10/1, 200x333) bf16", (2, 10, 1, 200, 333, 256), "bfloat16",
     None),
    ("ragged hd 192 window 16 (1, 4/2, 200x457) f32", (1, 4, 2, 200, 457, 192),
     "float32", 16),
    ("ragged hd 256 (2, 10/1, 1000x1000) bf16", (2, 10, 1, 1000, 1000, 256), "bfloat16", None),
    ("ragged hd 256 window 128 (1, 4/2, 300x300) f32", (1, 4, 2, 300, 300, 256),
     "float32", 128),
    ("ragged hd 256 s>t (1, 2/1, 160x96) bf16", (1, 2, 1, 160, 96, 256), "bfloat16", None),
    # recurrentgemma-2b's local attention (the recurrent lane): FLASH_WIDE.
    ("main recurrentgemma (4, 10/1, 4096x4096, 256) window 2048 bf16", *FLASH_WIDE),
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


def round_kernels(plan) -> dict:
    """The kernels one stacked (gather) round of ``plan``'s cell launches."""
    if plan.backend != "cuda":
        return {}
    if plan.polar == "newton-schulz" and plan.orth == "cholesky-qr2":
        return {"fused_round": 1}
    return {"batched_gram_polar" if plan.polar == "newton-schulz" else "batched_gram": 1,
            "align_average": 1}


def stream_refresh_steps(steps: int, cadence: int, dead_at=None) -> list:
    """The steps after which a cadence-driven service refreshes: the
    bootstrap after step 1, every ``cadence`` steps after the last, at once
    on a failure before step ``dead_at``, and a final one if stale."""
    out, last = [], None
    for t in range(steps):
        if t == dead_at and last is not None:
            out.append(t)
            last = t
        if last is None or t + 1 - last >= cadence:
            out.append(t + 1)
            last = t + 1
    if last != steps:
        out.append(steps)
    return out


def feed_stream(torch, svc, chunk_of, steps: int, *, dead=None, dead_at=None) -> dict:
    """Drive ``svc`` for ``steps`` steps (``chunk_of(t)`` the step's rows;
    shard ``dead`` dies before step ``dead_at``), then serve the full-data
    basis if stale.  Records each refresh's step, jump and plan, each
    step's host time (synchronised) and the lane's wall."""
    from repro_torch.comm import Membership

    def sync():
        if svc.dev.type == "cuda":
            torch.cuda.synchronize(svc.dev)

    rec = {"refresh_steps": [], "jumps": [], "plans": [], "step_ms": [], "refreshed": []}

    def note() -> bool:
        st = svc.stats
        if st["refreshes"] == len(rec["refresh_steps"]):
            return False
        rec["refresh_steps"].append(st["step"])
        rec["jumps"].append(st["last_jump"])
        rec["plans"].append(svc.plan)
        return True

    sync()
    t_lane = time.perf_counter()
    for t in range(steps):
        t0 = time.perf_counter()
        hit = False
        if t == dead_at:
            svc.set_membership(Membership.from_dead(svc.m, [dead]))
            hit = note()
        svc.observe(chunk_of(t))
        sync()
        hit = note() or hit
        rec["refreshed"].append(hit)
        rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
    if svc.stats["staleness"]:
        t0 = time.perf_counter()
        svc.refresh()
        sync()
        note()
        rec["final_ms"] = 1e3 * (time.perf_counter() - t0)
    sync()
    rec["wall"] = time.perf_counter() - t_lane
    ingest = sorted(ms for ms, hit in zip(rec["step_ms"], rec["refreshed"]) if not hit)
    rec["ingest_step_ms"] = ingest[len(ingest) // 2] if ingest else float("nan")
    rec["refresh_ms"] = ([ms - rec["ingest_step_ms"] for ms, hit in
                          zip(rec["step_ms"], rec["refreshed"]) if hit]
                         + ([rec["final_ms"]] if "final_ms" in rec else []))
    return rec


def dist_calls(dist, fn):
    """Run ``fn`` with every public function of ``torch.distributed``
    replaced by a recorder; returns (fn's result, the names called)."""
    calls = []
    saved = {n: getattr(dist, n) for n in dir(dist)
             if not n.startswith("_") and callable(getattr(dist, n))
             and not isinstance(getattr(dist, n), type)}
    try:
        for n in saved:
            setattr(dist, n, lambda *a, _n=n, **k: calls.append(_n))
        out = fn()
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
    return out, calls


def rank_worker(rank: int, init: str, out: str) -> int:
    """One rank of the cross-rank lanes.  Phase 2: B7 against its plain
    version (main and ragged shapes).  Phase 3: each lane of CROSS_LANES on
    this rank's shard of the data rule, counters zeroed before each lane,
    plus the remote lane again with rank SKEW_RANK's launch delayed.
    Then the elastic lane (``elastic_pca_collective``, plan "auto",
    ELASTIC_DEAD killed before ELASTIC_ROUND) on the N_PSUM shard, with
    this rank's local basis saved for the composed oracle.
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
    from repro_torch.runtime.elastic import elastic_pca_collective
    from repro_torch.runtime.fault import FailureInjector
    from repro_torch.comm import Membership
    from repro_torch.stream import SubspaceService

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
            "grid": pa.fused_ring_round_remote.grid,
            "form": pa.fused_ring_round_remote.last_form}
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

    # The elastic lane: the planner picks the cell, shard ELASTIC_DEAD dies
    # before round ELASTIC_ROUND, the runtime re-plans at m' = WORLD - 1.
    dist.barrier()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    handed.clear()
    t0 = time.perf_counter()
    rep = elastic_pca_collective(
        shards[N_PSUM], R, group=world, device=dev, n_iter=N_ITER,
        solver="subspace", iters=ITERS, plan="auto",
        injector=FailureInjector(fail_at=((ELASTIC_DEAD, ELASTIC_ROUND),)))
    torch.cuda.synchronize()
    report["lanes"]["elastic"] = {
        "wall": time.perf_counter() - t0, "launches": kernels.launch_counts(),
        "replans": rep.replans, "final_m_active": rep.final_membership.m_active,
        "events": [{"round": e.round_index, "rounds": e.rounds, "reason": e.reason,
                    "dead": list(e.membership.dead), "m_active": e.membership.m_active,
                    "plan": {k: getattr(e.plan, k) for k in (
                        "backend", "topology", "polar", "orth", "ring_chunk",
                        "comm_bits", "words", "bits", "source")}}
                   for e in rep.events]}
    torch.save(rep.basis.cpu(), os.path.join(out, f"elastic-{rank}.pt"))
    # This rank's local basis, formed again as the runtime formed it, for
    # the oracle (after the counted run).
    v = local_eigenbasis(empirical_covariance(shards[N_PSUM], backend=rep.events[0].plan.backend),
                         R, method="subspace", iters=ITERS)[0]
    torch.save(v.cpu(), os.path.join(out, f"elastic-basis-{rank}.pt"))

    # The collective stream lane: this rank streams its N_PSUM rows, shard
    # STREAM_DEAD dies at step RANK_STREAM_DEAD_AT, plan "auto".
    dist.barrier()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    svc = SubspaceService(D, R, group=world, device=dev, n_iter=N_ITER,
                          cadence=RANK_STREAM_CADENCE, solver="subspace", iters=ITERS,
                          plan="auto")
    chunk = N_PSUM // RANK_STREAM_STEPS
    for t in range(RANK_STREAM_STEPS):
        if t == RANK_STREAM_DEAD_AT:
            svc.set_membership(Membership.from_dead(WORLD, [STREAM_DEAD]))
        svc.observe(shards[N_PSUM][t * chunk:(t + 1) * chunk])
    if svc.stats["staleness"]:
        svc.refresh()
    torch.cuda.synchronize()
    st = svc.stats
    report["lanes"]["stream"] = {
        "wall": time.perf_counter() - t0, "launches": kernels.launch_counts(),
        **{k: st[k] for k in ("step", "rows_seen", "refreshes", "staleness", "m_active",
                              "replans", "events", "last_jump")},
        "plan": [svc.plan.backend, svc.plan.topology, svc.plan.polar, svc.plan.orth,
                 svc.plan.comm_bits]}
    torch.save(svc.basis.cpu(), os.path.join(out, f"stream-{rank}.pt"))
    del svc, shards

    # Phase 4: B7 per round at the main shape, CUDA events around B7_REPS
    # rounds on every rank (each call returns once its round is done), and
    # the host clock from a common barrier; each round's waits and compute
    # from the wrapper's events.
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

    split = []

    def b7_round():
        pa.fused_ring_round_remote(v_b7, ref_b7, group=world)
        hops = pa.fused_ring_round_remote.last_hops
        split.append((sum(w for w, _ in hops), sum(c for _, c in hops)))

    report["b7_time"] = {
        "kernel": per_round(b7_round, B7_REPS),
        "plain": per_round(lambda: pa.plain_remote(v_b7, ref_b7, group=world),
                           B7_PLAIN_REPS),
    }
    report["b7_split"] = [sum(x) / B7_REPS for x in zip(*split[1:])]  # after the warm-up
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


def profile_serving(torch, dev, arch=SERVE_ARCH, top=16, model=None, prompts=None,
                    stub=None) -> None:
    """The serving lane's device time: one full-width prefill and 8 decode
    steps of ``arch`` under torch.profiler, after a warm-up prefill (the
    served traffic of ``launch.serve.load``, or the given model, prompts
    and stub inputs)."""
    from repro_torch.launch.serve import load, prefill

    if model is None:
        model, prompts, stub = load(arch, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                                    reduced=False, device=dev, seed=SEED)
    start = prompts.shape[1] + stub["patch_embeds"].shape[1] if "patch_embeds" in stub \
        else prompts.shape[1]
    cache_len = start + 8
    prefill(model, prompts, cache_len=cache_len, **stub)  # warm-up
    torch.cuda.synchronize()
    out = []
    prof, wall_us = profiled(
        torch, lambda: out.append(prefill(model, prompts, cache_len=cache_len, **stub)))
    print_profile(f"{arch} prefill {tuple(prompts.shape)} "
                  f"{ {k: tuple(v.shape) for k, v in stub.items()} }", prof, wall_us, top=top)
    logits, cache = out[0]

    def decode():
        tok = logits.argmax(-1)[:, None]
        for i in range(8):
            step, _ = model.decode_step(tok, cache, start + i)
            tok = step.argmax(-1)[:, None]

    prof, wall_us = profiled(torch, decode)
    print_profile(f"{arch} 8 decode steps, batch {prompts.shape[0]}", prof, wall_us, top=top)
    del model, prompts, logits, cache, out


def serving_gap(torch, got, want) -> tuple:
    """(relative L2, max abs over the largest |want|, argmax agreements) of
    two (rows, vocab) logit matrices."""
    rel_l2 = ((got - want).norm() / want.norm()).item()
    max_abs = ((got - want).abs().max() / want.abs().max()).item()
    return rel_l2, max_abs, int((got.argmax(-1) == want.argmax(-1)).sum())


def within_bars(torch, got, want) -> bool:
    """Finite, and within SERVE_REL_L2 / SERVE_MAX_ABS of ``want``."""
    rel_l2, max_abs, _ = serving_gap(torch, got, want)
    return bool(torch.isfinite(got).all()) and rel_l2 <= SERVE_REL_L2 and max_abs <= SERVE_MAX_ABS


def side_by_side(cmds: dict, env: dict, timeout: int = 600):
    """Start every command of ``cmds`` ({key: argv}) at once, with ``env``;
    returns ``result(key)``: that command's ``CompletedProcess`` and the
    seconds from the start until it was seen done.  The first call waits
    for all of them (reading every pipe, so none blocks on a full one).
    Any still running when this script exits (a failed check) is stopped
    then; torchrun stops its ranks on SIGTERM.  The launchers checked this
    way are mostly start-up, which overlaps."""
    import atexit

    t0 = time.monotonic()
    procs = {k: subprocess.Popen(v, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env) for k, v in cmds.items()}
    atexit.register(lambda: [p.terminate() for p in procs.values() if p.poll() is None])
    done = {}

    def result(key):
        if not done:
            for k, p in procs.items():
                out, err = p.communicate(timeout=timeout)
                done[k] = (subprocess.CompletedProcess(p.args, p.returncode, out, err),
                           time.monotonic() - t0)
        return done[key]

    return result


def serve_cmd(arch: str, batch: int = 2, prompt_len: int = 256) -> list:
    """``launch.serve`` at ``arch``'s full config on the card, 8 tokens."""
    return [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--full-config",
            "--batch", str(batch), "--prompt-len", str(prompt_len), "--gen", "8",
            "--device", "cuda"]


def peak_above_held(torch, fn):
    """``fn()``, its peak device memory above what was held when it began
    (GB; the peak statistics reset just before it, so no earlier phase's
    peak counts) and that held memory (GB)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - held) / 1e9, held / 1e9


@contextlib.contextmanager
def world_of_one():
    """A (1, 1) ``(data, model)`` mesh on the card over a gloo world of one
    rank (no DTensor collective runs on it), torn down on exit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cuda")
    finally:
        dist.destroy_process_group()


def sharded_serve(torch, launches: dict, tag: str, model, prompts, unsharded: dict, *,
                  blocks: int, stub=None, held=None) -> None:
    """[sharded-recur] / [sharded-encdec]: ``model``, the unsharded lane's
    (its caches freed), placed by ``launch.sharding.shard_model`` on a
    (1, 1) mesh (every parameter and cache a DTensor) and served again
    through ``launch.serve.generate`` with the same ``prompts``, stub
    inputs and traffic: exactly ``blocks`` flash launches in the prefill
    and none in decode (nothing else launched), the unsharded lane's
    tokens (``unsharded``: its tokens, kernel-prefill logits, prefill_s,
    warm kernel prefill s, decode ms a step, and generate's peak GB above
    the GB held when it began), and a sharded
    kernel prefill's last-position logits within SERVE_REL_L2 /
    SERVE_MAX_ABS of the unsharded one's; prefill_s, that warm prefill's
    time, decode ms a step and the peaks (placing the model, serving)
    printed beside the unsharded lane's.  The model is left sharded.  With ``held`` (a
    dict) the checks go into it, for the caller to require."""
    from torch.distributed.tensor import DTensor

    from repro_torch import kernels
    from repro_torch.launch import sharding as S
    from repro_torch.launch.serve import generate

    t0 = time.perf_counter()
    stub = stub or {}
    cfg = model.cfg
    with world_of_one() as mesh:
        torch.cuda.empty_cache()
        _, place_peak, place_held = peak_above_held(torch, lambda: S.shard_model(model, cfg, mesh))
        params_dt = all(isinstance(p, DTensor) for p in model.parameters())
        kernels.reset_launch_counts()
        (toks, st), peak, gen_held = peak_above_held(
            torch, lambda: generate(model, prompts, gen=SERVE_GEN, mesh=mesh, **stub))
        counts = kernels.launch_counts()
        launches["flash_attention"] += counts["flash_attention"]
        with S.sharded(mesh):
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
            placed = S.shard_batch({"tokens": prompts, **stub}, mesh)
            lead = (placed.pop("frames"),) if "frames" in placed else ()
            logits, cache = model.prefill(*lead, placed.pop("tokens"), **placed)
            got = logits.full_tensor()[:, :cfg.vocab_size]
            torch.cuda.synchronize()
            t_warm = time.perf_counter() - t_warm
            flash = ""
            if blocks:  # B8's device time a launch in one more warm prefill
                prof, wall_us = profiled(torch, lambda: model.prefill(
                    *lead, S.shard_batch({"t": prompts}, mesh)["t"], **placed))
                events = [e for e in prof.key_averages()
                          if str(e.device_type).endswith("CUDA")]
                busy = sum(e.self_device_time_total for e in events)
                fa = [e for e in events if "flash_fwd" in e.key]
                fa_us, n_fa = sum(e.self_device_time_total for e in fa), sum(e.count for e in fa)
                flash = (f"; one warm prefill under the profiler: wall {wall_us / 1e3:.1f} ms, "
                         f"device {busy / 1e3:.1f} ms, B8 {fa_us / 1e3:.2f} ms over {n_fa} "
                         f"launches ({fa_us / 1e3 / max(n_fa, 1):.3f} ms a launch, "
                         f"{100 * fa_us / max(busy, 1):.1f} % of the device time)")
        leaves = []

        def walk(c):
            if isinstance(c, dict):
                for v in c.values():
                    walk(v)
            elif isinstance(c, list):
                for v in c:
                    walk(v)
            else:
                leaves.append(c)

        walk(cache)
        cache_dt = all(isinstance(t, DTensor) for t in leaves)
        del logits, cache, leaves
    rel_l2, max_abs, agree = serving_gap(torch, got, unsharded["logits"])
    same = bool((toks == unsharded["toks"].cpu()).all())
    dec_ms = st["decode_s"] / SERVE_GEN * 1e3
    print(f"[{tag}] {cfg.name} full config on a (1, 1) mesh (every parameter a DTensor "
          f"{params_dt}, every cache tensor {cache_dt}): prefill_s {st['prefill_s']:.4f} "
          f"(unsharded {unsharded['prefill_s']:.4f}; the first sharded call fills DTensor's "
          f"sharding caches), warm prefill {t_warm:.4f} s (unsharded {unsharded['warm_s']:.4f}, "
          f"{t_warm / unsharded['warm_s']:.2f}x), decode {dec_ms:.2f} ms/step (unsharded "
          f"{unsharded['decode_ms']:.2f}, {dec_ms / unsharded['decode_ms']:.2f}x), peak in "
          f"generate {peak:.2f} GB above the {gen_held:.2f} GB held (unsharded "
          f"{unsharded['peak_gb']:.2f} above {unsharded['held_gb']:.2f}), peak placing the "
          f"model {place_peak:.2f} GB above the {place_held:.2f} GB held; flash launches "
          f"{st['flash_launches']}; tokens equal the unsharded lane's {same}; last logits vs "
          f"the unsharded kernel prefill: rel L2 {rel_l2:.3e}, max abs {max_abs:.3e} of the "
          f"largest (bars {SERVE_REL_L2}, {SERVE_MAX_ABS}), argmax agree "
          f"{agree}/{got.shape[0]}{flash}; lane {time.perf_counter() - t0:.1f} s")
    checks = {
        f"{tag} {cfg.name} DTensors": params_dt and cache_dt,
        f"{tag} {cfg.name} flash launches {st['flash_launches']}, {counts}":
            st["flash_launches"] == {"prefill": blocks, "decode": 0}
            and counts == expected_counts({"flash_attention": blocks}),
        f"{tag} {cfg.name} tokens equal the unsharded lane's": same,
        f"{tag} {cfg.name} logits within the serving bars":
            within_bars(torch, got, unsharded["logits"])}
    if held is not None:
        held.update(checks)
        return
    for name, ok in checks.items():
        require(ok, f"{name}: failed")


# -- the recurrent serving lane (phase 3) -------------------------------------
def recurrent_lanes(torch, dev, launches: dict, serve_cli) -> dict:
    """recurrentgemma-2b (RG-LRU + local attention, B8 windowed at head_dim
    256) and mamba2-370m (SSD) served at their full configs through
    ``launch.serve``'s ``load`` and ``generate``: exactly one flash launch
    an attention block in the prefill and none in decode; the served model
    and prompts prefilled through the kernel and through plain attention,
    and prefilled over the first SERVE_PROMPT - 1 tokens then decoded one
    step (the ring, the recurrent states and the conv tails carried on the
    card), each against the whole prefill's last-position logits within
    SERVE_REL_L2 / SERVE_MAX_ABS; then the hybrid's serve launcher run
    (``serve_cli``: ``side_by_side``'s result) is checked.  Returns B8's
    device time in one warm hybrid prefill (the profiler's sum over the
    flash kernel) and that prefill's device time."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.launch.serve import generate, load
    from repro_torch.models import LM

    def bars(label, got, want):
        rel_l2, max_abs, agree = serving_gap(torch, got, want)
        print(f"[recur] {label}: rel L2 {rel_l2:.3e} (bar {SERVE_REL_L2}), max abs "
              f"{max_abs:.3e} of the largest logit {want.abs().max().item():.3f} "
              f"(bar {SERVE_MAX_ABS}), argmax agree {agree}/{got.shape[0]}")
        require(within_bars(torch, got, want), f"{label}: outside the serving bars")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    b8 = {}
    for arch, attn_blocks, cont_dtype in RECURRENT_ARCHS:
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model, prompts, _ = load(arch, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                              reduced=False, device="cuda", seed=SEED)
        (toks, st), peak_gb, held_gb = peak_above_held(
            torch, lambda: generate(model, prompts, gen=SERVE_GEN))
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        cfg = model.cfg
        launches["flash_attention"] += counts["flash_attention"]
        kinds = [blk.kind for blk in model.blocks]
        print(f"[recur] {arch} full config (layers {cfg.num_layers}, blocks "
              f"{ {k: kinds.count(k) for k in dict.fromkeys(kinds)} }, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab_size}, "
              f"{sum(p.numel() for p in model.parameters())} parameters), batch "
              f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, gen {SERVE_GEN}: prefill_s "
              f"{st['prefill_s']:.4f}, decode_s {st['decode_s']:.4f} "
              f"({st['decode_s'] / SERVE_GEN * 1e3:.2f} ms/step), prefill "
              f"{SERVE_BATCH * SERVE_PROMPT / st['prefill_s']:.0f} tok/s, decode "
              f"{SERVE_BATCH * SERVE_GEN / st['decode_s']:.1f} tok/s, peak memory in "
              f"generate {peak_gb:.2f} GB above the {held_gb:.2f} GB held, wall with weight "
              f"init {wall:.2f} s, attention blocks {st['attention_blocks']}, flash launches "
              f"{st['flash_launches']}")
        require(st["attention_blocks"] == attn_blocks
                and st["flash_launches"] == {"prefill": attn_blocks, "decode": 0},
                f"{arch}: flash launches {st['flash_launches']}, expected {attn_blocks} "
                f"in the prefill and none in decode")
        require(counts == expected_counts({"flash_attention": attn_blocks}),
                f"{arch}: launches {counts}")
        require(tuple(toks.shape) == (SERVE_BATCH, SERVE_GEN)
                and 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size,
                f"{arch}: token matrix {tuple(toks.shape)} out of range")

        vocab = cfg.vocab_size
        (lk, _), t_kernel = timed(lambda: model.prefill(prompts, use_kernel=None))
        (lp, _), t_plain = timed(lambda: model.prefill(prompts, use_kernel=False))
        lk, lp = lk[:, :vocab], lp[:, :vocab]
        first = bool((lk.argmax(-1).cpu() == toks[:, 0]).all())
        print(f"[recur] {arch} warm prefill through the kernel {t_kernel:.4f} s, through "
              f"plain attention {t_plain:.4f} s; first served token from the kernel "
              f"prefill {first}")
        bars(f"{arch} kernel vs plain prefill, last-position logits", lk, lp)
        require(first, f"{arch}: the served first tokens are not the kernel prefill's argmax")
        del lp
        kernels.reset_launch_counts()

        def continued(m):
            _, cache = m.prefill(prompts[:, :-1], cache_len=SERVE_PROMPT)
            return m.decode_step(prompts[:, -1:], cache, SERVE_PROMPT - 1)[0][:, :vocab]

        lc, t_cont = timed(lambda: continued(model))
        require(kernels.launch_counts()["flash_attention"] == attn_blocks,
                f"{arch}: continuation launches {kernels.launch_counts()}")
        launches["flash_attention"] += attn_blocks
        label = (f"{arch} prefill {SERVE_PROMPT - 1} + decode 1 ({t_cont:.4f} s) vs "
                 f"prefill {SERVE_PROMPT}")
        if cont_dtype == cfg.dtype:
            bars(label, lc, lk)
        else:
            # The served weights widened to f32 (exact), the same checks.
            def twin(**changes):
                m = LM(dataclasses.replace(cfg, **changes), device=dev,
                       param_dtype=torch.float32 if "dtype" in changes else None)
                m.load_state_dict(model.state_dict())  # bf16 widens exactly
                return m

            def rel(a, b):
                return ((a - b).norm() / b.norm()).item()

            chunk = twin(ssm_chunk=cfg.ssm_chunk // 2)
            lh = chunk.prefill(prompts)[0][:, :vocab]
            del chunk
            wide = twin(dtype=cont_dtype)
            lw = wide.prefill(prompts)[0][:, :vocab]
            print(f"[recur] {label}, {cfg.dtype} (not held): rel L2 {rel(lc, lk):.3e}; "
                  f"the {cfg.dtype} prefill at chunk {cfg.ssm_chunk // 2}: "
                  f"{rel(lh, lk):.3e}; in {cont_dtype}: {rel(lk, lw):.3e}")
            bars(f"{label}, {cont_dtype}", continued(wide), lw)
            del wide, lw, lh
        if attn_blocks:
            model.prefill(prompts)  # warm
            prof, wall_us = profiled(torch, lambda: model.prefill(prompts))
            events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
            busy_us = sum(e.self_device_time_total for e in events)
            fa = [e for e in events if "flash_fwd" in e.key]
            fa_us = sum(e.self_device_time_total for e in fa)
            b8 = {"arch": arch, "prefill_device_ms": busy_us / 1e3,
                  "prefill_wall_ms": wall_us / 1e3, "flash_ms": fa_us / 1e3,
                  "flash_calls": sum(e.count for e in fa),
                  "flash_share": fa_us / max(busy_us, 1)}
            print(f"[recur] {arch} one warm prefill under the profiler: wall "
                  f"{wall_us / 1e3:.1f} ms, device {busy_us / 1e3:.1f} ms; B8 "
                  f"({', '.join(sorted({e.key[:40] for e in fa})) or 'not seen'}) "
                  f"{fa_us / 1e3:.2f} ms over {b8['flash_calls']} launches, "
                  f"{100 * b8['flash_share']:.1f} % of the device time")
        # [sharded-recur]: the same model and prompts on a (1, 1) mesh; then
        # the hybrid on SHARD_RANKS ranks ([sharded-ranks]).
        unsharded = {"toks": toks, "logits": lk, "prefill_s": st["prefill_s"],
                     "warm_s": t_kernel, "decode_ms": st["decode_s"] / SERVE_GEN * 1e3,
                     "peak_gb": peak_gb, "held_gb": held_gb}
        sharded_serve(torch, launches, "sharded-recur", model, prompts, unsharded,
                      blocks=attn_blocks)
        del model, prompts, lc
        torch.cuda.empty_cache()
        if attn_blocks:
            sharded_ranks(torch, dev, launches, unsharded, arch=arch)
        del lk, unsharded
        torch.cuda.empty_cache()

    arch, attn_blocks, _ = RECURRENT_ARCHS[0]
    cli, took = serve_cli(arch)  # run beside the first serve launcher's
    require(cli.returncode == 0, f"serve launcher ({arch}) failed:\n{cli.stderr[-4000:]}")
    lines = cli.stdout.strip().splitlines()
    stats = dict(line.split(": ", 1) for line in lines[2:])
    print(f"[cli] repro_torch.launch.serve --arch {arch} --full-config --batch 2 "
          f"--prompt-len 256 --gen 8 ({took:.1f} s, side by side): {lines[0]}; "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("config", "prefill_tokens_per_s", "decode_tokens_per_s",
                       "attention_blocks", "flash_launches_prefill",
                       "flash_launches_decode")))
    require(lines[0] == "generated token matrix: (2, 8)"
            and stats["attention_blocks"] == str(attn_blocks)
            and stats["flash_launches_prefill"] == str(attn_blocks)
            and stats["flash_launches_decode"] == "0",
            f"serve launcher ({arch}): wrong token matrix or flash launches")
    return b8


# -- the MoE serving lane (phase 3) -------------------------------------------
# qwen3-moe-30b-a3b at its full config: 48 blocks of full attention (head_dim
# 64, 32 query heads on 4 KV heads) and 128 experts top-8 (expert d_ff 768),
# 30,079,649,792 parameters (60.16 GB in bf16) with the padded vocab; the
# other serving lanes' traffic; its default einsum dispatch form (one
# capacity per row: 320 slots an expert at 4096 tokens, 4 in decode).
MOE_ARCH, MOE_PARAMS = "qwen3-moe-30b-a3b", 30_079_649_792
# B8 at qwen3's prefill shape (b, hq, hkv, s, t, hd), bf16, causal (phase 4).
FLASH_MOE = (4, 32, 4, 4096, 4096, 64)


def moe_routes(torch, model):
    """Forward hooks on every MoE layer of ``model``: each forward appends,
    per layer, the routing of the layer's input computed again
    (``MoE.routing``; the module keeps no counters): the experts (uint8),
    the pairs dropped, and whether each row's last token lost a pair.
    Returns (the records, a function that removes the hooks)."""
    rec = []

    def hook(mod, inp, _out):
        rt = mod.routing(inp[0])
        rec.append({"experts": rt.experts.to(torch.uint8), "drops": (~rt.keep).sum(),
                    "pairs": rt.keep.numel(), "last_dropped": (~rt.keep[:, -1]).any(-1)})

    handles = [blk.mlp.register_forward_hook(hook) for blk in model.blocks]
    return rec, lambda: [h.remove() for h in handles]


def moe_lane(torch, dev, launches: dict) -> dict:
    """qwen3-moe-30b-a3b served at its full config through ``launch.serve``'s
    ``load`` and ``generate``: exactly one flash launch a block in the
    prefill (48) and none in decode; the pairs each layer drops in the
    prefill (forward hooks); the served model and prompts prefilled through
    the kernel and through plain attention one prompt row at a time (rows
    are independent in the einsum form; plain attention over the whole
    batch would not fit beside the weights), the routing decisions that
    differ between the two, the last-position logits within SERVE_REL_L2 /
    SERVE_MAX_ABS; a prefill of the first SERVE_PROMPT - 1 tokens plus one
    decode step against the whole prefill (both at capacity 320, so the
    first 4095 tokens' places and drops are the same; a decode step never
    drops): the K/V caches' first 4095 slots within the bars, and the
    logits of each row whose last token kept all its pairs in every layer
    (a dropped last token makes the two another function, by the
    reference's own semantics); B8's share of one profiled warm prefill;
    then the serve launcher in its own process.  Every check is printed
    before any is required.  Returns B8's served numbers for phase 4."""
    from repro_torch import kernels
    from repro_torch.launch.serve import generate, load
    from repro_torch.models.layers import moe_capacity

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.empty_cache()
    print(f"[moe] memory allocated before the lane: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    (model, prompts, _), t_init = timed(lambda: load(
        MOE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, reduced=False,
        device="cuda", seed=SEED))
    toks, st = generate(model, prompts, gen=SERVE_GEN)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = model.cfg
    layers, vocab = cfg.num_layers, cfg.vocab_size
    n_params = sum(p.numel() for p in model.parameters())
    launches["flash_attention"] += counts["flash_attention"]
    print(f"[moe] {MOE_ARCH} full config (layers {layers}, d_model {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, experts "
          f"{cfg.num_experts} top-{cfg.num_experts_per_token}, d_ff {cfg.d_ff}, vocab "
          f"{vocab}, {n_params} parameters, dispatch {cfg.moe_impl}), batch {SERVE_BATCH}, "
          f"prompt {SERVE_PROMPT}, gen {SERVE_GEN}: weight init {t_init:.2f} s, prefill_s "
          f"{st['prefill_s']:.4f}, decode_s {st['decode_s']:.4f} "
          f"({st['decode_s'] / SERVE_GEN * 1e3:.2f} ms/step), prefill "
          f"{SERVE_BATCH * SERVE_PROMPT / st['prefill_s']:.0f} tok/s, decode "
          f"{SERVE_BATCH * SERVE_GEN / st['decode_s']:.1f} tok/s, peak memory "
          f"{peak_gb:.2f} GB, attention blocks {st['attention_blocks']}, flash launches "
          f"{st['flash_launches']}, tokens {tuple(toks.shape)} in "
          f"[{int(toks.min())}, {int(toks.max())}]")
    require(n_params == MOE_PARAMS, f"{MOE_ARCH}: {n_params} parameters, not {MOE_PARAMS}")
    require(st["attention_blocks"] == layers
            and st["flash_launches"] == {"prefill": layers, "decode": 0},
            f"{MOE_ARCH}: flash launches {st['flash_launches']}, expected {layers} in "
            f"the prefill and none in decode")
    require(counts == expected_counts({"flash_attention": layers}),
            f"{MOE_ARCH}: launches {counts}")
    require(tuple(toks.shape) == (SERVE_BATCH, SERVE_GEN)
            and 0 <= int(toks.min()) and int(toks.max()) < vocab,
            f"{MOE_ARCH}: token matrix {tuple(toks.shape)} out of range")

    (lw, _), t_warm = timed(lambda: model.prefill(prompts))
    lw = lw[:, :vocab]
    rec, unhook = moe_routes(torch, model)
    lk, kcache = model.prefill(prompts)
    kern = list(rec)
    rec.clear()
    rows, t_plain = timed(lambda: [model.prefill(prompts[i:i + 1], use_kernel=False)[0]
                                   for i in range(SERVE_BATCH)])
    plain = list(rec)  # row by row, each its layers in order
    unhook()
    lk, lp = lk[:, :vocab], torch.cat(rows)[:, :vocab]
    del rows
    drops = [int(r["drops"]) for r in kern]
    pairs = kern[0]["pairs"]
    worst = max(range(layers), key=drops.__getitem__)
    flips = last_flips = 0
    for li in range(layers):
        ke = kern[li]["experts"].sort(-1).values
        pe = torch.cat([plain[i * layers + li]["experts"] for i in range(SERVE_BATCH)])
        differ = (ke != pe.sort(-1).values).any(-1)  # (B, S)
        flips += int(differ.sum())
        last_flips += int(differ[:, -1].sum())
    decisions = layers * SERVE_BATCH * SERVE_PROMPT
    first = bool((lw.argmax(-1).cpu() == toks[:, 0]).all())
    print(f"[moe] warm prefill through the kernel {t_warm:.4f} s; through plain attention "
          f"one row at a time {t_plain:.4f} s; first served token from the kernel prefill "
          f"{first}; hooked prefill equal to the warm one {bool(torch.equal(lk, lw))}")
    print(f"[moe] drops in the prefill (capacity {moe_capacity(cfg, SERVE_PROMPT)} slots an "
          f"expert a row, {pairs} pairs a layer): "
          f"{sum(drops)} of {layers * pairs} pairs ({100 * sum(drops) / (layers * pairs):.3f} "
          f"%); the most in layer {worst}: {drops[worst]} "
          f"({100 * drops[worst] / pairs:.3f} %); per layer {drops}")
    print(f"[moe] routing decisions (token, layer) whose expert set differs between the "
          f"kernel and the plain prefill: {flips} of {decisions} "
          f"({100 * flips / decisions:.4f} %), {last_flips} of {layers * SERVE_BATCH} at the "
          f"last position")
    gaps = {"kernel vs plain prefill": serving_gap(torch, lk, lp)}
    held = {"kernel vs plain prefill": within_bars(torch, lk, lp)}

    kernels.reset_launch_counts()

    def continued():
        _, cache = model.prefill(prompts[:, :-1], cache_len=SERVE_PROMPT)
        return model.decode_step(prompts[:, -1:], cache, SERVE_PROMPT - 1)[0], cache

    (lc, ccache), t_cont = timed(continued)
    lc = lc[:, :vocab]
    c_launches = kernels.launch_counts()["flash_attention"]
    launches["flash_attention"] += c_launches
    last = torch.stack([r["last_dropped"] for r in kern]).cpu()  # (layers, B)
    dropped_rows = last.any(0)
    cache_rel, cache_abs = [], []
    for kc, cc in zip(kcache, ccache):
        for name in ("k", "v"):
            want = kc[name][:, :, :SERVE_PROMPT - 1].float()
            got = cc[name][:, :, :SERVE_PROMPT - 1].float()
            cache_rel.append(((got - want).norm() / want.norm()).item())
            cache_abs.append(((got - want).abs().max() / want.abs().max()).item())
    label = f"prefill {SERVE_PROMPT - 1} + decode 1 ({t_cont:.4f} s) vs prefill {SERVE_PROMPT}"
    print(f"[moe] {label}: flash launches {c_launches}; the last token lost a pair in the "
          f"{SERVE_PROMPT}-token prefill in rows {dropped_rows.nonzero().flatten().tolist()} "
          f"(layers {[li for li in range(layers) if last[li].any()]}); K/V caches' first "
          f"{SERVE_PROMPT - 1} slots over {2 * layers} tensors: worst rel L2 "
          f"{max(cache_rel):.3e}, worst max abs {max(cache_abs):.3e} of the largest")
    held["K/V caches' first slots"] = (max(cache_rel) <= SERVE_REL_L2
                                       and max(cache_abs) <= SERVE_MAX_ABS)
    kept = ~dropped_rows.to(lc.device)
    gaps[f"{label}, all rows"] = serving_gap(torch, lc, lw)
    if kept.any():
        gaps[f"{label}, rows whose last token kept its pairs"] = serving_gap(
            torch, lc[kept], lw[kept])
        held[f"{label}, rows whose last token kept its pairs"] = within_bars(
            torch, lc[kept], lw[kept])
    for name, (rel_l2, max_abs, agree) in gaps.items():
        print(f"[moe] {name}: rel L2 {rel_l2:.3e} (bar {SERVE_REL_L2}), max abs "
              f"{max_abs:.3e} of the largest logit (bar {SERVE_MAX_ABS}), argmax agree "
              f"{agree}/{SERVE_BATCH if 'kept' not in name else int(kept.sum())}"
              f"{'' if name in held else ' (printed, not held)'}")
    del kcache, ccache, lc, lk, lp, kern, plain, rec

    model.prefill(prompts)  # warm
    prof, wall_us = profiled(torch, lambda: model.prefill(prompts))
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in events)
    fa = [e for e in events if "flash_fwd" in e.key]
    fa_us = sum(e.self_device_time_total for e in fa)
    b8 = {"arch": MOE_ARCH, "prefill_device_ms": busy_us / 1e3,
          "prefill_wall_ms": wall_us / 1e3, "flash_ms": fa_us / 1e3,
          "flash_calls": sum(e.count for e in fa), "flash_share": fa_us / max(busy_us, 1)}
    names = ", ".join(sorted({e.key[:40] for e in fa})) or "not seen"
    print(f"[moe] one warm prefill under the profiler: wall {wall_us / 1e3:.1f} ms, device "
          f"{busy_us / 1e3:.1f} ms; B8 ({names}) {fa_us / 1e3:.2f} ms over "
          f"{b8['flash_calls']} launches, "
          f"{100 * b8['flash_share']:.1f} % of the device time")
    print_profile(f"{MOE_ARCH} prefill {SERVE_BATCH} x {SERVE_PROMPT}", prof, wall_us, top=20)
    del model, prompts, lw, prof
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", MOE_ARCH,
         "--full-config", "--batch", "2", "--prompt-len", "256", "--gen", "8",
         "--device", "cuda"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": SRC},
    )
    require(cli.returncode == 0, f"serve launcher ({MOE_ARCH}) failed:\n{cli.stderr[-4000:]}")
    lines = cli.stdout.strip().splitlines()
    stats = dict(line.split(": ", 1) for line in lines[2:])
    print(f"[cli] repro_torch.launch.serve --arch {MOE_ARCH} --full-config --batch 2 "
          f"--prompt-len 256 --gen 8 ({time.monotonic() - t0:.1f} s): {lines[0]}; "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("config", "prefill_tokens_per_s", "decode_tokens_per_s",
                       "attention_blocks", "flash_launches_prefill",
                       "flash_launches_decode")))
    require(lines[0] == "generated token matrix: (2, 8)"
            and stats["attention_blocks"] == str(layers)
            and stats["flash_launches_prefill"] == str(layers)
            and stats["flash_launches_decode"] == "0",
            f"serve launcher ({MOE_ARCH}): wrong token matrix or flash launches")
    require(first, f"{MOE_ARCH}: the served first tokens are not the kernel prefill's argmax")
    require(c_launches == layers, f"{MOE_ARCH}: continuation launches {c_launches}")
    for name, ok in held.items():
        require(ok, f"{MOE_ARCH}: {name} outside the serving bars")
    return b8


# -- the VLM and encoder-decoder serving lanes (phase 3) ----------------------
# internvl2-2b at its full config (24 layers, d_model 2048, 16 query heads on
# 8 KV heads at head_dim 128; 1,891,244,032 parameters): the serving lanes'
# traffic (SERVE_BATCH x SERVE_PROMPT tokens, SERVE_GEN greedy tokens) after
# the config's 256 patch embeddings (the stub frontend's (B, 256, 1024), drawn
# by ``launch.serve.load``), so B8 runs causal at VLM_FLASH.
VLM_ARCH, VLM_PARAMS = "internvl2-2b", 1_891_244_032
VLM_FLASH = (SERVE_BATCH, 16, 8, 256 + SERVE_PROMPT, 256 + SERVE_PROMPT, 128)
# whisper-tiny (4 encoder + 4 decoder layers, d_model 384, 6 heads of 64, one
# query head a KV head; 56,355,456 parameters) at its realistic shape:
# WHISPER_BATCH requests of WHISPER_FRAMES frames (whisper's 30-s window after
# its conv stack) and a WHISPER_PROMPT-token decoder prompt, SERVE_GEN greedy
# tokens, through ``EncDec.prefill`` / ``decode_step``; its encoder runs B8
# bidirectional at WHISPER_FLASH (s = t = 1500: 11 full 128-row tiles and one
# of 92).  The launcher's semantics (frames = prompt length) run at
# WHISPER_CLI_PROMPT.
WHISPER_ARCH, WHISPER_PARAMS = "whisper-tiny", 56_355_456
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_CLI_PROMPT = 32, 1500, 64, 448
WHISPER_FLASH = (WHISPER_BATCH, 6, 6, WHISPER_FRAMES, WHISPER_FRAMES, 64)
# B8 held bidirectional (causal=False) against its plain version: (label,
# (b, hq, hkv, s, t, hd), dtype).  Whisper's encoder shape, ragged s = t at
# 1, 17 and 129, s != t both ways (every query row sees every key; no row is
# empty), head_dim 64 with groups 1 and 4, and head_dim 128.
FLASH_BIDIR_CHECKS = (
    ("whisper encoder (32, 6/6, 1500x1500, 64) bf16", WHISPER_FLASH, "bfloat16"),
    ("ragged s=t=1 (2, 4/1, 1x1, 64) bf16", (2, 4, 1, 1, 1, 64), "bfloat16"),
    ("ragged s=t=17 (1, 4/4, 17x17, 64) f32", (1, 4, 4, 17, 17, 64), "float32"),
    ("ragged s=t=129 (2, 8/2, 129x129, 128) bf16", (2, 8, 2, 129, 129, 128), "bfloat16"),
    ("ragged s<t (1, 4/1, 96x300, 64) bf16", (1, 4, 1, 96, 300, 64), "bfloat16"),
    ("ragged s>t (1, 4/2, 300x96, 128) bf16", (1, 4, 2, 300, 96, 128), "bfloat16"),
    ("ragged s>t (2, 6/6, 257x129, 64) f32", (2, 6, 6, 257, 129, 64), "float32"),
)


def whisper_inputs(torch, dev):
    """whisper-tiny's full-config model from the seeded generator and its
    realistic request: (model, WHISPER_BATCH x WHISPER_PROMPT tokens,
    {"frames": (WHISPER_BATCH, WHISPER_FRAMES, 384) bf16})."""
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config(WHISPER_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    frames = torch.randn(WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model, generator=gen,
                         device=dev, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT), generator=gen,
                           device=dev)
    return model, tokens, {"frames": frames}


def profile_whisper(torch, dev) -> None:
    """One whisper-tiny prefill (the realistic request) and 8 decode steps
    under torch.profiler, after a warm-up prefill."""
    model, tokens, stub = whisper_inputs(torch, dev)
    profile_serving(torch, dev, WHISPER_ARCH, model=model, prompts=tokens, stub=stub)


def vlm_whisper_lanes(torch, dev, launches: dict, serve_cli) -> dict:
    """internvl2-2b and whisper-tiny served at their full configs (see the
    constants above), on ``[vlm]`` and ``[whisper]`` lines: exact B8
    launches (24 in the VLM's prefill; 4 bidirectional in whisper's
    encoder and 4 causal in its decoder; none in decode), the kernel
    prefill against the plain prefill and a (prompt - 1) prefill plus one
    decode step against the whole prefill, within SERVE_REL_L2 /
    SERVE_MAX_ABS; prefill_s, ms a decode step and the peak memory; then
    the run of the serve launcher with ``--arch whisper-tiny --full-config``
    (``serve_cli``: ``side_by_side``'s result) is checked.
    Every check is printed before any is required.  Returns B8's served
    numbers for phase 4."""
    from repro_torch import kernels
    from repro_torch.launch.serve import generate, load

    held, served = {}, {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def bars(tag, label, got, want):
        rel_l2, max_abs, agree = serving_gap(torch, got, want)
        print(f"[{tag}] {label}: rel L2 {rel_l2:.3e} (bar {SERVE_REL_L2}), max abs "
              f"{max_abs:.3e} of the largest logit {want.abs().max().item():.3f} (bar "
              f"{SERVE_MAX_ABS}), argmax agree {agree}/{got.shape[0]}")
        held[f"{tag} {label}"] = within_bars(torch, got, want)

    def flash() -> int:
        return kernels.launch_counts()["flash_attention"]

    # internvl2-2b through launch.serve's load and generate.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    (model, prompts, stub), t_init = timed(lambda: load(
        VLM_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, reduced=False, device="cuda",
        seed=SEED))
    toks, st = generate(model, prompts, gen=SERVE_GEN, **stub)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cfg, pe = model.cfg, stub["patch_embeds"]
    p, layers = pe.shape[1], cfg.num_layers
    n_params = sum(q.numel() for q in model.parameters())
    launches["flash_attention"] += counts["flash_attention"]
    print(f"[vlm] {VLM_ARCH} full config (layers {layers}, d_model {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, vocab {cfg.vocab_size}, {n_params} "
          f"parameters with the padded vocab, patch_proj {tuple(model.patch_proj.shape)}), "
          f"batch {SERVE_BATCH}, {p} patches + prompt {SERVE_PROMPT}, gen {SERVE_GEN}: "
          f"prefill_s {st['prefill_s']:.4f}, decode_s {st['decode_s']:.4f} "
          f"({st['decode_s'] / SERVE_GEN * 1e3:.2f} ms/step), prefill "
          f"{SERVE_BATCH * (p + SERVE_PROMPT) / st['prefill_s']:.0f} tok/s, decode "
          f"{SERVE_BATCH * SERVE_GEN / st['decode_s']:.1f} tok/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, weight init {t_init:.2f} s, "
          f"attention blocks {st['attention_blocks']}, flash launches {st['flash_launches']}")
    held["vlm launches"] = (st["flash_launches"] == {"prefill": layers, "decode": 0}
                            and counts == expected_counts({"flash_attention": layers}))
    held["vlm tokens"] = (tuple(toks.shape) == (SERVE_BATCH, SERVE_GEN)
                          and 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size)
    vocab = cfg.vocab_size
    (lk, _), t_kernel = timed(lambda: model.prefill(prompts, patch_embeds=pe))
    (lp, _), t_plain = timed(lambda: model.prefill(prompts, patch_embeds=pe, use_kernel=False))
    lk, lp = lk[:, :vocab], lp[:, :vocab]
    held["vlm first tokens"] = bool((lk.argmax(-1).cpu() == toks[:, 0]).all())
    print(f"[vlm] warm prefill through the kernel {t_kernel:.4f} s, through plain attention "
          f"{t_plain:.4f} s; first served token from the kernel prefill "
          f"{held['vlm first tokens']}")
    bars("vlm", "kernel vs plain prefill, last-position logits", lk, lp)
    del lp
    kernels.reset_launch_counts()

    def vlm_continued():
        _, cache = model.prefill(prompts[:, :-1], patch_embeds=pe, cache_len=p + SERVE_PROMPT)
        return model.decode_step(prompts[:, -1:], cache, p + SERVE_PROMPT - 1)[0][:, :vocab]

    lc, t_cont = timed(vlm_continued)
    held["vlm continuation launches"] = flash() == layers
    launches["flash_attention"] += flash()
    bars("vlm", f"prefill {p} + {SERVE_PROMPT - 1} + decode 1 ({t_cont:.4f} s) vs prefill "
         f"{p} + {SERVE_PROMPT}", lc, lk)
    served["vlm"] = {"prefill_s": st["prefill_s"], "decode_ms": st["decode_s"] / SERVE_GEN * 1e3,
                     "launches": layers}
    del model, prompts, stub, pe, lk, lc
    torch.cuda.empty_cache()

    # whisper-tiny at its realistic shape through EncDec.prefill / decode_step.
    model, tokens, stub = whisper_inputs(torch, dev)
    cfg, frames = model.cfg, stub.pop("frames")
    enc_layers, dec_layers = cfg.num_encoder_layers, cfg.num_layers
    n_params = sum(q.numel() for q in model.parameters())
    torch.cuda.synchronize()
    w_held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()  # the serving's own peak, as [sharded-encdec]'s
    kernels.reset_launch_counts()
    with torch.no_grad():
        model.encode(frames)
    torch.cuda.synchronize()
    enc_launches = flash()
    kernels.reset_launch_counts()
    (logits, cache), t_prefill = timed(lambda: model.prefill(
        frames, tokens, cache_len=WHISPER_PROMPT + SERVE_GEN))
    pre_launches = flash()
    tok = logits.argmax(-1)[:, None]
    out = []

    def decode():
        nonlocal tok, cache
        for i in range(SERVE_GEN):
            out.append(tok[:, 0])
            step, cache = model.decode_step(tok, cache, WHISPER_PROMPT + i)
            tok = step.argmax(-1)[:, None]

    _, t_decode = timed(decode)
    dec_launches = flash() - pre_launches
    launches["flash_attention"] += enc_launches + flash()
    wtoks = torch.stack(out, dim=1)
    w_peak = (torch.cuda.max_memory_allocated() - w_held) / 1e9
    print(f"[whisper] {WHISPER_ARCH} full config (encoder {enc_layers} + decoder {dec_layers} "
          f"layers, d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}, {n_params} parameters with the padded "
          f"vocab), batch {WHISPER_BATCH}, {WHISPER_FRAMES} frames + prompt {WHISPER_PROMPT}, "
          f"gen {SERVE_GEN}: prefill_s {t_prefill:.4f}, decode_s {t_decode:.4f} "
          f"({t_decode / SERVE_GEN * 1e3:.2f} ms/step), decode "
          f"{WHISPER_BATCH * SERVE_GEN / t_decode:.1f} tok/s, peak memory "
          f"{w_peak:.2f} GB above the {w_held / 1e9:.2f} GB held; flash launches: encoder alone "
          f"{enc_launches} (bidirectional), prefill {pre_launches} ({enc_launches} encoder + "
          f"{pre_launches - enc_launches} decoder causal), decode {dec_launches}")
    held["whisper launches"] = (enc_launches == enc_layers
                                and pre_launches == enc_layers + dec_layers
                                and dec_launches == 0)
    held["whisper tokens"] = (tuple(wtoks.shape) == (WHISPER_BATCH, SERVE_GEN)
                              and 0 <= int(wtoks.min()) and int(wtoks.max()) < cfg.vocab_size)
    vocab = cfg.vocab_size
    (lk, _), t_kernel = timed(lambda: model.prefill(frames, tokens))
    (lp, _), t_plain = timed(lambda: model.prefill(frames, tokens, use_kernel=False))
    lk, lp = lk[:, :vocab], lp[:, :vocab]
    held["whisper first tokens"] = bool((lk.argmax(-1) == wtoks[:, 0]).all())
    print(f"[whisper] warm prefill through the kernel {t_kernel:.4f} s, through plain "
          f"attention {t_plain:.4f} s; first served token from the kernel prefill "
          f"{held['whisper first tokens']}")
    bars("whisper", "kernel vs plain prefill, last-position logits", lk, lp)
    kernels.reset_launch_counts()

    def whisper_continued():
        _, c = model.prefill(frames, tokens[:, :-1], cache_len=WHISPER_PROMPT)
        return model.decode_step(tokens[:, -1:], c, WHISPER_PROMPT - 1)[0][:, :vocab]

    lc, t_cont = timed(whisper_continued)
    held["whisper continuation launches"] = flash() == enc_layers + dec_layers
    launches["flash_attention"] += flash()
    bars("whisper", f"prefill {WHISPER_PROMPT - 1} + decode 1 ({t_cont:.4f} s) vs prefill "
         f"{WHISPER_PROMPT}", lc, lk)
    served["whisper"] = {"prefill_s": t_prefill, "decode_ms": t_decode / SERVE_GEN * 1e3,
                         "launches": {"encoder": enc_launches, "decoder": dec_launches}}
    del logits, cache, lp, lc
    # [sharded-encdec]: the same model, frames and prompts on a (1, 1) mesh.
    sharded_serve(torch, launches, "sharded-encdec", model, tokens,
                  {"toks": wtoks, "logits": lk, "prefill_s": t_prefill, "warm_s": t_kernel,
                   "decode_ms": t_decode / SERVE_GEN * 1e3, "peak_gb": w_peak,
                   "held_gb": w_held / 1e9},
                  blocks=enc_layers + dec_layers, stub={"frames": frames}, held=held)
    del model, frames, tokens, lk
    torch.cuda.empty_cache()

    # The serve launcher at whisper's reference semantics (frames = prompt),
    # run beside the first serve launcher's.
    cli, took = serve_cli(WHISPER_ARCH)
    require(cli.returncode == 0, f"serve launcher ({WHISPER_ARCH}) failed:\n{cli.stderr[-4000:]}")
    lines = cli.stdout.strip().splitlines()
    stats = dict(line.split(": ", 1) for line in lines[2:])
    blocks = enc_layers + dec_layers
    print(f"[cli] repro_torch.launch.serve --arch {WHISPER_ARCH} --full-config --batch "
          f"{SERVE_BATCH} --prompt-len {WHISPER_CLI_PROMPT} --gen 8 "
          f"({took:.1f} s, side by side): {lines[0]}; "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("config", "prefill_tokens_per_s", "decode_tokens_per_s",
                       "attention_blocks", "flash_launches_prefill", "flash_launches_decode")))
    held["whisper launcher"] = (lines[0] == f"generated token matrix: ({SERVE_BATCH}, 8)"
                                and stats["attention_blocks"] == str(blocks)
                                and stats["flash_launches_prefill"] == str(blocks)
                                and stats["flash_launches_decode"] == "0")
    for name, ok in held.items():
        require(ok, f"{name}: failed (see the lines above)")
    return served


# -- the training lanes (phase 3) ---------------------------------------------
# T1: the AdamW trainer at llama3.2-3b's full config (28 layers, d_model
# 3072, untied embeddings): f32 master weights, bf16 compute, remat per
# block, T1_BATCH x T1_SEQ tokens a step from the seeded TokenPipeline.
# Peak lr 5e-5: at the trainer's default 3e-4 with a 2-step warmup the
# first full-lr AdamW step moves every weight by ~lr with one sign, and
# the loss spiked (12.1 -> 14.1, grad norm 96; PERF.md §6).
TRAIN_ARCH = "llama3.2-3b"
T1_BATCH, T1_SEQ, T1_STEPS, T1_WARMUP, T1_LR = 8, 512, 8, 2, 5e-5
# T1c: 3 AdamW steps on the card and on the CPU from the same parameters and
# batches (granite-3-2b reduced, f32, f32 probabilities): losses within
# T1C_LOSS relative, each parameter leaf within T1C_PARAM relative L2 (the
# two devices' gradients differ by f32 rounding, which AdamW's first
# normalised steps carry into the parameters).
T1C_STEPS, T1C_LR, T1C_LOSS, T1C_PARAM = 3, 1e-3, 1e-5, 1e-4
# T2: the eigen trainer stacked on T2_SHARDS shards at T2_LAYERS of the
# full config's layers, full width; rank / min_dim as repro.launch.train.
T2_LAYERS, T2_SHARDS, T2_RANK, T2_REFRESH, T2_STEPS = 16, 4, 32, 4, 8
# T3: the eigen trainer in a rank world (T3_RANKS processes on this card
# over gloo) at T3_LAYERS full-width layers in f32, each shard its own rows
# of the pipeline's batches, held to the same trainer stacked, which runs
# first.  Each step's loss within T3_LOSS.  At each refresh every
# compressed leaf's basis but the embedding's within max(floor, 4 x the
# stacked refresh's own f32 error against the same refresh carried out in
# f64), the floor T3_FIRST_SD at the first refresh (the same parameters)
# and T3_LATER_SD after (two AdamW updates whose f32 rounding the 4-step
# local solve amplifies).  After the last step each rank's error feedback
# (sketched: err @ a seeded (n, T3_SKETCH) Gaussian), the low-rank and the
# full moments within T3_STATE of the stacked run's largest magnitude.
# The embedding's refresh is not defined on distinct rows: its shards'
# gradients sit on the rows of their own tokens, their local bases can be
# orthogonal, and two summation orders give different bases
# (tests/test_torch_train.py shows it on the reference).  So each rank
# takes the stacked run's refreshed embedding basis and moments, as the
# CPU tests take the reference's, and the steps after hold that leaf too.
T3_LAYERS, T3_RANKS, T3_STEPS, T3_REFRESH = 2, 4, 4, 2
T3_LOSS, T3_FIRST_SD, T3_LATER_SD, T3_STATE, T3_SKETCH = 1e-4, 1e-5, 1e-4, 1e-4, 16
ILL_POSED = "embed"
# T1s: T1 through ``launch.train.train(mesh=)`` on a (1, 1) mesh (every
# parameter and both AdamW moments a DTensor), T1S_STEPS steps of T1's
# traffic; its losses held to T1's first T1S_STEPS (the schedules agree
# there: warmup, then the peak) bit for bit, else within T1S_LOSS relative.
T1S_STEPS, T1S_LOSS = 4, 1e-5
# T3s: T3's trainer on a (T3_RANKS, 1) mesh in T3's rank processes, held to
# the stacked T3 run at T3's bars.  Then, in the same processes, the mesh
# checkpoint lane: T3S_CK (the reduced llama3.2-3b in f32, T3's steps, one
# refresh) on the same mesh straight, and checkpointed every 2 steps and
# preempted at T3S_FAIL; its step-2 checkpoint restored into the stacked
# trainer.  Both final losses within T4_BAR of the straight run's.  Reduced,
# because a checkpoint of T3's model holds 4 shards of error feedback of
# its 128256 x 3072 embedding and unembedding (~20 GB a step), and the
# smoke keeps its disk writes to a few GB.  One refresh, because
# a refresh after the checkpoint would average the embedding's local
# bases, whose refresh is ill-posed on distinct rows (ILL_POSED): the
# stacked and mesh forms would part there.
T3S_FAIL = 3
T3S_CK = dict(steps=T3_STEPS, batch=T1_BATCH, seq=64, lr=1e-3, warmup=T1_WARMUP, eigen=True,
              eigen_rank=8, eigen_refresh=T3_STEPS, seed=SEED, log_every=10 ** 9)
# [sharded-train-ranks]: a (2, 2) mesh of 4 ranks over NCCL, a card each, at
# T3's depth and dtype (its stacked comparison runs fit one card): AdamW
# and the eigen trainer, 4 steps each, held to the unsharded / stacked
# (2 shards) runs at T3's bars.  Every refresh's bases take T3's later
# floor, T3_LATER_SD: the model axis sums each gradient in another order
# from the first step on, and the 4-step local solve amplifies that
# rounding as it does T3's after two AdamW updates (the first refresh's
# bases lay up to 3.43e-5 from the stacked run's on 4 H100s).
SHARD_TRAIN_MESH = (2, 2)
# T4: the launcher preempted at step 5 and resumed from its step-4
# checkpoint against the straight run, both deterministic
# (torch.use_deterministic_algorithms): final losses within 1e-5, the
# reference's own bar (tests/test_fault_tolerance.py:208).
T4_ARCH, T4_STEPS, T4_FAIL, T4_BAR = "granite-3-2b", 8, 5, 1e-5
T4_DETERMINISTIC = (
    "import runpy, sys, torch; torch.use_deterministic_algorithms(True); "
    "sys.argv[0] = 'repro_torch.launch.train'; "
    "runpy.run_module('repro_torch.launch.train', run_name='__main__')")
# R1-R2: training the recurrent families (ROADMAP A11-hybrid-train,
# A11-ssm-train), after T1-T4.  R1: AdamW at each family's full config
# (recurrentgemma-2b: 26 blocks, 18 RG-LRU and 8 local attention at window
# 2048, untied embeddings; mamba2-370m: 48 SSD blocks, a tied embedding)
# with T1's traffic, steps, lr and checks, uncut.  R1c: each family's
# reduced config in f32, T1c's steps and bars, card vs CPU.  R2: the eigen
# trainer stacked with T2's shards, rank, refresh and steps: mamba2-370m at
# its full config, recurrentgemma-2b at full width and R2_HYBRID_LAYERS
# blocks (3 k + 2: both stages and 3 local attention blocks; its 26 blocks
# would need ~57 GB of error feedback alone, the cut T2 makes for llama).
# B2 and B4 are first held at R2's refresh shapes, R2_REFRESH_DS.
RECUR_TRAIN = ("recurrentgemma-2b", "mamba2-370m")
R2_HYBRID_LAYERS = 11
R2_REFRESH_DS = (256000, 7680, 2560, 50432, 2048, 1024)


def train_cfg(layers=None, **kw):
    """llama3.2-3b's full config, at ``layers`` layers if given."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(TRAIN_ARCH)
    return dataclasses.replace(cfg, **({"num_layers": layers} if layers else {}), **kw)


def refresh_exact(torch, model, opt, batch, starts, m):
    """The refresh of ``opt``'s compressed leaves (but the embedding) at
    this state, carried out in f64 in plain torch: every shard's gradient
    of its rows, its local solve from ``starts`` and the Procrustes
    average.  Returns {leaf: (d, r) f64 basis}."""
    from repro_torch.core.eigenspace import refinement_rounds
    from repro_torch.launch.steps import shard_rows
    from repro_torch.models.lm import loss_fn
    from repro_torch.optim import EigenCompressConfig

    iters = EigenCompressConfig().power_iters
    params = dict(model.named_parameters())
    names = [n for n in sorted(opt["eigen"]) if n != ILL_POSED]
    local = {n: [] for n in names}
    for i in range(m):
        loss, _ = loss_fn(model, shard_rows(batch, i, m))
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        with torch.no_grad():
            for n, g in zip(names, grads):
                q, g64 = torch.linalg.qr(starts[n].double())[0], g.double()
                for _ in range(iters):
                    q = torch.linalg.qr(g64 @ (g64.T @ q))[0]
                local[n].append(q)
        del grads
    out = {}
    with torch.no_grad():
        for n in names:
            st = opt["eigen"][n]
            prev = st["basis"].double() if bool(st["initialized"]) else None
            out[n] = refinement_rounds(torch.stack(local.pop(n)), prev, n_iter=1,
                                       backend="torch")
    return out


def recording_refreshes(torch, train_mod, seen: list, *, probes=None, force=None):
    """Make ``train_mod``'s trainer record, after each refresh, every
    compressed leaf's basis, m and v (CPU copies) into ``seen``.  With
    ``probes`` (a list) it also records each leaf's distance to the same
    refresh in f64 (``refresh_exact``, which draws no kernel); with
    ``force`` (a dict leaf -> fields a refresh) it first overwrites those
    fields of the refreshed state.  Returns the step factory to put
    back."""
    from repro_torch.core.metrics import subspace_dist64
    from repro_torch.launch.sharding import local, whole

    make = train_mod.make_eigen_refresh_step

    def recording(model, **kw):
        step = make(model, **kw)

        def run(opt, batch, starts):
            exact = (refresh_exact(torch, model, opt, batch, starts, kw["shards"])
                     if probes is not None else {})
            at = int(opt["step"])  # the step this refresh precedes
            out = step(opt, batch, starts)
            with torch.no_grad():
                for n, fields in (force or {}).get(at, {}).items():
                    for f, t in fields.items():
                        local(opt["eigen"][n][f]).copy_(t)
            seen.append({n: {f: whole(st[f]).cpu() for f in ("basis", "m", "v")}
                         for n, st in opt["eigen"].items()})
            if probes is not None:
                probes.append({n: subspace_dist64(seen[-1][n]["basis"], b.cpu())
                               for n, b in exact.items()})
            return out
        return run

    train_mod.make_eigen_refresh_step = recording
    return make


def t3_run(torch, dev, *, group=None, mesh=None, shards=T3_RANKS, probes=None, force=None,
           eigen=True, **kw):
    """T3's trainer: T3_LAYERS full-width layers in f32, eigen rank T2_RANK,
    the pipeline's own batches, stacked on ``shards`` shards, one shard a
    rank of ``group``, or on ``mesh`` (``probes`` and ``force``:
    ``recording_refreshes``; ``kw``: more of ``train``'s options).
    Returns (losses, refreshed states, optimizer state, model)."""
    from repro_torch.launch import train as train_mod

    seen = []
    make = recording_refreshes(torch, train_mod, seen, probes=probes, force=force)
    try:
        model, opt, losses = train_mod.train(
            train_cfg(T3_LAYERS, dtype="float32", attn_probs_bf16=False),
            steps=T3_STEPS, batch=T1_BATCH, seq=T1_SEQ, lr=T1_LR, warmup=T1_WARMUP,
            eigen=eigen, eigen_rank=T2_RANK, eigen_refresh=T3_REFRESH, device=dev,
            shards=None if group is not None or mesh is not None else shards, group=group,
            mesh=mesh, seed=SEED, log_every=10 ** 9, **kw)
    finally:
        train_mod.make_eigen_refresh_step = make
    return losses, seen, opt, model


def ck_run(torch, dev, **kw) -> list:
    """T3S_CK's trainer (``kw``: the mesh or shards, checkpoints, the
    failure); returns its losses."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import train as train_mod

    cfg = dataclasses.replace(get_reduced_config(TRAIN_ARCH), dtype="float32",
                              attn_probs_bf16=False)
    return train_mod.train(cfg, device=dev, **T3S_CK, **kw)[2]


def t3_state(torch, opt, shard=None) -> dict:
    """The optimizer state T3 holds, on the CPU: every compressed leaf's m,
    v and error feedback (the stacked form's ``shard``; sketched as err @
    a seeded (n, T3_SKETCH) Gaussian), and every full moment."""
    from repro_torch.launch.sharding import whole

    out = {}
    with torch.no_grad():
        for n, st in opt["eigen"].items():
            err = whole(st["err"]) if shard is None else st["err"][shard]
            gen = torch.Generator(device=err.device).manual_seed(SEED + 3)
            sketch = torch.randn(err.shape[-1], T3_SKETCH, generator=gen, device=err.device)
            out[f"err/{n}"] = (err @ sketch).cpu()
            out[f"m/{n}"], out[f"v/{n}"] = whole(st["m"]).cpu(), whole(st["v"]).cpu()
        for f in ("full_m", "full_v"):
            for n, t in opt[f].items():
                out[f"{f}/{n}"] = whole(t).cpu()
    return out


def train_rank_worker(rank: int, init: str, out: str) -> int:
    """One rank of T3: its shard of the eigen trainer, taking the stacked
    run's embedding refreshes (``t3-force.pt``), then one more train step
    with the bytes handed to torch.distributed counted.  Then T3s in the
    same process: the trainer on a (T3_RANKS, 1) mesh, the same counted
    step, and the mesh run checkpointed and preempted (its files in
    ``out/t3s-ck``)."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.interop import strict_fp32
    from repro_torch.launch.mesh import make_aggregation_mesh, make_mesh
    from repro_torch.launch.steps import make_eigen_train_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import constant

    strict_fp32()
    agg = make_aggregation_mesh(device="cuda", rank=rank, world_size=T3_RANKS,
                                local_rank=rank, local_world=T3_RANKS, init_method=init)
    force = {at: {n: {f: t.to(agg.device) for f, t in fields.items()}
                  for n, fields in k.items()}
             for at, k in torch.load(os.path.join(out, "t3-force.pt")).items()}
    handed = count_handed(dist)
    batch = {k: torch.from_numpy(v).to(agg.device, torch.long) for k, v in TokenPipeline(
        train_cfg().vocab_size, T1_SEQ, T1_BATCH, seed=SEED).batch(T3_STEPS).items()}
    report = {"rule": agg.rule}
    for lane, kw in (("t3", {"group": agg.group}),
                     ("t3s", {"mesh": make_mesh((T3_RANKS, 1), ("data", "model"),
                                                device="cuda")})):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses, seen, opt, model = t3_run(torch, agg.device, force=force, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        torch.save({"bases": [{n: st["basis"] for n, st in k.items()} for k in seen],
                    "state": t3_state(torch, opt)},
                   os.path.join(out, f"{lane}-rank{rank}.pt"))
        step = make_eigen_train_step(model, adamw_cfg=AdamWConfig(),
                                     schedule=constant(T1_LR), **kw)
        handed.clear()
        step(opt, batch)
        torch.cuda.synchronize()
        report[lane] = {"losses": losses, "wall": wall, "launches": launches,
                        "handed_step": sum(handed.values()),
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del losses, seen, opt, model, step
        torch.cuda.empty_cache()
    # The mesh checkpoint lane (T3S_CK): straight, then preempted at
    # T3S_FAIL and resumed from its step-2 checkpoint.
    t0 = time.perf_counter()
    report["ck"] = {"straight": ck_run(torch, agg.device, mesh=kw["mesh"])}
    report["ck"]["preempted"] = ck_run(torch, agg.device, mesh=kw["mesh"],
                                       checkpoint_dir=os.path.join(out, "t3s-ck"),
                                       checkpoint_every=2, fail_at=(T3S_FAIL,))
    report["ck"]["wall"] = time.perf_counter() - t0
    with open(os.path.join(out, f"t3-rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def shard_train_rank_worker(rank: int, init: str, out: str) -> int:
    """``--shard-train-rank K``: one rank of [sharded-train-ranks], T3's
    trainer on a SHARD_TRAIN_MESH mesh over NCCL (a card a rank): AdamW,
    then the eigen step taking the stacked run's embedding refreshes
    (``st-force.pt``), each with its collectives counted."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.comm import transport
    from repro_torch.interop import strict_fp32
    from repro_torch.launch import counting
    from repro_torch.launch.mesh import data_group, data_rank, make_mesh

    strict_fp32()
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    world = math.prod(SHARD_TRAIN_MESH)
    dist.init_process_group("nccl", init_method=init, rank=rank, world_size=world)
    mesh = make_mesh(SHARD_TRAIN_MESH, ("data", "model"), device="cuda")
    axes = {data_group(mesh).group_name: "data", mesh.get_group("model").group_name: "model"}
    force = {at: {n: {f: t.to(dev) for f, t in fields.items()} for n, fields in k.items()}
             for at, k in torch.load(os.path.join(out, "st-force.pt")).items()}
    report = {"data_rank": data_rank(mesh)}
    for lane, eigen in (("adamw", False), ("eigen", True)):
        kernels.reset_launch_counts()
        transport.reset_handed_bytes()
        comms = counting.LocalComms(axes=axes)
        t0 = time.perf_counter()
        with comms:
            losses, seen, opt, model = t3_run(torch, dev, mesh=mesh, eigen=eigen,
                                              force=force if eigen else None)
        torch.cuda.synchronize()
        report[lane] = {"losses": losses, "wall": time.perf_counter() - t0,
                        "launches": kernels.launch_counts(),
                        "collectives": {k: [int(comms.counts[k]), int(v)]
                                        for k, v in comms.by_kind.items()},
                        "by_axis": dict(comms.by_axis), "handed": transport.handed_bytes(),
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if eigen:
            torch.save({"bases": [{n: st["basis"] for n, st in k.items()} for k in seen],
                        "state": t3_state(torch, opt)},
                       os.path.join(out, f"st-rank{rank}.pt"))
        del losses, seen, opt, model
        torch.cuda.empty_cache()
    with open(os.path.join(out, f"st-rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def sharded_train_ranks(torch, dev, launches: dict) -> None:
    """[sharded-train-ranks] (see SHARD_TRAIN_MESH): the comparison runs on
    this card first (AdamW unsharded, the eigen trainer stacked on the
    mesh's data shards), then the rank processes
    (``--shard-train-rank K``).  Below its card count it prints its skip."""
    from repro_torch.core.metrics import subspace_dist64

    world, n_data = math.prod(SHARD_TRAIN_MESH), SHARD_TRAIN_MESH[0]
    if torch.cuda.device_count() < world:
        print(f"[sharded-train-ranks] skipped: needs {world} cards (gloo's all-gather on "
              f"CUDA crashes); this machine has {torch.cuda.device_count()}")
        return
    free_card(torch)
    base = t3_run(torch, dev, eigen=False)[0]
    free_card(torch)
    probes = []
    losses, seen, opt, _ = t3_run(torch, dev, shards=n_data, probes=probes)
    stacked_state = [t3_state(torch, opt, shard=k) for k in range(n_data)]
    del opt
    free_card(torch)
    force = {j * T3_REFRESH: {ILL_POSED: {f: k[ILL_POSED][f] for f in ("basis", "m", "v")}}
             for j, k in enumerate(seen)}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(force, os.path.join(tmp, "st-force.pt"))
        init = f"tcp://127.0.0.1:{free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--shard-train-rank", str(k),
             "--init", init, "--out", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for k in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        require(all(p.returncode == 0 for p in procs),
                f"sharded-train-ranks workers failed: "
                f"{[(p.returncode, lg[-3000:]) for p, lg in zip(procs, logs)]}")
        reps = []
        for k in range(world):
            with open(os.path.join(tmp, f"st-rank{k}.json")) as f:
                rep = json.load(f)
            rep["eigen"].update(torch.load(os.path.join(tmp, f"st-rank{k}.pt")))
            reps.append(rep)
    gaps = {"adamw": max(abs(a - b) for r in reps for a, b in zip(r["adamw"]["losses"], base)),
            "eigen": max(abs(a - b) for r in reps for a, b in zip(r["eigen"]["losses"], losses))}
    sds, ratios = [], []
    for j, refreshed in enumerate(seen):
        dist = {n: max(subspace_dist64(r["eigen"]["bases"][j][n], st["basis"]) for r in reps)
                for n, st in refreshed.items() if n != ILL_POSED}
        sds.append(max(dist.values()))
        ratios.append(max(g / max(T3_LATER_SD, 4 * probes[j][n]) for n, g in dist.items()))
    state_gap = 0.0
    for r in reps:
        for key, want in stacked_state[r["data_rank"]].items():
            state_gap = max(state_gap, ((r["eigen"]["state"][key] - want).abs().max()
                                        / want.abs().max().clamp_min(1e-30)).item())
    counts = {k: sum(r["eigen"]["launches"][k] for r in reps) for k in KERNELS}
    r0 = reps[0]
    print(f"[sharded-train-ranks] {TRAIN_ARCH} at {T3_LAYERS} layers (the stacked comparison "
          f"runs fit one card at T3's depth) full width in f32 on a {SHARD_TRAIN_MESH} mesh, "
          f"{world} ranks over NCCL: AdamW losses {r0['adamw']['losses']} (unsharded "
          f"{base}), worst gap {gaps['adamw']:.2e}; eigen losses {r0['eigen']['losses']} "
          f"(stacked on {n_data} shards {losses}), worst gap {gaps['eigen']:.2e} (bar "
          f"{T3_LOSS}); bases per refresh but the embedding's (f64 subspace distance) "
          f"{[f'{x:.2e}' for x in sds]}, over their bars (max({T3_LATER_SD}, 4 x the f32 "
          f"refresh's own error)) {[f'{x:.2f}' for x in ratios]}; "
          f"state worst gap {state_gap:.2e} (bar {T3_STATE}); launches summed over ranks "
          f"{ {k: c for k, c in counts.items() if c} }; walls (AdamW, eigen) "
          f"{[(round(r['adamw']['wall'], 2), round(r['eigen']['wall'], 2)) for r in reps]} s, "
          f"peak a rank {max(r['eigen']['peak_gb'] for r in reps):.2f} GB")
    for lane in ("adamw", "eigen"):
        print(f"[sharded-train-ranks] {lane}: collectives a rank through DTensor (kind: "
              f"[count, bytes]) {r0[lane]['collectives']}, by axis {r0[lane]['by_axis']}; "
              f"handed to torch.distributed on the data group {r0[lane]['handed']}")
    require(max(gaps.values()) <= T3_LOSS, f"sharded-train-ranks: losses {gaps}")
    require(all(x <= 1.0 for x in ratios), f"sharded-train-ranks: bases {ratios}")
    require(state_gap <= T3_STATE, f"sharded-train-ranks: state {state_gap}")
    each = len(seen[0]) * len(seen) * world  # one B2 and one B4 a leaf a refresh a rank
    require(counts == expected_counts({"batched_gram": each, "align_average": each}),
            f"sharded-train-ranks: launches {counts}")
    for k in KERNELS:
        launches[k] += counts[k]
    free_card(torch)


def run_train_ranks(out: str) -> None:
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-rank", str(k),
         "--init", init, "--out", out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(T3_RANKS)]
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
    bad = [(k, p.returncode, logs[k][-3000:]) for k, p in enumerate(procs) if p.returncode]
    require(not bad, f"train rank workers failed: {bad}")


def hold_refresh_shapes(torch, dev, ds=(128256, 8192, 3072)) -> None:
    """B2 and B4 at the shapes an eigen refresh gives them (4 shards, rank
    32, leading dims ``ds``: T2's are 128256 for the embedding, 8192 and
    3072 for the layers' matrices) against their plain versions, with the
    f32 sum bar; these launches are comparisons and count for no lane."""
    from repro_torch.kernels import procrustes_align as pa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    for d in ds:
        vs = noisy_stack(torch, gen, T2_SHARDS, d, T2_RANK, dev)
        rf = vs[0].contiguous()
        g_want = ref.batched_gram(vs, rf)
        g_err = (pa.batched_gram(vs, rf) - g_want).abs().max().item()
        g_tol = sum_tol(d, g_want.abs().max().item())
        zs = ref.batched_gram_polar(vs, rf)
        a_want = ref.align_average(vs, zs)
        a_err = (pa.align_average(vs, zs) - a_want).abs().max().item()
        a_tol = sum_tol(T2_SHARDS * T2_RANK, a_want.abs().max().item())
        print(f"[check] refresh shape ({T2_SHARDS}, {d}, {T2_RANK}): batched_gram max_abs_err "
              f"{g_err:.3e} tol {g_tol:.3e}, align_average max_abs_err {a_err:.3e} tol "
              f"{a_tol:.3e}")
        require(g_err <= g_tol and a_err <= a_tol,
                f"B2/B4 disagree with their plain versions at ({T2_SHARDS}, {d}, {T2_RANK})")


def free_card(torch) -> int:
    """Release the last lane's tensors and restart the peak count; returns
    the bytes still allocated (the earlier phases' tensors), which a
    lane's own peak leaves out."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def device_batch(torch, pipe, step, where) -> dict:
    return {k: torch.from_numpy(v).to(where, torch.long) for k, v in pipe.batch(step).items()}


def adamw_lane(torch, dev, cfg, batch: int, *, seq: int = T1_SEQ, lr: float = T1_LR,
               stub=None, extra_step=None, after=None) -> dict:
    """T1's AdamW run of ``cfg`` (f32 master weights from the seeded
    generator, T1_STEPS steps of ``batch`` x ``seq`` tokens, T1's
    schedule at peak ``lr``), each step timed to a synchronise, its
    launches counted.  ``stub(step)`` adds inputs to every step's batch (an
    encoder-decoder's frames); ``extra_step`` adds inputs to one step more
    after the T1_STEPS (a VLM's patch embeddings after its text steps),
    whose loss and ``patch_proj``'s first moment (before and after) are
    returned.  ``after(model, opt, step_fn, batch)`` runs after the timed
    steps (and their launch count) on the next step's batch and returns
    numbers to add.  Checks nothing; returns the numbers."""
    from repro_torch import kernels
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.schedule import warmup_cosine

    held = free_card(torch)
    t0 = time.perf_counter()
    model = build(cfg, device=dev, param_dtype=torch.float32,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    opt = adamw_init(dict(model.named_parameters()))
    step_fn = make_train_step(model, adamw_cfg=AdamWConfig(),
                              schedule=warmup_cosine(lr, T1_WARMUP, T1_STEPS))
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    losses, step_ms, norms, skipped = [], [], [], 0
    for s in range(T1_STEPS):
        b = device_batch(torch, pipe, s, dev)
        if stub is not None:
            b.update(stub(s))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step_fn(opt, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        norms.append(m["grad_norm"])
        skipped += int(m["step_skipped"])
    extra = {}
    if extra_step is not None:
        def patch_m():
            m = opt["m"].get("patch_proj")
            return None if m is None else m.norm().item()

        extra["patch_m_before"] = patch_m()
        m = step_fn(opt, {**device_batch(torch, pipe, T1_STEPS, dev), **extra_step})
        extra.update(extra_loss=float(m["loss"]), extra_skipped=int(m["step_skipped"]),
                     patch_m_after=patch_m())
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() - held
    if after is not None:
        extra.update(after(model, opt, step_fn, device_batch(torch, pipe, T1_STEPS, dev)))
    ms = sum(step_ms[1:]) / (len(step_ms) - 1)
    return {"params": n_params, "init_s": init_s, "step_ms": step_ms, "ms": ms,
            "tokens_s": batch * seq / (ms / 1e3), "peak_gb": peak / 1e9,
            "held_gb": held / 1e9, "losses": losses, "norms": norms, "skipped": skipped,
            "counts": counts, "batch": batch, "seq": seq, **extra}


def timed_train_steps(torch, train_mod, ms: list):
    """Make ``train_mod``'s trainer time each AdamW step to a synchronise
    (ms into ``ms``).  Returns the step factory to put back."""
    make = train_mod.make_train_step

    def timing(model, **kw):
        step = make(model, **kw)

        def run(opt, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(opt, batch)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    train_mod.make_train_step = timing
    return make


def t1s_lane(torch, dev, t1: dict) -> None:
    """T1s: T1 through ``launch.train.train(mesh=)`` on a (1, 1) mesh (a
    world of one), held to T1's own losses ``t1`` (see T1S_STEPS)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh

    held = free_card(torch)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    ms = []
    make = timed_train_steps(torch, train_mod, ms)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        t0 = time.perf_counter()
        model, opt, losses = train_mod.train(
            train_cfg(), steps=T1S_STEPS, batch=T1_BATCH, seq=T1_SEQ, lr=T1_LR,
            warmup=T1_WARMUP, device=dev, mesh=mesh, seed=SEED, log_every=10 ** 9)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dtensors = all(isinstance(t, DTensor) for t in [
            *model.parameters(), *opt["m"].values(), *opt["v"].values()])
        del model, opt
    finally:
        train_mod.make_train_step = make
        dist.destroy_process_group()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    want = t1["losses"][:T1S_STEPS]
    exact = losses == want
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    first = next((i for i, g in enumerate(gaps) if g), None)
    step_ms = sum(ms[1:]) / (len(ms) - 1)
    print(f"[sharded-train] T1s {TRAIN_ARCH} full config through train(mesh=) on a (1, 1) "
          f"mesh (every parameter and both AdamW moments a DTensor: {dtensors}), T1's traffic, "
          f"{T1S_STEPS} steps: wall {wall:.2f} s, step 0 {ms[0]:.1f} ms, ms/step after step 0 "
          f"{step_ms:.2f} (each {[round(x, 1) for x in ms[1:]]}) against T1's "
          f"{t1['ms']:.2f} ({step_ms / t1['ms']:.3f}x), peak memory {peak:.2f} GB (T1 "
          f"{t1['peak_gb']:.2f}); losses {losses} against T1's {want}: bit for bit {exact}, "
          f"worst relative gap {max(gaps):.2e} (bar {T1S_LOSS}), first gap at step {first}")
    require(dtensors, "T1s: a parameter or moment is not a DTensor")
    require(max(gaps) <= T1S_LOSS, f"T1s: losses {losses} vs T1's {want}")
    free_card(torch)


def mesh_adamw_lane(torch, dev, cfg, ref: dict, label: str, *, seq: int = T1_SEQ,
                    lr: float = T1_LR, stub=None) -> None:
    """R1s / V1s ([sharded-train]): ``cfg``'s AdamW lane on a (1, 1) mesh
    (every parameter and both moments a DTensor), T1S_STEPS steps of the
    unsharded lane's traffic (``adamw_lane``'s batches, seeds and schedule
    at peak ``lr``), its losses held to the first T1S_STEPS of that lane's
    (``ref``) as T1s holds T1's: bit for bit printed, T1S_LOSS required.
    An LM trains through ``launch.train.train(mesh=)``; with ``stub`` (an
    encoder-decoder's frames, which the launcher's pipeline lacks) through
    ``launch.steps.make_train_step(mesh=)`` on the pipeline's batches
    plus ``stub(step)``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import sharding as S
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.schedule import warmup_cosine

    held = free_card(torch)
    t0 = time.perf_counter()
    ms = []
    make = timed_train_steps(torch, train_mod, ms)
    try:
        with world_of_one() as mesh:
            if stub is None:
                model, opt, losses = train_mod.train(
                    cfg, steps=T1S_STEPS, batch=T1_BATCH, seq=seq, lr=lr, warmup=T1_WARMUP,
                    device=dev, mesh=mesh, seed=SEED, log_every=10 ** 9)
            else:
                model = S.shard_model(build(cfg, device=dev, param_dtype=torch.float32,
                                            generator=torch.Generator(device=dev).manual_seed(
                                                SEED)), cfg, mesh)
                opt = adamw_init(dict(model.named_parameters()))
                step_fn = train_mod.make_train_step(
                    model, adamw_cfg=AdamWConfig(), mesh=mesh,
                    schedule=warmup_cosine(lr, T1_WARMUP, T1S_STEPS))
                pipe = TokenPipeline(cfg.vocab_size, seq, T1_BATCH, seed=SEED)
                losses = [float(step_fn(opt, {**device_batch(torch, pipe, s, dev), **stub(s)})
                                ["loss"]) for s in range(T1S_STEPS)]
            torch.cuda.synchronize()
            dtensors = all(isinstance(t, DTensor) for t in [
                *model.parameters(), *opt["m"].values(), *opt["v"].values()])
            del model, opt
    finally:
        train_mod.make_train_step = make
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    want = ref["losses"][:T1S_STEPS]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    step_ms = sum(ms[1:]) / (len(ms) - 1)
    print(f"[sharded-train] {label} {cfg.name} full config on a (1, 1) mesh (every parameter "
          f"and both AdamW moments a DTensor: {dtensors}), {T1_BATCH} x {seq} tokens"
          f"{' + frames' if stub else ''}, {T1S_STEPS} steps: wall {wall:.2f} s, step 0 "
          f"{ms[0]:.1f} ms, ms/step after step 0 {step_ms:.2f} (each "
          f"{[round(x, 1) for x in ms[1:]]}) against the unsharded lane's {ref['ms']:.2f} "
          f"({step_ms / ref['ms']:.3f}x), peak memory {peak:.2f} GB (unsharded "
          f"{ref['peak_gb']:.2f}); losses {losses} against the unsharded lane's {want}: bit "
          f"for bit {losses == want}, worst relative gap {max(gaps):.2e} (bar {T1S_LOSS})")
    require(dtensors, f"{label} {cfg.name}: a parameter or moment is not a DTensor")
    require(max(gaps) <= T1S_LOSS, f"{label} {cfg.name}: losses {losses} vs {want}")
    free_card(torch)


def print_adamw(label, cfg, r, depth=None) -> None:
    at = f"at {depth}, full width" if depth else "full config"
    print(f"[{label} {cfg.name} {at} (layers {cfg.num_layers}, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, remat {cfg.remat}, compute "
          f"{cfg.dtype}, f32 master weights): {r['params']} parameters, batch {r['batch']} x "
          f"{r['seq']} tokens, AdamW, {T1_STEPS} steps, warmup {T1_WARMUP}: init "
          f"{r['init_s']:.2f} s, step 0 {r['step_ms'][0]:.1f} ms, ms/step after step 0 "
          f"{r['ms']:.2f} (each {[round(x, 1) for x in r['step_ms'][1:]]}), "
          f"{r['tokens_s']:.0f} tokens/s, peak memory {r['peak_gb']:.2f} GB "
          f"(max_memory_allocated less the {r['held_gb']:.2f} GB the earlier phases hold), "
          f"launches { {k: c for k, c in r['counts'].items() if c} }")
    print(f"[{label} losses {[round(x, 4) for x in r['losses']]}, grad norms "
          f"{[round(x, 3) for x in r['norms']]}, skipped {r['skipped']}")


def require_adamw(label, r) -> None:
    """T1's checks: finite losses, no skipped step, the mean of the last
    two losses below the first."""
    losses = r["losses"]
    require(all(math.isfinite(x) for x in losses), f"{label}: a loss is not finite")
    require(not r["skipped"], f"{label}: a step was skipped")
    require(sum(losses[-2:]) / 2 < losses[0], f"{label}: the loss did not fall: {losses}")


def card_vs_cpu(torch, dev, small, stub=None) -> tuple:
    """T1c: T1C_STEPS AdamW steps of the reduced config ``small`` on the
    CPU and on the card from the same parameters and batches (4 x 32
    tokens, plus ``stub(step)``'s CPU tensors: patch embeddings or
    frames).  Returns (worst relative loss gap, worst parameter relative
    L2, card losses, CPU losses)."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.schedule import constant

    runs = {}
    for where in ("cpu", dev):
        model = build(small, device="cpu", param_dtype=torch.float32,
                      generator=torch.Generator().manual_seed(SEED)).to(where)
        params = dict(model.named_parameters())
        opt = adamw_init(params)
        step_fn = make_train_step(model, adamw_cfg=AdamWConfig(), schedule=constant(T1C_LR))
        pipe = TokenPipeline(small.vocab_size, 32, 4, seed=SEED)
        ls = [float(step_fn(opt, {**device_batch(torch, pipe, s, where), **(
            {} if stub is None else {k: v.to(where) for k, v in stub(s).items()})})["loss"])
              for s in range(T1C_STEPS)]
        runs[str(where)] = (ls, {k: p.detach().cpu() for k, p in params.items()})
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    par_err = max(((pc[k] - pg[k]).norm() / pc[k].norm()).item() for k in pc)
    return loss_err, par_err, lg, lc


def eigen_lane(torch, dev, cfg) -> dict:
    """T2's eigen trainer run of ``cfg``: ``launch.train.train`` stacked on
    T2_SHARDS shards, rank T2_RANK, min_dim 64, a refresh every
    T2_REFRESH of T2_STEPS steps, T1's traffic; returns the numbers and
    the launches (one B2 and one B4 a compressed leaf a refresh
    expected)."""
    from repro_torch import kernels
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import compressed_paths
    from repro_torch.optim import EigenCompressConfig

    held = free_card(torch)
    comp = compressed_paths(cfg, EigenCompressConfig(rank=T2_RANK, min_dim=64))
    refreshes = len(range(0, T2_STEPS, T2_REFRESH))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, opt, losses = train_mod.train(
        cfg, steps=T2_STEPS, batch=T1_BATCH, seq=T1_SEQ, lr=T1_LR, warmup=T1_WARMUP,
        eigen=True, eigen_rank=T2_RANK, eigen_refresh=T2_REFRESH, device=dev,
        shards=T2_SHARDS, seed=SEED, log_every=10 ** 9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    return {
        "wall": wall, "peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
        "held_gb": held / 1e9, "params": sum(p.numel() for p in model.parameters()),
        "low": sum(min(T2_RANK, d, n) * n for d, n in comp.values()),
        "full": sum(d * n for d, n in comp.values()),
        "other": sum(p.numel() for k, p in model.named_parameters() if k not in comp),
        "err_gb": sum(st["err"].numel() * 4 for st in opt["eigen"].values()) / 1e9,
        "leaves": len(comp), "refreshes": refreshes, "losses": losses, "counts": counts,
        "want": expected_counts({"batched_gram": len(comp) * refreshes,
                                 "align_average": len(comp) * refreshes})}


def print_eigen(label, cfg, depth, r) -> None:
    print(f"[{label} eigen stacked, {cfg.name} at {depth}, full width ({r['params']} "
          f"parameters), {T2_SHARDS} shards of {T1_BATCH // T2_SHARDS} x "
          f"{r.get('seq', T1_SEQ)} tokens{r.get('also', '')}, "
          f"rank {T2_RANK}, min_dim 64, refresh every {T2_REFRESH}, {T2_STEPS} steps: wall "
          f"{r['wall']:.2f} s, {r['leaves']} compressed leaves, launches "
          f"{ {k: c for k, c in r['counts'].items() if c} } (expected one B2 and one B4 a "
          f"compressed leaf a refresh: {r['leaves']} x {r['refreshes']}), all-reduce words a "
          f"step: compressed {r['low']} (sum r n) against {r['full']} (sum d n, "
          f"{r['full'] / r['low']:.1f}x), plus {r['other']} uncompressed and 1 loss; err "
          f"{r['err_gb']:.2f} GB; peak memory {r['peak_gb']:.2f} GB (less the earlier "
          f"phases' {r['held_gb']:.2f} GB); losses {[round(x, 4) for x in r['losses']]}")


def train_lanes(torch, dev, launches: dict) -> None:
    """T1-T4 (see the constants above).  Adds the lanes' kernel launches to
    ``launches``."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.metrics import subspace_dist64
    from repro_torch.launch.steps import compressed_paths
    from repro_torch.optim import EigenCompressConfig


    # T1: AdamW at the full config; T1s: the same through train(mesh=).
    t_lane = time.perf_counter()
    cfg = train_cfg()
    r = adamw_lane(torch, dev, cfg, T1_BATCH)
    print_adamw("train] T1", cfg, r)
    require_adamw("T1", r)
    free_card(torch)
    t0 = time.perf_counter()
    t1s_lane(torch, dev, r)
    print(f"[sharded-train] T1s in {time.perf_counter() - t0:.1f} s")

    # T1c: the same AdamW steps on the card and on the CPU.
    small = dataclasses.replace(get_reduced_config("granite-3-2b"), dtype="float32",
                                attn_probs_bf16=False)
    loss_err, par_err, lg, lc = card_vs_cpu(torch, dev, small)
    print(f"[train] T1c {small.name} reduced f32, {T1C_STEPS} AdamW steps, card vs CPU: "
          f"losses {[round(x, 6) for x in lg]} vs {[round(x, 6) for x in lc]}, worst "
          f"relative loss gap {loss_err:.2e} (bar {T1C_LOSS}), worst parameter rel L2 "
          f"{par_err:.2e} (bar {T1C_PARAM})")
    require(loss_err <= T1C_LOSS and par_err <= T1C_PARAM, "T1c: card and CPU disagree")
    free_card(torch)

    # T2: the eigen trainer stacked, 16 layers at full width; first B2 and
    # B4 at its refresh shapes against their plain versions.
    hold_refresh_shapes(torch, dev)
    cfg2 = train_cfg(T2_LAYERS)
    r = eigen_lane(torch, dev, cfg2)
    print_eigen("train] T2", cfg2, f"{T2_LAYERS} of 28 layers", r)
    require(all(math.isfinite(x) for x in r["losses"]), "T2: a loss is not finite")
    require(r["counts"] == r["want"], f"T2: launches {r['counts']}, expected {r['want']}")
    for k in KERNELS:
        launches[k] += r["counts"][k]
    ecfg = EigenCompressConfig(rank=T2_RANK, min_dim=64)
    free_card(torch)

    # T3: the eigen trainer in a rank world against itself stacked, each
    # shard its own rows: the stacked run first, then the ranks, which take
    # its embedding refreshes.
    free_card(torch)
    kernels.reset_launch_counts()
    probes = []
    losses, seen, opt, model = t3_run(torch, dev, probes=probes)
    counts = kernels.launch_counts()
    comp3 = compressed_paths(model.cfg, ecfg)
    low3 = sum(min(T2_RANK, d, n) * n for d, n in comp3.values())
    other3 = sum(p.numel() for k, p in model.named_parameters() if k not in comp3)
    stacked_state = [t3_state(torch, opt, shard=k) for k in range(T3_RANKS)]
    del model, opt
    free_card(torch)
    force = {j * T3_REFRESH: {ILL_POSED: {f: k[ILL_POSED][f] for f in ("basis", "m", "v")}}
             for j, k in enumerate(seen)}
    want_bytes = 4 * (low3 + other3 + 1)
    n_ref = len(seen)
    want3 = {"batched_gram": len(comp3) * n_ref, "align_average": len(comp3) * n_ref}
    require(counts == expected_counts(want3), f"T3 stacked: launches {counts}")
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(force, os.path.join(tmp, "t3-force.pt"))
        t0 = time.perf_counter()
        run_train_ranks(tmp)
        ranks_wall = time.perf_counter() - t0
        reps = []
        for k in range(T3_RANKS):
            with open(os.path.join(tmp, f"t3-rank{k}.json")) as f:
                rep = json.load(f)
            for lane in ("t3", "t3s"):
                rep[lane].update(torch.load(os.path.join(tmp, f"{lane}-rank{k}.pt")))
            reps.append(rep)
        # The mesh checkpoint lane's step-2 checkpoint into the stacked trainer.
        ck = os.path.join(tmp, "t3s-stacked")
        shutil.copytree(os.path.join(tmp, "t3s-ck", "step_00000002"),
                        os.path.join(ck, "step_00000002"))
        t0 = time.perf_counter()
        into_stacked = ck_run(torch, dev, shards=T3_RANKS, checkpoint_dir=ck)
        stacked_s = time.perf_counter() - t0
        free_card(torch)
    for lane, label in (("t3", "T3 eigen"), ("t3s", "T3s eigen on a (4, 1) mesh")):
        rs = [r[lane] for r in reps]
        loss_gap = max(abs(a - b) for r in rs for a, b in zip(r["losses"], losses))
        sds, ratios = [], []
        for j, refreshed in enumerate(seen):
            floor = T3_FIRST_SD if j == 0 else T3_LATER_SD
            gaps = {n: max(subspace_dist64(r["bases"][j][n], st["basis"]) for r in rs)
                    for n, st in refreshed.items() if n != ILL_POSED}
            sds.append(max(gaps.values()))
            ratios.append(max(g / max(floor, 4 * probes[j][n]) for n, g in gaps.items()))
        state_gap = {}
        for k, r in enumerate(rs):
            for key, want in stacked_state[k].items():
                kind = key.split("/")[0]
                err = ((r["state"][key] - want).abs().max()
                       / want.abs().max().clamp_min(1e-30)).item()
                state_gap[kind] = max(state_gap.get(kind, 0.0), err)
        r_counts = {k: sum(r["launches"][k] for r in rs) for k in KERNELS}
        tag = "[train]" if lane == "t3" else "[sharded-train]"
        print(f"{tag} {label}, {T3_RANKS} ranks on the card ({reps[0]['rule']}), "
              f"{TRAIN_ARCH} at {T3_LAYERS} layers full width in f32, each shard its own rows, "
              f"rank {T2_RANK}, refresh every {T3_REFRESH}, {T3_STEPS} steps: wall "
              f"{max(r['wall'] for r in rs):.2f} s (processes {ranks_wall:.1f} s for T3 and "
              f"T3s), peak memory a rank {max(r['peak_gb'] for r in rs):.2f} GB, launches "
              f"summed over ranks { {k: c for k, c in r_counts.items() if c} }, stacked "
              f"{ {k: c for k, c in counts.items() if c} }; worst loss gap to the stacked run "
              f"{loss_gap:.2e} (bar {T3_LOSS}); bases per refresh but the embedding's (f64 "
              f"subspace distance) {[f'{x:.2e}' for x in sds]}, worst over their bars "
              f"(max({T3_FIRST_SD} then {T3_LATER_SD}, 4 x the f32 refresh's own error against "
              f"f64; those errors up to "
              f"{[f'{max(p.values()):.2e}' for p in probes]})) {[f'{x:.2f}' for x in ratios]}; "
              f"state after the last step, worst gap over the largest magnitude "
              f"{ {k: f'{v:.2e}' for k, v in state_gap.items()} } (bar {T3_STATE}); bytes "
              f"handed to torch.distributed in one step {[r['handed_step'] for r in rs]} "
              f"(expected 4 x ({low3} compressed + {other3} uncompressed + 1 loss) = "
              f"{want_bytes})")
        require(all(math.isfinite(x) for r in rs for x in r["losses"]),
                f"{label}: a loss is not finite")
        require(loss_gap <= T3_LOSS, f"{label}: losses {[r['losses'] for r in rs]} vs {losses}")
        require(all(x <= 1.0 for x in ratios), f"{label}: bases {sds}, over their bars {ratios}")
        require(all(v <= T3_STATE for v in state_gap.values()), f"{label}: state {state_gap}")
        require(all(r["handed_step"] == want_bytes for r in rs), f"{label}: bytes handed")
        require(r_counts == expected_counts({k: c * T3_RANKS for k, c in want3.items()}),
                f"{label} ranks: launches {r_counts}")
        for k in KERNELS:
            launches[k] += r_counts[k]
    for k in KERNELS:
        launches[k] += counts[k]
    cks = [r["ck"] for r in reps]
    final = cks[0]["straight"][-1]
    gaps = {"preempted": max(abs(c["preempted"][-1] - final) for c in cks),
            "into_stacked": abs(into_stacked[-1] - final)}
    print(f"[sharded-train] T3s checkpoints, {TRAIN_ARCH} reduced in f32 on the ({T3_RANKS}, 1) "
          f"mesh, {T3S_CK['batch']} x {T3S_CK['seq']} tokens, eigen rank "
          f"{T3S_CK['eigen_rank']}, one refresh, {T3_STEPS} steps, checkpointed every 2 and "
          f"preempted at step {T3S_FAIL} ({max(c['wall'] for c in cks):.2f} s with the straight "
          f"run; {len(cks[0]['preempted'])} steps run): final loss gap to the straight mesh run "
          f"{gaps['preempted']:.2e}; its step-2 checkpoint restored into the stacked trainer "
          f"({T3_RANKS} shards, no mesh, {stacked_s:.2f} s): final loss gap "
          f"{gaps['into_stacked']:.2e} (bar {T4_BAR}); final losses {final!r}, "
          f"{[c['preempted'][-1] for c in cks]}, {into_stacked[-1]!r}")
    require(all(len(c["preempted"]) == T3_STEPS + T3S_FAIL - 2 for c in cks),
            f"T3s: the preempted run did not resume from step 2: {cks}")
    require(len(into_stacked) == T3_STEPS - 2, f"T3s: the stacked restore ran {into_stacked}")
    require(all(g <= T4_BAR for g in gaps.values()), f"T3s resume: {gaps}")
    del seen, reps, stacked_state
    free_card(torch)

    # T4: the launcher, preempted and resumed, against the straight run.
    finals = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {"straight": [], "preempted": ["--fail-at", str(T4_FAIL)]}
        t4 = side_by_side(
            {label: [sys.executable, "-c", T4_DETERMINISTIC, "--arch", T4_ARCH, "--device",
                     dev.type, "--steps", str(T4_STEPS), "--eigen", "--checkpoint-dir",
                     os.path.join(tmp, label), "--checkpoint-every", "2", *extra]
             for label, extra in runs.items()},
            {**os.environ, "PYTHONPATH": SRC, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
        for label, extra in runs.items():
            cli, took = t4(label)
            require(cli.returncode == 0, f"train launcher ({label}) failed:\n"
                                         f"{cli.stderr[-4000:]}")
            stats = dict(line.split(": ", 1) for line in cli.stdout.splitlines()
                         if ": " in line)
            finals[label] = float(stats["final_loss_exact"])
            print(f"[cli] repro_torch.launch.train --arch {T4_ARCH} --steps {T4_STEPS} "
                  f"--eigen --checkpoint-every 2 {' '.join(extra)}, deterministic "
                  f"({took:.1f} s, the two side by side): device={stats['device']}, "
                  f"losses={stats['losses']}, final_loss_exact={stats['final_loss_exact']}, "
                  f"preempted {'preempted at step' in cli.stderr}")
            require(stats["device"] == torch.cuda.get_device_name(0), "T4: not on the card")
    gap = abs(finals["straight"] - finals["preempted"])
    print(f"[train] T4 resume after preemption at step {T4_FAIL}: final loss gap {gap:.2e} "
          f"(bar {T4_BAR})")
    require(gap <= T4_BAR, f"T4: final losses {finals}")
    print(f"[train] T1-T4, T1s and T3s in {time.perf_counter() - t_lane:.1f} s")
    t0 = time.perf_counter()
    sharded_train_ranks(torch, dev, launches)
    print(f"[sharded-train-ranks] in {time.perf_counter() - t0:.1f} s")


def recurrent_train_lanes(torch, dev, launches: dict) -> None:
    """R1, R1c and R2 (see the constants above), on ``[train-recur]``
    lines.  Adds R2's kernel launches to ``launches``."""
    import dataclasses

    from repro_torch.configs import get_config, get_reduced_config

    # R1: AdamW at each family's full config, uncut; R1s the same on a
    # (1, 1) mesh through train(mesh=).
    for arch in RECUR_TRAIN:
        cfg = get_config(arch)
        r = adamw_lane(torch, dev, cfg, T1_BATCH)
        print_adamw("train-recur] R1", cfg, r)
        require_adamw(f"R1 {arch}", r)
        require(not any(r["counts"].values()),
                f"R1 {arch}: kernels launched in training: {r['counts']}")
        free_card(torch)
        mesh_adamw_lane(torch, dev, cfg, r, "R1s")

    # R1c: each family's reduced config in f32, card vs CPU.
    for arch in RECUR_TRAIN:
        small = dataclasses.replace(get_reduced_config(arch), dtype="float32",
                                    attn_probs_bf16=False)
        loss_err, par_err, lg, lc = card_vs_cpu(torch, dev, small)
        print(f"[train-recur] R1c {small.name} reduced f32, {T1C_STEPS} AdamW steps, card vs "
              f"CPU: losses {[round(x, 6) for x in lg]} vs {[round(x, 6) for x in lc]}, worst "
              f"relative loss gap {loss_err:.2e} (bar {T1C_LOSS}), worst parameter rel L2 "
              f"{par_err:.2e} (bar {T1C_PARAM})")
        require(loss_err <= T1C_LOSS and par_err <= T1C_PARAM,
                f"R1c {arch}: card and CPU disagree")
    free_card(torch)

    # R2: the eigen trainer stacked; first B2 and B4 at its refresh shapes.
    hold_refresh_shapes(torch, dev, R2_REFRESH_DS)
    for arch in RECUR_TRAIN:
        cfg = get_config(arch)
        depth = f"its {cfg.num_layers} blocks"
        if cfg.family == "hybrid":
            depth = f"{R2_HYBRID_LAYERS} of its {cfg.num_layers} blocks"
            cfg = dataclasses.replace(cfg, num_layers=R2_HYBRID_LAYERS)
        r = eigen_lane(torch, dev, cfg)
        print_eigen("train-recur] R2", cfg, depth, r)
        require(all(math.isfinite(x) for x in r["losses"]), f"R2 {arch}: a loss is not finite")
        require(r["counts"] == r["want"], f"R2 {arch}: launches {r['counts']}, expected "
                                          f"{r['want']}")
        for k in KERNELS:
            launches[k] += r["counts"][k]
        free_card(torch)


# V1-V2: training the VLM and encoder-decoder families (ROADMAP A11-vlm,
# A11-whisper), after R1-R2, on ``[train-vlm]`` / ``[train-whisper]`` lines.
# V1: AdamW at each full config with T1's steps, lr and checks: internvl2-2b
# on T1's text batches (the launcher's path: ``patch_proj`` only decayed),
# then one step more with V1_PATCHES patch embeddings a row (its first
# moment must leave zero); whisper-tiny on T1_BATCH x (WHISPER_FRAMES frames
# + V1_WHISPER_SEQ tokens, its decoder's full context) at peak lr
# V1_WHISPER_LR (a 56 M-parameter model: at T1's 5e-5 its 8 steps barely
# move the loss; whisper-tiny was trained at 1.5e-3).  V1c: each reduced
# config in f32 with its stub inputs, T1c's steps and bars, card vs CPU.  V2:
# the eigen trainer stacked with T2's shards, rank, refresh and steps, both
# uncut: internvl2-2b through ``launch.train.train`` (24 layers: f32 masters
# 7.6 GB + 4 shards' error feedback 30.3 GB + one gradient 7.6 GB), whisper-
# tiny through ``launch.steps``' step functions on batches with frames (the
# launcher refuses it: its pipeline gives no frames).
V1_PATCHES, V1_WHISPER_SEQ, V1_WHISPER_LR = 256, 448, 5e-4


def vlm_whisper_train_lanes(torch, dev, launches: dict) -> None:
    """V1, V1c and V2 (see the constants above).  Adds V2's kernel
    launches to ``launches``."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.steps import (
        compressed_paths,
        eigen_opt_init,
        make_eigen_refresh_step,
        make_eigen_train_step,
        start_shapes,
    )
    from repro_torch.models import build
    from repro_torch.optim import EigenCompressConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.eigen_compress import draw_starts
    from repro_torch.optim.schedule import warmup_cosine

    wcfg = get_config(WHISPER_ARCH)

    def frames(step, batch=T1_BATCH, n=WHISPER_FRAMES, d=wcfg.d_model, where=dev):
        g = torch.Generator(device=where).manual_seed(SEED + 100 + step)
        return {"frames": torch.randn(batch, n, d, generator=g, device=where)}

    # V1: AdamW at the full configs.
    vlm = get_config(VLM_ARCH)
    g = torch.Generator(device=dev).manual_seed(SEED + 99)
    patches = {"patch_embeds": torch.randn(T1_BATCH, V1_PATCHES, vlm.patch_embed_dim,
                                           generator=g, device=dev)}
    r = adamw_lane(torch, dev, vlm, T1_BATCH, extra_step=patches)
    del patches
    print_adamw("train-vlm] V1", vlm, r)
    print(f"[train-vlm] V1 one step more with {V1_PATCHES} patches a row: loss "
          f"{r['extra_loss']:.4f}, skipped {r['extra_skipped']}, |m(patch_proj)| before "
          f"{r['patch_m_before']:.3e} (text steps: zero gradient), after {r['patch_m_after']:.3e}")
    require_adamw("V1 internvl2-2b", r)
    require(r["patch_m_before"] == 0.0 and r["patch_m_after"] > 0.0
            and math.isfinite(r["extra_loss"]) and not r["extra_skipped"],
            f"V1 internvl2-2b: the patch step {r}")
    require(not any(r["counts"].values()), f"V1 internvl2-2b: kernels launched: {r['counts']}")
    free_card(torch)
    r = adamw_lane(torch, dev, wcfg, T1_BATCH, seq=V1_WHISPER_SEQ, lr=V1_WHISPER_LR,
                   stub=frames)
    print_adamw("train-whisper] V1", wcfg, r)
    print(f"[train-whisper] V1 each row also {WHISPER_FRAMES} frames into the encoder")
    require_adamw("V1 whisper-tiny", r)
    require(not any(r["counts"].values()), f"V1 whisper-tiny: kernels launched: {r['counts']}")
    free_card(torch)
    # V1s: whisper's V1 on a (1, 1) mesh, through make_train_step(mesh=).
    mesh_adamw_lane(torch, dev, wcfg, r, "V1s", seq=V1_WHISPER_SEQ, lr=V1_WHISPER_LR,
                    stub=frames)

    # V1c: the reduced configs in f32 with their stub inputs, card vs CPU.
    f32 = dict(dtype="float32", attn_probs_bf16=False)
    for arch, tag in ((VLM_ARCH, "train-vlm"), (WHISPER_ARCH, "train-whisper")):
        small = dataclasses.replace(get_reduced_config(arch), **f32)
        if small.num_patches:
            def stub(s, c=small):
                g = torch.Generator().manual_seed(SEED + s)
                return {"patch_embeds": torch.randn(4, c.num_patches, c.patch_embed_dim,
                                                    generator=g)}
        else:
            def stub(s, c=small):
                return frames(s, batch=4, n=48, d=c.d_model, where="cpu")
        loss_err, par_err, lg, lc = card_vs_cpu(torch, dev, small, stub)
        print(f"[{tag}] V1c {small.name} reduced f32 with its stub inputs, {T1C_STEPS} AdamW "
              f"steps, card vs CPU: losses {[round(x, 6) for x in lg]} vs "
              f"{[round(x, 6) for x in lc]}, worst relative loss gap {loss_err:.2e} (bar "
              f"{T1C_LOSS}), worst parameter rel L2 {par_err:.2e} (bar {T1C_PARAM})")
        require(loss_err <= T1C_LOSS and par_err <= T1C_PARAM,
                f"V1c {arch}: card and CPU disagree")
    free_card(torch)

    # V2: the eigen trainer stacked, both uncut.
    hold_refresh_shapes(torch, dev, (vlm.padded_vocab, vlm.d_ff, vlm.d_model,
                                     vlm.patch_embed_dim, wcfg.padded_vocab, wcfg.d_ff,
                                     wcfg.d_model))
    r = eigen_lane(torch, dev, vlm)
    print_eigen("train-vlm] V2", vlm, f"its {vlm.num_layers} layers", r)
    require(all(math.isfinite(x) for x in r["losses"]), "V2 internvl2-2b: a loss is not finite")
    require(r["counts"] == r["want"], f"V2 internvl2-2b: launches {r['counts']}, expected "
                                      f"{r['want']}")
    for k in KERNELS:
        launches[k] += r["counts"][k]
    free_card(torch)

    held = free_card(torch)
    ecfg = EigenCompressConfig(rank=T2_RANK, refresh_every=T2_REFRESH, min_dim=64)
    comp = compressed_paths(wcfg, ecfg)
    model = build(wcfg, device=dev, param_dtype=torch.float32,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    opt = eigen_opt_init(model, ecfg, T2_SHARDS)
    sched = warmup_cosine(T1_LR, T1_WARMUP, T2_STEPS)
    train_step = make_eigen_train_step(model, adamw_cfg=AdamWConfig(), schedule=sched,
                                       shards=T2_SHARDS)
    refresh = make_eigen_refresh_step(model, ecfg=ecfg, shards=T2_SHARDS)
    pipe = TokenPipeline(wcfg.vocab_size, V1_WHISPER_SEQ, T1_BATCH, seed=SEED)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for step in range(T2_STEPS):
        b = {**device_batch(torch, pipe, step, dev), **frames(step)}
        if step % T2_REFRESH == 0:
            refresh(opt, b, draw_starts(start_shapes(opt), seed=SEED + 1, step=step,
                                        device=dev))
        losses.append(float(train_step(opt, b)["loss"]))
    torch.cuda.synchronize()
    refreshes = len(range(0, T2_STEPS, T2_REFRESH))
    r = {"wall": time.perf_counter() - t0,
         "peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9, "held_gb": held / 1e9,
         "params": sum(p.numel() for p in model.parameters()),
         "low": sum(min(T2_RANK, d, n) * n for d, n in comp.values()),
         "full": sum(d * n for d, n in comp.values()),
         "other": sum(p.numel() for k, p in model.named_parameters() if k not in comp),
         "err_gb": sum(st["err"].numel() * 4 for st in opt["eigen"].values()) / 1e9,
         "leaves": len(comp), "refreshes": refreshes, "losses": losses,
         "counts": kernels.launch_counts(),
         "want": expected_counts({"batched_gram": len(comp) * refreshes,
                                  "align_average": len(comp) * refreshes}),
         "seq": V1_WHISPER_SEQ, "also": f" and {WHISPER_FRAMES} frames a row"}
    print_eigen("train-whisper] V2", wcfg, f"its {wcfg.num_encoder_layers} + "
                f"{wcfg.num_layers} layers", r)
    require(all(math.isfinite(x) for x in losses), "V2 whisper-tiny: a loss is not finite")
    require(r["counts"] == r["want"], f"V2 whisper-tiny: launches {r['counts']}, expected "
                                      f"{r['want']}")
    for k in KERNELS:
        launches[k] += r["counts"][k]
    del model, opt
    free_card(torch)


# M1-M2: training the MoE family (ROADMAP A11-moe-train), after V1-V2, on
# ``[train-moe]`` lines.  M1: AdamW at qwen3-moe-30b-a3b's full width
# (d_model 2048, 128 experts top-8, vocab 151936, the config's einsum form,
# remat per block) with T1's traffic, lr and checks, at M1_LAYERS of its 48
# layers: a layer holds 613.7 M parameters (experts 604.0 M), 9.82 GB at 16
# bytes a parameter (f32 master, gradient, two moments), the two embeddings
# 9.96 GB; M1_LAYERS is the most whose measured peak left room on the
# card's 85.02 GB (``tools/moe_train_depth.py`` measures each depth's
# peak; PERF.md §6).  After the timed steps one more step runs with a
# forward pre-hook on every MoE layer (``moe_routing_step``): the drop
# share of each layer, and the routing decisions the remat recompute of
# the backward changed (required none).  M1c: both MoE archs' reduced
# configs in f32, both dispatch forms, T1c's steps and bars, card vs CPU.
# M2: T2's eigen trainer stacked at M2_LAYERS layers (four shards' error
# feedback on the two embeddings take ~10 GB, a layer's worth; 5 layers
# would leave under 4 GB of the card beside the 3.31 GB the earlier phases
# hold), one B2 and one B4 a compressed leaf a refresh, exactly; the words
# a step at that depth and reckoned at all 48 layers (the experts, 96.4 %
# of the parameters, are never compressed, as in the reference).
MOE_TRAIN_ARCHS = (MOE_ARCH, "kimi-k2-1t-a32b")
M1_LAYERS, M2_LAYERS = 6, 4


def moe_routing_step(torch, model, opt, step_fn, batch) -> dict:
    """One more AdamW step of ``model`` with a forward pre-hook on every
    MoE layer that routes the layer's input again (``MoE.routing``) at each
    call: under remat the backward calls each block's forward a second
    time.  Returns each layer's calls, its drop share in the step's
    forward, and the routing decisions (each pair's expert and whether it
    was kept) that differ between a layer's two calls."""
    calls = [[] for _ in model.blocks]

    def hook_of(i):
        def hook(mod, inp):
            rt = mod.routing(inp[0])
            calls[i].append((rt.experts, rt.keep))
        return hook

    # A pre-hook: the recompute stops once it has the tensors the backward
    # needs, before the layer's forward returns.
    handles = [blk.mlp.register_forward_pre_hook(hook_of(i))
               for i, blk in enumerate(model.blocks)]
    try:
        loss = float(step_fn(opt, batch)["loss"])
    finally:
        for h in handles:
            h.remove()
    flips = sum(int((c[0][0] != c[-1][0]).sum()) + int((c[0][1] != c[-1][1]).sum())
                for c in calls)
    return {"routing_calls": [len(c) for c in calls], "routing_flips": flips,
            "drop_shares": [(~c[0][1]).float().mean().item() for c in calls],
            "routing_loss": loss}


def moe_words(torch, cfg, comp) -> tuple:
    """(compressed words, those leaves' full words, the other leaves' words)
    a step for ``cfg``'s model (counted on the meta device)."""
    from repro_torch.models import LM

    model = LM(cfg, device="meta")
    other = sum(p.numel() for k, p in model.named_parameters() if k not in comp)
    return (sum(min(T2_RANK, d, n) * n for d, n in comp.values()),
            sum(d * n for d, n in comp.values()), other)


def moe_train_lanes(torch, dev, launches: dict) -> None:
    """M1, M1c and M2 (see the constants above).  Adds M2's kernel
    launches to ``launches``."""
    import dataclasses

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.launch.steps import compressed_paths
    from repro_torch.optim import EigenCompressConfig

    full = get_config(MOE_ARCH)

    # M1: AdamW at full width, M1_LAYERS layers.
    cfg = dataclasses.replace(full, num_layers=M1_LAYERS)
    r = adamw_lane(torch, dev, cfg, T1_BATCH,
                   after=lambda *a: moe_routing_step(torch, *a))
    depth = f"{M1_LAYERS} of {full.num_layers} layers"
    print_adamw("train-moe] M1", cfg, r, depth)
    print(f"[train-moe] M1 {full.num_experts} experts top-{full.num_experts_per_token}, "
          f"{cfg.moe_impl} form, capacity factor {cfg.capacity_factor}; one step more with "
          f"routing hooks (loss {r['routing_loss']:.4f}): drop share a layer "
          f"{[round(x, 4) for x in r['drop_shares']]}, calls a layer {r['routing_calls']} "
          f"(forward + the remat recompute), routing decisions the recompute changed "
          f"{r['routing_flips']}")
    require_adamw("M1", r)
    require(not any(r["counts"].values()), f"M1: kernels launched in training: {r['counts']}")
    require(r["routing_calls"] == [2] * M1_LAYERS and r["routing_flips"] == 0,
            f"M1: remat recompute routing {r['routing_calls']}, {r['routing_flips']} flips")
    free_card(torch)

    # M1c: both archs' reduced configs in f32, both forms, card vs CPU.
    for arch in MOE_TRAIN_ARCHS:
        for impl in ("einsum", "sort"):
            small = dataclasses.replace(get_reduced_config(arch), dtype="float32",
                                        attn_probs_bf16=False, moe_impl=impl)
            loss_err, par_err, lg, lc = card_vs_cpu(torch, dev, small)
            print(f"[train-moe] M1c {small.name} reduced f32, {impl} form, {T1C_STEPS} AdamW "
                  f"steps, card vs CPU: losses {[round(x, 6) for x in lg]} vs "
                  f"{[round(x, 6) for x in lc]}, worst relative loss gap {loss_err:.2e} (bar "
                  f"{T1C_LOSS}), worst parameter rel L2 {par_err:.2e} (bar {T1C_PARAM})")
            require(loss_err <= T1C_LOSS and par_err <= T1C_PARAM,
                    f"M1c {arch} {impl}: card and CPU disagree")
    free_card(torch)

    # M2: the eigen trainer stacked at M2_LAYERS layers; first B2 and B4 at
    # its refresh shapes.
    hold_refresh_shapes(torch, dev, (full.padded_vocab, full.d_model))
    cfg2 = dataclasses.replace(full, num_layers=M2_LAYERS)
    r = eigen_lane(torch, dev, cfg2)
    print_eigen("train-moe] M2", cfg2, f"{M2_LAYERS} of {full.num_layers} layers", r)
    ecfg = EigenCompressConfig(rank=T2_RANK, min_dim=64)
    low, comp_full, other = moe_words(torch, full, compressed_paths(full, ecfg))
    print(f"[train-moe] M2 words a step against the uncompressed baseline (computed from the "
          f"leaves' shapes, not a gain): at {M2_LAYERS} layers {r['low'] + r['other']} against "
          f"{r['full'] + r['other']} ({(r['full'] + r['other']) / (r['low'] + r['other']):.3f}x "
          f"fewer); reckoned at all {full.num_layers} layers {low + other} against "
          f"{comp_full + other} ({(comp_full + other) / (low + other):.3f}x fewer; the "
          f"uncompressed experts and the rest {other})")
    require(all(math.isfinite(x) for x in r["losses"]), "M2: a loss is not finite")
    require(r["counts"] == r["want"], f"M2: launches {r['counts']}, expected {r['want']}")
    for k in KERNELS:
        launches[k] += r["counts"][k]
    free_card(torch)


def profile_training(torch, dev, cfg=None) -> None:
    """One AdamW train step of ``cfg`` (T1's, llama3.2-3b's full config, by
    default) with T1's traffic under torch.profiler, after a warm-up
    step."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.schedule import constant

    cfg = cfg or train_cfg()
    model = build(cfg, device=dev, param_dtype=torch.float32,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    opt = adamw_init(dict(model.named_parameters()))
    step_fn = make_train_step(model, adamw_cfg=AdamWConfig(), schedule=constant(T1_LR))
    pipe = TokenPipeline(cfg.vocab_size, T1_SEQ, T1_BATCH, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev, torch.long) for k, v in pipe.batch(s).items()}
               for s in range(2)]
    step_fn(opt, batches[0])  # warm-up
    torch.cuda.synchronize()
    prof, wall_us = profiled(torch, lambda: step_fn(opt, batches[1]))
    print_profile(f"{cfg.name} train step {T1_BATCH} x {T1_SEQ} (AdamW, remat)", prof,
                  wall_us, top=20)


# -- the sharded lanes and the dry run (phase 3) -------------------------------
SHARD_RANKS = 2  # ranks of [sharded-ranks], sharing the card over gloo
DRYRUN_RANKS = 256
# The dry-run cells [dryrun] counts: paper-pca (multi_pod, topology,
# stream_steps) and the LM cells (arch, shape, eigen, part): every shape of
# recurrentgemma-2b and mamba2-370m (long_500k too: both are
# sub-quadratic) and whisper-tiny's three, and train_4k --eigen of the two
# recurrent archs.  DRYRUN_PARTS processes side by side, the paper-pca
# cells in part 0; the parts balance their CPU time (mamba2-370m's chunked
# SSD loops over its chunks: ~85 s at prefill_32k, ~125 s at train_4k and
# ~135 s with --eigen of the H100 machine's host; llama3.2-3b's and qwen3's
# eigen cells ~35 s and ~100 s).
DRYRUN_PCA = [(False, "ring", None), (True, "hier", None), (False, "ring", 4)]
DRYRUN_LM = [("llama3.2-3b", "train_4k", False, 0), ("llama3.2-3b", "prefill_32k", False, 0),
             ("llama3.2-3b", "decode_32k", False, 0), ("qwen3-moe-30b-a3b", "train_4k", False, 0),
             ("whisper-tiny", "train_4k", False, 0), ("whisper-tiny", "prefill_32k", False, 0),
             ("whisper-tiny", "decode_32k", False, 0),
             ("llama3.2-3b", "train_4k", True, 1), ("qwen3-moe-30b-a3b", "train_4k", True, 1),
             ("recurrentgemma-2b", "train_4k", True, 1),
             ("recurrentgemma-2b", "train_4k", False, 2),
             ("recurrentgemma-2b", "prefill_32k", False, 2),
             ("recurrentgemma-2b", "decode_32k", False, 2),
             ("recurrentgemma-2b", "long_500k", False, 2),
             ("mamba2-370m", "prefill_32k", False, 2),
             ("mamba2-370m", "train_4k", False, 3), ("mamba2-370m", "decode_32k", False, 3),
             ("mamba2-370m", "long_500k", False, 3),
             ("mamba2-370m", "train_4k", True, 4)]
DRYRUN_PARTS = 5


def dryrun_worker(out: str) -> int:
    """``--dryrun-out FILE.K``: count part K of the [dryrun] cells on fake
    process groups (no card work) and write their records: the paper-pca
    cells in part 0, and the LM cells whose part is K.  It runs beside
    the card's phases at the lowest priority, so it takes host time only
    where they leave it."""
    os.nice(19)
    sys.path.insert(0, SRC)
    from repro_torch.launch.dryrun import dryrun_cell, dryrun_paper_pca

    part = int(out.rsplit(".", 1)[1])
    recs = []
    if part == 0:
        for mp, topo, steps in DRYRUN_PCA:
            recs.append(dryrun_paper_pca(multi_pod=mp, topology=topo, stream_steps=steps,
                                         backend="cuda", verbose=False))
    for arch, shape, eigen, k in DRYRUN_LM:
        if k == part:
            recs.append(dryrun_cell(arch, shape, device_count=DRYRUN_RANKS, verbose=False,
                                    eigen=eigen))
    with open(out, "w") as f:
        json.dump(recs, f, default=str)
    return 0


def start_dryrun(out: str) -> list:
    """Start the dry-run processes; any still running when this script
    exits (a failed phase) is killed then."""
    import atexit

    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dryrun-out",
                               f"{out}.{k}"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k in range(DRYRUN_PARTS)]
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs


def dryrun_phase(procs: list, out: str) -> None:
    """[dryrun]: join the dry-run processes started after the sharded
    lanes, print one line a record and hold paper-pca's bytes to
    ``comm_cost``."""
    recs = []
    for k, proc in enumerate(procs):
        log, _ = proc.communicate(timeout=900)
        require(proc.returncode == 0, f"dry run failed:\n{log[-4000:]}")
        with open(f"{out}.{k}") as f:
            recs += json.load(f)
    base = {(r["arch"], r["shape"]): r for r in recs
            if r["arch"] != "paper-pca" and not r["eigen"]}
    for r in recs:
        if r["arch"] == "paper-pca":
            want = r["predicted_collective_bits"] / 8
            q = (f", query {r['query_collective_bytes_per_device']:.0f} B"
                 if "stream_steps" in r else "")
            print(f"[dryrun] paper-pca mesh {r['mesh']['shape']} {r['topology']} "
                  f"({r['kind']}, backend {r['backend']}): collective bytes a device "
                  f"{r['collective_bytes_per_device']:.0f} (comm_cost bits / 8: {want:.0f})"
                  f"{q}, FLOPs a device {r['flops_per_device']:.4e}, peak "
                  f"{r['memory']['peak_bytes'] / 1e9:.2f} GB, roofline {r['bottleneck']}"
                  f" (reckoned on fake tensors, not card times)")
            require(r["collective_bytes_per_device"] == want,
                    f"dry run: paper-pca bytes {r['collective_bytes_per_device']} != {want}")
            require(r.get("query_collective_bytes_per_device", 0) == 0,
                    "dry run: the stream query moved bytes")
        else:
            m = r["memory"]
            tag = " --eigen" if r["eigen"] else ""
            print(f"[dryrun] {r['arch']} x {r['shape']}{tag} mesh {r['mesh']['shape']}: FLOPs a "
                  f"device {r['flops_per_device']:.4e} (model {r['model_flops_per_device']:.4e}),"
                  f" args {m['argument_bytes'] / 1e9:.2f} GB (params "
                  f"{m['param_bytes'] / 1e9:.2f}, opt {m['opt_state_bytes'] / 1e9:.2f}), peak "
                  f"{m['peak_bytes'] / 1e9:.2f} GB, collectives "
                  f"{ {k: f'{v:.3e}' for k, v in r['collective_breakdown'].items()} }, roofline "
                  f"compute {r['compute_s'] * 1e3:.2f} ms / memory {r['memory_s'] * 1e3:.2f} ms"
                  f" / collective {r['collective_s'] * 1e3:.2f} ms (reckoned on fake tensors,"
                  f" not card times); counted in {r['count_s']:.1f} s of host time")
            # Sanity, not a bound: the count holds the bulk of the model's
            # products (6 N D counts the embedding lookup's parameters too),
            # and AdamW keeps two f32 moments a parameter.
            require(r["flops_per_device"] >= 0.5 * r["model_flops_per_device"] > 0,
                    f"dry run: {r['arch']} x {r['shape']} counted too few FLOPs")
            require(r["kind"] != "train" or r["eigen"]
                    or m["opt_state_bytes"] == 2 * m["param_bytes"],
                    f"dry run: {r['arch']} x {r['shape']} optimizer bytes")
            if r["eigen"]:
                b, w = base[(r["arch"], r["shape"])], r["data_axis_words"]
                print(f"[dryrun] {r['arch']} x {r['shape']} --eigen: data-axis bytes a device "
                      f"{r['data_axis_bytes']} (handed to torch.distributed: "
                      f"{r['data_axis_handed']}) against the baseline cell's "
                      f"{b['data_axis_bytes']} ({b['data_axis_bytes'] / r['data_axis_bytes']:.2f}x"
                      f"); compressed words {w['compressed']} against the full gradients' "
                      f"{w['full']} ({w['full'] / w['compressed']:.1f}x); args "
                      f"{m['argument_bytes'] / 1e9:.2f} GB against the baseline's "
                      f"{b['memory']['argument_bytes'] / 1e9:.2f} (no FSDP, err whole) "
                      f"(reckoned)")
                require(r["data_axis_bytes"] == sum(r["data_axis_handed"].values())
                        and 0 < w["compressed"] < w["full"],
                        f"dry run: {r['arch']} eigen data-axis bytes")


def shard_rank_worker(rank: int, init: str, out: str, arch: str = SERVE_ARCH,
                      dtype: str | None = None) -> int:
    """``--shard-rank K [--shard-arch ARCH] [--shard-dtype DTYPE]``: one
    rank of [sharded-ranks], ``arch`` (llama3.2-3b, or recurrentgemma-2b)
    at full width on a (1, SHARD_RANKS) mesh (NCCL with a card a rank,
    else gloo on the shared card).  Probes each collective kind on CUDA
    tensors first, then prefills the serving prompts through the sharded
    model; rank 0 writes the logits.  With ``dtype`` (``--ranks-witness``)
    the model is built in that dtype from the same seed, and rank 0 first
    prefills it unsharded and writes those logits too."""
    import dataclasses

    import torch
    import torch.distributed as dist

    sys.path.insert(0, SRC)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import kernels
    from repro_torch.interop import strict_fp32
    from repro_torch.launch import counting
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import load
    from repro_torch.models import build

    strict_fp32()
    # A card a rank over NCCL where there are enough cards; else the ranks
    # share card 0 over gloo.
    nccl = torch.cuda.device_count() >= SHARD_RANKS
    dev = torch.device("cuda", rank if nccl else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if nccl else "gloo", init_method=init, rank=rank,
                            world_size=SHARD_RANKS)
    report = {"refused": {}, "backend": dist.get_backend()}
    path = os.path.join(out, f"shard{rank}.json")

    def mark(**kw):
        report.update(kw)
        with open(path, "w") as f:
            json.dump(report, f)

    try:
        mesh = make_mesh((1, SHARD_RANKS), ("data", "model"), device="cuda")
        x = torch.ones(8, 16, device=dev)
        # Each collective kind as DTensor issues it: a redistribution of the
        # model axis from one placement to another.
        probes = {"all-reduce": (Partial(), Replicate()), "all-gather": (Shard(0), Replicate()),
                  "reduce-scatter": (Partial(), Shard(0)), "all-to-all": (Shard(0), Shard(1))}
        for kind, (src, dst) in probes.items():
            mark(probing=kind)  # a collective that kills the process is named here
            try:
                DTensor.from_local(x, mesh, [Replicate(), src]).redistribute(
                    mesh, [Replicate(), dst]).to_local()
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 -- reported by name
                report["refused"][kind] = f"{type(e).__name__}: {str(e)[:200]}"
        mark(probing=None)
        model, prompts, _ = load(arch, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                                 reduced=False, device=dev, seed=SEED)
        if dtype is not None:
            cfg = dataclasses.replace(model.cfg, dtype=dtype)
            del model
            model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
            if rank == 0:
                ref, _ = model.prefill(prompts)
                torch.save(ref[:, :cfg.vocab_size].cpu(), os.path.join(out, "ref.pt"))
                del ref
        S.shard_model(model, model.cfg, mesh)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        comms = counting.LocalComms()
        try:
            with S.sharded(mesh), CommDebugMode() as cdm, comms:
                t0 = time.perf_counter()
                logits, _ = model.prefill(S.shard_batch({"t": prompts}, mesh)["t"])
                whole = logits.full_tensor()
                torch.cuda.synchronize()
                report["prefill_s"] = time.perf_counter() - t0
            report["launches"] = kernels.launch_counts()["flash_attention"]
            report["blocks"] = model.attention_blocks
            report["collectives"] = {k: [int(comms.counts[k]), int(v)]
                                     for k, v in comms.by_kind.items()}
            report["comm_counts"] = {str(k): int(v) for k, v in cdm.get_comm_counts().items()}
            attn = next(b.mixer for b in model.blocks if b.kind in ("attn", "local_attn"))
            report["local_heads"] = [attn.wq.to_local().shape[1] // model.cfg.head_dim,
                                     attn.wk.to_local().shape[1] // model.cfg.head_dim]
            report["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if rank == 0:
                torch.save(whole[:, :model.cfg.vocab_size].cpu(),
                           os.path.join(out, "logits.pt"))
        except Exception as e:  # noqa: BLE001 -- reported with the probes
            report["error"] = f"{type(e).__name__}: {str(e)[:400]}"
    finally:
        dist.destroy_process_group()
    mark()
    return 0


def sharded_lanes(torch, dev, launches: dict, unsharded: dict) -> None:
    """[sharded]: llama3.2-3b served through ``launch.sharding`` on a (1, 1)
    mesh (a world of one: every parameter and cache a DTensor), held to
    the unsharded lane (``unsharded``: its tokens, kernel-prefill logits,
    prefill_s, decode ms a step, peak GB); [sharded-ranks]: the same model
    on SHARD_RANKS rank processes sharing the card over gloo, each rank's
    B8 on its local heads."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import generate, load

    t_lane = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, prompts, _ = load(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                                 reduced=False, device="cuda", seed=SEED)
        S.shard_model(model, model.cfg, mesh)
        from torch.distributed.tensor import DTensor
        require(all(isinstance(p, DTensor) for p in model.parameters()),
                "sharded: a parameter is not a DTensor")
        kernels.reset_launch_counts()
        toks, st = generate(model, prompts, gen=SERVE_GEN, mesh=mesh)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches["flash_attention"] += counts["flash_attention"]
        layers = model.cfg.num_layers
        require(st["flash_launches"] == {"prefill": layers, "decode": 0}
                and counts == expected_counts({"flash_attention": layers}),
                f"sharded: flash launches {st['flash_launches']}, {counts}")
        with S.sharded(mesh):
            logits, cache = model.prefill(S.shard_batch({"t": prompts}, mesh)["t"])
            got = logits.full_tensor()[:, :model.cfg.vocab_size]
        require(all(isinstance(t, DTensor) for blk in cache for t in blk.values()),
                "sharded: a cache tensor is not a DTensor")
        rel_l2, max_abs, agree = serving_gap(torch, got, unsharded["logits"])
        same = bool((toks == unsharded["toks"]).all())
        dec_ms = st["decode_s"] / SERVE_GEN * 1e3
        print(f"[sharded] {SERVE_ARCH} full config on a (1, 1) mesh (every parameter and "
              f"cache a DTensor): prefill_s {st['prefill_s']:.4f} (unsharded "
              f"{unsharded['prefill_s']:.4f}), decode {dec_ms:.2f} ms/step (unsharded "
              f"{unsharded['decode_ms']:.2f}), peak {peak:.2f} GB (unsharded "
              f"{unsharded['peak_gb']:.2f}); flash launches {st['flash_launches']}; tokens "
              f"equal the unsharded lane's {same}; last logits vs the unsharded kernel "
              f"prefill: rel L2 {rel_l2:.3e}, max abs {max_abs:.3e} of the largest "
              f"(bars {SERVE_REL_L2}, {SERVE_MAX_ABS}), argmax agree {agree}/{SERVE_BATCH}")
        require(same, "sharded: tokens differ from the unsharded lane's")
        require(within_bars(torch, got, unsharded["logits"]),
                "sharded: logits outside the serving bars")
        del model, prompts, logits, cache, got
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"[sharded] one-rank lane in {time.perf_counter() - t_lane:.1f} s")
    sharded_ranks(torch, dev, launches, unsharded)


def sharded_ranks(torch, dev, launches: dict, unsharded: dict | None, arch: str = SERVE_ARCH,
                  dtype: str | None = None) -> None:
    """[sharded-ranks]: ``arch`` on SHARD_RANKS rank processes over a
    (1, SHARD_RANKS) mesh (``--shard-rank K``), the rank-0 prefill logits
    held to the unsharded lane's (see ``sharded_lanes``), or with
    ``dtype`` (``unsharded`` None) to rank 0's own unsharded prefill of
    the model built in that dtype.  llama3.2-3b's lane probes the
    collectives on one card too (and prints gloo's refusal);
    recurrentgemma-2b's (5 query heads a rank over its one KV head, B8's
    head_dim-256 form, the RG-LRU's gate reductions over 'model') skips at
    once below SHARD_RANKS cards."""
    t0 = time.perf_counter()
    if arch != SERVE_ARCH and torch.cuda.device_count() < SHARD_RANKS:
        print(f"[sharded-ranks] {arch} skipped: needs {SHARD_RANKS} cards (NCCL; gloo "
              f"refuses the collectives on CUDA, as the {SERVE_ARCH} lane prints)")
        return
    with tempfile.TemporaryDirectory() as out:
        init = f"tcp://127.0.0.1:{free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--shard-rank", str(k),
             "--shard-arch", arch, "--init", init, "--out", out,
             *(("--shard-dtype", dtype) if dtype else ())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for k in range(SHARD_RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        reps = [json.load(open(os.path.join(out, f"shard{k}.json")))
                for k in range(SHARD_RANKS)]
        for p, r in zip(procs, reps):
            if p.returncode and r.get("probing"):
                # The process died inside a probe: that collective is refused.
                r["refused"][r["probing"]] = f"the rank process died (exit {p.returncode})"
                r["error"] = f"died probing {r['probing']}"
        require(all(p.returncode == 0 or r.get("probing") for p, r in zip(procs, reps)),
                f"sharded-ranks workers failed: "
                f"{[(p.returncode, lg[-3000:]) for p, lg in zip(procs, logs)]}")
        refused = reps[0]["refused"]
        print(f"[sharded-ranks] {reps[0]['backend']} on CUDA tensors, each collective kind "
              f"probed through DTensor: refused {refused or 'none'}")
        if "error" in reps[0] or any("error" in r for r in reps):
            errs = [r.get("error") for r in reps]
            require(bool(refused), f"sharded-ranks failed with no gloo refusal: {errs}")
            kinds = ", ".join(sorted(refused))
            require(reps[0]["backend"] == "gloo" and torch.cuda.device_count() < 2,
                    f"sharded-ranks: {reps[0]['backend']} refuses {kinds}: {errs}")
            print(f"[sharded-ranks] skipped: needs 2 cards (gloo refuses {kinds} on "
                  f"CUDA); {errs[0]}")
            return
        got = torch.load(os.path.join(out, "logits.pt")).to(dev)
        want = (unsharded["logits"] if dtype is None
                else torch.load(os.path.join(out, "ref.pt")).to(dev))
    rel_l2, max_abs, agree = serving_gap(torch, got, want)
    n = sum(r["launches"] for r in reps)
    launches["flash_attention"] += n
    r0 = reps[0]
    against = "the unsharded kernel prefill" if dtype is None else (
        f"rank 0's own unsharded {dtype} prefill")
    print(f"[sharded-ranks] {arch}{f' in {dtype}' if dtype else ''} full width on a "
          f"(1, {SHARD_RANKS}) mesh, "
          f"{SHARD_RANKS} ranks over {r0['backend']}: local heads (q, kv) "
          f"{r0['local_heads']}, prefill_s {r0['prefill_s']:.4f} / "
          f"{reps[1]['prefill_s']:.4f} (rank 0 / 1), peak {r0['peak_gb']:.2f} GB a rank, "
          f"flash launches {[r['launches'] for r in reps]}; rank-0 last logits vs "
          f"{against}: rel L2 {rel_l2:.3e}, max abs {max_abs:.3e} "
          f"(bars {SERVE_REL_L2}, {SERVE_MAX_ABS}), argmax agree {agree}/{SERVE_BATCH}")
    print(f"[sharded-ranks] collectives a rank in the prefill (kind: [count, bytes of "
          f"local operands]): {r0['collectives']}; CommDebugMode {r0['comm_counts']}")
    require(all(r["launches"] == r["blocks"] for r in reps),
            f"sharded-ranks: flash launches {[r['launches'] for r in reps]}")
    require(within_bars(torch, got, want), "sharded-ranks: rank-0 logits outside the serving bars")
    print(f"[sharded-ranks] lane in {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile the stacked main-path lanes instead of the checks")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--train-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--shard-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--shard-arch", default=SERVE_ARCH, help=argparse.SUPPRESS)
    ap.add_argument("--shard-dtype", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ranks-witness", action="store_true",
                    help="run only [sharded-ranks] for the hybrid (2 cards): in its config's "
                         "dtype and in float32, each against rank 0's own unsharded prefill")
    ap.add_argument("--shard-train-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-out", default=None, help=argparse.SUPPRESS)
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
    if args.train_rank is not None:
        return train_rank_worker(args.train_rank, args.init, args.out)
    if args.shard_rank is not None:
        return shard_rank_worker(args.shard_rank, args.init, args.out, args.shard_arch,
                                 args.shard_dtype)
    if args.shard_train_rank is not None:
        return shard_train_rank_worker(args.shard_train_rank, args.init, args.out)
    if args.dryrun_out is not None:
        return dryrun_worker(args.dryrun_out)
    sys.path.insert(0, SRC)

    from repro_torch import kernels
    from repro_torch.comm import (
        PARITY_TOL,
        Membership,
        comm_cost,
        get_codec,
        shard_generator,
    )
    from repro_torch.core import (
        central_estimate,
        dist_2,
        distributed_pca,
        empirical_covariance,
        refinement_rounds,
        subspace_dist64,
    )
    from repro_torch.plan import (
        Calibration,
        device_model,
        explain,
        plan_aggregation,
        resolve_plan,
        score_cells,
    )
    from repro_torch.runtime.elastic import replan
    from repro_torch.core.subspace import local_eigenbasis
    from repro_torch.stream import SubspaceService, basis_jump
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
    if args.ranks_witness:  # a second witness of [sharded-ranks]' hybrid gap
        for dtype in ("bfloat16", "float32"):
            sharded_ranks(torch, dev, {"flash_attention": 0}, None,
                          arch=RECURRENT_ARCHS[0][0], dtype=dtype)
        return 0

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
        torch.cuda.empty_cache()
        profile_serving(torch, dev, RECURRENT_ARCHS[0][0])
        torch.cuda.empty_cache()
        profile_serving(torch, dev, MOE_ARCH, top=24)
        torch.cuda.empty_cache()
        profile_serving(torch, dev, VLM_ARCH)
        torch.cuda.empty_cache()
        profile_whisper(torch, dev)
        torch.cuda.empty_cache()
        profile_training(torch, dev)
        import dataclasses

        from repro_torch.configs import get_config

        for arch in RECUR_TRAIN:
            free_card(torch)
            profile_training(torch, dev, get_config(arch))
        free_card(torch)
        profile_training(torch, dev, dataclasses.replace(get_config(MOE_ARCH),
                                                         num_layers=M1_LAYERS))
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
    gram_plan, b3_form = {}, {}
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
        print(f"[check] {'batched_gram_polar':<18} {label:<34} Newton-Schulz "
              f"{batched_gram_polar.last_form}, grid {batched_gram_polar.grid} blocks")
        b3_form[label] = batched_gram_polar.last_form
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

    # B3, B5 and B6 past r = 136: the grouped Newton-Schulz form streams
    # its iterate from L2, and B5/B6's factor runs on the whole grid.
    wide_stacks, wide_wires, round_form = {}, {}, {}
    for r in WIDE_RS:
        vs = noisy_stack(torch, gen, SHARDS, D, r, dev)
        rf = vs[0].contiguous()
        label = f"wide ({SHARDS}, {D}, {r})"
        hold("batched_gram_polar", label,
             batched_gram_polar(vs, rf), ref.batched_gram_polar(vs, rf), NS_TOL)
        print(f"[check] {'batched_gram_polar':<18} {label:<34} "
              f"Newton-Schulz {batched_gram_polar.last_form}, grid "
              f"{batched_gram_polar.grid} blocks")
        b3_form[r] = batched_gram_polar.last_form
        hold_round("fused_round", label, fused_round(vs, rf), ref.fused_round(vs, rf))
        deficient = vs.clone()
        deficient[:, :, -1] = 0  # V-bar of rank r - 1: the grid factor's shifted retry
        got = fused_round(deficient, deficient[0].contiguous())
        hold_round("fused_round", f"{label} rank-deficient", got,
                   ref.fused_round(deficient, deficient[0].contiguous()))
        require(got[:, -1].abs().max().item() == 0.0,
                f"fused_round: the rank-deficient round at r={r} left its zero column")
        round_form[r] = (fused_round.last_form, fused_round.last_factor)
        print(f"[check] {'fused_round':<18} {label:<34} grid {fused_round.grid} blocks; "
              f"Newton-Schulz {fused_round.last_form}; factor {fused_round.last_factor}")
        q, sc = int8_wire(vs)
        wide_wires[r] = {"f32": (vs, None), "bf16": (vs.to(torch.bfloat16), None),
                         "int8": (q, sc)}
        for wire, (w, sc) in wide_wires[r].items():
            hold_round("fused_ring_round", f"{label} {wire}",
                       fused_ring_round(w, rf, sc), ref.fused_ring_round(w, rf, sc))
        print(f"[check] {'fused_ring_round':<18} {label:<34} Newton-Schulz "
              f"{fused_ring_round.last_form}; factor {fused_ring_round.last_factor}")
        wide_stacks[r] = vs

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
    estimates, lane_counts = {}, {}
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
        lane_counts[(polar, orth)] = counts
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

    # The planned stacked lane: plan="auto" resolves the cell on the card's
    # model; it must run one of the lanes above, bit for bit, with the
    # same launches.  The scored tables in both contexts first.
    for context in ("stacked", "collective"):
        pl, table = explain(m=SHARDS, d=D, r=R, n_iter=N_ITER, context=context)
        print(f"[plan] {context} context, m={SHARDS} d={D} r={R} n_iter={N_ITER}: {pl}")
        for line in table.splitlines():
            print(f"[plan]   {line}")
        require(pl.device_kind == "h100", f"plan: device kind {pl.device_kind!r} on {name}")
    pl_auto = resolve_plan("auto", m=SHARDS, d=D, r=R, n_iter=N_ITER, context="stacked",
                           tensor_device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    v = distributed_pca(samples, R, shards=SHARDS, device=dev, n_iter=N_ITER,
                        solver="subspace", iters=ITERS, plan="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for k in KERNELS:
        launches[k] += counts[k]
    cell = (pl_auto.polar, pl_auto.orth)
    same = cell in estimates and torch.equal(v, estimates[cell])
    print(f"[main] plan=auto -> {pl_auto.backend}/{pl_auto.topology}/{cell[0]}/{cell[1]} "
          f"(predicted {pl_auto.total_s * 1e3:.3f} ms for the rounds): wall {wall:.2f} s, "
          f"launches { {k: c for k, c in counts.items() if c} }, bit for bit the "
          f"{cell[0]}/{cell[1]} lane {same}, dist_2(v, central) "
          f"{dist_2(v, v_cent).item():.4e}")
    require(pl_auto.backend == "cuda" and pl_auto.topology == "gather" and cell in estimates,
            f"plan=auto: {pl_auto} is not one of the stacked cuda lanes")
    require(same, f"plan=auto: the estimate differs from the {cell} lane's")
    require(counts == lane_counts[cell],
            f"plan=auto: launches {counts}, the {cell} lane's {lane_counts[cell]}")

    # The streaming lanes (A9): the stacked service fed the main data in
    # STREAM_STEPS chunks a shard, plan "auto" (B1 ingest, the planned
    # rounds at every refresh), then again with shard STREAM_DEAD dead.
    def stacked_service(m, cadence):
        return SubspaceService(D, R, shards=m, device=dev, n_iter=N_ITER, cadence=cadence,
                               solver="subspace", iters=ITERS, plan="auto")

    def stream_counts(rec, grams):
        want = {"gram": grams}
        for pl_r in rec["plans"]:
            for k, c in round_kernels(pl_r).items():
                want[k] = want.get(k, 0) + c * N_ITER
        return expected_counts(want)

    def print_stream(label, rec, counts, extra):
        print(f"[stream] {label}: wall {rec['wall']:.2f} s, ingest step (median, no "
              f"refresh) {rec['ingest_step_ms']:.2f} ms, refreshes after steps "
              f"{rec['refresh_steps']} taking "
              + ", ".join(f"{ms:.1f}" for ms in rec["refresh_ms"])
              + f" ms beyond ingest, plans "
              + "; ".join(sorted({f"{p.backend}/{p.topology}/{p.polar}/{p.orth}"
                                  for p in rec["plans"]}))
              + f", launches { {k: c for k, c in counts.items() if c} }, jumps "
              + ", ".join("-" if j is None else f"{j:.4e}" for j in rec["jumps"])
              + f"{extra}")

    chunk_of = lambda t: xs[:, t * STREAM_CHUNK:(t + 1) * STREAM_CHUNK]  # noqa: E731
    kernels.reset_launch_counts()
    svc = stacked_service(SHARDS, STREAM_CADENCE)
    rec = feed_stream(torch, svc, chunk_of, STREAM_STEPS)
    counts = kernels.launch_counts()
    for k in KERNELS:
        launches[k] += counts[k]
    v_stream = svc.basis.clone()
    st = svc.stats
    lane = "stream lane"
    expected = stream_counts(rec, STREAM_STEPS * SHARDS)
    require(counts == expected, f"{lane}: launches {counts}, expected {expected}")
    require(rec["refresh_steps"] == stream_refresh_steps(STREAM_STEPS, STREAM_CADENCE)
            and st["staleness"] == 0 and st["rows_seen"] == SHARDS * N_PER_SHARD,
            f"{lane}: refreshes after {rec['refresh_steps']}, stats {st}")
    jumps = [j for j in rec["jumps"] if j is not None]
    require(len(jumps) == len(rec["jumps"]) - 1 and max(jumps) < JUMP_BAR,
            f"{lane}: refresh jumps {rec['jumps']} (bar {JUMP_BAR})")
    # Ingest: each shard's state against the plain ingest over the same
    # chunks and against one B1 call over its rows (comparison launches).
    from repro_torch.core.covariance import gram_increment

    oneshot, worst = [], (0.0, 0.0, 0.0)
    for i in range(SHARDS):
        state_g = svc.state["gram"][i]
        plain = torch.zeros_like(state_g)
        for t in range(STREAM_STEPS):
            plain += gram_increment(chunk_of(t)[i])
        one = gram(xs[i])
        tol = sum_tol(N_PER_SHARD, plain.abs().max().item())
        e_plain = (state_g - plain).abs().max().item()
        e_one = (state_g - one).abs().max().item()
        worst = max(worst, (e_plain, e_one, tol))
        require(e_plain <= tol and e_one <= tol
                and int(svc.state["count"][i]) == N_PER_SHARD,
                f"{lane} shard {i}: state vs plain ingest {e_plain}, vs one B1 call "
                f"{e_one} (tol {tol})")
        oneshot.append(one)
        del plain
    # The local bases of the full-stream covariances (one B1 call each,
    # above): their spread around the served basis bounds a re-refresh on
    # the same state; the survivors' make the dead-shard lane's oracle.
    local = [local_eigenbasis(g / N_PER_SHARD, R, method="subspace", iters=ITERS)[0]
             for g in oneshot]
    eps2 = sum(torch.linalg.norm(v - v_stream @ (v_stream.T @ v)).item() ** 2
               for v in local) / SHARDS
    del oneshot
    # A re-refresh on the same state, against the one-shot B5 lane and the
    # central estimate, and the queries.
    svc.refresh()
    torch.cuda.synchronize()
    again = basis_jump(v_stream, svc.basis)
    sd_b5 = subspace_dist64(v_stream, v_b5)
    d_b5 = dist_2(v_b5, v_cent).item()
    d_stream = dist_2(v_stream, v_cent).item()
    qs = syn.sample_gaussian(factor, SERVE_QUERIES, generator=gen)
    proj, calls = dist_calls(torch.distributed, lambda: torch.cat(
        [svc.project(qs[lo:lo + SERVE_QBATCH]) for lo in range(0, SERVE_QUERIES, SERVE_QBATCH)]))
    torch.cuda.synchronize()
    print_stream(
        f"stacked m={SHARDS} d={D} r={R} {STREAM_STEPS} steps of {STREAM_CHUNK} rows, "
        f"cadence {STREAM_CADENCE}, plan auto", rec, counts,
        f" (bar {JUMP_BAR}); state vs plain ingest max_abs_err {worst[0]:.3e}, vs one "
        f"B1 call {worst[1]:.3e} (tol {worst[2]:.3e}); re-refresh on the same state "
        f"jumps {again:.4e} (bar: the local bases' spread mean ||(I - v v^T) V_i||_F^2 "
        f"= {eps2:.4e}); "
        f"subspace_dist64(v, one-shot B5 lane) {sd_b5:.4e} (bar: that lane's dist_2 to "
        f"central {d_b5:.4e}), dist_2(v, central) {d_stream:.4e}; {SERVE_QUERIES} "
        f"queries in batches of {SERVE_QBATCH}: torch.distributed calls {calls}")
    require(again <= eps2, f"{lane}: re-refresh jumped {again} (bar {eps2})")
    require(sd_b5 < d_b5 and d_stream < DIST_BAR,
            f"{lane}: {sd_b5} from the one-shot lane (bar {d_b5}), {d_stream} from central")
    want = torch.cat([qs[lo:lo + SERVE_QBATCH] @ svc.basis
                      for lo in range(0, SERVE_QUERIES, SERVE_QBATCH)])
    require(calls == [] and torch.equal(proj, want),
            f"{lane}: queries called {calls} or differ from the batches' qs @ basis")
    stream_walls = {"stacked": rec["wall"]}
    del svc, proj, qs, want

    kernels.reset_launch_counts()
    svc = stacked_service(SHARDS, STREAM_CADENCE)
    rec = feed_stream(torch, svc, chunk_of, STREAM_STEPS, dead=STREAM_DEAD,
                      dead_at=STREAM_DEAD_AT)
    counts = kernels.launch_counts()
    for k in KERNELS:
        launches[k] += counts[k]
    st = svc.stats
    lane = "stream lane, shard dead"
    expected = stream_counts(rec, STREAM_DEAD_AT * SHARDS
                             + (STREAM_STEPS - STREAM_DEAD_AT) * (SHARDS - 1))
    require(counts == expected, f"{lane}: launches {counts}, expected {expected}")
    require(rec["refresh_steps"] == stream_refresh_steps(STREAM_STEPS, STREAM_CADENCE,
                                                         STREAM_DEAD_AT)
            and (st["replans"], st["m_active"], st["events"], st["staleness"])
            == (1, SHARDS - 1, ["failure"], 0)
            and int(svc.state["count"][STREAM_DEAD]) == STREAM_DEAD_AT * STREAM_CHUNK,
            f"{lane}: refreshes after {rec['refresh_steps']}, stats {st}")
    # The serial oracle: the survivors' local bases of their full-stream
    # covariances (above), the rounds in the re-planned cell.
    mem = Membership.from_dead(SHARDS, [STREAM_DEAD])
    oracle = refinement_rounds(torch.stack([local[i] for i in mem.indices]).contiguous(),
                               n_iter=N_ITER, plan=svc.plan)
    sd = subspace_dist64(svc.basis, oracle)
    print_stream(f"stacked, shard {STREAM_DEAD} dead from step {STREAM_DEAD_AT}", rec,
                 counts, f"; replans {st['replans']}, m_active {st['m_active']}, events "
                 f"{st['events']}; subspace_dist64(v, serial oracle over the survivors) "
                 f"{sd:.3e} (tol {STACK_TOL:.0e}), dist_2(v, central) "
                 f"{dist_2(svc.basis, v_cent).item():.4e}")
    require(sd <= STACK_TOL, f"{lane}: {sd} from the serial oracle")
    stream_walls["stacked, shard dead"] = rec["wall"]
    del svc, local, oracle
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
    # The stacked service the rank world's stream lane is held to: the same
    # rows and schedule.
    xs_p = samples.reshape(WORLD, N_PSUM, D)
    p_chunk = N_PSUM // RANK_STREAM_STEPS
    kernels.reset_launch_counts()
    svc = stacked_service(WORLD, RANK_STREAM_CADENCE)
    rec = feed_stream(torch, svc, lambda t: xs_p[:, t * p_chunk:(t + 1) * p_chunk],
                      RANK_STREAM_STEPS, dead=STREAM_DEAD, dead_at=RANK_STREAM_DEAD_AT)
    counts = kernels.launch_counts()
    for k in KERNELS:
        launches[k] += counts[k]
    expected = stream_counts(rec, RANK_STREAM_DEAD_AT * WORLD
                             + (RANK_STREAM_STEPS - RANK_STREAM_DEAD_AT) * (WORLD - 1))
    print_stream(f"stacked m={WORLD} n={N_PSUM} in {RANK_STREAM_STEPS} steps, cadence "
                 f"{RANK_STREAM_CADENCE}, shard {STREAM_DEAD} dead from step "
                 f"{RANK_STREAM_DEAD_AT} (the rank world's stream lane's oracle)", rec,
                 counts, "")
    require(counts == expected, f"stacked N_PSUM stream lane: launches {counts}, "
                                f"expected {expected}")
    v_stream_psum = svc.basis.clone()
    stream_psum_stats = {k: svc.stats[k] for k in (
        "step", "rows_seen", "refreshes", "staleness", "m_active", "replans", "events")}
    stream_walls["stacked N_PSUM"] = rec["wall"]
    del svc, xs_p
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
        el_ests = [torch.load(os.path.join(out, f"elastic-{k}.pt")).to(dev)
                   for k in range(WORLD)]
        el_bases = torch.stack([torch.load(os.path.join(out, f"elastic-basis-{k}.pt"))
                                for k in range(WORLD)]).to(dev)
        ests_stream = [torch.load(os.path.join(out, f"stream-{k}.pt")).to(dev)
                       for k in range(WORLD)]
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
              f"{extra} over {len(cells)} ranks, grid {cells[0]['grid']} blocks, "
              f"hops' Newton-Schulz {cells[0]['form']} {'ok' if ok else 'FAIL'}")
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
    # The elastic lane: one initial and one failure event, one re-plan
    # priced at m' = WORLD - 1, and the estimate against the composed
    # oracle: round 0 over all WORLD local bases, then the remaining rounds
    # over the survivors' with that basis as the reference, each stacked
    # round in its event's (backend, polar, orth) cell.
    el = [rep["lanes"]["elastic"] for rep in reports]
    ev = el[0]["events"]
    mem_dead = Membership.from_dead(WORLD, [ELASTIC_DEAD])
    priced = replan(mem_dead, d=D, r=R, n_iter=N_ITER - ELASTIC_ROUND, ref_broadcast=False)
    fail_plan = ev[-1]["plan"]
    model_words = comm_cost(fail_plan["topology"], m=WORLD - 1, d=D, r=R,
                            n_iter=N_ITER - ELASTIC_ROUND, ref_broadcast=False,
                            comm_bits=fail_plan["comm_bits"]).words
    require([e["reason"] for e in ev] == ["initial", "failure"]
            and ev[1]["round"] == ELASTIC_ROUND and ev[1]["dead"] == [ELASTIC_DEAD],
            f"elastic: events {ev}")
    require(all(e["replans"] == 1 and e["final_m_active"] == WORLD - 1 for e in el),
            f"elastic: replans / final m' {[(e['replans'], e['final_m_active']) for e in el]}")
    require((fail_plan["backend"], fail_plan["topology"], fail_plan["polar"],
             fail_plan["orth"], fail_plan["comm_bits"], fail_plan["words"])
            == (priced.backend, priced.topology, priced.polar, priced.orth,
                priced.comm_bits, priced.words) and fail_plan["words"] == model_words,
            f"elastic: the re-plan {fail_plan} is not priced at m' = {WORLD - 1} "
            f"({priced}, comm_cost words {model_words})")

    def oracle_round(stack, ref, plan):
        return refinement_rounds(stack, ref, n_iter=1, backend=plan["backend"],
                                 polar=plan["polar"], orth=plan["orth"])

    orc = oracle_round(el_bases, None, ev[0]["plan"])
    survivors = el_bases[list(mem_dead.indices)].contiguous()
    for _ in range(N_ITER - ELASTIC_ROUND):
        orc = oracle_round(survivors, orc.contiguous(), fail_plan)
    sd = subspace_dist64(el_ests[0], orc)
    spread = max(subspace_dist64(e, el_ests[0]) for e in el_ests[1:])
    for rep in el:
        for kern, c in rep["launches"].items():
            launches[kern] += c
    print(f"[ranks] elastic plan=auto, shard {ELASTIC_DEAD} dead before round "
          f"{ELASTIC_ROUND}, m={WORLD} n={N_PSUM} d={D} r={R}: wall "
          f"{max(e['wall'] for e in el):.2f} s (slowest rank), launches/rank "
          f"{ {k: c for k, c in el[0]['launches'].items() if c} }, events "
          + "; ".join(f"round {e['round']}: {e['reason']} m'={e['m_active']} plan "
                      f"{e['plan']['backend']}/{e['plan']['topology']}/{e['plan']['polar']}/"
                      f"{e['plan']['orth']}/{e['plan']['comm_bits']} words {e['plan']['words']}"
                      for e in ev)
          + f", re-plan words at m'={WORLD - 1} by comm_cost {model_words}; "
          f"subspace_dist64(v, composed oracle) {sd:.3e} (tol {ELASTIC_TOL:.0e}), "
          f"rank spread {spread:.1e}, dist_2(v, central) "
          f"{dist_2(el_ests[0], v_cent_psum).item():.4e}")
    require(sd <= ELASTIC_TOL, f"elastic: {sd} from the composed oracle")
    require(spread <= ROUND_SD_TOL, f"elastic: ranks disagree by {spread}")
    del el_ests, el_bases, survivors
    # The collective stream lane: each rank its own N_PSUM rows, the same
    # schedule as the stacked service above; held to it at STACK_TOL.
    sl = [rep["lanes"]["stream"] for rep in reports]
    st_ests = ests_stream
    sd = subspace_dist64(st_ests[0], v_stream_psum)
    spread = max(subspace_dist64(e, st_ests[0]) for e in st_ests[1:])
    grams = [RANK_STREAM_STEPS if k != STREAM_DEAD else RANK_STREAM_DEAD_AT
             for k in range(WORLD)]
    for rep in sl:
        for kern, c in rep["launches"].items():
            launches[kern] += c
    print(f"[ranks] stream, {WORLD} ranks each streaming {N_PSUM} rows in "
          f"{RANK_STREAM_STEPS} steps, cadence {RANK_STREAM_CADENCE}, shard {STREAM_DEAD} "
          f"dead from step {RANK_STREAM_DEAD_AT}, plan {'/'.join(map(str, sl[0]['plan']))}: "
          f"wall {max(r['wall'] for r in sl):.2f} s (slowest rank), launches rank 0 "
          f"{ {k: c for k, c in sl[0]['launches'].items() if c} }, rank {STREAM_DEAD} "
          f"{ {k: c for k, c in sl[STREAM_DEAD]['launches'].items() if c} }, refreshes "
          f"{sl[0]['refreshes']}, replans {sl[0]['replans']}, m_active {sl[0]['m_active']}, "
          f"events {sl[0]['events']}, subspace_dist64(v, the stacked service) {sd:.3e} "
          f"(tol {STACK_TOL:.0e}), rank spread {spread:.1e}, dist_2(v, central) "
          f"{dist_2(st_ests[0], v_cent_psum).item():.4e}")
    require(all({k: r[k] for k in stream_psum_stats} == stream_psum_stats for r in sl),
            f"rank stream lane: stats {[{k: r[k] for k in stream_psum_stats} for r in sl]}, "
            f"the stacked service's {stream_psum_stats}")
    require(all(r["launches"]["gram"] == g for r, g in zip(sl, grams)),
            f"rank stream lane: B1 launches {[r['launches']['gram'] for r in sl]}, "
            f"expected {grams}")
    require(sd <= STACK_TOL and spread <= ROUND_SD_TOL,
            f"rank stream lane: {sd} from the stacked service, spread {spread}")
    stream_walls["ranks"] = max(r["wall"] for r in sl)
    del st_ests
    b7_time = [rep["b7_time"] for rep in reports]
    b7_split = [rep["b7_split"] for rep in reports]
    b7_form = reports[0]["b7"][f"main ({WORLD} ranks, {D}, {R})"]["form"]
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

    # The launcher in one process at the production width, the planner
    # choosing the cell and printing its table.
    t0 = time.monotonic()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.eigen", "--device", "cuda",
         "--d", str(D), "--r", str(R), "--n-per-shard", str(N_PSUM), "--shards",
         str(SHARDS), "--plan", "auto", "--explain"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": SRC},
    )
    require(cli.returncode == 0, f"launcher --plan auto failed:\n{cli.stderr[-4000:]}")
    lines = cli.stdout.strip().splitlines()
    stats = dict(line.split(": ", 1) for line in lines if ": " in line)
    chosen = next((line for line in lines if line.startswith("chosen: ")), "")
    print(f"[cli] repro_torch.launch.eigen --device cuda --d {D} --r {R} --n-per-shard "
          f"{N_PSUM} --plan auto --explain ({time.monotonic() - t0:.1f} s): {chosen}; "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("backend", "topology", "polar", "orth", "plan_source",
                       "dist_aligned", "dist_central", "dist_naive", "wall_s")))
    require(chosen.startswith(f"chosen: {stats['backend']}/{stats['topology']}/"
                              f"{stats['polar']}/{stats['orth']} ")
            and stats["plan_source"] == "planner" and stats["backend"] == "cuda"
            and float(stats["dist_aligned"]) < min(DIST_BAR, float(stats["dist_naive"])),
            "launcher --plan auto: table, plan or estimate wrong")

    # The launcher under torchrun, four times, WORLD ranks on this card
    # each: the fused ring, the hier topology, the elastic runtime and the
    # streaming lane, at (CLI_D, CLI_R) with N_PSUM samples per shard.  The
    # four run side by side (each is mostly start-up: its wall_s is ~12 s
    # of ~45) and are checked in turn.  The width flags take their long
    # spellings: some torchrun versions read "--d" and "--r" as prefixes of
    # their own options.
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.eigen",
                "--device", "cuda"]
    width = ["--dim", str(CLI_D), "--subspace-rank", str(CLI_R), "--n-per-shard", str(N_PSUM)]
    launchers = {
        "ring": ["--topology", "ring", "--polar", "newton-schulz", "--orth", "cholesky-qr2"],
        "hier": ["--topology", "hier", "--pods", str(PODS), "--polar", "newton-schulz"],
        "fail-at": ["--plan", "auto", "--fail-at", f"{ELASTIC_DEAD}:{ELASTIC_ROUND}"],
        "stream": ["--plan", "auto", "--stream", str(RANK_STREAM_STEPS), "--cadence",
                   str(RANK_STREAM_CADENCE), "--fail-at", f"{STREAM_DEAD}:{RANK_STREAM_DEAD_AT}"]}
    launcher = side_by_side({k: torchrun + v + width for k, v in launchers.items()},
                            {**os.environ, "PYTHONPATH": SRC})
    cli, took = launcher("ring")
    require(cli.returncode == 0, f"torchrun launcher failed:\n{cli.stderr[-4000:]}")
    stats = dict(line.split(": ", 1) for line in cli.stdout.strip().splitlines()
                 if ": " in line)
    print(f"[cli] torchrun --nproc-per-node {WORLD} repro_torch.launch.eigen "
          f"--topology ring --polar newton-schulz --orth cholesky-qr2 --dim {CLI_D} "
          f"--subspace-rank {CLI_R} --n-per-shard {N_PSUM} ({took:.1f} s, the four side "
          f"by side): "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("ranks", "d", "r", "backend", "topology", "transport",
                       "staged_bytes", "dist_aligned", "dist_central",
                       "dist_naive", "wall_s")))
    require(stats["backend"] == "cuda" and stats["topology"] == "ring"
            and stats["ranks"] == str(WORLD)
            and (stats["d"], stats["r"]) == (str(CLI_D), str(CLI_R)),
            "torchrun launcher: wrong lane or width")
    require(float(stats["dist_aligned"]) < min(DIST_BAR, float(stats["dist_naive"])),
            "torchrun launcher: estimate not within the bar or no better than naive")

    # The hier topology, PODS pods.
    cli, took = launcher("hier")
    require(cli.returncode == 0, f"torchrun hier launcher failed:\n{cli.stderr[-4000:]}")
    stats = dict(line.split(": ", 1) for line in cli.stdout.strip().splitlines()
                 if ": " in line)
    print(f"[cli] torchrun --nproc-per-node {WORLD} repro_torch.launch.eigen "
          f"--topology hier --pods {PODS} --polar newton-schulz --dim {CLI_D} "
          f"--subspace-rank {CLI_R} --n-per-shard {N_PSUM} ({took:.1f} s): "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("ranks", "pods", "d", "r", "backend", "topology", "transport",
                       "staged_bytes", "dist_aligned", "dist_central",
                       "dist_naive", "wall_s")))
    require(stats["backend"] == "cuda" and stats["topology"] == "hier"
            and stats["pods"] == str(PODS) and stats["ranks"] == str(WORLD)
            and (stats["d"], stats["r"]) == (str(CLI_D), str(CLI_R)),
            "torchrun hier launcher: wrong lane or width")
    require(float(stats["dist_aligned"]) < min(DIST_BAR, float(stats["dist_naive"])),
            "torchrun hier launcher: estimate not within the bar or no better than naive")

    # The elastic runtime, shard ELASTIC_DEAD killed before round
    # ELASTIC_ROUND, the planner choosing the cell.
    cli, took = launcher("fail-at")
    require(cli.returncode == 0, f"torchrun --fail-at launcher failed:\n{cli.stderr[-4000:]}")
    stats = dict(line.split(": ", 1) for line in cli.stdout.strip().splitlines()
                 if ": " in line)
    print(f"[cli] torchrun --nproc-per-node {WORLD} repro_torch.launch.eigen --plan auto "
          f"--fail-at {ELASTIC_DEAD}:{ELASTIC_ROUND} --dim {CLI_D} --subspace-rank {CLI_R} "
          f"--n-per-shard {N_PSUM} ({took:.1f} s): "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("ranks", "backend", "topology", "polar", "orth", "plan_source",
                       "replans", "final_m_active", "events", "dist_aligned",
                       "dist_central", "dist_naive", "wall_s")))
    require(stats["ranks"] == str(WORLD) and stats["replans"] == "1"
            and stats["final_m_active"] == str(WORLD - 1)
            and f"failure (m'={WORLD - 1}, dead=[{ELASTIC_DEAD}]" in stats["events"],
            "torchrun --fail-at launcher: wrong events")
    require(float(stats["dist_aligned"]) < min(DIST_BAR, float(stats["dist_naive"])),
            "torchrun --fail-at launcher: estimate not within the bar or no better than naive")

    # The streaming lane of the launcher, each rank streaming its shard,
    # shard STREAM_DEAD dying at step RANK_STREAM_DEAD_AT.
    cli, took = launcher("stream")
    require(cli.returncode == 0, f"torchrun --stream launcher failed:\n{cli.stderr[-4000:]}")
    stats = dict(line.split(": ", 1) for line in cli.stdout.strip().splitlines()
                 if ": " in line)
    print(f"[cli] torchrun --nproc-per-node {WORLD} repro_torch.launch.eigen --plan auto "
          f"--stream {RANK_STREAM_STEPS} --cadence {RANK_STREAM_CADENCE} --fail-at "
          f"{STREAM_DEAD}:{RANK_STREAM_DEAD_AT} --dim {CLI_D} --subspace-rank {CLI_R} "
          f"--n-per-shard {N_PSUM} ({took:.1f} s): "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("ranks", "backend", "topology", "stream_steps", "stream_rows_seen",
                       "stream_refreshes", "stream_staleness", "stream_last_jump",
                       "stream_drift", "replans", "events", "dist_aligned", "dist_central",
                       "wall_s")))
    require(stats["ranks"] == str(WORLD) and stats["backend"] == "cuda"
            and stats["stream_refreshes"] == str(len(stream_refresh_steps(
                RANK_STREAM_STEPS, RANK_STREAM_CADENCE, RANK_STREAM_DEAD_AT)))
            and stats["stream_staleness"] == "0" and stats["replans"] == "1"
            and stats["events"] == "['failure']",
            "torchrun --stream launcher: wrong lane, refreshes or events")
    require(float(stats["dist_aligned"]) < min(DIST_BAR, float(stats["dist_naive"])),
            "torchrun --stream launcher: estimate not within the bar or no better than naive")
    torch.cuda.synchronize()

    # serve --subspace at the main width, in its own process.
    t0 = time.monotonic()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--subspace", "--device", "cuda",
         "--dim", str(D), "--subspace-rank", str(R), "--queries", str(SERVE_QUERIES),
         "--batch", str(SERVE_QBATCH), "--plan", "auto"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": SRC},
    )
    require(cli.returncode == 0, f"serve --subspace failed:\n{cli.stderr[-4000:]}")
    stats = dict(line.split(": ", 1) for line in cli.stdout.strip().splitlines()
                 if ": " in line)
    print(f"[cli] repro_torch.launch.serve --subspace --dim {D} --subspace-rank {R} "
          f"--queries {SERVE_QUERIES} --batch {SERVE_QBATCH} --plan auto "
          f"({time.monotonic() - t0:.1f} s): "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("device", "step", "rows_seen", "refreshes", "staleness", "m_active",
                       "last_jump", "ingest_s", "query_s", "queries_per_s",
                       "projection_shape")))
    require(stats["device"] == name and stats["refreshes"] == "4"
            and stats["projection_shape"] == f"({SERVE_QBATCH}, {R})"
            and "backend='cuda'" in stats["plan"] and float(stats["queries_per_s"]) > 0,
            "serve --subspace: wrong device, refreshes, plan or projection")

    # Spectral initialization (quadratic sensing), stacked over
    # SPECTRAL_M machines, plan "auto": the error falls as n grows.
    from repro_torch.optim import distributed_spectral_init

    x_sharp = torch.linalg.qr(torch.randn(SPECTRAL_D, SPECTRAL_R, generator=gen,
                                          device=dev))[0]
    errs, sp_counts = [], {}
    for scale in SPECTRAL_SCALES:
        n = scale * SPECTRAL_R * SPECTRAL_D
        a, y = syn.quadratic_sensing_measurements(x_sharp, SPECTRAL_M * n, generator=gen)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x0 = distributed_spectral_init(a, y, SPECTRAL_R, shards=SPECTRAL_M, device=dev,
                                       n_iter=SPECTRAL_ITER, plan="auto")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        for k in KERNELS:
            launches[k] += counts[k]
            sp_counts[k] = sp_counts.get(k, 0) + counts[k]
        err = torch.linalg.matrix_norm(x0 - x_sharp @ (x_sharp.T @ x0), ord=2).item()
        errs.append(err)
        require(bool(torch.isfinite(x0).all()) and tuple(x0.shape) == (SPECTRAL_D, SPECTRAL_R),
                "spectral init: non-finite or misshapen estimate")
        print(f"[spectral] quadratic sensing m={SPECTRAL_M} d={SPECTRAL_D} r={SPECTRAL_R} "
              f"n = {scale} r d = {n} a machine ({SPECTRAL_M * n * SPECTRAL_D * 4 / 1e9:.2f} "
              f"GB of designs), n_iter {SPECTRAL_ITER}, plan auto: wall {wall:.3f} s, "
              f"launches { {k: c for k, c in counts.items() if c} }, "
              f"||(I - X X^T) X0||_2 {err:.4f}")
        del a, y, x0
    require(errs[-1] < errs[0], f"spectral init: the error did not fall with n: {errs}")
    torch.cuda.synchronize()

    # -- the serving lane (B8): the PCA data is gone, free its cache --------
    torch.cuda.empty_cache()
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def qkv(shape, dtype):
        b, hq, hkv, s_, t_, hd = shape
        return tuple(torch.randn(*sh, generator=gen, device=dev).to(dtypes[dtype])
                     for sh in ((b, hq, s_, hd), (b, hkv, t_, hd), (b, hkv, t_, hd)))

    row_ratio = {}
    causal_checks = [(label, shape, dtype, window, True)
                     for label, shape, dtype, window in FLASH_CHECKS]
    bidir_checks = [(f"bidirectional {label}", shape, dtype, None, False)
                    for label, shape, dtype in FLASH_BIDIR_CHECKS]
    for label, shape, dtype, window, causal in causal_checks + bidir_checks:
        q, k, v = qkv(shape, dtype)
        got = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        label = f"{label} [{flash_attention.last_form}]"
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        got, want = got.float(), want.float()
        require(bool(torch.isfinite(got).all()), f"flash_attention {label}: not finite")
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
        if causal and s_ > t_:
            require(bool((got[:, :, : s_ - t_] == 0).all()),
                    f"flash_attention {label}: rows without keys are not zero")
        del q, k, v, got, want
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model, prompts, _ = load(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
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
    unsharded = {"toks": toks, "logits": lk, "prefill_s": st["prefill_s"],
                 "decode_ms": st["decode_s"] / SERVE_GEN * 1e3, "peak_gb": peak_gb}
    del model, lp, prompts
    torch.cuda.empty_cache()

    # The serve launcher, once in its own process, at the full config: this
    # arch's, the hybrid's and whisper's side by side here (each mostly
    # start-up), the last two checked after their own lanes.
    serve_cli = side_by_side(
        {SERVE_ARCH: serve_cmd(SERVE_ARCH), RECURRENT_ARCHS[0][0]: serve_cmd(RECURRENT_ARCHS[0][0]),
         WHISPER_ARCH: serve_cmd(WHISPER_ARCH, SERVE_BATCH, WHISPER_CLI_PROMPT)},
        {**os.environ, "PYTHONPATH": SRC})
    cli, took = serve_cli(SERVE_ARCH)
    require(cli.returncode == 0, f"serve launcher failed:\n{cli.stderr[-4000:]}")
    lines = cli.stdout.strip().splitlines()
    stats = dict(line.split(": ", 1) for line in lines[2:])
    print(f"[cli] repro_torch.launch.serve --arch {SERVE_ARCH} --full-config --batch 2 "
          f"--prompt-len 256 --gen 8 ({took:.1f} s, with the hybrid's and whisper's side by "
          f"side): {lines[0]}; "
          + ", ".join(f"{k}={stats[k]}" for k in
                      ("config", "prefill_tokens_per_s", "decode_tokens_per_s",
                       "flash_launches_prefill", "flash_launches_decode")))
    require(lines[0] == "generated token matrix: (2, 8)"
            and stats["attention_blocks"] == str(layers)
            and stats["flash_launches_prefill"] == str(layers)
            and stats["flash_launches_decode"] == "0",
            "serve launcher: wrong token matrix or flash launches")
    torch.cuda.synchronize()

    # The sharded lanes ([sharded], [sharded-ranks]).  Then the dry run
    # starts: it counts on fake tensors, CPU work alone, in its own process
    # beside the card's next phases, and is joined at [dryrun].
    t_new = time.perf_counter()
    sharded_lanes(torch, dev, launches, unsharded)
    del unsharded, lk
    torch.cuda.empty_cache()
    new_s = time.perf_counter() - t_new
    dry_dir = tempfile.mkdtemp()
    dry_out = os.path.join(dry_dir, "dryrun.json")
    dry_proc = start_dryrun(dry_out)

    # The recurrent serving lane (recurrentgemma-2b, mamba2-370m).
    t0 = time.perf_counter()
    b8_served = recurrent_lanes(torch, dev, launches, serve_cli)
    torch.cuda.synchronize()
    print(f"[recur] both archs and the launcher in {time.perf_counter() - t0:.1f} s")

    # The MoE serving lane (qwen3-moe-30b-a3b).
    t0 = time.perf_counter()
    b8_moe = moe_lane(torch, dev, launches)
    torch.cuda.synchronize()
    print(f"[moe] the lane and the launcher in {time.perf_counter() - t0:.1f} s")

    # The VLM and encoder-decoder serving lanes (internvl2-2b, whisper-tiny).
    t0 = time.perf_counter()
    b8_vw = vlm_whisper_lanes(torch, dev, launches, serve_cli)
    torch.cuda.synchronize()
    print(f"[whisper] the VLM and whisper serving lanes and the launcher in "
          f"{time.perf_counter() - t0:.1f} s")

    # The training lanes (T1-T4).  The card still holds the earlier phases'
    # tensors that phase 4 times (a few GB); each lane's peak leaves them out.
    train_lanes(torch, dev, launches)
    torch.cuda.synchronize()
    # Training the recurrent families (R1, R1c, R2).
    t0 = time.perf_counter()
    recurrent_train_lanes(torch, dev, launches)
    torch.cuda.synchronize()
    print(f"[train-recur] R1, R1c and R2 in {time.perf_counter() - t0:.1f} s")
    # Training the VLM and encoder-decoder families (V1, V1c, V2).
    t0 = time.perf_counter()
    vlm_whisper_train_lanes(torch, dev, launches)
    torch.cuda.synchronize()
    print(f"[train-whisper] V1, V1c and V2 of both families in "
          f"{time.perf_counter() - t0:.1f} s")
    # Training the MoE family (M1, M1c, M2).
    t0 = time.perf_counter()
    moe_train_lanes(torch, dev, launches)
    torch.cuda.synchronize()
    print(f"[train-moe] M1, M1c and M2 in {time.perf_counter() - t0:.1f} s")
    # [dryrun]: the dry run started after the sharded lanes.
    t0 = time.perf_counter()
    dryrun_phase(dry_proc, dry_out)
    new_s += time.perf_counter() - t0
    print(f"[sharded] new phases in {new_s:.1f} s (the sharded lanes, and the wait for the "
          f"dry run's process, started after them)")

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
        if k == "batched_gram_polar":
            rows[-1]["newton_schulz_form"] = b3_form["main (8, 8192, 128)"]
        if k == "fused_ring_round":
            rows[-1]["by_wire"] = {
                wname: {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2][0],
                        "bound_by": t[2][1]} for wname, t in ring_ms.items()}
    by_name = {row["name"]: row for row in rows}
    # B1 at the streaming ingest's chunk shape (STREAM_CHUNK, D): what each
    # live shard launches every step of the stream lanes.
    xc = x[:STREAM_CHUNK]
    c_ms, c_plain, c_lib = (time_ms(lambda: gram(xc), 20), time_ms(lambda: ref.gram(xc), 20),
                            time_ms(lambda: xc.T @ xc, 20))
    c_bound, c_by = bound(1.0 * STREAM_CHUNK * D * (D + 1), 4 * (STREAM_CHUNK * D + D * D))
    print(f"[time] gram ingest chunk ({STREAM_CHUNK}, {D}) f32 kernel_ms {c_ms:.4f} "
          f"bound_ms {c_bound:.4f} ({c_by}) plain_ms {c_plain:.4f} library_ms {c_lib:.4f} "
          f"(x.T @ x); {STREAM_CHUNK * D * (D + 1) / (c_ms * 1e9):.2f} TFLOP/s")
    by_name["gram"]["ingest_chunk"] = {
        "shape": [STREAM_CHUNK, D], "ms": c_ms, "plain_ms": c_plain, "library_ms": c_lib,
        "bound_ms": c_bound, "bound_by": c_by}
    by_name["gram"]["stream_lane_walls_s"] = stream_walls
    # A refresh's local solve on one shard's (D, D) covariance: the
    # subspace iteration the stream lanes run (ITERS steps) and the exact
    # eigh, the service's default solver, which serve --subspace keeps.
    cov = gram(xc) / STREAM_CHUNK
    solve_ms = {method: time_ms(lambda: local_eigenbasis(cov, R, method=method, iters=ITERS), 2)
                for method in ("subspace", "eigh")}
    print(f"[time] local solve of one ({D}, {D}) covariance, r={R}: subspace iteration "
          f"({ITERS} steps) {solve_ms['subspace']:.2f} ms, eigh {solve_ms['eigh']:.2f} ms")
    by_name["gram"]["local_solve_ms"] = solve_ms
    del xc, cov
    # B3, B5 and B6 (each wire) past r = 136: the grouped Newton-Schulz
    # form streaming its iterate from L2, B5/B6's factor on the whole grid.
    for r_w in WIDE_RS:
        vs_w = wide_stacks[r_w]
        rf_w = vs_w[0].contiguous()
        wide_bytes = 4 * (SHARDS * D * r_w + 2 * D * r_w)
        wide_flops = {
            "batched_gram_polar": 2.0 * SHARDS * D * r_w * r_w
            + DEFAULT_NS_ITERS * SHARDS * 4.0 * r_w ** 3,
            "fused_round": 4.0 * SHARDS * D * r_w * r_w + 8.0 * D * r_w * r_w
            + DEFAULT_NS_ITERS * SHARDS * 4.0 * r_w ** 3,
        }
        cases = [("batched_gram_polar", None, lambda: batched_gram_polar(vs_w, rf_w),
                  lambda: ref.batched_gram_polar(vs_w, rf_w), wide_bytes),
                 ("fused_round", None, lambda: fused_round(vs_w, rf_w),
                  lambda: ref.fused_round(vs_w, rf_w), wide_bytes)]
        for wname, (w, sc) in wide_wires[r_w].items():
            cases.append((
                "fused_ring_round", wname,
                lambda w=w, sc=sc: fused_ring_round(w, rf_w, sc),
                lambda w=w, sc=sc: ref.fused_ring_round(w, rf_w, sc),
                w.numel() * w.element_size() + 4 * 2 * D * r_w
                + (0 if sc is None else sc.numel() * 4)))
        for k, wname, kern, plain, nbytes in cases:
            w_ms, w_plain = time_ms(kern, 5), time_ms(plain, 5)
            w_bound, w_by = bound(wide_flops["fused_round" if wname else k], nbytes)
            if k == "batched_gram_polar":
                form = b3_form[r_w]
            else:
                wrapper = fused_round if k == "fused_round" else fused_ring_round
                form = f"{wrapper.last_form}; factor {wrapper.last_factor}"
            print(f"[time] {k:<18} wide r={r_w}{'' if wname is None else f' {wname}'} "
                  f"({form}) kernel_ms {w_ms:.4f} bound_ms {w_bound:.4f} ({w_by}) "
                  f"plain_ms {w_plain:.4f}")
            cell = {"ms": w_ms, "plain_ms": w_plain, "bound_ms": w_bound, "bound_by": w_by}
            label = f"wide ({SHARDS}, {D}, {r_w})"
            if k == "batched_gram_polar":
                cell["newton_schulz_form"] = form
            else:
                cell.update(newton_schulz_form=form.split("; factor ")[0],
                            factor_form=form.split("; factor ")[1],
                            max_abs_err=results[k]["errs"][
                                label if wname is None else f"{label} {wname}"][0])
            if wname is None:
                by_name[k].setdefault("wide_r", {})[r_w] = cell
            else:
                by_name[k].setdefault("wide_r", {}).setdefault(r_w, {})[wname] = cell
        by_name["fused_round"]["wide_r"][r_w]["rank_deficient_max_abs_err"] = results[
            "fused_round"]["errs"][f"wide ({SHARDS}, {D}, {r_w}) rank-deficient"][0]
    # B8 at recurrentgemma-2b's local attention shape (head_dim 256).
    (b, hq, hkv, s_, t_, hd), wdt, win = FLASH_WIDE
    q, k_, v_ = qkv(FLASH_WIDE[0], wdt)
    visible = sum(min(t_ - s_ + i + 1, win) for i in range(s_))
    w_flops = 4.0 * b * hq * hd * visible
    w_bound = 1e3 * max(w_flops / peak_bf16, 2 * (2 * b * hq * s_ * hd + 2 * b * hkv * t_ * hd)
                        / peak_bw)
    qpos = torch.arange(s_, device=dev)[:, None] + (t_ - s_)
    kpos = torch.arange(t_, device=dev)[None, :]
    mask = (kpos <= qpos) & (qpos - kpos < win)
    w_ms = time_ms(lambda: flash_attention(q, k_, v_, window=win), 10)
    w_form = flash_attention.last_form
    w_plain = time_ms(lambda: ref.flash_attention(q, k_, v_, window=win), 3)
    w_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_, v_, attn_mask=mask, enable_gqa=True), 5)
    print(f"[time] flash_attention wide {FLASH_WIDE} [{w_form}] kernel_ms "
          f"{w_ms:.4f} bound_ms {w_bound:.4f} (operations, bf16 peak; {w_flops / 1e9:.1f} "
          f"GFLOP) plain_ms {w_plain:.4f} library_ms {w_lib:.4f} (SDPA, boolean window "
          f"mask); {w_flops / (w_ms * 1e9):.2f} TFLOP/s, {w_ms / w_lib:.3f}x SDPA's time, "
          f"{100 * w_bound / w_ms:.1f} % of the bound")
    by_name["flash_attention"]["wide_hd256"] = {
        "shape": list(FLASH_WIDE[0]), "window": win, "ms": w_ms, "plain_ms": w_plain,
        "bound_ms": w_bound, "library_ms": w_lib, "form": w_form, "served": b8_served}
    del q, k_, v_, mask
    # B8 at qwen3-moe-30b-a3b's prefill shape (head_dim 64).
    b, hq, hkv, s_, t_, hd = FLASH_MOE
    q, k_, v_ = qkv(FLASH_MOE, "bfloat16")
    m_flops = 4.0 * b * hq * hd * (s_ * (s_ + 1) // 2)
    m_bytes = 2 * (2 * b * hq * s_ * hd + 2 * b * hkv * t_ * hd)
    m_bound = 1e3 * max(m_flops / peak_bf16, m_bytes / peak_bw)
    m_by = "operations" if m_flops / peak_bf16 >= m_bytes / peak_bw else "bytes"
    m_ms = time_ms(lambda: flash_attention(q, k_, v_), 10)
    m_form = flash_attention.last_form
    m_plain = time_ms(lambda: ref.flash_attention(q, k_, v_), 3)
    m_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_, v_, is_causal=True, enable_gqa=True), 10)
    print(f"[time] flash_attention qwen3 {FLASH_MOE} bf16 causal [{m_form}] kernel_ms "
          f"{m_ms:.4f} bound_ms {m_bound:.4f} ({m_by}, bf16 peak; {m_flops / 1e9:.1f} GFLOP, "
          f"{m_bytes / 1e6:.1f} MB) plain_ms {m_plain:.4f} library_ms {m_lib:.4f} (SDPA "
          f"is_causal, enable_gqa); {m_flops / (m_ms * 1e9):.2f} TFLOP/s")
    by_name["flash_attention"]["qwen3_hd64"] = {
        "shape": list(FLASH_MOE), "ms": m_ms, "plain_ms": m_plain, "bound_ms": m_bound,
        "bound_by": m_by, "library_ms": m_lib, "form": m_form, "served": b8_moe}
    del q, k_, v_
    # B8 at whisper-tiny's encoder shape (bidirectional: every query row sees
    # all t keys) and at internvl2-2b's prefill shape (causal, 256 patches +
    # 4096 tokens), each beside SDPA on the same inputs.
    for key, shape, causal, arch in (("whisper_encoder_bidirectional", WHISPER_FLASH, False,
                                      "whisper"),
                                     ("internvl2_prefill", VLM_FLASH, True, "vlm")):
        b, hq, hkv, s_, t_, hd = shape
        q, k_, v_ = qkv(shape, "bfloat16")
        visible = s_ * t_ if not causal else sum(min(t_, t_ - s_ + i + 1) for i in range(s_))
        x_flops = 4.0 * b * hq * hd * visible
        x_bytes = 2 * (2 * b * hq * s_ * hd + 2 * b * hkv * t_ * hd)
        x_bound = 1e3 * max(x_flops / peak_bf16, x_bytes / peak_bw)
        x_by = "operations" if x_flops / peak_bf16 >= x_bytes / peak_bw else "bytes"
        x_ms = time_ms(lambda: flash_attention(q, k_, v_, causal=causal), 10)
        x_form = flash_attention.last_form
        x_plain = time_ms(lambda: ref.flash_attention(q, k_, v_, causal=causal), 3)
        x_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_, v_, is_causal=causal, enable_gqa=True), 10)
        print(f"[time] flash_attention {key} {shape} bf16 causal={causal} [{x_form}] "
              f"kernel_ms {x_ms:.4f} bound_ms {x_bound:.4f} ({x_by}, bf16 peak; "
              f"{x_flops / 1e9:.1f} GFLOP, {x_bytes / 1e6:.1f} MB) plain_ms {x_plain:.4f} "
              f"library_ms {x_lib:.4f} (SDPA is_causal={causal}, enable_gqa); "
              f"{x_flops / (x_ms * 1e9):.2f} TFLOP/s")
        by_name["flash_attention"][key] = {
            "shape": list(shape), "causal": causal, "ms": x_ms, "plain_ms": x_plain,
            "bound_ms": x_bound, "bound_by": x_by, "library_ms": x_lib, "form": x_form,
            "served": b8_vw[arch]}
        del q, k_, v_
    # B7, timed in the rank world (phase 3's processes): WORLD ranks share
    # the card, so the world's bound is WORLD ranks' work; each rank does
    # B6's operations and writes WORLD - 1 hops of d r f32 to its neighbour.
    rank_bound, _ = bound(round_flops, 4 * (3 + WORLD - 1) * d * r)
    world_bound, b7_by = bound(WORLD * round_flops, WORLD * 4 * (3 + WORLD - 1) * d * r)
    b7_ms = max(t["kernel"][0] for t in b7_time)
    b7_wall = max(t["kernel"][1] for t in b7_time)
    b7_plain = max(t["plain"][0] for t in b7_time)
    slow = max(range(WORLD), key=lambda k: b7_time[k]["kernel"][0])
    print(f"[time] fused_ring_round_remote per round, the wrapper's CUDA events around "
          f"each hop's waits and launch: slowest rank (rank {slow}) waits "
          f"{b7_split[slow][0]:.4f} ms, compute {b7_split[slow][1]:.4f} ms; mean over "
          f"ranks waits {sum(w for w, _ in b7_split) / WORLD:.4f} ms, compute "
          f"{sum(c for _, c in b7_split) / WORLD:.4f} ms; hops' Newton-Schulz {b7_form}")
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
        "world_wall_ms": b7_wall, "newton_schulz_form": b7_form,
        "wait_ms": b7_split[slow][0], "compute_ms": b7_split[slow][1],
        "per_rank": [{"ms": t["kernel"][0], "plain_ms": t["plain"][0], "wait_ms": sp[0],
                      "compute_ms": sp[1]} for t, sp in zip(b7_time, b7_split)],
    })
    # The planner held to the card: the stacked rounds alone on a fixed
    # (SHARDS, D, r) f32 stack, every (backend, polar, orth) cell, N_ITER
    # rounds, CUDA events around single warm calls, median of 5, timed by
    # tools/h100_model.py in a process of its own (the tool the H100
    # model's constants came from; it measures them again here);
    # predicted (the H100 model) beside measured, and the table again
    # calibrated from these timings.
    with tempfile.TemporaryDirectory() as tmp:
        model_json = os.path.join(tmp, "h100_model.json")
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "tools", "h100_model.py"), "--out",
             model_json], capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": SRC})
        require(proc.returncode == 0, f"tools/h100_model.py failed:\n{proc.stderr[-4000:]}")
        with open(model_json) as f:
            card = json.load(f)
    h100 = device_model("h100")
    print(f"[plan4] tools/h100_model.py ({time.monotonic() - t0:.1f} s): launch "
          f"{card['launch_latency_s'] * 1e6:.2f} us (model {h100.launch_latency_s * 1e6:.2f}), "
          f"op {card['op_latency_s'] * 1e6:.2f} us (model {h100.op_latency_s * 1e6:.2f}), "
          f"LAPACK {card['lapack_latency_s'] * 1e3:.3f} ms (model "
          f"{h100.lapack_latency_s * 1e3:.3f}; svd {card['svd_s']}, qr {card['qr_s']} s), "
          f"B5 past r = 136, {N_ITER} rounds: "
          + ", ".join(f"r={r_w} {w['ms']:.4f} ms" for r_w, w in card["wide_round"].items()))
    for r_p in PLAN_RS:
        kw = dict(m=SHARDS, d=D, r=r_p, n_iter=N_ITER, context="stacked")
        cells = score_cells(**kw)
        pick = plan_aggregation(**kw)
        measured = {tuple(k.split("/")): ms for k, ms in card["cells_ms"][str(r_p)].items()}
        fastest = min(measured, key=measured.get)
        got = measured[(pick.backend, pick.polar, pick.orth)]
        for c in cells:
            key = (c.backend, c.polar, c.orth)
            print(f"[plan4] r={r_p} {'/'.join(key):<35} predicted_ms {c.total_s * 1e3:9.4f} "
                  f"measured_ms {measured[key]:9.4f}{' *pick' if key == (pick.backend, pick.polar, pick.orth) else ''}"
                  f"{' fastest' if key == fastest else ''}")
        print(f"[plan4] r={r_p}: pick {pick.backend}/{pick.polar}/{pick.orth} "
              f"{got:.4f} ms, fastest {'/'.join(fastest)} {measured[fastest]:.4f} ms, "
              f"ratio {got / measured[fastest]:.3f} (bar {PLAN_SLACK})")
        require(got <= PLAN_SLACK * measured[fastest],
                f"planner at r={r_p}: pick {pick} {got} ms vs fastest {fastest} "
                f"{measured[fastest]} ms")
        cal = Calibration.from_records("h100", [
            {"topology": "stacked", "mode": "compiled", "wall_us_min": ms * 1e3,
             "m": SHARDS, "d": D, "r": r_p, "n_iter": N_ITER, "polar": p_, "orth": o_}
            for (_, p_, o_), ms in measured.items()], source=f"chip_smoke phase 4, r={r_p}")
        pl_cal, table = explain(calibration=cal, **kw)
        print(f"[plan4] r={r_p} calibrated: dispatch_s {cal.dispatch_s:.6g}, flops_per_s "
              f"{cal.flops_per_s}, {cal.cells} cells -> {pl_cal.backend}/{pl_cal.polar}/"
              f"{pl_cal.orth} (measured {measured[(pl_cal.backend, pl_cal.polar, pl_cal.orth)]:.4f} ms)")
        for line in table.splitlines():
            print(f"[plan4]   {line}")

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

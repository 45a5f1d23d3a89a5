"""Serving entry point of the port (counterpart of
``repro/launch/serve.py``): the LM lane and the streaming subspace
service::

    python -m repro_torch.launch.serve --arch llama3.2-3b --prompt-len 64 --gen 32
    python -m repro_torch.launch.serve --arch llama3.2-3b --full-config \\
        --batch 4 --prompt-len 4096 --gen 32          # full width on one card
    python -m repro_torch.launch.serve --subspace --dim 8192 --subspace-rank 128

LM lane: builds the model from a seeded ``torch.Generator`` (random
weights, as the reference), draws ``batch`` prompts of ``prompt_len``
tokens from the next seed, prefills them in one batch, then decodes
``gen`` greedy tokens for every row in lockstep.  Prefill runs the flash
kernel (B8) in every layer on a Hopper card; decode steps take the plain
grouped product.  Prints the reference's lines (the token matrix's shape
and the timings) and adds tokens per second and the flash launches of
prefill and decode.  One process, one device: the reference's mesh,
parameter shardings and jitted, donated decode step are no-ops there and
have no counterpart here; serving over several cards is later work
(ROADMAP A11).

``--subspace`` serves the streaming eigenspace estimate instead
(``serve_subspace``, ``repro_torch.stream.SubspaceService``): a seeded
spiked-covariance stream in, cadence refreshes, then batched query
projections; prints the service's stats with ``ingest_s``, ``query_s``
and ``queries_per_s``.  One process holds the m shards stacked
(``--shards``); under ``torchrun`` each rank holds one shard (the
collective form).  ``--dim``/``--subspace-rank`` spell ``--d``/``--r``
in a form ``torchrun``'s parser leaves to the script.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import kernels
from repro_torch.configs import ARCHS, get_config, get_reduced_config
from repro_torch.interop import resolve_device, strict_fp32
from repro_torch.launch.mesh import under_torchrun
from repro_torch.models import LM, build

__all__ = ["load", "generate", "serve", "serve_subspace", "main"]


def _flash_launches() -> int:
    return kernels.launch_counts()["flash_attention"]


def load(
    arch: str,
    *,
    batch: int,
    prompt_len: int,
    reduced: bool = True,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> tuple[LM, torch.Tensor]:
    """The served model and its prompts: weights from a generator on
    ``device`` seeded ``seed``, ``batch`` prompts of ``prompt_len`` tokens
    from one seeded ``seed + 1``."""
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    dev = resolve_device(device)
    model = build(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    pgen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), generator=pgen, device=dev
    )
    return model, prompts


def generate(model: LM, prompts: torch.Tensor, *, gen: int) -> tuple[torch.Tensor, dict]:
    """Prefill ``prompts`` (batch, prompt_len) into a cache of
    ``prompt_len + gen`` slots, then ``gen`` greedy decode steps.

    Returns the (batch, gen) token matrix (CPU, int64: the prefill's
    token, then one per decode step but the last) and ``{"prefill_s",
    "decode_s", "flash_launches": {"prefill", "decode"}}``, times on a
    host clock around synchronised work.
    """
    dev = prompts.device
    prompt_len = prompts.shape[1]

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    n0 = _flash_launches()
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, cache_len=prompt_len + gen)
    sync()
    t_prefill = time.perf_counter() - t0
    n1 = _flash_launches()

    out = []
    tok = torch.argmax(logits, dim=-1)[:, None]
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(tok[:, 0])
        logits, cache = model.decode_step(tok, cache, prompt_len + i)
        tok = torch.argmax(logits, dim=-1)[:, None]
    sync()
    t_decode = time.perf_counter() - t0
    tokens = torch.stack(out, dim=1).cpu()
    return tokens, {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "flash_launches": {"prefill": n1 - n0, "decode": _flash_launches() - n1},
    }


def serve(
    arch: str,
    *,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    reduced: bool = True,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> tuple[torch.Tensor, dict]:
    """``load`` the model and prompts, then ``generate``: ``batch`` random
    prompts prefilled, then ``gen`` greedy decode steps."""
    model, prompts = load(arch, batch=batch, prompt_len=prompt_len,
                          reduced=reduced, device=device, seed=seed)
    return generate(model, prompts, gen=gen)


def serve_subspace(
    *,
    d: int = 256,
    r: int = 8,
    steps: int = 16,
    rows_per_step: int = 128,
    cadence: int = 4,
    batch: int = 256,
    queries: int = 4096,
    delta: float = 0.2,
    shards: int = 8,
    device: str | torch.device = "cuda",
    topology: str | None = None,
    comm_bits=None,
    plan=None,
    seed: int = 0,
    agg=None,
):
    """Serve the streaming eigenspace estimate: ingest, refresh, project.

    A seeded (M1) spiked-covariance stream (``repro_torch.data.synthetic``;
    shard k's rows from the generator seeded from (seed, k)) feeds every
    shard ``rows_per_step`` rows a step for ``steps`` steps; the service
    refreshes on the cadence; then ``queries`` query rows are projected
    through the served basis in ``batch``-row waves.  ``agg`` (a
    ``launch.mesh.AggregationGroup``) runs the collective form, this rank
    on shard ``agg.rank``; without it ``shards`` shards are stacked.
    Returns (service, stats): the service's stats plus ``ingest_s``,
    ``query_s`` and ``queries_per_s`` (host clock around synchronised
    work).
    """
    from repro_torch.data import synthetic as syn
    from repro_torch.stream import SubspaceService

    dev = agg.device if agg is not None else resolve_device(device)
    strict_fp32()
    knobs = dict(cadence=cadence, topology=topology, comm_bits=comm_bits, plan=plan,
                 device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    _, _, factor = syn.covariance_from_spectrum(
        syn.spectrum_m1(d, r, delta=delta, device=dev), generator=gen)
    n = steps * rows_per_step
    if agg is None:
        svc = SubspaceService(d, r, shards=shards, **knobs)
        stream = torch.stack([syn.sample_shard(factor, n, seed=seed, shard=k)
                              for k in range(shards)])
    else:
        svc = SubspaceService(d, r, group=agg.local_group if agg.pods else agg.group,
                              pod_group=agg.pod_group, **knobs)
        stream = syn.sample_shard(factor, n, seed=seed, shard=agg.rank)[None]
    qs = syn.sample_gaussian(factor, queries, generator=gen)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    for t in range(steps):
        chunk = stream[:, t * rows_per_step:(t + 1) * rows_per_step]
        svc.observe(chunk if agg is None else chunk[0])
    sync()
    t_ingest = time.perf_counter() - t0
    out = None
    t0 = time.perf_counter()
    for lo in range(0, queries, batch):
        out = svc.project(qs[lo:lo + batch])
    sync()
    t_query = time.perf_counter() - t0
    stats = dict(svc.stats)
    stats.update({
        "ingest_s": t_ingest,
        "query_s": t_query,
        "queries_per_s": queries / max(t_query, 1e-9),
        "projection_shape": tuple(out.shape),
    })
    return svc, stats


def main(argv=None) -> int:
    from repro_torch.plan import PLAN_CHOICES

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--subspace", action="store_true",
                    help="serve the streaming eigenspace estimate "
                         "(repro_torch.stream.SubspaceService) instead of an LM: "
                         "synthetic stream in, cadence refreshes, batched "
                         "query projection throughput out")
    ap.add_argument("--d", "--dim", dest="d", type=int, default=256,
                    help="--subspace: ambient dimension (under torchrun --dim)")
    ap.add_argument("--r", "--subspace-rank", dest="r", type=int, default=8,
                    help="--subspace: subspace rank (under torchrun --subspace-rank)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--rows-per-step", type=int, default=128)
    ap.add_argument("--cadence", type=int, default=4)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--shards", type=int, default=None,
                    help="--subspace: shards stacked in one process (default "
                         "8); under torchrun the world size")
    ap.add_argument("--plan", default="none", choices=PLAN_CHOICES,
                    help="--subspace: auto lets the cost-model planner pick the "
                         "refresh's cell")
    args = ap.parse_args(argv)
    if args.subspace:
        agg = None
        if under_torchrun():
            from repro_torch.launch.mesh import make_aggregation_mesh

            agg = make_aggregation_mesh(device=args.device)
            if args.shards not in (None, agg.world):
                ap.error(f"--shards {args.shards} under torchrun with {agg.world} ranks")
        try:
            _, stats = serve_subspace(
                d=args.d, r=args.r, steps=args.steps,
                rows_per_step=args.rows_per_step, cadence=args.cadence,
                batch=max(args.batch, 64), queries=args.queries,
                shards=args.shards or 8, device=args.device,
                plan="auto" if args.plan == "auto" else None, agg=agg,
            )
        finally:
            if agg is not None:
                import torch.distributed as dist

                dist.destroy_process_group()
        if agg is None or agg.rank == 0:
            dev = agg.device if agg is not None else resolve_device(args.device)
            print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
            for k, v in stats.items():
                print(f"{k}: {v}")
        return 0
    if not args.arch:
        ap.error("--arch is required (or pass --subspace)")
    try:  # an arch of an unported family names its ROADMAP item
        cfg = get_config(args.arch) if args.full_config else get_reduced_config(args.arch)
    except NotImplementedError as err:
        ap.error(str(err))
    dev = resolve_device(args.device)
    strict_fp32()
    toks, stats = serve(
        args.arch, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
        reduced=not args.full_config, device=dev,
    )
    print("generated token matrix:", tuple(toks.shape))
    print({k: stats[k] for k in ("prefill_s", "decode_s")})
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    print(f"config: {cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} vocab={cfg.vocab_size}")
    print(f"prefill_tokens_per_s: {args.batch * args.prompt_len / stats['prefill_s']:.1f}")
    print(f"decode_tokens_per_s: {args.batch * args.gen / max(stats['decode_s'], 1e-9):.1f}")
    print(f"flash_launches_prefill: {stats['flash_launches']['prefill']}")
    print(f"flash_launches_decode: {stats['flash_launches']['decode']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

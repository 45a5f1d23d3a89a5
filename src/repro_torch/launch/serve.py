"""Serving entry point of the port, the LM lane (counterpart of
``repro/launch/serve.py``)::

    python -m repro_torch.launch.serve --arch llama3.2-3b --prompt-len 64 --gen 32
    python -m repro_torch.launch.serve --arch llama3.2-3b --full-config \\
        --batch 4 --prompt-len 4096 --gen 32          # full width on one card

Builds the model from a seeded ``torch.Generator`` (random weights, as
the reference), draws ``batch`` prompts of ``prompt_len`` tokens from the
next seed, prefills them in one batch, then decodes ``gen`` greedy tokens
for every row in lockstep.  Prefill runs the flash kernel (B8) in every
layer on a Hopper card; decode steps take the plain grouped product.
Prints the reference's lines (the token matrix's shape and the timings)
and adds tokens per second and the flash launches of prefill and decode.

One process, one device: the reference's mesh, parameter shardings and
jitted, donated decode step are no-ops there and have no counterpart
here; serving over several cards is later work (ROADMAP A11), and so is
the streaming subspace service (``--subspace``, ROADMAP A9).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import kernels
from repro_torch.configs import ARCHS, get_config, get_reduced_config
from repro_torch.interop import resolve_device, strict_fp32
from repro_torch.models import LM, build

__all__ = ["load", "generate", "serve", "main"]


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--subspace", action="store_true",
                    help="the streaming eigenspace service: not ported yet (ROADMAP A9)")
    args = ap.parse_args(argv)
    if args.subspace:
        ap.error("--subspace (the streaming eigenspace service) is not ported "
                 "to repro_torch yet: ROADMAP A9")
    if not args.arch:
        ap.error("--arch is required")
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

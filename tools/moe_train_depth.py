"""Measure how many of qwen3-moe-30b-a3b's 48 layers train on one card at
full width, the depths ``chip_smoke.py``'s M1 and M2 lanes take.

    PYTHONPATH=src python3 tools/moe_train_depth.py [--m1 4 5 6 7] [--m2 3 4 5]

For each M1 depth: the model built with f32 master weights from a seeded
generator, three AdamW steps of 8 x 512 tokens from the seeded pipeline
(the smoke's T1 traffic), each timed to a synchronise; for each M2
depth: the eigen trainer (``launch.train.train``) stacked on 4 shards,
rank 32, two steps, the first with a refresh.  Prints one line a depth:
``torch.cuda.max_memory_allocated`` (the run's peak, nothing else held),
the step times or the wall, or that the card ran out of memory; then the
card's name and power limit and its total memory.

Needs a CUDA card; TF32 stays off (``interop.strict_fp32``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import subprocess
import time

ARCH, BATCH, SEQ, LR = "qwen3-moe-30b-a3b", 8, 512, 5e-5


def _fresh(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def adamw_depth(torch, dev, layers: int) -> str:
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.schedule import constant

    cfg = dataclasses.replace(get_config(ARCH), num_layers=layers)
    pipe = TokenPipeline(cfg.vocab_size, SEQ, BATCH, seed=0)
    try:
        model = build(cfg, device=dev, param_dtype=torch.float32,
                      generator=torch.Generator(device=dev).manual_seed(0))
        opt = adamw_init(dict(model.named_parameters()))
        step = make_train_step(model, adamw_cfg=AdamWConfig(), schedule=constant(LR))
        times = []
        for s in range(3):
            batch = {k: torch.from_numpy(v).to(dev, torch.long)
                     for k, v in pipe.batch(s).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(opt, batch)["loss"])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return (f"M1 AdamW at {layers} layers: peak {torch.cuda.max_memory_allocated() / 1e9:.2f}"
                f" GB, steps {[round(t, 1) for t in times]} ms, last loss {loss:.4f}")
    except torch.cuda.OutOfMemoryError:
        return f"M1 AdamW at {layers} layers: out of memory"


def eigen_depth(torch, dev, layers: int) -> str:
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(get_config(ARCH), num_layers=layers)
    try:
        t0 = time.perf_counter()
        train(cfg, steps=2, batch=BATCH, seq=SEQ, lr=LR, warmup=2, eigen=True, eigen_rank=32,
              eigen_refresh=4, device=dev, shards=4, seed=0, log_every=10 ** 9)
        torch.cuda.synchronize()
        return (f"M2 eigen at {layers} layers: peak {torch.cuda.max_memory_allocated() / 1e9:.2f}"
                f" GB, wall {time.perf_counter() - t0:.2f} s (a refresh and 2 steps)")
    except torch.cuda.OutOfMemoryError:
        return f"M2 eigen at {layers} layers: out of memory"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m1", type=int, nargs="*", default=[4, 5, 6, 7])
    ap.add_argument("--m2", type=int, nargs="*", default=[3, 4, 5])
    args = ap.parse_args(argv)
    import torch

    from repro_torch.interop import strict_fp32

    if not torch.cuda.is_available():
        raise SystemExit("moe_train_depth: needs a CUDA card")
    strict_fp32()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[depth] {smi}, total memory "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB", flush=True)
    for layers in args.m1:
        _fresh(torch)
        print(f"[depth] {adamw_depth(torch, dev, layers)}", flush=True)
    for layers in args.m2:
        _fresh(torch)
        print(f"[depth] {eigen_depth(torch, dev, layers)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

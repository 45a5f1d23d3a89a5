"""End-to-end example: train a ~100M-parameter LM for a few hundred steps
with the production stack of the port: f32 master weights, AdamW,
async checkpointing, crash recovery, the straggler monitor and
(optionally) the paper's eigen-compressed data-parallel gradients (port
of ``examples/train_lm.py``).

Run (full, ~100M params, a few hundred steps; on the card by default):
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300

Quick validation (~10M params):
  PYTHONPATH=src python -m repro_torch.examples.train_lm --small --steps 60 --device cpu

With the paper's gradient compression over 4 stacked data shards:
  PYTHONPATH=src python -m repro_torch.examples.train_lm --small --steps 60 --eigen --shards 4

The example trains its own two dense configs and takes no arch id.  A
registered arch of the dense, MoE, hybrid, SSM or VLM family trains
through the launcher: ``python -m repro_torch.launch.train --arch
mamba2-370m`` or ``--arch qwen3-moe-30b-a3b``.
"""

import argparse
import logging
import os
import tempfile

import numpy as np

from repro_torch.launch.train import train
from repro_torch.models import param_count
from repro_torch.models.config import ModelConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true", help="~10M params (quick)")
    ap.add_argument("--eigen", action="store_true")
    ap.add_argument("--shards", type=int, default=1,
                    help="data-parallel shards stacked in this process")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    if args.small:
        cfg = ModelConfig(
            name="lm-small", family="dense", num_layers=4, d_model=256,
            num_heads=8, num_kv_heads=4, d_ff=1024, vocab_size=8192,
            remat="none", fsdp=False,
        )
        batch, seq = 8, 128
    else:
        # ~100M-parameter llama-style model.
        cfg = ModelConfig(
            name="lm-100m", family="dense", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
            remat="none", fsdp=False,
        )
        batch, seq = 16, 256
    print(f"model: {cfg.name}, {param_count(cfg)/1e6:.1f}M params")
    print(f"device: {args.device}, shards: {args.shards}")
    _, _, losses = train(
        cfg,
        steps=args.steps,
        batch=batch,
        seq=seq,
        lr=3e-4,
        warmup=max(args.steps // 10, 10),
        eigen=args.eigen,
        eigen_rank=64,
        eigen_refresh=50,
        checkpoint_dir=args.ckpt,
        checkpoint_every=100,
        log_every=10,
        device=args.device,
        shards=args.shards,
    )
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps")
    if losses[-1] >= losses[0]:
        raise SystemExit("training did not reduce the loss")
    first10 = float(np.mean(losses[:10]))
    last10 = float(np.mean(losses[-10:]))
    print(f"mean(first 10)={first10:.4f}  mean(last 10)={last10:.4f}")


if __name__ == "__main__":
    main()

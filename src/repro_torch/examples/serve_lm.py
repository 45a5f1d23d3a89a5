"""Batched serving demo: prefill + greedy decode with a cache written in
place, for the port's dense, hybrid and SSM architectures (reduced
config; port of ``examples/serve_lm.py``).  On the card the prefill runs
the flash kernel (B8) in every attention block.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch llama3.2-3b [--device cpu]
"""

import argparse
import logging

from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    toks, stats = serve(
        args.arch,
        batch=args.batch,
        prompt_len=args.prompt_len,
        gen=args.gen,
        reduced=True,
        device=args.device,
    )
    print(f"arch={args.arch}: generated {tuple(toks.shape)} tokens")
    print(f"prefill {stats['prefill_s']:.3f}s, decode {stats['decode_s']:.3f}s")


if __name__ == "__main__":
    main()

"""Compare the port's kernels of two checkouts bit for bit on the card.

    PYTHONPATH=<checkout>/src python3 tools/compare_builds.py save OUT.pt
    PYTHONPATH=<checkout>/src python3 tools/compare_builds.py diff A.pt B.pt

``save`` runs B1-B8 of the checkout whose ``src`` is on the path (built
into that checkout's own build directory) on inputs drawn from seed 0:
B1 at (4096, 1024) and (257, 205) f32; B2-B7 on stacks (8, 8192, 128),
(3, 205, 5) and (4, 300, 136), all within the shared-memory path
(r <= 136), B4 on random orthogonal factors; B7 in a world of one rank
over gloo; B8 at the serving shape
(4, 24/8, 4096 x 4096, 128) in bf16 and at (1, 4/2, 300 x 300, 128) in
bf16 and f32, causal; and the three stacked main-path lanes of
``chip_smoke.py`` (d = 8192, r = 128, 8 shards of 65536 samples drawn as
it draws them): the local bases and each lane's estimate.  ``diff`` also
prints the f64 subspace distance of each lane's two estimates.  ``diff`` prints for
each output whether the two sets hold the same bits and the largest
difference, and exits 1 if any output differs.  Needs a Hopper card.
"""

from __future__ import annotations

import socket
import sys

import torch


def save(out: str) -> None:
    import torch.distributed as dist

    from repro_torch.kernels import covariance as cov
    from repro_torch.kernels import procrustes_align as pa
    from repro_torch.kernels.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for n, d in ((4096, 1024), (257, 205)):
        res[f"B1 {n}x{d}"] = cov.gram(torch.randn(n, d, generator=g, device=dev))
    ranks = {}
    for m, d, r in ((8, 8192, 128), (3, 205, 5), (4, 300, 136)):
        base = torch.linalg.qr(torch.randn(d, r, generator=g, device=dev))[0]
        noise = 0.01 * torch.randn(m, d, r, generator=g, device=dev)
        vs = torch.linalg.qr(base[None] + noise)[0].contiguous()
        rf = vs[0].contiguous()
        k = f"{m}x{d}x{r}"
        res[k + " B2"] = pa.batched_gram(vs, rf)
        res[k + " B3"] = pa.batched_gram_polar(vs, rf)
        # B4 on factors of its own, so that its bits do not follow B3's.
        zs = torch.linalg.qr(torch.randn(m, r, r, generator=g, device=dev))[0].contiguous()
        res[k + " B4"] = pa.align_average(vs, zs)
        res[k + " B5"] = pa.fused_round(vs, rf, n_iter=2)
        res[k + " B6 f32"] = pa.fused_ring_round(vs, rf, ring_chunk=33)
        res[k + " B6 bf16"] = pa.fused_ring_round(vs.to(torch.bfloat16), rf, ring_chunk=33)
        ranks[k + " B7 one rank"] = (vs[1].contiguous(), rf)
    for b, hq, hkv, s_, hd, dtype in ((4, 24, 8, 4096, 128, torch.bfloat16),
                                      (1, 4, 2, 300, 128, torch.bfloat16),
                                      (1, 4, 2, 300, 128, torch.float32)):
        q, k_, v_ = (torch.randn(b, h, s_, hd, generator=g, device=dev).to(dtype)
                     for h in (hq, hkv, hkv))
        res[f"B8 {b}x{hq}/{hkv}x{s_}x{hd} {dtype}"] = flash_attention(q, k_, v_)
        del q, k_, v_
    res.update(stacked_lanes(dev))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        for k, (v, rf) in ranks.items():
            res[k] = pa.fused_ring_round_remote(v, rf, group=None)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    torch.save({k: t.cpu() for k, t in res.items()}, out)
    print(f"saved {len(res)} outputs to {out}")


def stacked_lanes(dev) -> dict:
    """chip_smoke.py's stacked lanes at the paper-pca width: the local
    bases and the estimate of each (polar, orth) lane, backend cuda."""
    from repro_torch.core.distributed import _local_basis
    from repro_torch.core.eigenspace import refinement_rounds
    from repro_torch.data import synthetic as syn
    from repro_torch.interop import strict_fp32

    strict_fp32()
    d, r, n, shards = 8192, 128, 65536, 8
    gen = torch.Generator(device=dev).manual_seed(0)
    tau = syn.spectrum_m1(d, r, delta=0.2, device=dev)
    _, _, factor = syn.covariance_from_spectrum(tau, generator=gen)
    xs = syn.sample_shards(factor, n, seed=0, shards=shards).reshape(shards, n, d)
    vs = torch.stack([_local_basis(x, r, backend="cuda", solver="subspace", iters=30)
                      for x in xs])
    del xs
    res = {"lanes: local bases": vs}
    for polar, orth in (("svd", "qr"), ("newton-schulz", "qr"),
                        ("newton-schulz", "cholesky-qr2")):
        res[f"lane {polar}/{orth}"] = refinement_rounds(
            vs, n_iter=2, backend="cuda", polar=polar, orth=orth)
    return res


def diff(a_path: str, b_path: str) -> int:
    from repro_torch.core.metrics import subspace_dist64

    a, b = torch.load(a_path), torch.load(b_path)
    if a.keys() != b.keys():
        print(f"the two sets hold different outputs: {sorted(a.keys() ^ b.keys())}")
        return 1
    differ = 0
    for k in a:
        same = torch.equal(a[k], b[k])
        differ += not same
        sd = (f"  subspace_dist64 {subspace_dist64(a[k], b[k]):.3e}"
              if k.startswith("lane ") else "")
        print(f"[compare] {k:<24} same bits {same}  "
              f"max|diff| {(a[k] - b[k]).abs().max().item():.3e}{sd}")
    return int(differ > 0)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "save":
        save(argv[1])
        return 0
    if len(argv) == 3 and argv[0] == "diff":
        return diff(argv[1], argv[2])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

"""Synthetic covariance models of the paper's Section 3 (port of the
Gaussian part of ``repro/data/synthetic.py``).

(M1)/(M2) spectra, Haar-rotated covariances (eq. (34)) and Gaussian
samples.  Randomness comes from an explicit ``torch.Generator`` on the
output's device; torch and ``jax.random`` give different numbers from one
seed, so cross-package tests make their inputs in numpy instead.

Data rule of the two forms of distributed PCA (``sample_shard``): shard
k's rows come from their own generator, seeded from (seed, k), so a
one-process run over the stacked shards and a run with one shard per
rank estimate from the same data.  As in
the reference, (M2)'s first trailing eigenvalue is ``1 - delta``, so the
eigengap is exactly ``delta``.
"""

from __future__ import annotations

import torch

from repro_torch.interop import resolve_device

__all__ = [
    "random_orthogonal",
    "spectrum_m1",
    "spectrum_m2",
    "covariance_from_spectrum",
    "sample_gaussian",
    "sample_shard",
    "sample_shards",
]

# Rows drawn per matmul in ``sample_gaussian``: bounds the Gaussian
# scratch to one block instead of a second (n, d) array.
_SAMPLE_BLOCK = 65536


def random_orthogonal(
    d: int,
    *,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Haar random orthogonal (d, d) matrix via QR of a Gaussian, with the
    sign fix of Mezzadri 2007."""
    dev = resolve_device(device)
    g = torch.randn((d, d), generator=generator, dtype=dtype, device=dev)
    q, r = torch.linalg.qr(g)
    return q * torch.sign(torch.diagonal(r))[None, :]


def spectrum_m1(
    d: int,
    r: int,
    *,
    lam_l: float = 0.5,
    lam_h: float = 1.0,
    delta: float = 0.2,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """(M1): r principal eigenvalues linearly spaced in [lam_l, lam_h];
    trailing (lam_l - delta) * 0.9**(i - r - 1).  Gap == delta."""
    dev = resolve_device(device)
    if r > 1:
        head = lam_h - (lam_h - lam_l) * torch.arange(r, device=dev) / (r - 1)
    else:
        head = torch.tensor([lam_h], device=dev)
    tail = (lam_l - delta) * 0.9 ** torch.arange(d - r, device=dev)
    return torch.cat([head, tail]).to(torch.float32)


def spectrum_m2(
    d: int,
    r: int,
    r_star: float,
    *,
    delta: float = 0.25,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """(M2): principal eigenvalues 1; trailing decay alpha solving
    (1 - delta) / (1 - alpha) = r_star - r (intdim ~= r_star)."""
    if not r_star > r + (1.0 - delta):
        raise ValueError(f"need r_star > r + 1 - delta, got r_star={r_star}, r={r}")
    dev = resolve_device(device)
    alpha = 1.0 - (1.0 - delta) / (r_star - r)
    head = torch.ones((r,), device=dev)
    tail = (1.0 - delta) * alpha ** torch.arange(d - r, device=dev)
    return torch.cat([head, tail]).to(torch.float32)


def covariance_from_spectrum(
    tau: torch.Tensor, *, generator: torch.Generator | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sigma = U diag(tau) U^T with Haar U (eq. (34)), on ``tau``'s device.
    Returns (sigma, u, factor): the caller slices u's leading columns for
    the ground truth; ``factor = U diag(sqrt(tau))`` samples x = factor z."""
    u = random_orthogonal(
        tau.shape[0], generator=generator, device=tau.device, dtype=tau.dtype
    )
    sigma = (u * tau[None, :]) @ u.T
    factor = u * torch.sqrt(tau)[None, :]
    return sigma, u, factor


def sample_gaussian(
    factor: torch.Tensor, n: int, *, generator: torch.Generator | None = None
) -> torch.Tensor:
    """n samples of x = factor @ z, z ~ N(0, I_d); (n, d) on factor's
    device.  Drawn in row blocks written in place into the output."""
    d = factor.shape[1]
    out = torch.empty((n, d), dtype=factor.dtype, device=factor.device)
    for lo in range(0, n, _SAMPLE_BLOCK):
        hi = min(lo + _SAMPLE_BLOCK, n)
        z = torch.randn(
            (hi - lo, d), generator=generator, dtype=factor.dtype,
            device=factor.device,
        )
        torch.matmul(z, factor.T, out=out[lo:hi])
    return out


def _shard_seed(seed: int, shard: int) -> int:
    return seed * 1_000_003 + shard + 1


def sample_shard(
    factor: torch.Tensor, n: int, *, seed: int, shard: int
) -> torch.Tensor:
    """Shard ``shard``'s n samples (n, d) of x = factor @ z, from the
    generator seeded from (``seed``, ``shard``) on factor's device."""
    gen = torch.Generator(device=factor.device).manual_seed(_shard_seed(seed, shard))
    return sample_gaussian(factor, n, generator=gen)


def sample_shards(
    factor: torch.Tensor, n: int, *, seed: int, shards: int
) -> torch.Tensor:
    """The first ``shards`` shards of ``sample_shard`` stacked by rows:
    (shards * n, d), shard k in rows [k n, (k + 1) n)."""
    d = factor.shape[1]
    out = torch.empty((shards * n, d), dtype=factor.dtype, device=factor.device)
    for k in range(shards):
        out[k * n:(k + 1) * n] = sample_shard(factor, n, seed=seed, shard=k)
    return out

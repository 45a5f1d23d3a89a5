"""Port parity past the widths the first CUDA kernels took, on the CPU.

* r = 200, past the 136 at which the grouped Newton-Schulz form of B3,
  B5, B6 and B7 streams its iterate from L2 on the card and the round
  kernels' CholeskyQR factor runs on the whole grid: the port's plain
  ``batched_gram_polar``, ``fused_round`` and ``fused_ring_round``
  against the reference's Pallas kernels in interpret mode, at <= 1e-5
  f64 subspace distance and <= 1e-4 max abs (the bars of the round
  tests); ``fused_round`` also on a rank-deficient stack (every basis's
  last column zero), where both CholeskyQR passes take the shifted
  factor.
* head_dim 256 (recurrentgemma's local attention, B8's 64-key-tile form
  on the card): the plain flash attention against the reference's kernel
  in interpret mode, GQA, causal with and without a window, s != t both
  ways (right-aligned queries, rows without keys), bidirectional, and
  windows at the 64-key tile's edges, at the f32 bar of the reference's
  own kernel tests (2e-5).

The CUDA kernels at these widths are held against the same plain
versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import procrustes_align as jpa
from repro_torch.core.metrics import subspace_dist64
from repro_torch.interop import from_reference, to_numpy
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import procrustes_align as tpa

M, D, R = 2, 256, 200
SD_TOL, ABS_TOL = 1e-5, 1e-4
FLASH_TOL = 2e-5


def _stack(seed):
    """(M, D, R) noisy orthonormal copies of one subspace, f32."""
    rng = np.random.default_rng(seed)
    base = np.linalg.qr(rng.standard_normal((D, R)))[0]
    vs = np.linalg.qr(base[None] + 0.1 * rng.standard_normal((M, D, R)))[0]
    return vs.astype(np.float32)


def _both(vs):
    return jnp.asarray(vs), from_reference({"vs": vs}, device="cpu")["vs"]


def _hold(got, want):
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(to_numpy(got) - want).max() <= ABS_TOL
    assert subspace_dist64(got, want) <= SD_TOL


def test_batched_gram_polar_past_shared_memory_width():
    jvs, tvs = _both(_stack(0))
    got = tpa.batched_gram_polar(tvs, tvs[0])
    want = np.asarray(jpa.batched_gram_polar(jvs, jvs[0], interpret=True))
    assert got.shape == (M, R, R)
    assert np.abs(to_numpy(got) - want).max() <= ABS_TOL


@pytest.mark.parametrize("kind", ["fused_round", "fused_ring_round"])
def test_fused_rounds_past_shared_memory_width(kind):
    jvs, tvs = _both(_stack(1))
    before = getattr(tpa, kind).launches
    got = getattr(tpa, kind)(tvs, tvs[0])
    assert getattr(tpa, kind).launches == before  # CPU: the plain version
    _hold(got, getattr(jpa, kind)(jvs, jvs[0], interpret=True))


def test_fused_round_takes_the_shift_past_shared_memory_width():
    vs = _stack(3)
    vs[:, :, -1] = 0  # V-bar of rank r - 1: a zero pivot in both passes
    jvs, tvs = _both(vs)
    got = tpa.fused_round(tvs, tvs[0])
    _hold(got, jpa.fused_round(jvs, jvs[0], interpret=True))
    assert got[:, -1].abs().max().item() == 0.0


@pytest.mark.parametrize("window", [None, 16])
def test_flash_head_dim_256_matches_reference_kernel(window):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((1, 2, 64, 256), (1, 1, 64, 256), (1, 1, 64, 256)))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, window=window, bq=64, bk=64,
                               interpret=True)
    t = from_reference({"q": q, "k": k, "v": v}, device="cpu")
    got = tfa.flash_attention(t["q"], t["k"], t["v"], causal=True, window=window)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=FLASH_TOL, rtol=0)


@pytest.mark.parametrize("s,t,causal,window", [
    (48, 100, True, None),    # s < t: right-aligned queries
    (100, 48, True, None),    # s > t: the first rows see no key
    (64, 130, False, None),   # bidirectional, s < t
    (130, 64, False, None),   # bidirectional, s > t
    (130, 130, True, 63),     # windows at the 64-key tile's edges
    (130, 130, True, 64),
    (130, 130, True, 65),
    (70, 129, True, 64),
])
def test_flash_head_dim_256_edges_match_reference_kernel(s, t, causal, window):
    rng = np.random.default_rng(s * t + (window or 0))
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((1, 2, s, 256), (1, 1, t, 256), (1, 1, t, 256)))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window, bq=64, bk=64,
                               interpret=True)
    tt = from_reference({"q": q, "k": k, "v": v}, device="cpu")
    got = tfa.flash_attention(tt["q"], tt["k"], tt["v"], causal=causal, window=window)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=FLASH_TOL, rtol=0)
    if causal and s > t:
        assert bool((got[:, :, : s - t] == 0).all())

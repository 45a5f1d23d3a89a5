"""Port parity of the fused round kernels' plain versions and wrappers
(B5 ``fused_round``, B6 ``fused_ring_round``) on the CPU.

The same numpy-seeded inputs go through the reference's Pallas kernels in
interpret mode (as ``tests/test_fused_round.py`` and
``tests/test_fused_ring.py`` run them) and through the port's wrappers,
which on CPU tensors run the plain versions and launch nothing.  Bar: <= 1e-5
f64 subspace distance (the reference's own cube bar), and orthonormal
output.  The guarded-Cholesky cases are held elementwise at 1e-5: their
outputs are deliberately not orthonormal (the shifted factor).  The CUDA
kernels are held against the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.quantize import get_codec as j_get_codec
from repro.comm.ring import DEFAULT_RING_CHUNK as J_DEFAULT_RING_CHUNK
from repro.comm.ring import chunk_spans as j_chunk_spans
from repro.core import eigenspace as jeig
from repro.kernels import procrustes_align as jpa
from repro.kernels import ref as jref
from repro_torch.comm.ring import DEFAULT_RING_CHUNK, chunk_spans
from repro_torch.core import eigenspace as teig
from repro_torch.core.metrics import subspace_dist64
from repro_torch.interop import from_reference, to_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import procrustes_align as tpa
from repro_torch.kernels import ref as tref

TOL = 1e-5


def _stack(seed, m, d, r):
    """(m, d, r) orthonormal bases from a numpy seed."""
    g = np.random.default_rng(seed).standard_normal((m, d, r))
    return np.linalg.qr(g)[0].astype(np.float32)


def _both(**arrays):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            from_reference(arrays, device="cpu"))


def _hold(got, want, r):
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    assert subspace_dist64(got, np.asarray(want)) <= TOL
    np.testing.assert_allclose(to_numpy(got.T @ got), np.eye(r), atol=1e-5)


# ------------------------------------------------------------ B5 ----------
@pytest.mark.parametrize(
    "m,d,r", [(5, 300, 8), (3, 205, 5), (1, 130, 3), (2, 2100, 5), (4, 64, 1)]
)
def test_fused_round_matches_pallas(m, d, r):
    """Shapes of test_fused_round.py: block-misaligned d, the pad path
    (d > the 2048 block), m == 1 and r == 1."""
    vs = _stack(m * d + r, m, d, r)
    j, t = _both(vs=vs)
    want = jpa.fused_round(j["vs"], j["vs"][0], interpret=True)
    _hold(tpa.fused_round(t["vs"], t["vs"][0]), want, r)
    _hold(tref.fused_round(t["vs"], t["vs"][0]), jref.fused_round(j["vs"], j["vs"][0]), r)


def test_fused_round_multi_round():
    vs = _stack(0, 4, 150, 6)
    j, t = _both(vs=vs)
    want = jpa.fused_round(j["vs"], j["vs"][0], n_iter=3, interpret=True)
    _hold(tops.fused_round(t["vs"], t["vs"][0], n_iter=3, use_kernel=True), want, 6)


@pytest.mark.parametrize("ns_iters", [2, 8, 24])
def test_fused_round_ns_iteration_sweep(ns_iters):
    """ns_iters threads through to the Newton-Schulz stage."""
    vs = _stack(7, 3, 96, 6)
    j, t = _both(vs=vs)
    want = jpa.fused_round(j["vs"], j["vs"][0], ns_iters=ns_iters, interpret=True)
    _hold(tpa.fused_round(t["vs"], t["vs"][0], ns_iters=ns_iters), want, 6)


@pytest.mark.parametrize("m,d,r", [(4, 205, 5), (3, 96, 4), (2, 2100, 5)])
def test_routed_fused_cell_matches_reference_estimator(m, d, r):
    """refinement_rounds(cuda, newton-schulz, cholesky-qr2) - the cell
    routed to fused_round - against the reference's (xla, svd, qr)
    estimator and its (pallas, ...) fused cell in interpret mode."""
    vs = _stack(m * d, m, d, r)
    j, t = _both(vs=vs)
    got = teig.refinement_rounds(t["vs"], backend="cuda", polar="newton-schulz",
                                 orth="cholesky-qr2", n_iter=2)
    base = jeig.refinement_rounds(j["vs"], n_iter=2, backend="xla")
    fused = jeig.refinement_rounds(j["vs"], n_iter=2, backend="pallas",
                                   polar="newton-schulz", orth="cholesky-qr2")
    assert subspace_dist64(got, np.asarray(base)) <= TOL
    assert subspace_dist64(got, np.asarray(fused)) <= TOL


def test_guarded_cholesky_collapsed_and_zero_reference():
    """A zero reference collapses every Gram, polar factor and V̄ to 0:
    the shifted factor keeps the output finite (and zero), as the
    reference's in-kernel guard does."""
    u = _stack(11, 1, 120, 4)[0]
    vs = np.stack([u, -u, u, -u])
    j, t = _both(vs=vs, u=u)
    for ref_j, ref_t in ((j["u"], t["u"]), (jnp.zeros_like(j["u"]), torch.zeros(120, 4))):
        got = tpa.fused_round(t["vs"], ref_t)
        want = jpa.fused_round(j["vs"], ref_j, interpret=True)
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=TOL)


def test_guarded_cholesky_rank_deficient_takes_the_shift():
    """Every basis with an exactly zero last column: V̄ has rank r - 1, a
    pivot of S1 is 0, and both passes must take the shifted factor.  The
    result is deterministic, so it is held elementwise."""
    vs = _stack(5, 3, 150, 4)
    vs[:, :, -1] = 0.0
    j, t = _both(vs=vs)
    got = tpa.fused_round(t["vs"], t["vs"][0])
    want = jpa.fused_round(j["vs"], j["vs"][0], interpret=True)
    assert bool(torch.isfinite(got).all())
    assert float(got[:, -1].abs().max()) == 0.0
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=TOL)
    # Without the shift the unguarded factor would divide by a zero pivot.
    q = to_numpy(got)
    assert np.linalg.norm(q.T @ q - np.eye(4)) > 0.1


# ------------------------------------------------------------ B6 ----------
@pytest.mark.parametrize(
    "m,d,r,chunk",
    [
        (4, 96, 8, 40),     # chunk does not divide d
        (3, 33, 5, 8),      # ragged everything
        (1, 7, 3, 16),      # d < chunk, m == 1
        (8, 128, 16, 128),  # chunk == d
        (2, 100, 4, 33),    # a short last chunk
    ],
)
def test_fused_ring_round_matches_pallas(m, d, r, chunk):
    vs = _stack(m * d + r, m, d, r)
    j, t = _both(vs=vs)
    want = jpa.fused_ring_round(j["vs"], j["vs"][0], ring_chunk=chunk, interpret=True)
    _hold(tpa.fused_ring_round(t["vs"], t["vs"][0], ring_chunk=chunk), want, r)


def test_fused_ring_round_wire_dtypes():
    """bf16 and int8 (+ scales) wire stacks: the reference's own codec
    encodes them, and the same bytes cross to the port."""
    m, d, r = 4, 96, 8
    vs = _stack(1, m, d, r)
    codec = j_get_codec(8)
    data, scale = jax.vmap(lambda v, k: codec.encode(v, key=k))(
        jnp.asarray(vs), jax.random.split(jax.random.PRNGKey(3), m))
    j, t = _both(vs=vs, vb=np.asarray(jnp.asarray(vs).astype(jnp.bfloat16)),
                 q=np.asarray(data), s=np.asarray(scale))
    assert t["vb"].dtype == torch.bfloat16 and t["q"].dtype == torch.int8
    assert torch.equal(t["vb"].float(), torch.from_numpy(np.asarray(j["vb"], np.float32)))
    want_b = jpa.fused_ring_round(j["vb"], j["vs"][0], ring_chunk=40, interpret=True)
    _hold(tpa.fused_ring_round(t["vb"], t["vs"][0], ring_chunk=40), want_b, r)
    want_q = jpa.fused_ring_round(j["q"], j["vs"][0], scales=j["s"], ring_chunk=40,
                                  interpret=True)
    got_q = tops.fused_ring_round(t["q"], t["vs"][0], scales=t["s"], ring_chunk=40,
                                  use_kernel=True)
    _hold(got_q, want_q, r)
    _hold(tref.fused_ring_round(t["q"], t["vs"][0], t["s"]),
          jref.fused_ring_round(j["q"], j["vs"][0], j["s"]), r)


def test_fused_ring_round_scale_validation():
    """Scales exactly for the int8 wire; an unknown wire dtype is refused."""
    m, d, r = 2, 32, 4
    vs = torch.from_numpy(_stack(2, m, d, r))
    with pytest.raises(ValueError):
        tpa.fused_ring_round(vs, vs[0], torch.ones(m, r))
    with pytest.raises(ValueError):
        tpa.fused_ring_round(vs.to(torch.int8), vs[0])
    with pytest.raises(ValueError):
        tpa.fused_ring_round(vs.to(torch.float16), vs[0])
    with pytest.raises(ValueError):
        tref.fused_ring_round(vs.to(torch.int8), vs[0])


@pytest.mark.parametrize("d,chunk", [(100, 33), (7, 16), (8192, 2048), (8192, 1000), (205, 1)])
def test_chunk_spans_single_home(d, chunk):
    """The ring's chunk geometry matches the reference, and the fused ring
    round's d-splits are whole chunks that cover d."""
    assert DEFAULT_RING_CHUNK == J_DEFAULT_RING_CHUNK
    assert chunk_spans(d, chunk) == j_chunk_spans(d, chunk)
    rows = tpa.ring_split_rows(d, chunk)
    c = max(1, min(chunk, d))
    splits = -(-d // rows)
    assert rows % c == 0 and splits <= tpa._MAX_RING_SPLITS
    assert (splits - 1) * rows < d <= splits * rows

"""Port parity of the kernels' plain versions and wrappers on the CPU.

The same numpy-seeded inputs go through the reference's Pallas kernels
(interpret mode, as ``tests/test_kernels.py`` runs them), the reference's
oracles (``repro.kernels.ref``) and the port: the plain PyTorch versions
(``repro_torch.kernels.ref``) and the CUDA wrappers, which on CPU tensors
run the plain version and launch nothing.  The CUDA kernels themselves are
held against the plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.

Tolerances: Gram f32 ``2e-4 * d`` (rtol 1e-2) and bf16 ``2e-1 * d`` as in
``tests/test_kernels.py``; the Gram stages and ``align_average`` 1e-5 on
orthonormal stacks; Newton-Schulz polar 1e-4, since 24 steps amplify
summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import covariance as jcov
from repro.kernels import ops as jops
from repro.kernels import procrustes_align as jpa
from repro.kernels import ref as jref
from repro_torch import kernels as tkernels
from repro_torch.interop import from_reference, to_numpy
from repro_torch.kernels import _build
from repro_torch.kernels import covariance as tcov
from repro_torch.kernels import ops as tops
from repro_torch.kernels import procrustes_align as tpa
from repro_torch.kernels import ref as tref

GRAM_TOL = {"float32": 2e-4, "bfloat16": 2e-1}
STAGE_TOL = 1e-5
NS_TOL = 1e-4
# (m, d, r, bk): block-misaligned d, r < 8, m == 1, as test_kernels_ragged.
STACKS = [(2, 64, 4, 64), (3, 205, 5, 64), (1, 130, 3, 128), (4, 200, 16, 128)]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _noisy_stack(seed, m, d, r, noise=0.1):
    """Noisy orthonormal copies of one r-dim subspace (the paper's setting):
    an (m, d, r) f32 stack whose Grams are near the identity."""
    base = np.linalg.qr(_normal(seed, d, r))[0]
    vs = np.linalg.qr(base[None] + noise * _normal(seed + 1, m, d, r))[0]
    return vs.astype(np.float32)


def _both(**arrays):
    """The same arrays as jnp (reference) and torch CPU tensors (port)."""
    t = from_reference(arrays, device="cpu")
    return {k: jnp.asarray(v) for k, v in arrays.items()}, t


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(
        to_numpy(got), np.asarray(want, np.float32), atol=atol, rtol=rtol
    )


# ------------------------------------------------------------------ B1 ----
@pytest.mark.parametrize("n,d", [(64, 64), (300, 200), (257, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_plain_matches_pallas_and_oracle(n, d, dtype):
    j, t = _both(x=_normal(n + d, n, d))
    jx = j["x"].astype(dtype)
    tx = t["x"].to(getattr(torch, dtype))
    got = tref.gram(tx)
    assert got.dtype == torch.float32 and got.shape == (d, d)
    tol = GRAM_TOL[dtype] * d
    _close(got, jcov.gram(jx, bn=128, bd=128, interpret=True), tol, 1e-2)
    _close(got, jref.gram(jx), tol, 1e-2)


@pytest.mark.parametrize("symmetric", [False, True])
def test_gram_wrapper_on_cpu_runs_plain_version(symmetric):
    """The wrapper takes a CPU tensor to the plain version (no launch),
    and matches the reference's symmetric triangle-skip kernel."""
    j, t = _both(x=_normal(7, 192, 136))
    tkernels.reset_launch_counts()
    got = tcov.gram(t["x"], symmetric=symmetric)
    want = jcov.gram(j["x"], bn=64, bd=64, symmetric=symmetric, interpret=True)
    _close(got, want, GRAM_TOL["float32"] * 136, 1e-2)
    assert tkernels.launch_counts()["gram"] == 0


def test_gram_wrapper_stack_is_per_shard():
    """An (m, n, d) stack gives one Gram per leading index."""
    x = _normal(3, 3, 50, 20)
    got = tcov.gram(torch.from_numpy(x))
    for i in range(3):
        _close(got[i], jref.gram(jnp.asarray(x[i])), 1e-4)


# --------------------------------------------------------------- B2-B4 ----
@pytest.mark.parametrize("m,d,r,bk", STACKS)
def test_batched_gram_plain_matches_pallas(m, d, r, bk):
    j, t = _both(vs=_noisy_stack(m, m, d, r), ref=_noisy_stack(9, 1, d, r)[0])
    got = tpa.batched_gram(t["vs"], t["ref"])  # CPU: the plain version
    assert got.shape == (m, r, r) and got.dtype == torch.float32
    _close(got, jpa.batched_gram(j["vs"], j["ref"], bk=bk, interpret=True), STAGE_TOL)
    _close(got, jref.batched_gram(j["vs"], j["ref"]), STAGE_TOL)


@pytest.mark.parametrize("m,d,r,bk", STACKS)
def test_batched_gram_polar_plain_matches_pallas(m, d, r, bk):
    vs = _noisy_stack(d, m, d, r)
    j, t = _both(vs=vs, ref=vs[0])
    got = tpa.batched_gram_polar(t["vs"], t["ref"])
    assert got.shape == (m, r, r) and got.dtype == torch.float32
    _close(got, jpa.batched_gram_polar(j["vs"], j["ref"], bk=bk, interpret=True), NS_TOL)
    _close(got, jref.batched_gram_polar(j["vs"], j["ref"]), NS_TOL)


@pytest.mark.parametrize("m,d,r,bk", STACKS)
def test_align_average_plain_matches_pallas(m, d, r, bk):
    vs = _noisy_stack(r, m, d, r)
    zs = np.linalg.qr(_normal(5, m, r, r))[0].astype(np.float32)
    j, t = _both(vs=vs, zs=zs)
    got = tpa.align_average(t["vs"], t["zs"])
    assert got.shape == (d, r) and got.dtype == torch.float32
    _close(got, jpa.align_average(j["vs"], j["zs"], bd=bk, interpret=True), STAGE_TOL)
    _close(got, jref.align_average(j["vs"], j["zs"]), STAGE_TOL)


@pytest.mark.parametrize("polar", ["svd", "newton-schulz"])
def test_align_one_matches_reference(polar):
    vs = _noisy_stack(21, 2, 97, 6)
    j, t = _both(v=vs[0], ref=vs[1])
    got = tops.align_one(t["v"], t["ref"], polar=polar, use_kernel=True)
    want = jops.align_one(j["v"], j["ref"], polar=polar, use_kernel=False)
    _close(got, want, NS_TOL if polar == "newton-schulz" else STAGE_TOL)


def test_cpu_wrappers_launch_nothing():
    vs = torch.from_numpy(_noisy_stack(2, 3, 40, 4))
    tkernels.reset_launch_counts()
    tops.gram(vs[0], use_kernel=True)
    tops.batched_gram(vs, vs[0], use_kernel=True)
    z = tops.batched_gram_polar(vs, vs[0], use_kernel=True)
    tops.align_average(vs, z, use_kernel=True)
    tops.fused_round(vs, vs[0], n_iter=2, use_kernel=True)
    tops.fused_ring_round(vs.to(torch.bfloat16), vs[0], use_kernel=True)
    assert tkernels.launch_counts() == {
        "gram": 0, "batched_gram": 0, "batched_gram_polar": 0, "align_average": 0,
        "fused_round": 0, "fused_ring_round": 0,
    }


# ------------------------------------------------- dispatch and planning ----
def test_resolve_backend():
    assert tops.resolve_backend("auto", "cpu") == "torch"
    assert tops.resolve_backend("auto", torch.device("cuda", 0)) == "cuda"
    assert tops.resolve_backend("cuda", "cpu") == "cuda"
    assert tops.resolve_backend("torch", "cuda") == "torch"
    with pytest.raises(ValueError):
        tops.resolve_backend("pallas", "cpu")


def test_dispatch_defaults_to_plain_off_hopper(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not tops.on_sm90()
    x = torch.from_numpy(_normal(1, 30, 12))
    _close(tops.gram(x), jref.gram(jnp.asarray(x.numpy())), 1e-4)


@pytest.mark.parametrize("d,m,r,sms", [
    (8192, 8, 128, 132), (205, 3, 5, 132), (16, 1, 1, 132), (100000, 2, 64, 114),
])
def test_split_rows_cover_d(d, m, r, sms):
    rows, splits = tpa._split_rows(d, m, r, sms)
    assert rows % tpa._GRAM_ROWS == 0
    assert (splits - 1) * rows < d <= splits * rows


def test_split_then_reduce_equals_plain():
    """The d-split of the two-pass Gram stages (partials per split, summed
    in split order) is the plain Gram: the wrapper's row arithmetic."""
    vs = torch.from_numpy(_noisy_stack(4, 3, 205, 5))
    ref = vs[0]
    rows, splits = tpa._split_rows(205, 3, 5, 132)
    parts = [
        torch.einsum("mdr,ds->mrs", vs[:, s * rows:(s + 1) * rows],
                     ref[s * rows:(s + 1) * rows])
        for s in range(splits)
    ]
    assert splits > 1
    _close(sum(parts), tref.batched_gram(vs, ref), 1e-6)


def test_wrappers_refuse_other_devices():
    x = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError):
        tcov.gram(x)
    with pytest.raises(ValueError):
        tpa.batched_gram(torch.empty((2, 8, 4), device="meta"), x)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_load_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _build.load.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load()

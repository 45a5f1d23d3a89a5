"""Port parity of the serial numerics: metrics, Procrustes, orthonormal-
ization, eigensolvers, covariance, synthetic data and the interop layer.

Inputs are made once in numpy from a seed and handed to both packages
(``repro_torch.interop.from_reference`` and ``jnp.asarray``); outputs are
compared in f32 elementwise or with the f64 subspace distance
(``subspace_dist64``) where only the span is defined.  No test turns on
JAX's x64 mode (it would leak into later files on an xdist worker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import covariance as jcovm
from repro.core import metrics as jmet
from repro.core import orthonorm as jorth
from repro.core import procrustes as jpro
from repro.core import subspace as jsub
from repro.data import synthetic as jsyn
from repro_torch import interop
from repro_torch.core import covariance as tcovm
from repro_torch.core import metrics as tmet
from repro_torch.core import orthonorm as torth
from repro_torch.core import procrustes as tpro
from repro_torch.core import subspace as tsub
from repro_torch.data import synthetic as tsyn
from repro_torch.interop import from_reference, to_numpy

TOL = 1e-5


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _basis(seed, d, r):
    return np.linalg.qr(_normal(seed, d, r))[0].astype(np.float32)


def _both(**arrays):
    return (
        {k: jnp.asarray(v) for k, v in arrays.items()},
        from_reference(arrays, device="cpu"),
    )


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(
        to_numpy(got), np.asarray(want, np.float32), atol=atol, rtol=0
    )


def _spiked_cov(seed, d, r, delta=0.2):
    """A (d, d) covariance with the (M1) spectrum: eigengap delta at r."""
    tau = np.asarray(jsyn.spectrum_m1(d, r, delta=delta), np.float64)
    u = np.linalg.qr(np.random.default_rng(seed).standard_normal((d, d)))[0]
    return ((u * tau) @ u.T).astype(np.float32)


# -------------------------------------------------------------- metrics ----
@pytest.mark.parametrize("fn", ["dist_2", "dist_f"])
def test_distances_match_reference(fn):
    j, t = _both(u=_basis(0, 40, 4), v=_basis(1, 40, 4), w=_basis(2, 40, 1)[:, 0])
    _close(getattr(tmet, fn)(t["u"], t["v"]), getattr(jmet, fn)(j["u"], j["v"]))
    # (d,) vectors promote to (d, 1) columns in both packages.
    _close(getattr(tmet, fn)(t["w"], t["u"][:, 0]),
           getattr(jmet, fn)(j["w"], j["u"][:, 0]))


def test_subspace_dist64_matches_reference():
    a, b = _normal(3, 30, 3), _normal(4, 30, 3)
    t = from_reference({"a": a, "b": b}, device="cpu")
    want = jmet.subspace_dist64(a, b)
    assert abs(tmet.subspace_dist64(t["a"], t["b"]) - want) < 1e-12
    assert abs(tmet.subspace_dist64(a, b) - want) < 1e-12


# ----------------------------------------------------------- procrustes ----
@pytest.mark.parametrize("kind", ["near-identity", "random"])
def test_newton_schulz_polar_matches_reference(kind):
    g = _normal(5, 3, 6, 6)
    if kind == "near-identity":
        g = np.eye(6, dtype=np.float32)[None] + 0.1 * g
    j, t = _both(g=g)
    _close(tpro.newton_schulz_polar(t["g"]), jpro.newton_schulz_polar(j["g"]), 1e-4)
    _close(tpro.polar_factor(t["g"], polar="svd"),
           jpro.polar_factor(j["g"], polar="svd"), 1e-4)


def test_newton_schulz_zero_gram_stays_finite():
    z = tpro.newton_schulz_polar(torch.zeros(2, 4, 4))
    assert torch.all(z == 0)


@pytest.mark.parametrize("polar", ["svd", "newton-schulz"])
def test_align_and_align_batch_match_reference(polar):
    base = _basis(6, 50, 5)
    vs = np.linalg.qr(base[None] + 0.1 * _normal(7, 3, 50, 5))[0].astype(np.float32)
    j, t = _both(vs=vs, ref=base)
    _close(tpro.align(t["vs"][0], t["ref"], polar=polar),
           jpro.align(j["vs"][0], j["ref"], polar=polar), 1e-4)
    _close(tpro.align_batch(t["vs"], t["ref"], polar=polar),
           jpro.align_batch(j["vs"], j["ref"], polar=polar), 1e-4)
    _close(tpro.procrustes_distance(t["vs"][0], t["ref"]),
           jpro.procrustes_distance(j["vs"][0], j["ref"]), 1e-4)


@pytest.mark.parametrize("shape", [(20,), (20, 1)])
@pytest.mark.parametrize("flip", [False, True])
def test_sign_fix_matches_reference(shape, flip):
    src = _normal(8, 20)
    ref = -src if flip else src + 0.1 * _normal(9, 20)
    j, t = _both(src=src.reshape(shape), ref=ref)
    _close(tpro.sign_fix(t["src"], t["ref"]), jpro.sign_fix(j["src"], j["ref"]), 0)


def test_resolvers_refuse_unknown_methods():
    with pytest.raises(ValueError):
        tpro.resolve_polar("cholesky")
    with pytest.raises(ValueError):
        torth.resolve_orth("householder")


# ------------------------------------------------------------ orthonorm ----
def _weak_direction(seed, d, r, eps):
    """r - 1 strong directions plus one of norm ~eps: kappa ~ 1/eps."""
    q = _basis(seed, d, r) + 0.01 * _normal(seed + 1, d, r)
    return (q * np.r_[np.ones(r - 1), eps]).astype(np.float32)


@pytest.mark.parametrize("case", ["well", "weak", "guard"])
def test_orthonormalizers_match_reference(case):
    v = {
        "well": _normal(10, 64, 6),
        "weak": _weak_direction(11, 160, 4, 0.05),
        "guard": _weak_direction(12, 160, 4, 3e-4),  # the shift retry fires
    }[case]
    j, t = _both(v=v)
    for port, ref in ((torth.qr_orthonormalize, jorth.qr_orthonormalize),
                      (torth.cholesky_qr2, jorth.cholesky_qr2)):
        q = port(t["v"])
        qn = to_numpy(q).astype(np.float64)
        assert np.abs(qn.T @ qn - np.eye(v.shape[1])).max() < 1e-5
        assert tmet.subspace_dist64(q, ref(j["v"])) <= TOL


def test_cholesky_qr2_beyond_its_range_matches_reference():
    """kappa ~ 1e6 is beyond CholeskyQR2's f32 range (~3e3): both packages
    stay finite and lose orthogonality the same way, elementwise."""
    j, t = _both(v=_weak_direction(12, 160, 4, 1e-6))
    q = torth.cholesky_qr2(t["v"])
    assert bool(torch.isfinite(q).all())
    _close(q, jorth.cholesky_qr2(j["v"]), 1e-6)


def test_cholesky_qr2_guard_and_zero_input():
    assert torth.cholqr_guard_coeffs(100, 8, 1e-7) == jorth.cholqr_guard_coeffs(
        100, 8, 1e-7
    )
    zero = torth.cholesky_qr2(torch.zeros(12, 3))
    assert bool(torch.isfinite(zero).all()) and float(zero.abs().max()) == 0.0
    for orth in ("qr", "cholesky-qr2"):
        v = torch.from_numpy(_normal(13, 30, 4))
        q = torth.orthonormalize(v, orth=orth)
        assert tmet.subspace_dist64(q, v.numpy()) < 1e-6


def test_cholesky_qr2_keeps_f64():
    v = torch.from_numpy(_normal(14, 20, 3).astype(np.float64))
    assert torth.cholesky_qr2(v).dtype == torch.float64


# ------------------------------------------------------------- subspace ----
def test_top_r_eigh_matches_reference():
    j, t = _both(c=_spiked_cov(15, 48, 4))
    tv, tl = tsub.top_r_eigh(t["c"], 4)
    jv, jl = jsub.top_r_eigh(j["c"], 4)
    _close(tl, jl)
    assert tmet.subspace_dist64(tv, jv) <= TOL


@pytest.mark.parametrize("iters", [5, 30])
def test_subspace_iteration_with_v0_matches_reference(iters):
    j, t = _both(c=_spiked_cov(16, 64, 5), v0=_normal(17, 64, 5))
    tv, tl = tsub.subspace_iteration(t["c"], 5, iters=iters, v0=t["v0"])
    jv, jl = jsub.subspace_iteration(j["c"], 5, iters=iters, v0=j["v0"])
    _close(tl, jl)
    assert tmet.subspace_dist64(tv, jv) <= TOL


def test_subspace_iteration_seeding():
    """No v0: a seed-0 generator on the matrix's device (deterministic);
    an explicit generator gives its own start."""
    c = torch.from_numpy(_spiked_cov(18, 40, 3))
    a, _ = tsub.subspace_iteration(c, 3, iters=2)
    b, _ = tsub.subspace_iteration(c, 3, iters=2)
    assert torch.equal(a, b)
    g = torch.Generator().manual_seed(5)
    e, _ = tsub.subspace_iteration(c, 3, iters=2, generator=g)
    assert not torch.equal(a, e)
    with pytest.raises(ValueError):
        tsub.local_eigenbasis(c, 3, method="lanczos")


# ----------------------------------------------------------- covariance ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_increment_dtype_rule(dtype):
    """Accumulation never follows a bf16 payload down (reference :25)."""
    j, t = _both(x=_normal(19, 40, 16))
    got = tcovm.gram_increment(t["x"].to(getattr(torch, dtype)),
                               dtype=getattr(torch, dtype))
    want = jcovm.gram_increment(j["x"].astype(dtype), dtype=getattr(jnp, dtype))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, 1e-4)
    assert tcovm.gram_increment(torch.zeros(0, 5)).abs().max() == 0


@pytest.mark.parametrize("backend,jbackend", [
    ("torch", "xla"), ("cuda", "pallas"), ("auto", "auto"),
])
def test_empirical_covariance_matches_reference(backend, jbackend):
    j, t = _both(x=_normal(20, 300, 72))
    got = tcovm.empirical_covariance(t["x"], backend=backend)
    _close(got, jcovm.empirical_covariance(j["x"], backend=jbackend))


def test_empirical_covariance_plain_path_keeps_f64():
    x = torch.from_numpy(_normal(21, 10, 4).astype(np.float64))
    assert tcovm.empirical_covariance(x).dtype == torch.float64


# ------------------------------------------------------------ synthetic ----
@pytest.mark.parametrize("spec", ["m1", "m1-rank1", "m2"])
def test_spectra_match_reference(spec):
    if spec == "m1":
        t, j = tsyn.spectrum_m1(50, 5, device="cpu"), jsyn.spectrum_m1(50, 5)
    elif spec == "m1-rank1":
        t, j = tsyn.spectrum_m1(20, 1, device="cpu"), jsyn.spectrum_m1(20, 1)
    else:
        t, j = tsyn.spectrum_m2(60, 4, 10.0, device="cpu"), jsyn.spectrum_m2(60, 4, 10.0)
    _close(t, j, 1e-6)
    with pytest.raises(ValueError):
        tsyn.spectrum_m2(10, 4, 4.5, device="cpu")


def test_covariance_and_samples_distribution():
    """torch and jax.random streams differ, so hold the port's draws to
    their distribution: Haar U orthogonal, Sigma's spectrum is tau, and
    the sample covariance converges to Sigma."""
    gen = torch.Generator().manual_seed(0)
    tau = tsyn.spectrum_m1(24, 3, device="cpu")
    sigma, u, factor = tsyn.covariance_from_spectrum(tau, generator=gen)
    assert torch.allclose(u.T @ u, torch.eye(24), atol=1e-5)
    lam = torch.linalg.eigvalsh(sigma.double()).flip(0)
    assert torch.allclose(lam, torch.sort(tau.double(), descending=True)[0], atol=1e-5)
    assert torch.allclose(factor @ factor.T, sigma, atol=1e-5)
    x = tsyn.sample_gaussian(factor, 70000, generator=gen)  # two row blocks
    assert x.shape == (70000, 24)
    assert torch.allclose(x.T @ x / 70000, sigma, atol=0.03)
    q = tsyn.random_orthogonal(16, generator=torch.Generator().manual_seed(1),
                               device="cpu")
    assert torch.allclose(q.T @ q, torch.eye(16), atol=1e-5)


# --------------------------------------------------------------- interop ----
def test_from_reference_and_to_numpy():
    arrays = {"a": np.arange(6, dtype=np.float64).reshape(2, 3),
              "b": jnp.ones((2,), jnp.float32)}
    t = from_reference(arrays, device="cpu")
    assert t["a"].dtype == torch.float64 and t["b"].dtype == torch.float32
    t16 = from_reference(arrays, device="cpu", dtype=torch.bfloat16)
    assert t16["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(t16["a"]), arrays["a"])


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        from_reference({"a": np.zeros(2)}, device="cuda")
    with pytest.raises(RuntimeError):
        tsyn.spectrum_m1(8, 2)  # entry points default to the card
    assert interop.resolve_device("cpu") == torch.device("cpu")


def test_strict_fp32_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    interop.strict_fp32()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"

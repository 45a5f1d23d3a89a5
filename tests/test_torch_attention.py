"""Port parity of attention on the CPU: the flash kernel's plain version
(B8), the plain attention oracle, the dispatch rule and the attention
module.

The same numpy-seeded inputs go through the reference (its Pallas flash
kernel in interpret mode, as ``tests/test_kernels.py`` runs it, and its
oracle ``repro.kernels.ref.attention``) and the port (the B8 wrapper,
which on CPU tensors runs ``repro_torch.kernels.ref.flash_attention``,
and ``repro_torch.kernels.ref.attention``).  The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.

Tolerances: the flash kernel 2e-5 in f32 and 3e-2 in bf16, the bars of
the reference's own kernel tests (``tests/test_kernels.py:122,146``).
The plain oracle in f32: 1e-6, or the repo's bound for an f32 sum of t
products taken in two orders (4 eps sqrt(t) times the largest output)
where that is larger; with ``probs_bf16`` each probability may round to
the neighbouring bf16 value in the two frameworks (their f32 ``exp``
differ in the last bits), which moves an output by at most 2^-8 max|v|,
so that is the bar there, and nearly every entry must still agree at the
f32 bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as ref_reduced_config
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import init_split
from repro_torch import kernels as tkernels
from repro_torch.configs import get_reduced_config
from repro_torch.interop import from_reference, lm_params_from_reference, to_numpy
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers

FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
EPS32 = 2.0 ** -23


def _qkv(seed, b, hq, hkv, s, t, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = {
        "q": rng.standard_normal((b, hq, s, d)),
        "k": rng.standard_normal((b, hkv, t, d)),
        "v": rng.standard_normal((b, hkv, t, d)),
    }
    arrs = {n: a.astype(np.float32) for n, a in arrs.items()}
    jdt = jnp.dtype(dtype)
    j = {n: jnp.asarray(a).astype(jdt) for n, a in arrs.items()}
    t_ = from_reference({n: np.asarray(a) for n, a in j.items()}, device="cpu")
    return j, t_


def _flash_case(seed, shape, dtype="float32", *, causal=True, window=None):
    j, t = _qkv(seed, *shape, dtype=dtype)
    want = jfa.flash_attention(
        j["q"], j["k"], j["v"], causal=causal, window=window, bq=64, bk=64,
        interpret=True,
    )
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(t["q"], t["k"], t["v"], causal=causal, window=window)
    assert tfa.flash_attention.launches == before  # CPU: plain version only
    assert got.dtype == t["q"].dtype and tuple(got.shape) == tuple(want.shape)
    return to_numpy(got), np.asarray(want, np.float32)


# The shape list of tests/test_kernels.py:104-164, then s > t.
SHAPES = [
    (1, 2, 2, 128, 128, 64),  # MHA
    (2, 4, 2, 256, 256, 64),  # GQA 2:1
    (1, 8, 1, 128, 128, 32),  # MQA
    (1, 2, 1, 96, 160, 64),   # uneven s/t, padding path
    (1, 2, 2, 32, 256, 64),   # suffix queries (chunked prefill)
    (1, 4, 2, 80, 80, 16),    # the reduced configs' head_dim
]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flash_matches_reference_kernel(shape):
    got, want = _flash_case(0, shape)
    np.testing.assert_allclose(got, want, atol=FLASH_TOL["float32"], rtol=0)


@pytest.mark.parametrize("window", [16, 64, 1024])
def test_flash_window_matches_reference_kernel(window):
    got, want = _flash_case(1, (1, 2, 2, 256, 256, 64), window=window)
    np.testing.assert_allclose(got, want, atol=FLASH_TOL["float32"], rtol=0)


def test_flash_window_with_suffix_queries():
    got, want = _flash_case(5, (1, 4, 2, 48, 200, 32), window=40)
    np.testing.assert_allclose(got, want, atol=FLASH_TOL["float32"], rtol=0)


def test_flash_bf16_matches_reference_kernel():
    got, want = _flash_case(2, (1, 4, 2, 128, 128, 64), "bfloat16")
    np.testing.assert_allclose(got, want, atol=FLASH_TOL["bfloat16"], rtol=0)


# The CUDA kernel's 128-row query tile and 128-key K/V tile edges (the
# card checks of tests/test_torch_cuda.py), head_dim 80 (two 64-column
# boxes, the second zero-padded): the plain version against the JAX kernel.
@pytest.mark.parametrize("s,t", [(127, 127), (129, 129), (255, 255), (129, 255),
                                 (255, 127)], ids=str)
def test_flash_tile_edges_match_reference_kernel(s, t):
    got, want = _flash_case(6, (1, 2, 1, s, t, 80))
    np.testing.assert_allclose(got, want, atol=FLASH_TOL["float32"], rtol=0)


@pytest.mark.parametrize("window", [128, 129])
def test_flash_window_tile_edges_match_reference_kernel(window):
    got, want = _flash_case(7, (1, 2, 1, 255, 255, 80), window=window)
    np.testing.assert_allclose(got, want, atol=FLASH_TOL["float32"], rtol=0)


def test_flash_bf16_tile_edge_matches_reference_kernel():
    got, want = _flash_case(8, (1, 4, 2, 129, 255, 80), "bfloat16")
    np.testing.assert_allclose(got, want, atol=FLASH_TOL["bfloat16"], rtol=0)


def test_flash_rows_without_keys_are_zero():
    """s > t under the causal mask: the first s - t rows see no key.  The
    kernel (and its plain version) give zeros there, where the oracle
    gives the uniform mean of v (ROADMAP C)."""
    shape = (1, 2, 1, 160, 96, 32)
    got, want = _flash_case(3, shape)
    np.testing.assert_allclose(got, want, atol=FLASH_TOL["float32"], rtol=0)
    s, t = shape[3], shape[4]
    assert np.all(got[:, :, : s - t] == 0.0)
    j, _ = _qkv(3, *shape)
    oracle = np.asarray(jref.attention(j["q"], j["k"], j["v"], causal=True))
    assert np.abs(oracle[:, :, : s - t]).max() > 1e-2
    np.testing.assert_allclose(got[:, :, s - t:], oracle[:, :, s - t:],
                               atol=FLASH_TOL["float32"], rtol=0)


def test_flash_noncausal_and_padding_keys():
    got, want = _flash_case(4, (1, 2, 1, 40, 72, 24), causal=False)
    np.testing.assert_allclose(got, want, atol=FLASH_TOL["float32"], rtol=0)


def test_flash_plain_refuses_uneven_heads():
    _, t = _qkv(0, 1, 3, 2, 8, 8, 16)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(t["q"], t["k"], t["v"])


def _oracle_tol(want, t):
    return max(1e-6, 4 * EPS32 * np.sqrt(t) * np.abs(want).max())


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("shape", [(1, 2, 1, 96, 160, 64), (2, 4, 2, 64, 64, 32),
                                   (1, 2, 1, 160, 96, 32)], ids=str)
def test_plain_attention_matches_oracle(shape, window):
    j, t = _qkv(6, *shape)
    want = np.asarray(jref.attention(j["q"], j["k"], j["v"], causal=True, window=window))
    got = to_numpy(tref.attention(t["q"], t["k"], t["v"], causal=True, window=window))
    np.testing.assert_allclose(got, want, atol=_oracle_tol(want, shape[4]), rtol=0)


@pytest.mark.parametrize("shape", [(1, 2, 1, 96, 160, 64), (2, 4, 2, 128, 128, 32)], ids=str)
def test_plain_attention_probs_bf16_matches_oracle(shape):
    j, t = _qkv(7, *shape)
    want = np.asarray(jref.attention(j["q"], j["k"], j["v"], causal=True, probs_bf16=True))
    got = to_numpy(tref.attention(t["q"], t["k"], t["v"], causal=True, probs_bf16=True))
    bound = 2.0 ** -8 * np.abs(np.asarray(j["v"])).max()
    np.testing.assert_allclose(got, want, atol=bound, rtol=0)
    close = np.abs(got - want) <= _oracle_tol(want, shape[4])
    assert close.mean() >= 0.99, close.mean()


def test_plain_attention_bf16_inputs():
    j, t = _qkv(8, 1, 4, 2, 64, 64, 32, "bfloat16")
    want = np.asarray(jref.attention(j["q"], j["k"], j["v"], causal=True), np.float32)
    got = to_numpy(tref.attention(t["q"], t["k"], t["v"], causal=True))
    assert t["q"].dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, atol=FLASH_TOL["bfloat16"], rtol=0)


# ------------------------------------------------------------- dispatch ----
def test_attention_dispatch(monkeypatch):
    """None resolves on the tensors, not on the host's card: CPU tensors
    take the oracle whether or not the host has a Hopper card (CUDA
    tensors with s > 1 take the wrapper: tests/test_torch_cuda.py); True
    forces the wrapper (its plain version on CPU tensors), False the
    oracle."""
    _, t = _qkv(9, 1, 2, 1, 16, 16, 16)
    calls = []
    flash, plain = tref.flash_attention, tref.attention
    monkeypatch.setattr(tops._fa, "flash_attention",
                        lambda *a, **k: calls.append("kernel") or flash(*a, **k))
    monkeypatch.setattr(tops._ref, "attention",
                        lambda *a, **k: calls.append("plain") or plain(*a, **k))
    monkeypatch.setattr(tops, "on_sm90", lambda: False)
    tops.attention(t["q"], t["k"], t["v"])
    tops.attention(t["q"], t["k"], t["v"], use_kernel=True)
    monkeypatch.setattr(tops, "on_sm90", lambda: True)
    tops.attention(t["q"], t["k"], t["v"])
    tops.attention(t["q"][:, :, -1:], t["k"], t["v"])  # decode stays plain
    tops.attention(t["q"], t["k"], t["v"], use_kernel=False)
    assert calls == ["plain", "kernel", "plain", "plain", "plain"]


@pytest.mark.parametrize("probs_bf16", [False, True])
def test_cpu_attention_does_not_depend_on_host_card(monkeypatch, probs_bf16):
    """On a host with a Hopper card, CPU tensors still give the oracle's
    result bit for bit (not the flash plain version, whose probabilities
    stay f32), and the shared dispatch of the other kernels picks the
    plain version for CPU tensors too."""
    _, t = _qkv(11, 1, 4, 2, 24, 24, 16, "bfloat16")
    want = tref.attention(t["q"], t["k"], t["v"], causal=True, probs_bf16=probs_bf16)
    monkeypatch.setattr(tops, "on_sm90", lambda: True)
    monkeypatch.setattr(tops._fa, "flash_attention",
                        lambda *a, **k: pytest.fail("CPU tensors reached the B8 wrapper"))
    got = tops.attention(t["q"], t["k"], t["v"], causal=True, probs_bf16=probs_bf16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    monkeypatch.setattr(tops._cov, "gram",
                        lambda *a, **k: pytest.fail("CPU tensors reached the gram wrapper"))
    x = t["q"][0, 0].float()
    assert torch.equal(tops.gram(x), tref.gram(x))


def test_cpu_flash_wrapper_launches_nothing():
    _, t = _qkv(10, 1, 2, 1, 16, 16, 16)
    tkernels.reset_launch_counts()
    tops.attention(t["q"], t["k"], t["v"], use_kernel=True)
    assert tkernels.launch_counts()["flash_attention"] == 0


# ------------------------------------------------------- attention module ----
def _attention_pair(arch, seed=0):
    jcfg = dataclasses.replace(ref_reduced_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    values, _ = init_split(jcfg, jax.random.PRNGKey(seed))
    values = jax.tree.map(np.asarray, values)
    model = lm_params_from_reference(values, tcfg, device="cpu")
    p = jax.tree.map(lambda a: a[0], values["stages"][0]["block0"]["mixer"])
    return jcfg, p, model.blocks[0].mixer


@pytest.mark.parametrize("arch", ["llama3.2-3b", "chatglm3-6b"])
def test_attention_module_prefill_matches_reference(arch):
    """The port's Attention in prefill mode against apply_attention(...,
    mode="prefill", use_flash=True), which runs the Pallas kernel in
    interpret mode: the output and the cache."""
    jcfg, p, att = _attention_pair(arch)
    rng = np.random.default_rng(11)
    b, s = 2, 40
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    want, wcache = jlayers.apply_attention(
        p, jcfg, jnp.asarray(x), positions=jnp.arange(s), mode="prefill",
        use_flash=True,
    )
    kv_shape = (b, jcfg.num_kv_heads, s, jcfg.head_dim)
    cache = {"k": torch.zeros(kv_shape), "v": torch.zeros(kv_shape)}
    with torch.no_grad():
        got, gcache = att(torch.from_numpy(x), positions=torch.arange(s),
                          mode="prefill", cache=cache, use_kernel=True)
    assert gcache["k"] is cache["k"]  # written in place
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_numpy(gcache[name]), np.asarray(wcache[name]),
                                   atol=1e-5, rtol=0)


def test_attention_module_decode_matches_reference():
    """Decode against a cache: the grouped GQA product over valid slots,
    the new K/V written into slot ``pos`` (in place in the port)."""
    jcfg, p, att = _attention_pair("granite-3-2b", seed=1)
    rng = np.random.default_rng(12)
    b, cache_len, pos = 2, 24, 17
    kv_shape = (b, jcfg.num_kv_heads, cache_len, jcfg.head_dim)
    ck = rng.standard_normal(kv_shape).astype(np.float32)
    cv = rng.standard_normal(kv_shape).astype(np.float32)
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    want, wcache = jlayers.apply_attention(
        p, jcfg, jnp.asarray(x), positions=jnp.asarray(pos), mode="decode",
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
    )
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    with torch.no_grad():
        got, gcache = att(torch.from_numpy(x), positions=torch.full((1,), pos),
                          mode="decode", cache=cache, pos=pos)
    assert gcache["k"] is cache["k"]  # written in place
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_numpy(gcache[name]), np.asarray(wcache[name]),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_and_rms_norm_match_reference(fraction):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5, fraction)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5, fraction)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5, rtol=0)
    scale = rng.standard_normal(16).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5, rtol=1e-6)

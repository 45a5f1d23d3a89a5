"""Port parity of the recurrent families on the CPU: recurrentgemma-2b
(RG-LRU + local attention, the hybrid family) and mamba2-370m (Mamba2
SSD, the SSM family).

The same seeded numpy inputs, and the reference's own parameters, go
through the reference's functions and the port's modules, at the reduced
configs.  Bars (each test's docstring repeats its own):

  * ``causal_conv``: f32 within 1e-6; bf16 within one bf16 step (2^-8) of
    the output's largest magnitude (XLA may keep f32 between fused bf16
    elementwise ops, so bits can differ).
  * RG-LRU, SSD and local attention, layer by layer: f32 within 1e-5
    (the doubling scan sums in another order than ``associative_scan``,
    a few f32 roundings); bf16 within 2^-5 of the output's largest
    magnitude (``test_torch_lm.py``'s bf16 bar).
  * both LMs served (prefill, then greedy decode fed the reference's
    tokens, past the window): the dense family's bars of
    ``test_torch_lm.py``: f32 with f32 probabilities 1e-4 and the same
    greedy tokens; f32 with bf16 probabilities 2^-8 of the largest logit;
    bf16 2^-5 of the largest logit, or the reference's own spread where
    that is wider: its compiled serve against the same serve run op by op
    (``jax.disable_jit``), which round the same bf16 values in other
    places.  At five layers with a recurrent state carried through
    decode that spread can pass the dense family's 2^-5, which was sized
    for two layers; it is computed only where the port's error passes
    2^-5.
  * the port's own golden test: prefill plus decode reproduces its
    train-mode forward within 1e-4 (``tests/test_serving.py:59-64``).
"""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_reduced_config as ref_reduced_config
from repro.models import config as jconfig
from repro.models import init_split
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.registry import abstract_params
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.interop import (
    join_reference,
    lm_params_from_reference,
    reference_leaves,
    split_reference,
    to_numpy,
)
from repro_torch.launch import serve as tserve
from repro_torch.models import LM, build, param_count
from repro_torch.models import layers as TL

REPO = Path(__file__).resolve().parents[1]
HYBRID, SSM = "recurrentgemma-2b", "mamba2-370m"
ARCHS = [HYBRID, SSM]
B = 2
BF16_BAR = 2.0 ** -5


def _cfgs(arch, **overrides):
    return (dataclasses.replace(ref_reduced_config(arch), **overrides),
            dataclasses.replace(get_reduced_config(arch), **overrides))


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else to_numpy(a)


def _load(module, values):
    """The reference's leaves of one mixer into the port's module."""
    with torch.no_grad():
        for name, arr in values.items():
            p = getattr(module, name)
            p.copy_(torch.from_numpy(np.array(arr, np.float32)).reshape(p.shape))
    return module


def _mixer(arch, kind, dtype, **overrides):
    """(reference cfg, reference leaves, port module) of one mixer."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype, **overrides)
    init = {"rglru": JL.init_rglru, "ssd": JL.init_ssd,
            "local_attn": JL.init_attention}[kind]
    values, _ = JL.split_params(init(jax.random.PRNGKey(0), jcfg))
    values = jax.tree.map(np.asarray, values)
    tdt = getattr(torch, dtype)
    module = {"rglru": lambda: TL.RGLRU(tcfg, dtype=tdt),
              "ssd": lambda: TL.SSD(tcfg, dtype=tdt),
              "local_attn": lambda: TL.Attention(tcfg, window=tcfg.window_size,
                                                 dtype=tdt)}[kind]()
    return jcfg, values, _load(module, values)


def _zero_cache(arch, kind, batch, **overrides):
    _, tcfg = _cfgs(arch, **overrides)
    return LM(dataclasses.replace(tcfg, num_layers=1, block_pattern=(kind,)),
              device="cpu").blocks[0].init_cache(batch, 64)


def _close(got, want, dtype, f32_bar):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    bar = f32_bar if dtype == "float32" else BF16_BAR * np.abs(want).max()
    assert err <= bar, (err, bar)


# ------------------------------------------------------------ causal conv ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(dtype, with_tail):
    """f32 within 1e-6; bf16 within 2^-8 of the output's largest
    magnitude; the new tail (the last K-1 inputs, f32) exactly."""
    jx, tx = _x((B, 11, 24), 0, dtype)
    w = np.random.default_rng(1).standard_normal((4, 24)).astype(np.float32) * 0.5
    tail = np.random.default_rng(2).standard_normal((B, 3, 24)).astype(np.float32)
    jy, jt = JL._causal_conv(jx, jnp.asarray(w), jnp.asarray(tail) if with_tail else None)
    ty, tt = TL.causal_conv(tx, torch.from_numpy(w),
                            torch.from_numpy(tail) if with_tail else None)
    assert ty.dtype == tx.dtype and tt.dtype == torch.float32
    err, scale = np.abs(_np(jy) - _np(ty)).max(), np.abs(_np(jy)).max()
    assert err <= (1e-6 if dtype == "float32" else 2.0 ** -8 * scale), (err, scale)
    np.testing.assert_array_equal(_np(tt), _np(jnp.asarray(jt, jnp.float32)))


def test_conv_tail_carries_across_short_calls():
    """One step at a time (S = 1 < K - 1) the tail keeps the inputs from
    the calls before: the same output as one call over the sequence."""
    _, tx = _x((B, 7, 8), 3, "float32")
    w = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 8)).astype(np.float32))
    full, _ = TL.causal_conv(tx, w, None)
    tail, steps = None, []
    for t in range(7):
        y, tail = TL.causal_conv(tx[:, t:t + 1], w, tail)
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, 1), full, atol=1e-6, rtol=0)


# -------------------------------------------------------------- the scan ----
@pytest.mark.parametrize("s", [1, 2, 7, 64, 4096])
def test_doubling_scan_matches_sequential_f64(s):
    """The doubling scan in f32 against a sequential loop in f64, a in
    (0, 1) as RG-LRU's: within 1e-5 of the largest state."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (B, s, 8))
    b = rng.standard_normal((B, s, 8))
    want, h = np.empty_like(b), np.zeros((B, 8))
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = TL.doubling_scan(torch.from_numpy(a).float(), torch.from_numpy(b).float())
    assert np.abs(_np(got) - want).max() <= 1e-5 * np.abs(want).max()


# ----------------------------------------------------------------- RG-LRU ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_train_prefill_decode_match_reference(dtype):
    """Train, prefill (and its state), prefill continued from that cache
    (the reference's ``test_rglru_state_continuity``) and three decode
    steps: f32 within 1e-5, bf16 within 2^-5 of the largest output."""
    jcfg, values, mod = _mixer(HYBRID, "rglru", dtype)
    jx, tx = _x((B, 32, jcfg.d_model), 5, dtype)
    with torch.no_grad():
        jy, _ = JL.apply_rglru(values, jcfg, jx, mode="train")
        ty, _ = mod(tx, mode="train")
        _close(ty, jy, dtype, 1e-5)

        cache = _zero_cache(HYBRID, "rglru", B)
        jy1, jc = JL.apply_rglru(values, jcfg, jx[:, :16], mode="prefill")
        ty1, cache = mod(tx[:, :16], mode="prefill", cache=cache)
        _close(ty1, jy1, dtype, 1e-5)
        _close(cache["h"], jc["h"], dtype, 1e-5)
        np.testing.assert_array_equal(_np(cache["conv"]), _np(jc["conv"]))

        jy2, jc = JL.apply_rglru(values, jcfg, jx[:, 16:29], cache=jc, mode="prefill")
        ty2, cache = mod(tx[:, 16:29], mode="prefill", cache=cache)
        _close(ty2, jy2, dtype, 1e-5)
        for t in range(29, 32):
            jyd, jc = JL.apply_rglru(values, jcfg, jx[:, t:t + 1], cache=jc, mode="decode")
            tyd, cache = mod(tx[:, t:t + 1], mode="decode", cache=cache)
            _close(tyd, jyd, dtype, 1e-5)
        _close(cache["h"], jc["h"], dtype, 1e-5)


def test_rglru_state_continuity():
    """The port's own: prefill of x[:16], then prefill of x[16:] from its
    cache, equals the train scan of x (the reference's bar, 2e-4; f32)."""
    _, _, mod = _mixer(HYBRID, "rglru", "float32")
    _, tx = _x((B, 32, 64), 1, "float32")
    with torch.no_grad():
        full, _ = mod(tx, mode="train")
        cache = _zero_cache(HYBRID, "rglru", B)
        y1, cache = mod(tx[:, :16], mode="prefill", cache=cache)
        y2, _ = mod(tx[:, 16:], mode="prefill", cache=cache)
    torch.testing.assert_close(torch.cat([y1, y2], 1), full, atol=2e-4, rtol=0)


# -------------------------------------------------------------------- SSD ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,s", [(4, 48), (16, 48), (48, 48), (16, 44), (16, 5)])
def test_ssd_train_matches_reference(dtype, chunk, s):
    """Train at chunks 4, 16 and 48, and at S not a multiple of the chunk
    (the padded path, a = 1 on the pad) or below it: f32 within 1e-5,
    bf16 within 2^-5 of the largest output."""
    jcfg, values, mod = _mixer(SSM, "ssd", dtype, ssm_chunk=chunk)
    jx, tx = _x((B, s, jcfg.d_model), 6, dtype)
    jy, _ = JL.apply_ssd(values, jcfg, jx, mode="train")
    with torch.no_grad():
        ty, _ = mod(tx, mode="train")
    _close(ty, jy, dtype, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_prefill_from_state_and_decode_match_reference(dtype):
    """A prefill of 20 tokens (chunk 16: padded), a second prefill from
    its state ``s0`` and conv tail, then three decode steps: outputs and
    the state f32 within 1e-5, bf16 within 2^-5 of the largest value."""
    jcfg, values, mod = _mixer(SSM, "ssd", dtype)
    jx, tx = _x((B, 40, jcfg.d_model), 7, dtype)
    with torch.no_grad():
        cache = _zero_cache(SSM, "ssd", B)
        jy, jc = JL.apply_ssd(values, jcfg, jx[:, :20], mode="prefill")
        ty, cache = mod(tx[:, :20], mode="prefill", cache=cache)
        _close(ty, jy, dtype, 1e-5)
        _close(cache["s"], jc["s"], dtype, 1e-5)
        jy, jc = JL.apply_ssd(values, jcfg, jx[:, 20:37], cache=jc, mode="prefill")
        ty, cache = mod(tx[:, 20:37], mode="prefill", cache=cache)
        _close(ty, jy, dtype, 1e-5)
        for t in range(37, 40):
            jy, jc = JL.apply_ssd(values, jcfg, jx[:, t:t + 1], cache=jc, mode="decode")
            ty, cache = mod(tx[:, t:t + 1], mode="decode", cache=cache)
            _close(ty, jy, dtype, 1e-5)
        _close(cache["s"], jc["s"], dtype, 1e-5)
        np.testing.assert_array_equal(_np(cache["conv"]), _np(jc["conv"]))


# -------------------------------------------------------- local attention ----
@pytest.mark.parametrize("s", [5, 8, 13])
def test_local_attention_prefill_and_ring(s):
    """Prefill at S below, at and past the window (8): the output within
    1e-5 (f32), and the ring slot ``p % 8`` of every kept position p
    (the last min(8, S)) holding the reference's key and value."""
    jcfg, values, mod = _mixer(HYBRID, "local_attn", "float32", window_size=8)
    jx, tx = _x((B, s, jcfg.d_model), 8, "float32")
    jy, jc = JL.apply_attention(values, jcfg, jx, positions=jnp.arange(s), window=8,
                                mode="prefill")
    cache = _zero_cache(HYBRID, "local_attn", B, window_size=8, dtype="float32")
    with torch.no_grad():
        ty, cache = mod(tx, positions=torch.arange(s), mode="prefill", cache=cache)
    _close(ty, jy, "float32", 1e-5)
    assert cache["k"].shape[2] == 8  # min(window, cache_len 64)
    for p in range(max(0, s - 8), s):
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(cache[key][:, :, p % 8]),
                                       _np(jc[key][:, :, p % 8]), atol=1e-5, rtol=0)


def test_local_attention_decode_three_windows_past():
    """Prefill 6 tokens, then decode 3 windows (window 8) past the
    prompt, one token at a time against the reference's ring decode: each
    step within 1e-5 (f32).  Covers the slots ahead of ``pos`` whose
    ``pos - j`` is negative (the divisor-signed remainder)."""
    jcfg, values, mod = _mixer(HYBRID, "local_attn", "float32", window_size=8)
    jx, tx = _x((B, 6 + 26, jcfg.d_model), 9, "float32")
    _, jc = JL.apply_attention(values, jcfg, jx[:, :6], positions=jnp.arange(6), window=8,
                               mode="prefill")
    cache = _zero_cache(HYBRID, "local_attn", B, window_size=8, dtype="float32")
    with torch.no_grad():
        mod(tx[:, :6], positions=torch.arange(6), mode="prefill", cache=cache)
        for pos in range(6, 32):
            jy, jc = JL.apply_attention(values, jcfg, jx[:, pos:pos + 1],
                                        positions=jnp.asarray(pos), window=8,
                                        cache=jc, mode="decode")
            ty, cache = mod(tx[:, pos:pos + 1], positions=torch.full((1,), pos),
                            mode="decode", cache=cache, pos=pos)
            _close(ty, jy, "float32", 1e-5)


def test_local_ring_smaller_than_window():
    """A serving length below the window keeps min(window, cache_len)
    slots, and decoding in it matches the full-window ring (f32, 1e-6)."""
    _, _, mod = _mixer(HYBRID, "local_attn", "float32", window_size=16)
    _, tx = _x((B, 10, 64), 10, "float32")
    small = _zero_cache(HYBRID, "local_attn", B, window_size=16, dtype="float32")
    small = {k: v[:, :, :10].clone() for k, v in small.items()}
    big = _zero_cache(HYBRID, "local_attn", B, window_size=16, dtype="float32")
    with torch.no_grad():
        outs = []
        for cache in (small, big):
            mod(tx[:, :4], positions=torch.arange(4), mode="prefill", cache=cache)
            ys = [mod(tx[:, p:p + 1], positions=torch.full((1,), p), mode="decode",
                      cache=cache, pos=p)[0] for p in range(4, 10)]
            outs.append(torch.cat(ys, 1))
    torch.testing.assert_close(outs[0], outs[1], atol=1e-6, rtol=0)


# ------------------------------------------------------ the LMs, served ----
def _serve_both(arch, prompt, gen, **overrides):
    """Prefill ``prompt`` tokens then ``gen`` greedy decode steps in both
    packages, both fed the reference's tokens.  Returns (max abs logit
    error, largest logit, greedy tokens equal at every step, a function
    of no argument giving the reference's compiled serve against its
    op-by-op one on the same tokens: the max abs logit difference)."""
    jcfg, tcfg = _cfgs(arch, **overrides)
    values, _ = init_split(jcfg, jax.random.PRNGKey(0))
    values = jax.tree.map(np.asarray, values)
    model = lm_params_from_reference(values, tcfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, prompt)).astype(np.int32)
    jl, jc = jlm.prefill(values, jcfg, jnp.asarray(prompts), cache_len=prompt + gen)
    tl, tc = model.prefill(torch.from_numpy(prompts).long(), cache_len=prompt + gen)
    errs, scale, same, fed, want = [], 0.0, [], [], []
    for i in range(gen + 1):
        jn, tn = np.asarray(jl), to_numpy(tl)
        assert tn.shape == (B, jcfg.padded_vocab) and tn.dtype == np.float32
        errs.append(np.abs(jn - tn).max())
        scale = max(scale, np.abs(jn[:, :jcfg.vocab_size]).max())
        same.append(bool((jn.argmax(-1) == tn.argmax(-1)).all()))
        want.append(jn)
        if i == gen:
            break
        tok = jn.argmax(-1)[:, None].astype(np.int32)
        fed.append(tok)
        jl, jc = jlm.decode_step(values, jcfg, jnp.asarray(tok), jc, prompt + i)
        tl, tc = model.decode_step(torch.from_numpy(tok).long(), tc, prompt + i)

    def self_spread():
        with jax.disable_jit():
            el, ec = jlm.prefill(values, jcfg, jnp.asarray(prompts), cache_len=prompt + gen)
            out = [np.abs(want[0] - np.asarray(el)).max()]
            for i, tok in enumerate(fed):
                el, ec = jlm.decode_step(values, jcfg, jnp.asarray(tok), ec, prompt + i)
                out.append(np.abs(want[i + 1] - np.asarray(el)).max())
        return max(out)

    return max(errs), scale, all(same), self_spread


# (prompt, gen): prompt + gen past the window (16), and a prompt past it.
LENGTHS = [(12, 6), (20, 4)]


@pytest.mark.parametrize("prompt,gen", LENGTHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_matches_reference_f32(arch, prompt, gen):
    """f32 with f32 probabilities: logits within 1e-4, same greedy tokens."""
    err, _, same, _ = _serve_both(arch, prompt, gen, dtype="float32",
                                  attn_probs_bf16=False)
    assert err <= 1e-4, err
    assert same


@pytest.mark.parametrize("prompt,gen", LENGTHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_matches_reference_f32_bf16_probs(arch, prompt, gen):
    """f32 with bf16 probabilities: within 2^-8 of the largest logit."""
    err, scale, _, _ = _serve_both(arch, prompt, gen, dtype="float32")
    assert err <= 2.0 ** -8 * scale, (err, scale)


@pytest.mark.parametrize("prompt,gen", LENGTHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_matches_reference_bf16(arch, prompt, gen):
    """bf16 (the configs' dtype): within 2^-5 of the largest logit, or
    within the reference's own spread (compiled against op by op) where
    that is wider (module docstring)."""
    err, scale, _, self_spread = _serve_both(arch, prompt, gen)
    if err > BF16_BAR * scale:
        spread = self_spread()
        assert err <= spread, (err, scale, spread)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch, dtype):
    """The port's golden test: prefill of 16 tokens then decode to 24
    reproduces its own train-mode forward within 1e-4
    (``tests/test_serving.py:59-64``); the window is 16, so decode runs
    past it.  In f32 the probabilities are f32 too (see
    ``test_torch_lm.py::_golden_errors``)."""
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=dtype,
                              attn_probs_bf16=dtype == "bfloat16")
    model = build(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    s, prompt = 24, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, s), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full, _ = model(tokens, mode="train")
    last, cache = model.prefill(tokens[:, :prompt], cache_len=s)
    errs = [(last - full[:, prompt - 1]).abs().max().item()]
    for t in range(prompt, s):
        logit, cache = model.decode_step(tokens[:, t:t + 1], cache, t)
        errs.append((logit - full[:, t]).abs().max().item())
    assert max(errs) < 1e-4, errs


def test_long_decode_past_small_window_matches_forward():
    """The reference's ``test_local_attention_ring_buffer_long_decode`` on
    the port: 3 layers, window 8, prefill 16 and decode to 40, three
    windows past the prompt, against the train-mode forward (1e-4, f32)."""
    cfg = dataclasses.replace(get_reduced_config(HYBRID), num_layers=3, window_size=8,
                              dtype="float32", attn_probs_bf16=False)
    model = build(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full, _ = model(tokens, mode="train")
    _, cache = model.prefill(tokens[:, :16], cache_len=40)
    assert cache[2]["k"].shape[2] == 8 and cache[0]["h"].shape == (B, 64)
    for t in range(16, 40):
        logit, cache = model.decode_step(tokens[:, t:t + 1], cache, t)
        assert (logit - full[:, t]).abs().max().item() < 1e-4, t


def test_caches_per_kind():
    """One cache per block of its kind; only full attention grows with
    the serving length."""
    model = build(get_reduced_config(HYBRID), device="cpu")
    cache = model.init_cache(3, 100)
    assert [blk.kind for blk in model.blocks] == ["rglru", "rglru", "local_attn",
                                                 "rglru", "rglru"]
    assert set(cache[0]) == {"h", "conv"} and cache[0]["h"].shape == (3, 64)
    assert cache[0]["conv"].shape == (3, 3, 64) and cache[0]["h"].dtype == torch.float32
    assert cache[2]["k"].shape == (3, 1, 16, 16) and cache[2]["k"].dtype == torch.bfloat16
    assert model.attention_blocks == 1
    ssm = build(get_reduced_config(SSM), device="cpu")
    c = ssm.init_cache(3, 100)[0]
    assert c["s"].shape == (3, 8, 16, 16) and c["conv"].shape == (3, 3, 128)
    assert ssm.attention_blocks == 0


# ------------------------------------------------- configs, parameters ----
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for got, want in ((get_config(arch), ref_config(arch)),
                      (get_reduced_config(arch), ref_reduced_config(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.stages() == want.stages()


@pytest.mark.parametrize("arch,leaves", [(HYBRID, 3_549_795_840), (SSM, 368_236_032)])
def test_full_config_parameter_counts(arch, leaves):
    """``param_count`` equals the reference's, and the full LM's tensors
    (built on the meta device: nothing allocated) hold as many numbers
    as the reference's ``abstract_params``: 3,549,795,840 and
    368,236,032 (mamba2's tied, padded embedding, conv and dt_bias are
    outside ``param_count``)."""
    cfg = get_config(arch)
    assert param_count(cfg) == jconfig.param_count(ref_config(arch))
    model = LM(cfg, device="meta")
    values, _ = abstract_params(ref_config(arch))
    ref_total = sum(math.prod(v.shape) for v in jax.tree.leaves(values))
    assert sum(p.numel() for p in model.parameters()) == ref_total == leaves
    assert len(model.blocks) == cfg.num_layers
    assert model.attention_blocks == (8 if arch == HYBRID else 0)


def test_new_leaves_init_distribution():
    """Fan-in truncated normals (the conv's fan-in is its width K = 4),
    ``lam = linspace(2.2, 6.9, w)``, ``a_log = log(linspace(1, 16, H))``,
    ``dt_bias`` zeros, ``dskip`` ones (``init_rglru``, ``init_ssd``)."""
    sigma = 0.8796256610342398  # std of N(0, 1) truncated to [-2, 2]
    cfg = dataclasses.replace(get_reduced_config(HYBRID), d_model=256, lru_width=256,
                              num_heads=4)
    rg = build(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).blocks[0].mixer
    for w, fan_in in ((rg.wx, 256), (rg.wa, 256), (rg.wo, 256), (rg.conv, 4)):
        std = w.float().std().item() * fan_in ** 0.5
        assert abs(std - sigma) < 0.05, std
        assert w.float().abs().max().item() <= 2.0 / fan_in ** 0.5 * (1 + 2 ** -8)
    np.testing.assert_allclose(_np(rg.lam), np.linspace(2.2, 6.9, 256), atol=1e-6)
    ssd = build(get_reduced_config(SSM), device="cpu").blocks[0].mixer
    np.testing.assert_allclose(_np(ssd.a_log), np.log(np.linspace(1, 16, 8)), atol=1e-6)
    assert not ssd.dt_bias.any() and bool((ssd.dskip == 1).all())
    for w, fan_in in ((ssd.wx, 64), (ssd.wb, 64), (ssd.wo, 128)):
        assert w.float().abs().max().item() <= 2.0 / fan_in ** 0.5 * (1 + 2 ** -8)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_used_leaves_stay_f32(arch):
    """Under bf16 parameters the leaves the reference uses in f32 stay
    f32 (RG-LRU wa, wi, lam; SSD wb, wc, wdt, a_log, dt_bias, dskip), as
    the norms do; the projections take the parameter dtype."""
    model = build(get_reduced_config(arch), device="cpu")
    f32 = {"wa", "wi", "lam", "wb", "wc", "wdt", "a_log", "dt_bias", "dskip"}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if "mixer" in name and leaf in f32 or "norm" in name:
            assert p.dtype == torch.float32, name
        else:
            assert p.dtype == torch.bfloat16, name


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_leaves_cover_the_model(arch):
    """Every port parameter has a reference leaf of its shape, every
    reference leaf a port parameter, and split / join round-trip the
    reference's flattened tree."""
    jcfg, tcfg = _cfgs(arch)
    values, _ = init_split(jcfg, jax.random.PRNGKey(0))
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(values)[0]}
    leaves = reference_leaves(tcfg)
    model = build(tcfg, device="cpu")
    params = dict(model.named_parameters())
    assert set(leaves) == set(params)
    assert {leaf.path for leaf in leaves.values()} == set(flat)
    for name, leaf in leaves.items():
        assert flat[leaf.path].shape == leaf.shape, name
    named = split_reference(flat, tcfg)
    assert {k: v.shape for k, v in named.items()} == {k: tuple(p.shape)
                                                      for k, p in params.items()}
    back = join_reference(named, tcfg)
    assert set(back) == set(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr)


# ------------------------------------------------------------- launcher ----
@pytest.mark.parametrize("arch,blocks", [(HYBRID, 1), (SSM, 0)])
def test_cli_serves_recurrent_archs_on_cpu(arch, blocks):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--device",
         "cpu", "--batch", "2", "--prompt-len", "20", "--gen", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "generated token matrix: (2, 3)"
    stats = dict(line.split(": ", 1) for line in lines[2:])
    assert stats["config"].startswith(f"{arch} layers=")
    assert stats["attention_blocks"] == str(blocks)
    assert stats["flash_launches_prefill"] == "0"  # the CPU runs the plain version


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("eigen", [False, True], ids=["baseline", "eigen"])
def test_cli_trains_recurrent_archs_on_cpu(arch, eigen):
    """``python -m repro_torch.launch.train --device cpu --arch ...`` trains
    both recurrent families at their reduced configs, AdamW and the
    eigen-compressed step (``test_torch_recurrent_train.py`` holds both
    against the reference)."""
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch",
         arch, "--steps", "2", "--batch", "4", "--seq", "24", *(["--eigen"] if eigen else [])],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    stats = dict(line.split(": ", 1) for line in proc.stdout.splitlines() if ": " in line)
    assert stats["device"] == "cpu" and stats["eigen"] == str(eigen)
    assert stats["config"].startswith(f"{arch} (") and stats["losses"] == "2"
    assert math.isfinite(float(stats["final_loss_exact"]))


def test_serve_is_seeded():
    toks, stats = tserve.serve(SSM, batch=2, prompt_len=9, gen=4, device="cpu")
    again, _ = tserve.serve(SSM, batch=2, prompt_len=9, gen=4, device="cpu")
    assert toks.shape == (2, 4) and torch.equal(toks, again)
    assert stats["attention_blocks"] == 0

"""Port parity of the MoE family on the CPU: qwen3-moe-30b-a3b and
kimi-k2-1t-a32b (``repro/models/layers.py:313-464``, ``lm.py:165-166``).

The same seeded numpy inputs, and the reference's own parameters, go
through the reference's functions and the port's modules, at the reduced
configs (8 experts, top-2, d_model 64, d_ff 32).  Bars (each test's
docstring repeats its own):

  * ``moe_capacity`` and both forms' capacities: equal.
  * one MoE layer against ``apply_moe_einsum`` / ``apply_moe_sort``, with
    drops (asserted) and at ``capacity_factor=100`` (none): f32 within
    1e-5 abs and the aux loss within 1e-6; bf16 within one bf16 step at
    the output's largest magnitude; the experts equal.  Every token's
    k-th and (k+1)-th router probabilities differ by more than 1e-6, so
    a failure there is not a tie broken two ways.
  * both LMs served (prefill, then greedy decode fed the reference's
    tokens), at a prompt that drops and one that does not: the dense
    family's bars of ``test_torch_lm.py`` (f32 with f32 probabilities
    1e-4 and the same greedy tokens; bf16 2^-5 of the largest logit).
  * the port's own golden test: prefill plus decode reproduces its
    train-mode forward within 1e-4 where nothing is dropped.
  * ``loss_fn``'s CE and aux against the reference's metrics in f32: aux
    within 1e-6, CE and the loss within 1e-6 relative (a CE of ~6.7 is
    ~14 f32 steps of 4.8e-7; the two logsumexps over 512 entries sum in
    other orders).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
from repro_torch.models import LM, build, loss_fn, param_count
from repro_torch.models import layers as TL

QWEN, KIMI = "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"
ARCHS = [QWEN, KIMI]
B = 2
MARGIN = 1e-6
NO_DROP = 100.0  # capacity_factor at which no expert overflows


def _cfgs(arch, **overrides):
    return (dataclasses.replace(ref_reduced_config(arch), **overrides),
            dataclasses.replace(get_reduced_config(arch), **overrides))


def _margin(mod, x):
    """The smallest gap between a token's k-th and (k+1)-th router
    probabilities (f32, as the router computes them)."""
    k = mod.cfg.num_experts_per_token
    probs = torch.softmax(x.float() @ mod.router.float(), dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    return (top[..., k - 1] - top[..., k]).min().item()


# ------------------------------------------------------------- capacity ----
@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_capacity_matches_reference(arch, full):
    """Per-row capacity equal to the reference's at s in {1, 7, 64, 4095,
    4096}; qwen3's full config gives 320, 320, 20 and 4 at s = 4096, 4095,
    256 and 1 (decode)."""
    jcfg = ref_config(arch) if full else ref_reduced_config(arch)
    tcfg = get_config(arch) if full else get_reduced_config(arch)
    for s in (1, 7, 64, 4095, 4096):
        assert TL.moe_capacity(tcfg, s) == JL.moe_capacity(jcfg, s), s
    if arch == QWEN and full:
        assert [TL.moe_capacity(tcfg, s) for s in (4096, 4095, 256, 1)] == [320, 320, 20, 4]


# ------------------------------------------------------------ one layer ----
def _layer(arch, impl, dtype, cf, s=64, seed=0):
    """(reference out, aux, experts; port out, aux, routing; margin) of
    one MoE layer on the same parameters and x (B, s, d)."""
    jcfg, tcfg = _cfgs(arch, moe_impl=impl, capacity_factor=cf, dtype=dtype)
    values, _ = JL.split_params(JL.init_moe(jax.random.PRNGKey(seed), jcfg))
    values = jax.tree.map(np.asarray, values)
    mod = TL.MoE(tcfg, dtype=getattr(torch, dtype))
    with torch.no_grad():
        for name, arr in values.items():
            getattr(mod, name).copy_(torch.from_numpy(np.array(arr, np.float32)))
    x = np.random.default_rng(seed + 1).standard_normal((B, s, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    fn = JL.apply_moe_sort if impl == "sort" else JL.apply_moe_einsum
    jout, jaux = fn(values, jcfg, jx)
    probs = jax.nn.softmax(jnp.einsum("bsm,me->bse", jx.astype(jnp.float32),
                                      jnp.asarray(values["router"])), axis=-1)
    _, jexperts = jax.lax.top_k(probs, jcfg.num_experts_per_token)
    with torch.no_grad():
        tout, taux = mod(tx)
        rt = mod.routing(tx)
        margin = _margin(mod, tx)
    return (np.asarray(jout, np.float32), float(jaux), np.asarray(jexperts),
            to_numpy(tout), float(taux), rt, margin)


@pytest.mark.parametrize("cf", [1.25, NO_DROP])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(arch, impl, dtype, cf):
    """One MoE layer, (2, 64) tokens, against the reference's form of the
    same name: the experts equal, drops at the config's capacity factor
    (asserted) and none at 100; f32 out within 1e-5, bf16 within one
    bf16 step at the output's largest magnitude; aux within 1e-6."""
    jout, jaux, jexp, tout, taux, rt, margin = _layer(arch, impl, dtype, cf)
    assert margin > MARGIN, margin
    np.testing.assert_array_equal(rt.experts.numpy(), jexp)
    drops = int((~rt.keep).sum())
    assert (drops > 0) if cf != NO_DROP else (drops == 0), drops
    assert tout.shape == jout.shape
    scale = np.abs(jout).max()
    bar = 1e-5 if dtype == "float32" else 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert np.abs(tout - jout).max() <= bar, (np.abs(tout - jout).max(), bar)
    assert abs(taux - jaux) <= 1e-6, (taux, jaux)


def test_moe_capacity_of_each_form():
    """The einsum form takes ``moe_capacity`` per row, the sort form one
    capacity over the B*S token group, ``max(4, int(cf B S k / e + 3) //
    4 * 4)``."""
    _, tcfg = _cfgs(QWEN)
    x = torch.randn(3, 40, tcfg.d_model, generator=torch.Generator().manual_seed(0))
    for impl, groups, cap in (("einsum", 3, TL.moe_capacity(tcfg, 40)),
                              ("sort", 1, max(4, int(1.25 * 120 * 2 / 8 + 3) // 4 * 4))):
        mod = build(dataclasses.replace(tcfg, moe_impl=impl), device="cpu").blocks[0].mlp
        rt = mod.routing(x)
        assert (rt.groups, rt.cap) == (groups, cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forms_agree_without_drops(dtype):
    """At ``capacity_factor=100`` nothing is dropped and the two forms are
    one function (``tests/test_invariants.py::test_moe_sort_equals_einsum_
    no_drop``): f32 within 1e-6; in bf16 they round the combine at
    different points, so within one bf16 step at the largest magnitude."""
    _, tcfg = _cfgs(KIMI, capacity_factor=NO_DROP, dtype=dtype)
    einsum = build(tcfg, device="cpu", generator=torch.Generator().manual_seed(2)).blocks[0].mlp
    sort = TL.MoE(dataclasses.replace(tcfg, moe_impl="sort"), dtype=getattr(torch, dtype))
    sort.load_state_dict(einsum.state_dict())
    x = torch.randn(B, 48, tcfg.d_model, generator=torch.Generator().manual_seed(3))
    x = x.to(getattr(torch, dtype))
    with torch.no_grad():
        out_e, aux_e = einsum(x)
        out_s, aux_s = sort(x)
    scale = out_e.float().abs().max().item()
    bar = 1e-6 if dtype == "float32" else 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert (out_e.float() - out_s.float()).abs().max().item() <= bar
    assert aux_e.item() == aux_s.item()


@settings(max_examples=25, deadline=None)
@given(e=st.integers(2, 8), k=st.integers(1, 3), s=st.integers(1, 24),
       cf=st.sampled_from([0.25, 0.5, 1.0, 1.25]), impl=st.sampled_from(["einsum", "sort"]),
       seed=st.integers(0, 2 ** 16))
def test_moe_kept_pairs_are_gate_weighted_and_dropped_ones_zero(e, k, s, cf, impl, seed):
    """Against an oracle written out token by token (f64): a pair is kept
    when fewer than ``cap`` pairs before it, in token-major then k order
    within its group (a row, or the whole batch for the sort form), went
    to its expert; each token's output is the sum over its kept pairs of
    gate x its expert's SwiGLU of the token, so a dropped pair adds
    nothing and a token with none kept gives zero."""
    k = min(k, e)
    cfg = dataclasses.replace(get_reduced_config(QWEN), num_experts=e,
                              num_experts_per_token=k, capacity_factor=cf,
                              moe_impl=impl, dtype="float32", d_model=16, d_ff=8)
    gen = torch.Generator().manual_seed(seed)
    mod = build(cfg, device="cpu", generator=gen).blocks[0].mlp
    x = torch.randn(B, s, cfg.d_model, generator=gen)
    with torch.no_grad():
        out, _ = mod(x)
        rt = mod.routing(x)
    experts, gates = rt.experts.numpy(), rt.gates.numpy().astype(np.float64)
    xd = x.double().numpy()
    wi, wg, wo = (p.detach().double().numpy() for p in (mod.wi, mod.wg, mod.wo))
    want = np.zeros((B, s, cfg.d_model))
    seen = {}
    for b in range(B):
        if impl == "einsum":
            seen = {}
        for t in range(s):
            for j in range(k):
                ex = experts[b, t, j]
                place = seen.get(ex, 0)
                seen[ex] = place + 1
                assert bool(rt.keep[b, t, j]) == (place < rt.cap)
                if place < rt.cap:
                    g, h = xd[b, t] @ wg[ex], xd[b, t] @ wi[ex]
                    want[b, t] += gates[b, t, j] * ((g / (1 + np.exp(-g)) * h) @ wo[ex])
    np.testing.assert_allclose(out.double().numpy(), want, atol=1e-5, rtol=0)


# ------------------------------------------------------ the LMs, served ----
def _watch(model):
    """Forward hooks on every MoE layer that record its drops and its
    smallest k / (k+1) router margin; returns (record, handles)."""
    rec = {"drops": 0, "margin": math.inf}

    def hook(mod, inp, _out):
        rt = mod.routing(inp[0])
        rec["drops"] += int((~rt.keep).sum())
        rec["margin"] = min(rec["margin"], _margin(mod, inp[0]))

    return rec, [blk.mlp.register_forward_hook(hook) for blk in model.blocks]


def _serve_both(arch, prompt, gen, **overrides):
    """Prefill ``prompt`` tokens then ``gen`` greedy decode steps in both
    packages, both fed the reference's tokens.  Returns (max abs logit
    error, largest logit, greedy tokens equal at every step, the port's
    drops, its smallest router margin)."""
    jcfg, tcfg = _cfgs(arch, **overrides)
    values, _ = init_split(jcfg, jax.random.PRNGKey(0))
    values = jax.tree.map(np.asarray, values)
    model = lm_params_from_reference(values, tcfg, device="cpu")
    rec, handles = _watch(model)
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, prompt)).astype(np.int32)
    jl, jc = jlm.prefill(values, jcfg, jnp.asarray(prompts), cache_len=prompt + gen)
    tl, tc = model.prefill(torch.from_numpy(prompts).long(), cache_len=prompt + gen)
    errs, scale, same = [], 0.0, []
    for i in range(gen + 1):
        jn, tn = np.asarray(jl), to_numpy(tl)
        assert tn.shape == (B, jcfg.padded_vocab) and tn.dtype == np.float32
        errs.append(np.abs(jn - tn).max())
        scale = max(scale, np.abs(jn[:, :jcfg.vocab_size]).max())
        same.append(bool((jn.argmax(-1) == tn.argmax(-1)).all()))
        if i == gen:
            break
        tok = jn.argmax(-1)[:, None].astype(np.int32)
        jl, jc = jlm.decode_step(values, jcfg, jnp.asarray(tok), jc, prompt + i)
        tl, tc = model.decode_step(torch.from_numpy(tok).long(), tc, prompt + i)
    for h in handles:
        h.remove()
    return max(errs), scale, all(same), rec["drops"], rec["margin"]


@pytest.mark.parametrize("cf", [1.25, NO_DROP])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_matches_reference_f32(arch, cf):
    """f32 with f32 probabilities, a 24-token prompt and 5 decode steps:
    logits within 1e-4, the same greedy tokens; the prefill drops pairs
    at the config's capacity factor and none at 100."""
    err, _, same, drops, margin = _serve_both(arch, 24, 3, dtype="float32",
                                              attn_probs_bf16=False, capacity_factor=cf)
    assert margin > MARGIN, margin
    assert (drops > 0) if cf != NO_DROP else (drops == 0), drops
    assert err <= 1e-4, err
    assert same


@pytest.mark.parametrize("cf", [1.25, NO_DROP])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_matches_reference_bf16(arch, cf):
    """bf16 (the configs' dtype): within 2^-5 of the largest logit."""
    err, scale, _, drops, margin = _serve_both(arch, 24, 3, capacity_factor=cf)
    assert margin > MARGIN, margin
    assert (drops > 0) if cf != NO_DROP else (drops == 0), drops
    assert err <= 2.0 ** -5 * scale, (err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_sort_form_matches_reference(arch):
    """The sort form served in f32 (f32 probabilities) with drops: logits
    within 1e-4, the same greedy tokens."""
    err, _, same, drops, margin = _serve_both(arch, 24, 3, dtype="float32",
                                              attn_probs_bf16=False, moe_impl="sort")
    assert margin > MARGIN and drops > 0, (margin, drops)
    assert err <= 1e-4, err
    assert same


def test_deep_lm_with_collapsed_routing_matches_reference():
    """qwen3's blocks at a mid width (6 layers, d_model 256, 32 experts
    top-8, d_ff 64) in f32 over 2 x 256 tokens: with random weights the
    routing concentrates on a few experts as depth grows (the full config
    drops 82 % of its pairs on the card, PERF.md §6), here over 40 % of
    the pairs in the last layer; the prefill's logits stay within 1e-4 of
    the reference's."""
    kw = dict(num_layers=6, d_model=256, num_heads=4, num_kv_heads=1, d_ff=64,
              vocab_size=1024, num_experts=32, dtype="float32", attn_probs_bf16=False)
    jcfg = dataclasses.replace(ref_config(QWEN), **kw)
    tcfg = dataclasses.replace(get_config(QWEN), **kw)
    values, _ = init_split(jcfg, jax.random.PRNGKey(0))
    values = jax.tree.map(np.asarray, values)
    model = lm_params_from_reference(values, tcfg, device="cpu")
    shares = []
    for blk in model.blocks:
        blk.mlp.register_forward_hook(
            lambda m, i, o: shares.append((~m.routing(i[0]).keep).float().mean().item()))
    prompts = np.random.default_rng(0).integers(0, 1024, (B, 256)).astype(np.int32)
    want, _ = jlm.prefill(values, jcfg, jnp.asarray(prompts))
    got, _ = model.prefill(torch.from_numpy(prompts).long())
    assert shares[-1] > 0.4, shares
    assert np.abs(np.asarray(want) - to_numpy(got)).max() <= 1e-4


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch, dtype):
    """The port's golden test (``tests/test_serving.py:59-64``) where
    nothing is dropped (``capacity_factor=100``; with drops a longer
    forward has more slots than a short prefill, another function):
    prefill of 16 tokens then decode to 24 reproduces the train-mode
    forward within 1e-4."""
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=dtype, capacity_factor=NO_DROP,
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


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch, impl):
    """``loss_fn`` in f32 on the reference's parameters: aux (summed over
    the 2 MoE layers) within 1e-6 of the reference's, ce and the loss
    (ce + 0.01 aux) within 1e-6 relative."""
    jcfg, tcfg = _cfgs(arch, dtype="float32", attn_probs_bf16=False, moe_impl=impl)
    values, _ = init_split(jcfg, jax.random.PRNGKey(0))
    values = jax.tree.map(np.asarray, values)
    model = lm_params_from_reference(values, tcfg, device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (B, 32)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, 32)).astype(np.int32)
    jloss, jm = jlm.loss_fn(values, jcfg, {"tokens": jnp.asarray(tokens),
                                           "labels": jnp.asarray(labels)})
    tloss, tm = loss_fn(model, {"tokens": torch.from_numpy(tokens).long(),
                                "labels": torch.from_numpy(labels).long()})
    assert abs(tm["aux"].item() - float(jm["aux"])) <= 1e-6
    assert tm["aux"].item() > 1.0  # two layers' aux, each about 1
    for got, want in ((tm["ce"], jm["ce"]), (tloss, jloss)):
        assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want)), (got, want)


# ----------------------------------------- configs, counts, init, leaves ----
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for got, want in ((get_config(arch), ref_config(arch)),
                      (get_reduced_config(arch), ref_reduced_config(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.stages() == want.stages()


@pytest.mark.parametrize("arch,leaves", [(QWEN, 30_079_649_792),
                                         (KIMI, 1_041_166_988_288)])
def test_full_config_parameter_counts(arch, leaves):
    """``param_count`` equals the reference's, and the full LM's tensors
    (built on the meta device: nothing allocated) hold as many numbers as
    the reference's ``abstract_params``: ``param_count`` plus the padded
    vocab rows of the embedding and the unembedding."""
    cfg = get_config(arch)
    assert param_count(cfg) == jconfig.param_count(ref_config(arch))
    model = LM(cfg, device="meta")
    values, _ = abstract_params(ref_config(arch))
    ref_total = sum(math.prod(v.shape) for v in jax.tree.leaves(values))
    assert sum(p.numel() for p in model.parameters()) == ref_total == leaves
    assert ref_total == param_count(cfg) + 2 * (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model
    assert len(model.blocks) == model.attention_blocks == cfg.num_layers


def test_init_follows_reference_distribution():
    """``router`` (d, e) and ``wi`` / ``wg`` (e, d, f) with fan-in d, ``wo``
    (e, f, d) with fan-in f (``_dense_init(..., in_axis=1)``): a standard
    normal truncated to [-2, 2] times 1/sqrt(fan-in), std 0.8796 /
    sqrt(fan-in); the router stored in f32, the experts in the config's
    dtype."""
    cfg = dataclasses.replace(get_reduced_config(QWEN), d_model=256, d_ff=128, num_experts=16)
    mlp = build(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).blocks[0].mlp
    sigma = 0.8796256610342398  # std of N(0, 1) truncated to [-2, 2]
    assert mlp.router.dtype == torch.float32 and mlp.wi.dtype == torch.bfloat16
    for w, fan_in in ((mlp.router, cfg.d_model), (mlp.wi, cfg.d_model),
                      (mlp.wg, cfg.d_model), (mlp.wo, cfg.d_ff)):
        std = w.float().std().item() * fan_in ** 0.5
        assert abs(std - sigma) < 0.02, std
        assert w.float().abs().max().item() <= 2.0 / fan_in ** 0.5 * (1 + 2 ** -8)
    assert tuple(mlp.wi.shape) == (16, 256, 128) and tuple(mlp.wo.shape) == (16, 128, 256)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_leaves_cover_the_model(arch):
    """Every port parameter has a reference leaf of its shape (the stacked
    router (L, d, e), wi / wg (L, e, d, f), wo (L, e, f, d)), every
    reference leaf a port parameter, and split / join round-trip the
    reference's flattened tree."""
    jcfg, tcfg = _cfgs(arch)
    values, _ = init_split(jcfg, jax.random.PRNGKey(0))
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(values)[0]}
    leaves = reference_leaves(tcfg)
    params = dict(build(tcfg, device="cpu").named_parameters())
    assert set(leaves) == set(params)
    assert {leaf.path for leaf in leaves.values()} == set(flat)
    for name, leaf in leaves.items():
        assert flat[leaf.path].shape == leaf.shape, name
    assert leaves["blocks.1.mlp.wo"].shape == (2, 8, 32, 64)
    named = split_reference(flat, tcfg)
    assert {k: v.shape for k, v in named.items()} == {k: tuple(p.shape)
                                                      for k, p in params.items()}
    back = join_reference(named, tcfg)
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_trains_moe(arch):
    """The trainers take the MoE family: AdamW through ``launch.train.train``
    (a warm-up step at lr 0, then one step) and one eigen refresh and step
    through the step
    builders (2 stacked shards, rank 4: the router compressed), each with a
    finite loss, and every MoE leaf (router and experts) moved."""
    from repro_torch.launch import steps
    from repro_torch.launch.train import train
    from repro_torch.optim import EigenCompressConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.eigen_compress import draw_starts

    fresh = build(get_reduced_config(arch), device="cpu", param_dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0))
    # warmup 1: step 0 takes lr 0, step 1 the peak
    model, opt, losses = train(arch, steps=2, warmup=1, batch=2, seq=16, device="cpu")
    assert len(losses) == 2 and all(map(math.isfinite, losses)) and int(opt["step"]) == 2
    moved = dict(model.named_parameters())
    moe = [n for n in moved if ".mlp." in n]
    assert len(moe) == 4 * model.cfg.num_layers
    for name, p in fresh.named_parameters():
        if name in moe:
            assert not torch.equal(p, moved[name]), name

    model = build(get_reduced_config(arch), device="cpu", param_dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0))
    ecfg = EigenCompressConfig(rank=4, min_dim=64)
    opt = steps.eigen_opt_init(model, ecfg, 2)
    assert "blocks.0.mlp.router" in opt["eigen"] and "blocks.0.mlp.wi" not in opt["eigen"]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, model.cfg.vocab_size, (2, 16), generator=gen)
             for k in ("tokens", "labels")}
    steps.make_eigen_refresh_step(model, ecfg=ecfg, shards=2)(
        opt, batch, draw_starts(steps.start_shapes(opt), seed=1, step=0, device="cpu"))
    metrics = steps.make_eigen_train_step(model, adamw_cfg=AdamWConfig(),
                                          schedule=lambda s: 1e-3, shards=2)(opt, batch)
    assert math.isfinite(float(metrics["loss"]))
    for name, p in model.named_parameters():
        if name in moe:
            assert not torch.equal(p, before[name]), name

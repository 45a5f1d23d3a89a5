"""Port parity of the encoder-decoder (whisper-tiny: bidirectional
encoder over stub frame embeddings, causal decoder with cross-attention)
on the CPU, serving and training.

The reference's parameters cross into the port's ``EncDec`` through
``interop.lm_params_from_reference``; tokens come from the token
pipeline, frames (B, S_ENC, d_model) from a numpy generator seeded by
(SEED, step) (``frames_at``).  Two variants of the reduced config:
``encdec-f32`` (f32 with f32 attention probabilities) and
``encdec-bf16`` (the reduced config as it is).

The reference runs in this process for the forward, loss, gradients and
serving, and once for the module in one subprocess on 4 fake CPU devices
for its eigen trainer on 4 data shards (batches with frames, every state
before and after each refresh and step and each shard's gradients at
each refresh saved; ``test_torch_train.py``'s teacher-forced check).
Its launcher does not train whisper (its pipeline gives no frames), and
neither does the port's (``test_train_cli_refuses_whisper``).

Bars:
  * forward (encoder states, decoder logits) and loss: f32 within 1e-5
    of their largest magnitude (loss relative); bf16 within 2^-5 of
    their largest magnitude, loss 2e-3 relative (the dense family's);
  * gradients against ``jax.grad``: f32 1e-5 (loss) / 1e-4 (relative L2
    of every leaf), bf16 2e-3 / 5e-2;
  * serving: the port's prefill (frames encoded once, the prompt's self
    K/V and the cross K/V cached) and teacher-forced decode steps
    (reusing the cross cache) against the reference's teacher-forced
    decoder logits: f32 within 1e-4, bf16 within 2^-5 of their largest
    magnitude; the port's own prefill + decode against its own forward
    within 1e-4;
  * the AdamW step (1e-4 relative L2 of every parameter) and the eigen
    steps teacher-forced (``_teacher_forced``'s bars with the
    reference's per-shard gradients; the decoder's untied embedding is
    left out of the refreshed bases, ill-posed on distinct rows as the
    dense family's).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as T
from conftest import REPO, SRC, run_with_devices
from repro.configs import get_config as ref_config
from repro.configs import get_reduced_config as ref_reduced_config
from repro.launch.steps import compressed_paths as ref_compressed_paths
from repro.models import encdec as jed
from repro.models import init_split
from repro.models.registry import abstract_params
from repro.models.registry import build as ref_build
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.eigen_compress import EigenCompressConfig as RefECfg
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.interop import (
    decays,
    join_reference,
    lm_params_from_reference,
    opt_state_from_reference,
    opt_state_to_reference,
    reference_leaves,
    to_numpy,
)
from repro_torch.launch import steps as tsteps
from repro_torch.models import EncDec, build, loss, param_count
from repro_torch.models import encdec as ted
from repro_torch.models import layers as TL
from repro_torch.optim import eigen_compress as EC
from repro_torch.optim.adamw import AdamWConfig, adamw_init

ARCH = "whisper-tiny"
B, S, SEED, PROMPT, S_ENC = T.B, T.S, T.SEED, 10, 24
TAGS = {"encdec-f32": T.F32, "encdec-bf16": {}}


def frames_at(cfg, step):
    """The frames of the batch at ``step`` (the reference's run builds
    the same)."""
    rng = np.random.default_rng([SEED, step])
    return {"frames": rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)}


REF_CODE = r'''
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_reduced_config
from repro.data.tokens import TokenPipeline
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import eigen_opt_init, jit_eigen_steps
from repro.models import init_split
from repro.models.registry import build
from repro.optim.adamw import AdamWConfig
from repro.optim.eigen_compress import EigenCompressConfig
from repro.optim.schedule import warmup_cosine

OUT, B, S, S_ENC, SEED = {out!r}, {B}, {S}, {S_ENC}, {SEED}
ARCH, KW, EIGEN = {arch!r}, {kw!r}, {eigen!r}
out = {{}}


def put(prefix, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(k)] = np.asarray(v, np.float32)


def frames_at(cfg, step):
    rng = np.random.default_rng([SEED, step])
    return {{"frames": rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)}}


def save_state(prefix, params, opt):
    put(prefix + "params", params)
    for path, st in opt["eigen"].items():
        for f, v in st.items():
            out[f"{{prefix}}eigen/{{f}}/{{path}}"] = np.asarray(v)
    for f in ("full_m", "full_v"):
        for path, v in opt[f].items():
            out[f"{{prefix}}{{f}}/{{path}}"] = np.asarray(v)
    out[prefix + "step"] = np.asarray(opt["step"])


cfg = dataclasses.replace(get_reduced_config(ARCH), **KW)
mesh = make_host_mesh(model=1)
ecfg = EigenCompressConfig(rank=EIGEN["eigen_rank"], refresh_every=EIGEN["eigen_refresh"],
                           min_dim=64)
values, axes = init_split(cfg, jax.random.PRNGKey(SEED))
values = jax.tree.map(np.asarray, values)
pipe = TokenPipeline(cfg.vocab_size, S, B, seed=SEED)


def batch(step):
    return {{**pipe.batch(step), **frames_at(cfg, step)}}


train_jit, refresh_jit, (ps, os_, bs) = jit_eigen_steps(
    cfg, mesh, values, axes, batch(0), adamw_cfg=AdamWConfig(),
    schedule=warmup_cosine(EIGEN["lr"], EIGEN["warmup"], EIGEN["steps"]), ecfg=ecfg)
opt = jax.device_put(eigen_opt_init(values, ecfg, 4, axes), os_)
params = jax.device_put(values, ps)
shard_grad = jax.jit(jax.grad(lambda v, b: build(cfg).loss(v, b)[0]))
key = jax.random.PRNGKey(SEED + 1)
losses = []
for step in range(EIGEN["steps"]):
    b = jax.device_put(batch(step), bs)
    save_state(f"distinct/state{{step}}/", params, opt)
    if step % ecfg.refresh_every == 0:
        for i in range(4):
            rows = {{k: jnp.asarray(v[i * B // 4:(i + 1) * B // 4])
                    for k, v in batch(step).items()}}
            put(f"distinct/grads{{step}}/{{i}}/", shard_grad(params, rows))
        key, sub = jax.random.split(key)
        k = step // ecfg.refresh_every
        keys = jax.random.split(sub, max(len(opt["eigen"]), 1))
        for i, (path, st) in enumerate(sorted(opt["eigen"].items())):
            shp = st["basis"].shape
            if len(shp) == 2:
                start = jax.random.normal(keys[i], shp, jnp.float32)
            else:
                kl = jax.random.split(keys[i], shp[0])
                start = jnp.stack([jax.random.normal(kl[l], shp[1:], jnp.float32)
                                   for l in range(shp[0])])
            out[f"eigen/starts{{k}}/{{path}}"] = np.asarray(start)
        opt = refresh_jit(params, opt, b, sub)
        save_state(f"distinct/refreshed{{step}}/", params, opt)
    params, opt, metrics = train_jit(params, opt, b)
    losses.append(float(metrics["loss"]))
save_state(f"distinct/state{{EIGEN['steps']}}/", params, opt)
out["distinct/losses"] = np.asarray(losses)
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread, so that the suite's other
    workers' threads do not stall this module's (and the reverse)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("encdec-ref") / "ref.npz"
    code = REF_CODE.format(out=str(path), B=B, S=S, S_ENC=S_ENC, SEED=SEED, arch=ARCH,
                           kw=T.F32, eigen=T.EIGEN)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", " ".join(
            [os.environ.get("XLA_FLAGS", ""), "--xla_cpu_multi_thread_eigen=false"]).strip())
        run_with_devices(code, n_devices=4)
    with np.load(path) as data:
        return dict(data)


def _cfgs(tag):
    jcfg = dataclasses.replace(ref_reduced_config(ARCH), **TAGS[tag])
    tcfg = dataclasses.replace(get_reduced_config(ARCH), name=tag, **TAGS[tag])
    return jcfg, tcfg


def _pair(tag, param_dtype=torch.float32):
    jcfg, tcfg = _cfgs(tag)
    values = jax.tree.map(np.asarray, init_split(jcfg, jax.random.PRNGKey(SEED))[0])
    return jcfg, values, lm_params_from_reference(values, tcfg, device="cpu",
                                                  param_dtype=param_dtype)


def _batches(cfg, step=0):
    """(reference batch, port batch): the pipeline's tokens at ``step``
    and ``frames_at``."""
    arrays = {**T.TokenPipeline(cfg.vocab_size, S, B, seed=SEED).batch(step),
              **frames_at(cfg, step)}
    port = {k: torch.from_numpy(v).long() if v.dtype.kind in "iu" else torch.from_numpy(v)
            for k, v in arrays.items()}
    return {k: jnp.asarray(v) for k, v in arrays.items()}, port


def _scaled(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -------------------------------------------------------- model parity ----
@pytest.mark.parametrize("tag,bar,loss_bar", [
    ("encdec-f32", 1e-5, 1e-5), ("encdec-bf16", 2.0 ** -5, 2e-3)])
def test_forward_and_loss_match_reference(tag, bar, loss_bar):
    """The encoder's states (bidirectional, S_enc = 24 frames) and the
    decoder's teacher-forced logits over them, and the loss."""
    jcfg, values, model = _pair(tag)
    jb, tb = _batches(jcfg)

    @jax.jit
    def ref_forward(v, b):
        enc = jed.encode(v, jcfg, b["frames"])
        return enc, jed.decode(v, jcfg, b["tokens"], enc_out=enc)[0], jed.loss_fn(v, jcfg, b)[0]

    want_enc, want, want_loss = ref_forward(values, jb)
    with torch.no_grad():
        enc = model.encode(tb["frames"])
        got, _ = model.decode(tb["tokens"], enc_out=enc)
        got_loss, _ = loss(model, tb)
    assert enc.shape == (B, S_ENC, jcfg.d_model) and got.shape == (B, S, jcfg.padded_vocab)
    vocab = jcfg.vocab_size
    errs = (_scaled(to_numpy(enc), np.asarray(want_enc, np.float32)),
            _scaled(to_numpy(got)[..., :vocab], np.asarray(want)[..., :vocab]),
            abs(float(got_loss) - float(want_loss)) / float(want_loss))
    print(f"{tag}: encoder states {errs[0]:.3g}, logits {errs[1]:.3g} of their largest "
          f"magnitude, loss {errs[2]:.3g} relative")
    assert errs[0] <= bar and errs[1] <= bar and errs[2] <= loss_bar


@pytest.mark.parametrize("tag,loss_bar,grad_bar", [
    ("encdec-f32", 1e-5, 1e-4), ("encdec-bf16", 2e-3, 5e-2)])
def test_gradients_match_reference(tag, loss_bar, grad_bar):
    """Every leaf's gradient, through the encoder (plain bidirectional
    attention: a gradient is taken), the cross-attention and the decoder,
    against ``jax.grad``."""
    jcfg, values, model = _pair(tag)
    jb, tb = _batches(jcfg)
    (want_loss, _), want = jax.jit(jax.value_and_grad(ref_build(jcfg).loss, has_aux=True))(
        values, jb)
    want = _flat(want)
    params = dict(model.named_parameters())
    got_loss, _ = loss(model, tb)
    got = join_reference(dict(zip(params, torch.autograd.grad(got_loss, list(params.values())))),
                         model.cfg)
    assert set(got) == set(want)
    loss_err = abs(float(got_loss) - float(want_loss)) / float(want_loss)
    errs = {k: T._rel_l2(got[k], want[k]) for k in want}
    print(f"{tag}: loss {loss_err:.3g} relative, worst gradient {max(errs.values()):.3g} "
          f"relative L2")
    assert loss_err <= loss_bar
    assert max(errs.values()) <= grad_bar, errs


@functools.lru_cache(maxsize=None)
def _serve_errors(tag):
    """The port's prefill (frames, prompt) and teacher-forced decode
    steps: (errors against the reference's teacher-forced decoder
    logits, their largest magnitude, errors against the port's own
    forward)."""
    jcfg, values, model = _pair(tag, param_dtype=None)  # the config's dtype
    jb, tb = _batches(jcfg)
    cdt = getattr(torch, jcfg.dtype)
    want = jax.jit(lambda v, b: jed.decode(v, jcfg, b["tokens"], enc_out=jed.encode(
        v, jcfg, b["frames"]))[0])(values, jb)
    want = np.asarray(want)
    tokens, frames = tb["tokens"], tb["frames"].to(cdt)
    with torch.no_grad():
        own, _ = model.decode(tokens, enc_out=model.encode(frames))
    last, cache = model.prefill(frames, tokens[:, :PROMPT], cache_len=S)
    cross = [c["cross"]["k"] for c in cache]
    assert cross[0].shape == (B, jcfg.num_kv_heads, S_ENC, jcfg.head_dim)
    assert cache[0]["self"]["k"].shape[2] == S
    outs = [last]
    for t in range(PROMPT, S):
        logit, cache = model.decode_step(tokens[:, t:t + 1], cache, t)
        outs.append(logit)
    assert all(c["cross"]["k"] is k for c, k in zip(cache, cross))  # built once, reused
    vocab = jcfg.vocab_size
    errs, mine = [], []
    for i, t in enumerate(range(PROMPT - 1, S)):
        errs.append(np.abs(to_numpy(outs[i])[:, :vocab] - want[:, t, :vocab]).max())
        mine.append((outs[i] - own[:, t]).abs().max().item())
    return errs, np.abs(want[..., :vocab]).max(), mine


@pytest.mark.parametrize("tag,bar", [("encdec-f32", 1e-4), ("encdec-bf16", 2.0 ** -5)])
def test_serving_matches_reference_teacher_forced(tag, bar):
    errs, scale, _ = _serve_errors(tag)
    print(f"{tag}: worst logit error {max(errs):.3g}, {max(errs) / scale:.3g} of the "
          f"largest logit")
    assert max(errs) <= bar * (1.0 if tag.endswith("f32") else scale), (errs, scale)


@pytest.mark.parametrize("tag", list(TAGS))
def test_prefill_decode_matches_forward(tag):
    """The port's golden serving test (``tests/test_serving.py``'s bar)."""
    _, _, mine = _serve_errors(tag)
    assert max(mine) < 1e-4, mine


def test_sinusoid_matches_reference():
    """``_sinusoid`` in f32 at whisper's 1500 positions and width 384."""
    pos = np.arange(1500)
    want = np.asarray(jax.jit(lambda p: jed._sinusoid(p, 384))(jnp.asarray(pos)))
    got = ted._sinusoid(torch.from_numpy(pos), 384).numpy()
    assert got.dtype == np.float32
    # The angles p f differ by the last bits of f (exp in f32): within two
    # f32 spacings of the angle, 2^-22 p, for every position.
    err = np.abs(got - want).max(axis=-1)
    assert (err <= 2.0 ** -22 * np.maximum(pos, 1) + 1e-7).all(), err.max()


def test_mlp_gelu_is_within_a_bf16_step_of_the_references():
    """whisper's non-gated MLP keeps ``F.gelu(approximate="tanh")``: in
    bf16 it differs from the reference's ``jax.nn.gelu`` in a share of
    the values (printed), each within one bf16 step of the input (2^-7
    |x|: the reference rounds every op to bf16, ``F.gelu`` once), while
    ``gelu_tanh_ref`` gives the reference's bits; the model's bf16 bars
    above hold with ``F.gelu`` (their tests print the readings)."""
    x = np.random.default_rng(0).standard_normal((256, 128)).astype(np.float32) * 3
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x).astype(jnp.bfloat16)),
                      np.float32)
    xt = torch.from_numpy(x).bfloat16()
    got = torch.nn.functional.gelu(xt, approximate="tanh").float().numpy()
    print(f"F.gelu differs from jax.nn.gelu in {(got != want).mean():.1%} of bf16 values")
    assert np.abs(got - want).max() > 0
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(xt.float().numpy())).all()
    assert np.array_equal(TL.gelu_tanh_ref(xt).float().numpy(), want)
    cfg = get_reduced_config(ARCH)
    mlp = TL.MLP(cfg, dtype=torch.bfloat16)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape) * 0.2)
    h = xt[:, :cfg.d_model].reshape(4, 64, cfg.d_model)
    assert torch.equal(mlp(h), torch.nn.functional.gelu(h @ mlp.wi, approximate="tanh") @ mlp.wo)


def test_attention_paths(monkeypatch):
    """Which attention each part takes: the encoder bidirectional, through
    the kernel's route when no gradient is taken (here its plain version:
    CPU tensors) and the plain path under a gradient (forcing the kernel
    there is refused); the decoder's self-attention causal; the
    cross-attention plain and bidirectional."""
    _, cfg = _cfgs("encdec-f32")
    model = build(cfg, device="cpu", param_dtype=torch.float32)
    seen, attention = [], TL.kops.attention
    monkeypatch.setattr(TL.kops, "attention", lambda *a, causal, use_kernel=None, **k: (
        seen.append((causal, use_kernel)) or attention(*a, causal=causal,
                                                       use_kernel=use_kernel, **k)))
    _, tb = _batches(cfg)
    with torch.no_grad():
        model.prefill(tb["frames"], tb["tokens"], use_kernel=True)
    enc, dec = cfg.num_encoder_layers, cfg.num_layers
    assert seen == [(False, True)] * enc + [(True, True), (False, False)] * dec
    seen.clear()
    loss(model, tb)
    assert seen == [(False, False)] * enc + [(True, False), (False, False)] * dec
    with pytest.raises(ValueError, match="no backward"):
        model.encode(tb["frames"], use_kernel=True)


def test_remat_gives_the_same_gradients():
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(get_reduced_config(ARCH), remat=remat, **T.F32)
        model = build(cfg, device="cpu", param_dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0))
        l, _ = loss(model, _batches(cfg)[1])
        out[remat] = (l.detach(), torch.autograd.grad(l, list(model.parameters())))
    assert torch.equal(out["none"][0], out["full"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["none"][1], out["full"][1]))


# --------------------------------------------------------------- train ----
def test_adamw_step_matches_reference():
    """One AdamW step of ``make_train_step`` on a batch with frames
    against the reference's ``adamw_update`` on its gradient: every
    parameter and first moment, the stacked (L, d) layer norms decayed
    and ``enc_norm`` / ``dec_norm`` not (ROADMAP C13)."""
    jcfg, values, model = _pair("encdec-f32")
    jb, tb = _batches(jcfg)
    rng = np.random.default_rng(1)  # non-zero norms, so that their decay shows
    values = jax.tree_util.tree_map_with_path(
        lambda k, v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if "norm" in jax.tree_util.keystr(k) else v, values)
    model = lm_params_from_reference(values, model.cfg, device="cpu", param_dtype=torch.float32)
    acfg = RefAdamWConfig()
    grads = jax.jit(jax.grad(lambda v, b: ref_build(jcfg).loss(v, b)[0]))(values, jb)
    p, st, _ = jax.jit(lambda g, s, p: ref_adamw_update(g, s, p, lr=1e-3, cfg=acfg))(
        grads, ref_adamw_init(values), values)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    tsteps.make_train_step(model, adamw_cfg=AdamWConfig(), schedule=lambda s: 1e-3)(opt, tb)
    got, want = join_reference(params, model.cfg), _flat(p)
    errs = {k: T._rel_l2(got[k], want[k]) for k in want}
    assert max(errs.values()) <= 1e-4, errs
    mom, want_m = join_reference(opt["m"], model.cfg), _flat(st["m"])
    assert max(T._scaled_err(mom[k], want_m[k]) for k in want_m) <= 1e-4
    dec = decays(model.cfg)
    assert dec("encoder.0.norm1") and dec("decoder.1.norm_x")
    assert not dec("enc_norm") and not dec("dec_norm")


def test_eigen_steps_match_reference_stacked(ref):
    """Every refresh and train step of the reference's eigen run on
    batches with frames (rank 8, a refresh every 2 steps), from the
    reference's state before it, stacked on 4 shards, each its rows.
    The refreshed bases' probe counts the gradients' difference and the
    reference's own f32 error (``_teacher_forced``'s ``ref_own``): at
    (64, 64) and rank 8, some of whisper's leaves have a small gap after
    the 8th singular value, and there the reference's f32 refresh lies
    further from its own f64 refresh (up to 1.1e-2, ``encoder.1.attn.wo``
    at step 4) than the port's lies from the port's f64 refresh
    (1.5e-3)."""
    _, cfg = _cfgs("encdec-f32")
    comp = tsteps.compressed_paths(cfg, EC.EigenCompressConfig(rank=8, min_dim=64))
    assert "decoder.0.cross_attn.wq" in comp and "encoder.1.attn.wo" in comp
    assert "decoder.0.cross_attn.wk" not in comp
    readings = []
    worst = T._teacher_forced(ref, cfg, ref_grads=True, ref_own=True, readings=readings,
                              stub=lambda t: frames_at(cfg, t))
    for r in sorted(readings, key=lambda r: r["ratio_f32"])[-2:]:
        print(f"step {r['step']} {r['leaf']}: {r['ratio_f32']:.3g} x the port's own f32 "
              f"probe's bar; port's f32 error {r['f32']:.3g}, the reference's own "
              f"{r['ref_own']:.3g}, the gradients' term {r['grads']:.3g}, the bases "
              f"{r['basis_gap']:.3g} apart")
    T._assert_within(worst)


def test_opt_state_crosses_both_ways(ref):
    """The reference-form eigen state after the last step into the port's
    stacked form and back bit for bit (both stacks, the cross-attention),
    and one rank's slice of it."""
    _, cfg = _cfgs("encdec-f32")
    pre = f"distinct/state{T.EIGEN['steps']}/"
    paths = set(T._under(ref, pre + "eigen/m/"))
    ref_opt = {
        "eigen": {p: {f: ref[f"{pre}eigen/{f}/{p}"] for f in
                      ("basis", "m", "v", "err", "initialized")} for p in paths},
        "full_m": T._under(ref, pre + "full_m/"), "full_v": T._under(ref, pre + "full_v/"),
        "step": ref[pre + "step"]}
    opt = opt_state_from_reference(ref_opt, cfg, device="cpu")
    back = opt_state_to_reference(opt, cfg)
    assert set(back["eigen"]) == paths
    for p in paths:
        for f in ("basis", "m", "v", "err"):
            assert np.array_equal(back["eigen"][p][f], ref_opt["eigen"][p][f]), (p, f)
    for f in ("full_m", "full_v"):
        assert set(back[f]) == set(ref_opt[f])
        for p, v in ref_opt[f].items():
            assert np.array_equal(back[f][p], v), (f, p)
    one = opt_state_from_reference(ref_opt, cfg, device="cpu", shard=2)
    path = "['decoder']['cross_attn']['wq']"
    assert np.array_equal(one["eigen"]["decoder.1.cross_attn.wq"]["err"].numpy(),
                          ref_opt["eigen"][path]["err"][2, 1])


# ------------------------------------------------- counts, init, paths ----
def test_config_matches_reference():
    for got, want in ((get_config(ARCH), ref_config(ARCH)),
                      (get_reduced_config(ARCH), ref_reduced_config(ARCH))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", [ARCH, "internvl2-2b"])
@pytest.mark.parametrize("rank,min_dim", [(32, 64), (8, 64)])
def test_compressed_paths_match_the_references(arch, rank, min_dim):
    """``compressed_paths`` selects exactly the leaves the reference's
    selects on its own tree (full and reduced configs): whisper's
    embeddings, the encoder's, decoder's and cross-attention's wq / wo
    and the MLPs, never wk / wv; internvl2-2b's dense leaves and
    ``patch_proj``."""
    ecfg = EC.EigenCompressConfig(rank=rank, min_dim=min_dim)
    for cfg, jcfg in ((get_config(arch), ref_config(arch)),
                      (get_reduced_config(arch), ref_reduced_config(arch))):
        values, axes = abstract_params(jcfg)
        want = ref_compressed_paths(values, axes, RefECfg(rank=rank, min_dim=min_dim))
        leaves = reference_leaves(cfg)
        got = {leaves[n].path for n in tsteps.compressed_paths(cfg, ecfg)}
        assert got == set(want)
    full = tsteps.compressed_paths(get_config(arch), EC.EigenCompressConfig(rank=32, min_dim=64))
    if arch == ARCH:
        assert "encoder.0.attn.wk" not in full and "unembed" in full
        assert "decoder.3.cross_attn.wo" in full
    else:
        assert full["patch_proj"] == (1024, 2048)


def test_full_config_on_meta_matches_reference_tree():
    """The full config on the meta device: 56,355,456 parameters
    (``param_count``, the logical vocab), and every leaf, padded vocab
    rows included, with the reference's ``abstract_params`` path, shape
    and axes."""
    cfg = get_config(ARCH)
    assert param_count(cfg) == 56_355_456
    model = EncDec(cfg, device="meta")
    values, axes = abstract_params(ref_config(ARCH))
    shapes, ax = _flat_shapes(values), {
        jax.tree_util.keystr(k): a for k, a in jax.tree_util.tree_flatten_with_path(
            axes, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for s in shapes.values())
    leaves = reference_leaves(cfg)
    assert {leaf.path for leaf in leaves.values()} == set(shapes)
    params = dict(model.named_parameters())
    assert set(params) == set(leaves)
    for name, leaf in leaves.items():
        assert leaf.shape == shapes[leaf.path] and leaf.axes == tuple(ax[leaf.path]), name
        assert params[name].numel() == int(np.prod(leaf.layer_shape)), name


def _flat_shapes(values):
    return {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(values)[0]}


def test_init_follows_reference_distribution():
    """The truncated normal scaled by 1/sqrt(fan_in) for the encoder's,
    decoder's and cross-attention's projections and the MLP (fan-in d,
    or h hd / d_ff for the output projections), norms zero and f32."""
    cfg = dataclasses.replace(get_reduced_config(ARCH), d_model=256, d_ff=512)
    model = build(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    sigma = 0.8796256610342398
    layer = model.decoder[0]
    for w, fan_in in ((layer.cross_attn.wq, 256), (layer.cross_attn.wo, 256),
                      (layer.self_attn.wk, 256), (model.encoder[1].mlp.wo, 512),
                      (model.encoder[0].attn.wv, 256), (model.unembed, 256)):
        assert w.dtype == torch.bfloat16
        assert abs(w.float().std().item() * fan_in ** 0.5 - sigma) < 0.03
        assert w.float().abs().max().item() <= 2.0 / fan_in ** 0.5 * (1 + 2 ** -8)
    for p in (model.enc_norm, model.dec_norm, layer.norm_x, model.encoder[0].norm2):
        assert p.dtype == torch.float32 and not p.any()


def test_models_refuse_the_other_kind():
    with pytest.raises(ValueError, match="build models.EncDec"):
        build.__globals__["LM"](get_reduced_config(ARCH), device="cpu")
    with pytest.raises(ValueError, match="build models.LM"):
        EncDec(get_reduced_config("llama3.2-3b"), device="cpu")


# ------------------------------------------------------------ launchers ----
def test_train_cli_refuses_whisper():
    """The launcher's token pipeline gives no frames: exit 2, saying so
    (the reference's launcher fails with a KeyError)."""
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", ARCH,
         "--steps", "2"], env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 2
    assert "gives no frames" in proc.stderr and "KeyError" in proc.stderr

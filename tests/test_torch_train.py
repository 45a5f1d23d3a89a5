"""Port parity of the training slice on the CPU: the loss and its
gradients, AdamW, the schedule, the token pipeline, the baseline trainer
and the eigen-compressed trainer (the paper's technique in training),
stacked and in a gloo rank world.

The reference runs once for the module, in one subprocess on 4 fake CPU
devices (``make_host_mesh(model=1)``: a data axis of 4), and saves what
it computed to an npz; the port starts from the reference's parameters
(``interop.split_reference``) and is fed the same batches.  The eigen
trainer's refreshes start from the reference's own ``jax.random`` draws,
reproduced from ``repro/launch/train.py:121,129``, ``steps.py:353`` and
``eigen_compress.py:149`` (one split of the key a refresh, one key a
compressed leaf in sorted path order, one a layer of a stacked leaf):
the draws are the only place the port's numbers would otherwise differ.

Configs: granite-3-2b and llama3.2-3b reduced, in f32 with f32 attention
probabilities (the tight bars), and granite-3-2b's own bf16 config.

Bars:
  * f32 loss within 1e-5 relative, every gradient within 1e-4 relative
    L2, leaf by leaf through the interop path map;
  * AdamW (clip, decay with the stacked-norm rule, bias correction over
    two steps, then a non-finite gradient that the NaN guard skips):
    parameters and moments within 1e-6 of each leaf's largest magnitude,
    equal step counters and skip flags, the global norm within 1e-6
    relative;
  * ``warmup_cosine`` over steps 0..12 within 1 f32 ulp (2^-23 relative);
  * ``TokenPipeline`` bit for bit over several (seed, step, host_id);
  * the baseline trainer, f32: 8 losses within 1e-4;
  * the eigen trainer (rank 8, a refresh every 2 steps, 6 steps), stacked
    on 4 shards and on 4 gloo ranks, teacher-forced on the pipeline's own
    batches (each shard its rows): every refresh and step from the
    reference's state before it; each refresh's bases within max(1e-5,
    4 x the refresh's own f32 error against f64) f64 subspace distance and
    its rotated moments within 1e-4 (every leaf but the embedding, whose
    refresh is not defined on distinct rows: ``ILL_POSED``); each step's
    loss within 1e-5 relative, every shard's error feedback, the
    low-rank and the full moments within 1e-4 of each leaf's largest
    magnitude; and free-running, every shard fed the same rows, the
    first 4 losses within 1e-4;
  * bf16 (the configs' dtype): the frameworks round to bf16 at different
    places; the loss within 2e-3 relative, every gradient within 5e-2
    relative L2, and the baseline trainer's losses within 2e-2.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import SRC, run_with_devices
from repro.configs import get_reduced_config as ref_reduced_config
from repro.data.tokens import TokenPipeline as RefPipeline
from repro.launch.steps import compressed_paths as ref_compressed_paths
from repro.models.registry import abstract_params
from repro.optim.eigen_compress import EigenCompressConfig as RefECfg
from repro_torch.configs import get_reduced_config
from repro_torch.core.metrics import subspace_dist64
from repro_torch.data.tokens import TokenPipeline
from repro_torch.interop import (
    decays,
    join_reference,
    opt_state_from_reference,
    opt_state_to_reference,
    reference_leaves,
    split_reference,
)
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import LM, loss_fn, model_class
from repro_torch.models import loss as model_loss
from repro_torch.optim import EigenCompressConfig
from repro_torch.optim import eigen_compress as EC
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import warmup_cosine

B, S, SEED = 4, 16, 0
F32 = dict(dtype="float32", attn_probs_bf16=False)
TAGS = {"granite-f32": ("granite-3-2b", F32), "llama-f32": ("llama3.2-3b", F32),
        "granite-bf16": ("granite-3-2b", {})}
TRAIN = dict(steps=8, batch=B, seq=S, lr=1e-3, warmup=2, log_every=100)
EIGEN = dict(steps=6, batch=B, seq=S, lr=1e-3, warmup=2, eigen=True, eigen_rank=8,
             eigen_refresh=2, log_every=100)

REF_CODE = r'''
import dataclasses, sys, types
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import registry, get_reduced_config
from repro.data.tokens import TokenPipeline
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import eigen_opt_init, jit_eigen_steps
from repro.launch.train import train
from repro.models import init_split
from repro.models.registry import build
from repro.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro.optim.eigen_compress import EigenCompressConfig
from repro.optim.schedule import warmup_cosine

OUT, B, S, SEED = {out!r}, {B}, {S}, {SEED}
TAGS, TRAIN, EIGEN = {tags!r}, {train!r}, {eigen!r}
out = {{}}


def put(prefix, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(k)] = np.asarray(v)


def register(tag, arch, kw):
    # train() takes an arch id: register the variant as examples/train_lm.py does.
    cfg = dataclasses.replace(get_reduced_config(arch), name=tag, **kw)
    mod = types.ModuleType("cfg_" + tag.replace("-", "_"))
    mod.CONFIG, mod.reduced = cfg, (lambda: cfg)
    sys.modules["repro.configs." + mod.__name__] = mod
    registry.ARCHS[tag] = mod.__name__
    return cfg


def batch_of(cfg, step=0):
    return {{k: jnp.asarray(v) for k, v in
            TokenPipeline(cfg.vocab_size, S, B, seed=SEED).batch(step).items()}}


cfgs = {{tag: register(tag, arch, kw) for tag, (arch, kw) in TAGS.items()}}
for tag, cfg in cfgs.items():
    values, _ = init_split(cfg, jax.random.PRNGKey(SEED))
    (loss, _), grads = jax.jit(jax.value_and_grad(build(cfg).loss, has_aux=True))(
        values, batch_of(cfg))
    put(f"values/{{tag}}", values)
    put(f"grads/{{tag}}", grads)
    out[f"loss/{{tag}}"] = np.asarray(loss)

# AdamW: the norms made non-zero (so their decay shows), a clipped step,
# an unclipped one, then a non-finite gradient.
cfg = cfgs["granite-f32"]
values, _ = init_split(cfg, jax.random.PRNGKey(SEED))
rng = np.random.default_rng(1)
values = jax.tree_util.tree_map_with_path(
    lambda k, v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    if "norm" in jax.tree_util.keystr(k) else np.asarray(v), values)
grads = jax.jit(jax.grad(lambda v: build(cfg).loss(v, batch_of(cfg))[0]))(values)
g2 = jax.tree.map(lambda g: g * 0.05, grads)
gs = [jax.tree.map(lambda g: g * 10.0, grads), g2,
      jax.tree_util.tree_map_with_path(
          lambda k, g: g.at[0].set(jnp.nan) if "final_norm" in jax.tree_util.keystr(k)
          else g, g2)]
acfg = AdamWConfig()
update = jax.jit(lambda g, s, p, lr: adamw_update(g, s, p, lr=lr, cfg=acfg))
state, p = adamw_init(values), values
put("adamw/p", values)
for i, (g, lr) in enumerate(zip(gs, (1e-3, 5e-4, 5e-4))):
    put(f"adamw/g{{i}}", g)
    p, state, om = update(g, state, p, jnp.float32(lr))
    put(f"adamw/p{{i}}", p)
    put(f"adamw/m{{i}}", state["m"])
    put(f"adamw/v{{i}}", state["v"])
    out[f"adamw/step{{i}}"] = np.asarray(state["step"])
    out[f"adamw/gnorm{{i}}"] = np.asarray(om["grad_norm"])
    out[f"adamw/skipped{{i}}"] = np.asarray(om["step_skipped"])
sched = warmup_cosine(3e-4, 3, 10)
out["sched"] = np.asarray([sched(s) for s in range(13)], np.float32)

mesh = make_host_mesh(model=1)
for tag in ("granite-f32", "granite-bf16"):
    _, _, losses = train(tag, mesh=mesh, **TRAIN)
    out[f"train/{{tag}}"] = np.asarray(losses)

# The refresh alone on the paper's setting (a shared rank-4 signal and
# per-shard noise), aligned to shard 0 and to a previous basis.
from repro.compat import make_mesh, shard_map
from repro.optim.eigen_compress import refresh_basis
from jax.sharding import PartitionSpec as P
d, n, r = 48, 32, 4
u, _ = jnp.linalg.qr(jax.random.normal(jax.random.PRNGKey(0), (d, r)))
gs = jnp.stack([u @ jax.random.normal(jax.random.PRNGKey(i), (r, n))
                + 0.05 * jax.random.normal(jax.random.PRNGKey(10 + i), (d, n))
                for i in range(4)])
prev, _ = jnp.linalg.qr(u + 0.1 * jax.random.normal(jax.random.PRNGKey(5), (d, r)))
out["refresh/gs"], out["refresh/prev"] = np.asarray(gs), np.asarray(prev)
out["refresh/start"] = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (d, r)))
mesh4 = make_mesh((4,), ("data",))
for init in (False, True):
    def f(g, init=init):
        return refresh_basis(g[0], prev, jnp.asarray(init), axis_name="data",
                             cfg=EigenCompressConfig(rank=r), key=jax.random.PRNGKey(42))[None]
    got = jax.jit(shard_map(f, mesh=mesh4, in_specs=P("data"), out_specs=P("data"),
                            check_vma=False))(gs)
    out[f"refresh/basis{{int(init)}}"] = np.asarray(got)

# The eigen trainer: train()'s loop, with each refresh's start bases
# recorded, twice: on the pipeline's own batches (each shard its rows,
# every state before and after each refresh and step saved, for the
# teacher-forced tests), and on batches whose shards see the same rows
# (the losses, for the free-running trajectory).
cfg = cfgs["granite-f32"]
values, axes = init_split(cfg, jax.random.PRNGKey(SEED))
values = jax.tree.map(np.asarray, values)


class Shared(TokenPipeline):
    def batch(self, step):
        return {{k: np.tile(v, (4, 1)) for k, v in
                TokenPipeline(self.vocab, self.seq, self.global_batch // 4,
                              seed=self.seed).batch(step).items()}}


ecfg = EigenCompressConfig(rank=EIGEN["eigen_rank"], refresh_every=EIGEN["eigen_refresh"],
                           min_dim=64)
pipes = {{"distinct": TokenPipeline(cfg.vocab_size, S, B, seed=SEED),
         "eigen": Shared(cfg.vocab_size, S, B, seed=SEED)}}
train_jit, refresh_jit, (ps, os_, bs) = jit_eigen_steps(
    cfg, mesh, values, axes, pipes["eigen"].batch(0), adamw_cfg=AdamWConfig(),
    schedule=warmup_cosine(EIGEN["lr"], EIGEN["warmup"], EIGEN["steps"]), ecfg=ecfg)


def save_state(prefix, params, opt):
    put(prefix + "params", params)
    for path, st in opt["eigen"].items():
        for f, v in st.items():
            out[f"{{prefix}}eigen/{{f}}/{{path}}"] = np.asarray(v)
    for f in ("full_m", "full_v"):
        for path, v in opt[f].items():
            out[f"{{prefix}}{{f}}/{{path}}"] = np.asarray(v)
    out[prefix + "step"] = np.asarray(opt["step"])


for run, pipe in pipes.items():
    states = run == "distinct"
    opt = jax.device_put(eigen_opt_init(values, ecfg, 4, axes), os_)
    params = jax.device_put(values, ps)
    key = jax.random.PRNGKey(SEED + 1)
    losses = []
    for step in range(EIGEN["steps"]):
        b = jax.device_put(pipe.batch(step), bs)
        if states:
            save_state(f"{{run}}/state{{step}}/", params, opt)
        if step % ecfg.refresh_every == 0:
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
            if states:
                save_state(f"{{run}}/refreshed{{step}}/", params, opt)
        params, opt, metrics = train_jit(params, opt, b)
        losses.append(float(metrics["loss"]))
    if states:
        save_state(f"{{run}}/state{{EIGEN['steps']}}/", params, opt)
    out[f"{{run}}/losses"] = np.asarray(losses)
np.savez(OUT, **out)
'''


def _cfg(tag):
    arch, kw = TAGS[tag]
    return dataclasses.replace(get_reduced_config(arch), name=tag, **kw)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("train-ref") / "ref.npz"
    run_with_devices(REF_CODE.format(out=str(path), B=B, S=S, SEED=SEED, tags=TAGS,
                                     train=TRAIN, eigen=EIGEN), n_devices=4)
    with np.load(path) as data:
        return dict(data)


def _under(ref, prefix) -> dict:
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def _model_at(ref, cfg, prefix) -> LM:
    """The port's model (``LM`` or ``EncDec``) holding the reference's f32
    parameters under ``prefix``."""
    named = split_reference(_under(ref, prefix), cfg)
    model = model_class(cfg)(cfg, device="cpu", param_dtype=torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(named[name]))
    return model


def _model(ref, tag) -> LM:
    """The port's LM holding the reference's f32 parameters of ``tag``."""
    return _model_at(ref, _cfg(tag), f"values/{tag}")


def _batch(cfg, step=0):
    return {k: torch.from_numpy(v).long()
            for k, v in TokenPipeline(cfg.vocab_size, S, B, seed=SEED).batch(step).items()}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _scaled_err(got, want):
    """max |got - want| over the largest magnitude of want."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("tag,loss_bar,grad_bar", [
    ("granite-f32", 1e-5, 1e-4), ("llama-f32", 1e-5, 1e-4),
    ("granite-bf16", 2e-3, 5e-2)])
def test_loss_and_gradients_match_reference(ref, tag, loss_bar, grad_bar):
    model = _model(ref, tag)
    loss, metrics = loss_fn(model, _batch(model.cfg))
    want = float(ref[f"loss/{tag}"])
    assert abs(float(loss.detach()) - want) <= loss_bar * abs(want)
    assert float(metrics["aux"]) == 0.0
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    got = join_reference(dict(zip(params, grads)), model.cfg)
    want = _under(ref, f"grads/{tag}")
    assert set(got) == set(want)
    errs = {k: _rel_l2(got[k], want[k]) for k in want}
    assert max(errs.values()) <= grad_bar, errs


def test_adamw_steps_match_reference(ref):
    """Clip (step 0's norm is far above 1), decay by the reference leaf's
    rank (the (d,) block norms are decayed, final_norm is not), bias
    correction at steps 1 and 2, and the NaN guard at step 3."""
    cfg = _cfg("granite-f32")
    params = {k: torch.from_numpy(v.copy())
              for k, v in split_reference(_under(ref, "adamw/p"), cfg).items()}
    state = adamw_init(params)
    acfg = AdamWConfig()
    for i, lr in enumerate((1e-3, 5e-4, 5e-4)):
        grads = {k: torch.from_numpy(v.copy())
                 for k, v in split_reference(_under(ref, f"adamw/g{i}"), cfg).items()}
        om = adamw_update(grads, state, params, lr=float(np.float32(lr)), cfg=acfg,
                          decays=decays(cfg))
        assert abs(om["grad_norm"] - float(ref[f"adamw/gnorm{i}"])) <= 1e-6 * abs(
            float(ref[f"adamw/gnorm{i}"])) or not np.isfinite(om["grad_norm"])
        assert om["step_skipped"] == float(ref[f"adamw/skipped{i}"])
        assert int(state["step"]) == int(ref[f"adamw/step{i}"])
        for what, tree in (("p", params), ("m", state["m"]), ("v", state["v"])):
            got = join_reference(tree, cfg)
            want = _under(ref, f"adamw/{what}{i}")
            errs = {k: _scaled_err(got[k], want[k]) for k in want}
            assert max(errs.values()) <= 1e-6, (i, what, errs)
    assert float(ref["adamw/gnorm0"]) > 10 * acfg.clip_norm  # step 0 was clipped
    assert float(ref["adamw/skipped2"]) == 1.0


def test_decay_and_compression_follow_the_reference_leaf():
    """Weight decay by the reference leaf's rank and compressibility by the
    reference's ``compressed_paths`` on its own tree (abstract shapes,
    nothing materialised), for every dense reduced config and the
    recurrent families' reduced and full configs, at a few (rank,
    min_dim).  The recurrent stacked vectors (RG-LRU's lam (L, w), SSD's
    a_log / dt_bias / dskip (L, H)) are decayed, as the reference's (L, .)
    leaves are.  Where the reference would compress such a vector as one
    matrix across layers (mamba2's 48 layers at min_dim <= 48) the port
    raises."""
    from repro.configs import get_config as ref_config
    from repro_torch.configs import get_config

    cases = [(arch, True) for arch in ("granite-3-2b", "llama3.2-3b", "chatglm3-6b",
                                       "internlm2-20b", "recurrentgemma-2b", "mamba2-370m")]
    cases += [("recurrentgemma-2b", False), ("mamba2-370m", False)]
    raised = []
    for arch, reduced in cases:
        values, axes = abstract_params(ref_reduced_config(arch) if reduced else ref_config(arch))
        cfg = get_reduced_config(arch) if reduced else get_config(arch)
        leaves = reference_leaves(cfg)
        rule = decays(cfg)
        for name, leaf in leaves.items():
            assert rule(name) == (len(leaf.shape) >= 2), name
        assert rule("blocks.0.norm1") and not rule("final_norm")
        for rank, min_dim in ((8, 64), (4, 16), (32, 64), (32, 1024)):
            want = ref_compressed_paths(values, axes, RefECfg(rank=rank, min_dim=min_dim))
            ecfg = EigenCompressConfig(rank=rank, min_dim=min_dim)
            vectors = {leaf.path for leaf in leaves.values()
                       if leaf.layer is not None and len(leaf.shape) == 2}
            if vectors & set(want):
                with pytest.raises(NotImplementedError, match="stacked vector"):
                    tsteps.compressed_paths(cfg, ecfg)
                raised.append((arch, reduced, rank, min_dim))
                continue
            got = tsteps.compressed_paths(cfg, ecfg)
            assert {leaves[n].path for n in got} == set(want), (arch, reduced, rank, min_dim)
            assert "blocks.0.mixer.wk" not in got  # kv_heads: not a compressed view
            assert not any(n.endswith((".conv", ".lam", ".a_log")) for n in got)
    assert raised == [("mamba2-370m", False, 4, 16)]
    hybrid, ssm = decays(get_config("recurrentgemma-2b")), decays(get_config("mamba2-370m"))
    assert hybrid("blocks.0.mixer.lam") and hybrid("blocks.25.mixer.lam")  # stage 2: L = 1
    assert all(ssm(f"blocks.47.mixer.{v}") for v in ("a_log", "dt_bias", "dskip"))
    full = {arch: tsteps.compressed_paths(get_config(arch), EigenCompressConfig(rank=32,
                                                                                min_dim=64))
            for arch in ("recurrentgemma-2b", "mamba2-370m")}
    assert full["mamba2-370m"]["blocks.0.mixer.wdt"] == (1024, 32)  # r = n: lossless
    assert full["mamba2-370m"]["embed"] == (50432, 1024)  # tied, padded vocab
    assert full["recurrentgemma-2b"]["blocks.2.mixer.wq"] == (2560, 2560)  # local attention
    assert full["recurrentgemma-2b"]["unembed"] == (2560, 256000)


def test_warmup_cosine_matches_reference(ref):
    sched = warmup_cosine(3e-4, 3, 10)
    got = np.asarray([sched(s) for s in range(13)], np.float32)
    np.testing.assert_allclose(got, ref["sched"], rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("seed,step,hosts,host", [
    (0, 0, 1, 0), (0, 7, 1, 0), (3, 2, 2, 1), (11, 123, 4, 3)])
def test_token_pipeline_bit_equal(seed, step, hosts, host):
    kw = dict(seed=seed, num_hosts=hosts, host_id=host)
    want = RefPipeline(515, 33, 8, **kw).batch(step)
    got = TokenPipeline(515, 33, 8, **kw).batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    it = TokenPipeline(515, 33, 8, **kw).iterator(start_step=step)
    assert np.array_equal(next(it)["tokens"], want["tokens"])
    it.close()


@pytest.mark.parametrize("tag,bar", [("granite-f32", 1e-4), ("granite-bf16", 2e-2)])
def test_baseline_trainer_matches_reference(ref, tag, bar, monkeypatch):
    model = _model(ref, tag)
    monkeypatch.setattr(ttrain, "build", lambda cfg, **kw: model)
    _, opt, losses = ttrain.train(model.cfg, device="cpu", **TRAIN)
    want = ref[f"train/{tag}"]
    assert len(losses) == len(want)
    np.testing.assert_allclose(losses, want, rtol=0, atol=bar)
    assert int(opt["step"]) == TRAIN["steps"]


class SharedPipeline(TokenPipeline):
    """Every shard's rows are one draw of the pipeline (the global batch is
    that draw tiled 4 times), as the reference's shared-row eigen run above
    is fed: the free-running trajectory tests use it, since on distinct
    rows the embedding's refresh (``ILL_POSED``) makes two correct
    implementations' trajectories part at the first refresh."""

    def batch(self, step):
        return {k: np.tile(v, (4, 1)) for k, v in TokenPipeline(
            self.vocab, self.seq, self.global_batch // 4, seed=self.seed).batch(step).items()}


def _per_leaf(flat, cfg) -> dict:
    """Reference key path -> (L, ...) stacked array, to port leaf name ->
    that leaf's layer (refresh starts and bases: shaped (d, r) already)."""
    out = {}
    for name, leaf in reference_leaves(cfg).items():
        if leaf.path in flat:
            arr = flat[leaf.path]
            out[name] = arr if leaf.layer is None else arr[leaf.layer]
    return out


def _starts(ref, cfg):
    """starts(step): the reference's draws of the refresh at ``step``, one
    (d, r) a port leaf."""
    def at(step):
        k = step // EIGEN["eigen_refresh"]
        return {n: torch.from_numpy(v.copy())
                for n, v in _per_leaf(_under(ref, f"eigen/starts{k}/"), cfg).items()}
    return at


def _ref_state(ref, cfg, prefix, *, shard=None):
    """(model, optimizer state) of the reference's eigen run saved under
    ``prefix``: the stacked form, or with ``shard`` that rank's."""
    model = _model_at(ref, cfg, prefix + "params")
    paths = set(_under(ref, prefix + "eigen/basis/"))
    ref_opt = {"eigen": {p: {f: ref[f"{prefix}eigen/{f}/{p}"] for f in
                             ("basis", "m", "v", "err", "initialized")} for p in paths},
               "full_m": _under(ref, prefix + "full_m/"),
               "full_v": _under(ref, prefix + "full_v/"), "step": ref[prefix + "step"]}
    return model, opt_state_from_reference(ref_opt, cfg, device="cpu", shard=shard)


# The embedding's refresh is not defined on distinct rows: each shard's
# gradient of the (vocab, d) embedding lives on the rows of its own
# tokens, so two shards' local bases can be orthogonal and the Procrustes
# polar factor of their Gram is not defined (see
# test_embedding_refresh_is_ill_posed_on_disjoint_tokens).  Its refreshed
# basis, and its moments rotated into it, are the only quantities the
# teacher-forced tests leave out; the train steps that follow start from
# the reference's basis, and hold the embedding's error feedback and
# moments with every other leaf's.
ILL_POSED = ("embed",)


def _refresh64(grads, starts, opt, ecfg) -> dict:
    """The refresh of each compressed leaf carried out in f64 on the
    per-shard gradients ``grads`` (one dict leaf -> gradient a shard):
    each shard's 4-step local solve from the leaf's start, then the
    Procrustes average against its basis.  Leaf -> (d, r) array."""
    out = {}
    for n, st in opt["eigen"].items():
        local = []
        for g in grads:
            g64 = torch.as_tensor(g[n]).double()
            q = torch.linalg.qr(starts[n].double())[0]
            for _ in range(4):
                q = torch.linalg.qr(g64 @ (g64.T @ q))[0]
            local.append(q)
        out[n] = EC.refresh_basis(torch.stack(local), st["basis"].double(),
                                  bool(st["initialized"]), cfg=ecfg).numpy()
    return out


def _probes(model, batch, starts, opt, ecfg, ref_grads=None, m=4) -> dict:
    """Leaf -> {"f32": the refresh's own f32 rounding error at this state:
    how far its refreshed basis (each shard's 4-step local solve on its
    rows, then their Procrustes average) lies from the same refresh of
    the same gradients carried out in f64; two f32 implementations of
    the refresh may each be that far from the f64 one}.  With
    ``ref_grads`` (each shard's gradients as the reference computed them,
    port leaf -> array), each shard's gradient is first held within 1e-4
    relative L2 of the reference's (the worst of the shards is "gap"),
    and the entry also has "grads": how far the f64 refresh of the
    port's gradients lies from the f64 refresh of the reference's, what
    the gradients' own difference moves the bases."""
    params = dict(model.named_parameters())
    names = sorted(opt["eigen"])
    grads, local, gap = [], {n: [] for n in names}, dict.fromkeys(names, 0.0)
    for i in range(m):
        loss, _ = model_loss(model, tsteps.shard_rows(batch, i, m))
        shard = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names],
                                                    allow_unused=True, materialize_grads=True)))
        grads.append(shard)
        with torch.no_grad():
            for n, g in shard.items():
                local[n].append(EC._local_basis(g, starts[n].shape[1], 4, starts[n]))
                if ref_grads is not None:
                    gap[n] = max(gap[n], _rel_l2(g.numpy(), ref_grads[i][n]))
                    assert gap[n] <= 1e-4, (n, i, gap[n])
    exact = _refresh64(grads, starts, opt, ecfg)
    out = {}
    for n in names:
        st = opt["eigen"][n]
        got = EC.refresh_basis(torch.stack(local[n]), st["basis"], bool(st["initialized"]),
                               cfg=ecfg).numpy()
        out[n] = {"f32": subspace_dist64(got, exact[n])}
    if ref_grads is not None:
        theirs = _refresh64(ref_grads, starts, opt, ecfg)
        for n in names:
            out[n].update(grads=subspace_dist64(theirs[n], exact[n]), gap=gap[n],
                          ref64=theirs[n])
    return out


def _whole_state(opt) -> dict:
    """A mesh run's optimizer state with every DTensor whole (a plain
    state's itself)."""
    from repro_torch.launch.sharding import whole

    if isinstance(opt, dict):
        return {k: _whole_state(v) for k, v in opt.items()}
    return whole(opt) if isinstance(opt, torch.Tensor) else opt


def _teacher_forced(ref, cfg, *, group=None, rank=None, seq=S,
                    ill_posed=ILL_POSED, ref_grads=False, readings=None,
                    stub=None, ref_own=False, eigen_rank=None, m=4, eigen=None,
                    mesh=None) -> dict:
    """Every refresh and train step of the reference's eigen run on the
    pipeline's own batches of ``seq`` tokens (each shard its rows), each
    started from the reference's own state before it.  Returns the worst
    ratio of error to bar of each quantity (<= 1 passes): a refresh's
    bases (max(1e-5, 4 x the leaf's probe) f64 subspace distance; with
    ``ref_grads`` the probe is the larger of ``_probes``' "f32" and
    "grads", the
    reference's per-shard gradients saved as ``distinct/grads{t}/{shard}/``)
    and rotated m as P m (1e-4 of the largest magnitude), every leaf but
    ``ill_posed``; a step's loss (1e-5 relative), error feedback (each
    shard's), low-rank and full moments after it (1e-4 of the largest
    magnitude), every leaf.  A ``readings`` list gets, for each refresh
    and held leaf, its probes, its basis's distance to the reference's
    (and with ``ref_own`` the reference's own f32 error) and its ratio to
    the bar of the f32 probe alone.  ``stub(t)`` gives the numpy arrays a step's batch
    carries beside its tokens (patch embeddings or frames).  With
    ``ref_own`` (and ``ref_grads``) the probe also counts the reference's
    own f32 error: how far its refreshed basis lies from the f64 refresh
    of its own per-shard gradients.  The port's basis is then held to
    what the triangle through the two f64 refreshes allows (the port's
    f32 error, the gradients' difference, the reference's f32 error),
    where the reference's f32 refresh strays further from its f64 one
    than the port's does (an ill-conditioned leaf: a small gap after the
    r-th singular value, which 4 local steps do not resolve); the
    rotated moment P m, which moves with the subspace, is then held to
    the same probe (at least 1e-4).  ``eigen_rank`` is the run's rank
    (default ``EIGEN``'s), ``eigen`` its run (default ``EIGEN``), ``m``
    its data shards.  With ``mesh`` (a ``(data, model)`` ``DeviceMesh``,
    ``rank`` this rank's data index) each state is placed on it as the
    mesh trainer places it and the steps run on it."""
    from repro_torch.launch import sharding as Sh

    eigen = eigen or EIGEN
    shards = None if group is not None or mesh is not None else m
    ecfg = EigenCompressConfig(rank=eigen_rank or eigen["eigen_rank"],
                               refresh_every=eigen["eigen_refresh"], min_dim=64)
    sched = warmup_cosine(eigen["lr"], eigen["warmup"], eigen["steps"])

    def state(prefix):
        model, opt = _ref_state(ref, cfg, prefix, shard=rank)
        if mesh is not None:
            Sh.shard_model(model, cfg, mesh, eigen=True)
            Sh.place_eigen_state(opt, mesh)
        return model, opt

    pipe = TokenPipeline(cfg.vocab_size, seq, B, seed=SEED)
    leaves = reference_leaves(cfg)
    starts = _starts(ref, cfg)
    worst = {k: 0.0 for k in ("basis", "m_rotated", "loss", "err", "m", "v", "full")}

    def hold(key, got, want, bar):
        worst[key] = max(worst[key], _scaled_err(got, want) / bar)

    def pick(arr, name):
        layer = leaves[name].layer
        return arr if layer is None else arr[layer]

    for t in range(eigen["steps"]):
        batch = {k: torch.from_numpy(v).long() for k, v in pipe.batch(t).items()}
        if stub is not None:
            batch.update({k: torch.from_numpy(v) for k, v in stub(t).items()})
        prefix = f"distinct/state{t}/"
        if t % ecfg.refresh_every == 0:
            model, opt = _ref_state(ref, cfg, prefix)
            probes = _probes(model, batch, starts(t), opt, ecfg, [
                split_reference(_under(ref, f"distinct/grads{t}/{i}/"), cfg)
                for i in range(m)] if ref_grads else None, m=m)
            model, opt = state(prefix)
            tsteps.make_eigen_refresh_step(model, ecfg=ecfg, shards=shards, group=group,
                                           mesh=mesh)(opt, batch, starts(t))
            prefix = f"distinct/refreshed{t}/"
            for name, st in opt["eigen"].items():
                if name in ill_posed:
                    continue
                path = leaves[name].path
                want_b = pick(ref[f"{prefix}eigen/basis/{path}"], name)
                got_b = Sh.whole(st["basis"]).numpy()
                probe = max(probes[name]["f32"], probes[name].get("grads", 0.0))
                own = {}
                if ref_own:
                    own["ref_own"] = subspace_dist64(want_b, probes[name]["ref64"])
                    probe = max(probe, own["ref_own"])
                gap = subspace_dist64(got_b, want_b)
                worst["basis"] = max(worst["basis"], gap / max(1e-5, 4 * probe))
                if readings is not None:
                    readings.append({"step": t, "leaf": name,
                                     **{k: v for k, v in probes[name].items() if k != "ref64"},
                                     "basis_gap": gap, **own,
                                     "ratio_f32": gap / max(1e-5, 4 * probes[name]["f32"])})
                # P m, the rotated moment in the parameter space, which does
                # not depend on the basis's column frame.  It moves with the
                # subspace (by its distance times |m|): with ``ref_own`` its
                # bar follows the basis's.
                hold("m_rotated", got_b @ Sh.whole(st["m"]).numpy(),
                     want_b @ pick(ref[f"{prefix}eigen/m/{path}"], name),
                     max(1e-4, 4 * probe) if ref_own else 1e-4)
        model, opt = state(prefix)
        metrics = tsteps.make_eigen_train_step(
            model, adamw_cfg=AdamWConfig(), schedule=sched, shards=shards,
            group=group, mesh=mesh)(opt, batch)
        want = float(ref["distinct/losses"][t])
        worst["loss"] = max(worst["loss"], abs(float(metrics["loss"]) - want) / (1e-5 * want))
        got = opt_state_to_reference(_whole_state(opt), cfg)
        after = f"distinct/state{t + 1}/"
        for path, st in got["eigen"].items():
            err = ref[f"{after}eigen/err/{path}"]
            hold("err", st["err"], err if rank is None else err[rank], 1e-4)
            for f in ("m", "v"):
                hold(f, st[f], ref[f"{after}eigen/{f}/{path}"], 1e-4)
        for f in ("full_m", "full_v"):
            for path, v in got[f].items():
                hold("full", v, ref[f"{after}{f}/{path}"], 1e-4)
    return worst


def _assert_within(worst: dict) -> None:
    assert all(v <= 1.0 for v in worst.values()), worst


def test_eigen_steps_match_reference_stacked(ref):
    _assert_within(_teacher_forced(ref, _cfg("granite-f32")))


def _free_run(ref, cfg, **kw):
    """``train()`` end to end from the reference's initial parameters, fed
    the shared batches and the reference's start draws (the trainer's
    model factory, pipeline and draws replaced for the run)."""
    model = _model(ref, "granite-f32")
    starts = _starts(ref, cfg)
    swap = {"build": lambda c, **k: model, "TokenPipeline": SharedPipeline,
            "draw_starts": lambda shapes, *, seed, step, device: starts(step)}
    real = {k: getattr(ttrain, k) for k in swap}
    try:
        for k, v in swap.items():
            setattr(ttrain, k, v)
        _, opt, losses = ttrain.train(cfg, device="cpu", **EIGEN, **kw)
    finally:
        for k, v in real.items():
            setattr(ttrain, k, v)
    return opt, losses


# The free-running trajectory (shared rows) is held to the reference's
# over the steps before its third refresh.  After three AdamW updates the two runs'
# parameters differ in the coordinates whose gradient is at the rounding
# level (Adam moves each by a full lr step, with either sign), and the
# 4-step local solve turns that into ~1e-2 between the bases of the third
# refresh; the teacher-forced tests above hold that refresh and every
# later step from the reference's own state.
FREE_STEPS = 4


def test_eigen_trainer_stacked_runs_the_reference_trajectory(ref):
    cfg = _cfg("granite-f32")
    opt, losses = _free_run(ref, cfg, shards=4)
    assert opt["eigen"]["embed"]["err"].shape[0] == 4 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses[:FREE_STEPS], ref["eigen/losses"][:FREE_STEPS],
                               rtol=0, atol=1e-4)


def _port_refresh(ref, cfg_kw, *, group=None, rank=None):
    """The port's refresh on the reference's shared-signal gradients:
    stacked (all 4) or this rank's."""
    ecfg = EigenCompressConfig(rank=4, **cfg_kw)
    start = torch.from_numpy(ref["refresh/start"])
    gs = torch.from_numpy(ref["refresh/gs"])
    prev = torch.from_numpy(ref["refresh/prev"])
    out = {}
    for init in (False, True):
        if group is None:
            v = torch.stack([EC._local_basis(g, 4, ecfg.power_iters, start) for g in gs])
        else:
            v = EC._local_basis(gs[rank], 4, ecfg.power_iters, start)
        out[int(init)] = EC.refresh_basis(v, prev, init, cfg=ecfg, group=group).numpy()
    return out


def test_refresh_matches_reference_on_a_shared_signal(ref):
    """Algorithm 1 over the shards' local gradient bases (a shared rank-4
    signal with per-shard noise, the reference's own refresh test), aligned
    to shard 0's basis and to a previous basis: within 1e-5 f64."""
    got = _port_refresh(ref, {})
    for init in (0, 1):
        want = ref[f"refresh/basis{init}"]
        for k in range(4):  # the same basis on every shard
            assert subspace_dist64(got[init], want[k]) <= 1e-5
        if init:  # aligned to prev: the same columns, not only the span
            assert np.abs(got[init] - want[0]).max() <= 1e-5


def test_local_basis_matches_reference():
    """The subspace iteration from the reference's start: 4 steps on an
    LM-gradient-shaped matrix, within 1e-5 f64."""
    from repro.optim.eigen_compress import _local_basis as ref_local_basis

    rng = np.random.default_rng(3)
    g = rng.standard_normal((96, 40)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    start = np.asarray(jax.random.normal(key, (96, 8), jax.numpy.float32))
    want = np.asarray(ref_local_basis(jax.numpy.asarray(g), 8, 4, key))
    got = EC._local_basis(torch.from_numpy(g), 8, 4, torch.from_numpy(start.copy())).numpy()
    assert subspace_dist64(got, want) <= 1e-5


def test_embedding_refresh_is_ill_posed_on_disjoint_tokens(ref):
    """Why the teacher-forced tests leave the embedding's refreshed basis
    out, and the free-running ones repeat one draw on every shard: on
    distinct rows the shards' embedding gradients live on the rows of
    their own tokens, so two shards' local bases can be orthogonal
    (V_iᵀ V_0 = 0) and the Procrustes polar factor of that Gram is not
    defined: any implementation, the reference under another summation
    order included, returns a different basis (the reference's and the
    port's average of the same local bases were 0.99 apart in f64)."""
    model = _model(ref, "granite-f32")
    embed = dict(model.named_parameters())["embed"]
    batch = _batch(model.cfg)
    gen = torch.Generator().manual_seed(0)
    start = torch.randn(embed.shape[0], 8, generator=gen)
    vs = []
    for i in range(4):
        loss, _ = loss_fn(model, tsteps.shard_rows(batch, i, 4))
        g = torch.autograd.grad(loss, [embed])[0]
        vs.append(EC._local_basis(g, 8, 4, start))
    smallest = min(torch.linalg.svdvals(v.T @ vs[0]).max().item() for v in vs[1:])
    assert smallest < 1e-6  # some shard's basis is orthogonal to shard 0's


WORKER = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, {tests!r})
import test_torch_train as T
from repro_torch.launch.mesh import make_aggregation_mesh

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
agg = make_aggregation_mesh(device="cpu", rank=rank, world_size=world, init_method=init)
with np.load({ref!r}) as data:
    ref = dict(data)
cfg = T._cfg("granite-f32")
worst = T._teacher_forced(ref, cfg, group=agg.group, rank=rank)
_, losses = T._free_run(ref, cfg, group=agg.group)
refresh = T._port_refresh(ref, {{}}, group=agg.group, rank=rank)
with open(out, "w") as f:
    json.dump({{"worst": worst, "losses": losses,
               "refresh": {{k: v.tolist() for k, v in refresh.items()}}}}, f)
torch.distributed.destroy_process_group()
"""


def test_eigen_trainer_rank_world_matches_reference(ref, tmp_path):
    """4 gloo ranks, one shard each, each its rows of the global batch:
    every refresh and step from the reference's state (err per rank
    against the reference's shard), the free-running trajectory against
    the reference's and the stacked port's, and the refresh alone on the
    shared signal."""
    np.savez(tmp_path / "ref.npz", **ref)
    (tmp_path / "worker.py").write_text(WORKER.format(
        tests=os.path.dirname(os.path.abspath(__file__)), ref=str(tmp_path / "ref.npz")))
    init = f"file://{tmp_path / 'rendezvous'}"
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(k), "4", init,
         str(tmp_path / f"rank{k}.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    _, stacked = _free_run(ref, _cfg("granite-f32"), shards=4)
    for k in range(4):
        got = json.loads((tmp_path / f"rank{k}.json").read_text())
        _assert_within(got["worst"])
        np.testing.assert_allclose(got["losses"][:FREE_STEPS],
                                   ref["eigen/losses"][:FREE_STEPS], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["losses"], stacked, rtol=1e-6, atol=0)
        for init in (0, 1):
            assert subspace_dist64(np.asarray(got["refresh"][str(init)]),
                                   ref[f"refresh/basis{init}"][k]) <= 1e-5


def test_opt_state_crosses_both_ways(ref):
    """The reference-form eigen state (the npz's final one) into the port's
    stacked form and back, and one rank's slice of it."""
    cfg = _cfg("granite-f32")
    pre = f"distinct/state{EIGEN['steps']}/"
    paths = set(_under(ref, pre + "eigen/m/"))
    ref_opt = {
        "eigen": {p: {f: ref[f"{pre}eigen/{f}/{p}"] for f in
                      ("basis", "m", "v", "err", "initialized")} for p in paths},
        "full_m": _under(ref, pre + "full_m/"), "full_v": _under(ref, pre + "full_v/"),
        "step": ref[pre + "step"]}
    opt = opt_state_from_reference(ref_opt, cfg, device="cpu")
    assert opt["eigen"]["blocks.1.mlp.wi"]["err"].shape == (4, 64, 128)
    back = opt_state_to_reference(opt, cfg)
    for p in paths:
        for f in ("basis", "m", "v", "err"):
            assert np.array_equal(back["eigen"][p][f], ref_opt["eigen"][p][f]), (p, f)
    for p, v in ref_opt["full_m"].items():
        assert np.array_equal(back["full_m"][p], v)
    one = opt_state_from_reference(ref_opt, cfg, device="cpu", shard=2)
    assert np.array_equal(one["eigen"]["embed"]["err"].numpy(),
                          ref_opt["eigen"]["['embed']"]["err"][2])


def test_remat_gives_the_same_gradients():
    """``cfg.remat == "full"`` runs each block under torch.utils.checkpoint
    in train mode: the same loss and gradients bit for bit on the CPU."""
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(_cfg("llama-f32"), remat=remat)
        model = LM(cfg, device="cpu", param_dtype=torch.float32)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        loss, _ = loss_fn(model, _batch(cfg))
        out[remat] = (loss.detach(), torch.autograd.grad(loss, list(model.parameters())))
    assert torch.equal(out["none"][0], out["full"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["none"][1], out["full"][1]))


def test_f32_master_weights_give_the_bf16_models_logits():
    """A bf16 config with f32 master weights (training) computes the logits
    of the same draws stored in bf16 (serving), bit for bit: each weight is
    cast to bf16 at its use."""
    from repro_torch.models import build

    cfg = get_reduced_config("llama3.2-3b")
    tokens = _batch(cfg)["tokens"]
    master = build(cfg, device="cpu", param_dtype=torch.float32,
                   generator=torch.Generator().manual_seed(0))
    stored = build(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert master.embed.dtype == torch.float32 and stored.embed.dtype == torch.bfloat16
    with torch.no_grad():
        assert torch.equal(master(tokens, mode="train")[0], stored(tokens, mode="train")[0])

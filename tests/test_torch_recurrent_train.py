"""Port parity of training the recurrent families on the CPU:
recurrentgemma-2b (RG-LRU + local attention, the hybrid family) and
mamba2-370m (Mamba2 SSD with a tied embedding, the SSM family), at their
reduced configs, B = 4 rows of S = 40 tokens: past the hybrid's window
of 16 and off the SSM's chunk of 16 (its padded path).

The reference runs once for the module, in one subprocess on 4 fake CPU
devices (a data axis of 4): the loss and its gradients, its baseline
trainer (AdamW), and its eigen trainer with every state before and after
each refresh and step saved, as ``test_torch_train.py``'s reference run
does for the dense family (whose teacher-forced check this file reuses).
A second subprocess beside it computes the witness of the refresh bar
below (``WITNESS_CODE``).

Bars:
  * f32 (with f32 attention probabilities): loss within 1e-5 relative,
    every gradient within 1e-4 relative L2, leaf by leaf through the
    interop path map;
  * bf16 (the configs' dtype): the dense family's 2e-3 relative on the
    loss and 5e-2 relative L2 on every gradient, or the reference's own
    spread where that is wider: its compiled gradient against the same
    gradient run op by op (``jax.disable_jit``), which rounds the same
    bf16 values at other places (the port's ``silu_ref`` and
    ``gelu_tanh_ref`` round where the reference's forward does, but
    their backward rounds elsewhere).  The spread is computed only where
    the port's error exceeds the bar;
  * the baseline trainer, f32, 8 AdamW steps: losses within 1e-4, every
    parameter after the last step within 1e-4 relative L2;
  * the eigen trainer (rank 8, min_dim 64, a refresh every 2 steps, 6
    steps) stacked on 4 shards, teacher-forced on the pipeline's own
    batches (each shard its rows): ``test_torch_train.py``'s bars, the
    refreshed bases' probe also counting the gradients' own difference:
    the two frameworks' gradients through the scans and the conv differ
    by f32 summation order, and each shard's 4-step local solve
    amplifies that difference as it amplifies its own rounding, so the
    reference also saves each shard's gradients at each refresh; each of
    the port's is held within 1e-4 relative L2 of it, and the probe takes
    the f64 refresh of those beside the f64 refresh of the port's.  The
    witness: the reference's own compiled and op-by-op gradients at the
    first refresh fail the dense bar against each other, and the port's
    lie within 4 x that gap of the reference's compiled ones.  The
    hybrid's untied embedding is left out of the refreshed bases, as the
    dense family's (ill-posed on distinct rows); mamba2's tied embedding
    is held (the unembedding's gradient touches every row, so the shards'
    local bases overlap);
  * remat on against off: bit for bit;
  * the primitives' gradients: ``causal_conv`` and ``_ssd_scan_chunked``
    against ``jax.grad`` of the reference's within 1e-5 relative L2 (the
    SSD exponent masked before ``exp``, so no NaN above the diagonal);
    ``doubling_scan`` against a sequential f64 loop within 1e-5 relative
    L2 at S in {1, 7, 64, 4096}, and against ``associative_scan``'s.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as T
from conftest import SRC, run_with_devices
from repro.configs import get_reduced_config as ref_reduced_config
from repro.models import init_split
from repro.models import layers as JL
from repro.models.registry import build as ref_build
from repro_torch.configs import get_reduced_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.interop import (
    join_reference,
    opt_state_from_reference,
    opt_state_to_reference,
    reference_leaves,
    split_reference,
)
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import LM, loss_fn
from repro_torch.models import layers as TL
from repro_torch.optim import eigen_compress as EC

B, S, SEED = 4, 40, 0
HYBRID, SSM = "recurrentgemma-2b", "mamba2-370m"
F32 = dict(dtype="float32", attn_probs_bf16=False)
TAGS = {"hybrid-f32": (HYBRID, F32), "ssm-f32": (SSM, F32),
        "hybrid-bf16": (HYBRID, {}), "ssm-bf16": (SSM, {})}
FAMILIES = {"hybrid-f32": HYBRID, "ssm-f32": SSM}
TRAIN = dict(steps=8, batch=B, seq=S, lr=1e-3, warmup=2, log_every=100)
EIGEN = {**T.EIGEN, "seq": S}
# The untied embedding's refresh is ill-posed on distinct rows
# (test_torch_train.py::ILL_POSED); the tied one's is not
# (test_tied_embedding_refresh_is_well_posed_on_distinct_rows).
ILL_POSED = {"hybrid-f32": ("embed",), "ssm-f32": ()}
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
from repro.optim.adamw import AdamWConfig
from repro.optim.eigen_compress import EigenCompressConfig
from repro.optim.schedule import warmup_cosine

OUT, B, S, SEED = {out!r}, {B}, {S}, {SEED}
TAGS, FAMILIES, TRAIN, EIGEN = {tags!r}, {families!r}, {train!r}, {eigen!r}
out = {{}}


def put(prefix, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(k)] = np.asarray(v, np.float32)


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

mesh = make_host_mesh(model=1)
for tag in FAMILIES:
    params, _, losses = train(tag, mesh=mesh, **TRAIN)
    out[f"train/{{tag}}"] = np.asarray(losses)
    put(f"trained/{{tag}}", params)

# The eigen trainer: train()'s loop on the pipeline's own batches (each
# shard its rows), with each refresh's start bases and every state before
# and after each refresh and step saved.
ecfg = EigenCompressConfig(rank=EIGEN["eigen_rank"], refresh_every=EIGEN["eigen_refresh"],
                           min_dim=64)


def save_state(prefix, params, opt):
    put(prefix + "params", params)
    for path, st in opt["eigen"].items():
        for f, v in st.items():
            out[f"{{prefix}}eigen/{{f}}/{{path}}"] = np.asarray(v)
    for f in ("full_m", "full_v"):
        for path, v in opt[f].items():
            out[f"{{prefix}}{{f}}/{{path}}"] = np.asarray(v)
    out[prefix + "step"] = np.asarray(opt["step"])


for tag in FAMILIES:
    cfg = cfgs[tag]
    values, axes = init_split(cfg, jax.random.PRNGKey(SEED))
    values = jax.tree.map(np.asarray, values)
    pipe = TokenPipeline(cfg.vocab_size, S, B, seed=SEED)
    train_jit, refresh_jit, (ps, os_, bs) = jit_eigen_steps(
        cfg, mesh, values, axes, pipe.batch(0), adamw_cfg=AdamWConfig(),
        schedule=warmup_cosine(EIGEN["lr"], EIGEN["warmup"], EIGEN["steps"]), ecfg=ecfg)
    opt = jax.device_put(eigen_opt_init(values, ecfg, 4, axes), os_)
    params = jax.device_put(values, ps)
    shard_grad = jax.jit(jax.grad(lambda v, b: build(cfg).loss(v, b)[0]))
    key = jax.random.PRNGKey(SEED + 1)
    losses = []
    for step in range(EIGEN["steps"]):
        b = jax.device_put(pipe.batch(step), bs)
        save_state(f"{{tag}}/distinct/state{{step}}/", params, opt)
        if step % ecfg.refresh_every == 0:
            for i in range(4):
                rows = {{k: jnp.asarray(v[i * B // 4:(i + 1) * B // 4])
                        for k, v in pipe.batch(step).items()}}
                put(f"{{tag}}/distinct/grads{{step}}/{{i}}/", shard_grad(params, rows))
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
                out[f"{{tag}}/eigen/starts{{k}}/{{path}}"] = np.asarray(start)
            opt = refresh_jit(params, opt, b, sub)
            save_state(f"{{tag}}/distinct/refreshed{{step}}/", params, opt)
        params, opt, metrics = train_jit(params, opt, b)
        losses.append(float(metrics["loss"]))
    save_state(f"{{tag}}/distinct/state{{EIGEN['steps']}}/", params, opt)
    out[f"{{tag}}/distinct/losses"] = np.asarray(losses)
np.savez(OUT, **out)
'''
# The witness for the refresh's amplification: each shard's gradient at
# the first refresh (the initial values, batch 0) as the reference
# computes it compiled and op by op (jax.disable_jit), two summation
# orders of the same f32 function.  Its own process, run beside the one
# above: op by op compiles each primitive anew (about a minute).
WITNESS_CODE = r'''
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_reduced_config
from repro.data.tokens import TokenPipeline
from repro.models import init_split
from repro.models.registry import build

OUT, B, S, SEED = {out!r}, {B}, {S}, {SEED}
TAGS, FAMILIES = {tags!r}, {families!r}
out = {{}}
for tag in FAMILIES:
    arch, kw = TAGS[tag]
    cfg = dataclasses.replace(get_reduced_config(arch), **kw)
    values = jax.tree.map(np.asarray, init_split(cfg, jax.random.PRNGKey(SEED))[0])
    grad = jax.grad(lambda v, b: build(cfg).loss(v, b)[0])
    batch = TokenPipeline(cfg.vocab_size, S, B, seed=SEED).batch(0)
    for i in range(4):
        rows = {{k: jnp.asarray(v[i * B // 4:(i + 1) * B // 4]) for k, v in batch.items()}}
        for kind, fn in (("jit", jax.jit(grad)), ("eager", grad)):
            with jax.disable_jit(kind == "eager"):
                flat = jax.tree_util.tree_flatten_with_path(fn(values, rows))[0]
            for k, v in flat:
                out[f"witness/{{tag}}/{{kind}}/{{i}}/" + jax.tree_util.keystr(k)] = np.asarray(v)
np.savez(OUT, **out)
'''


def _cfg(tag):
    arch, kw = TAGS[tag]
    return dataclasses.replace(get_reduced_config(arch), name=tag, **kw)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These shapes are tiny: one intra-op thread, so that the suite's
    other workers' threads do not stall this module's (and the reverse)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recurrent-train-ref")
    paths = [tmp / "ref.npz", tmp / "witness.npz"]
    kw = dict(B=B, S=S, SEED=SEED, tags=TAGS, families=FAMILIES)
    codes = [REF_CODE.format(out=str(paths[0]), train=TRAIN, eigen=EIGEN, **kw),
             WITNESS_CODE.format(out=str(paths[1]), **kw)]
    with pytest.MonkeyPatch.context() as mp:
        # One Eigen thread a device in the reference's processes, for the same reason.
        mp.setenv("XLA_FLAGS", " ".join(
            [os.environ.get("XLA_FLAGS", ""), "--xla_cpu_multi_thread_eigen=false"]).strip())
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            for job in [pool.submit(run_with_devices, code, n_devices=4) for code in codes]:
                job.result()
    out = {}
    for path in paths:
        with np.load(path) as data:
            out.update(data)
    return out


def _batch(cfg, step=0):
    return {k: torch.from_numpy(v).long()
            for k, v in TokenPipeline(cfg.vocab_size, S, B, seed=SEED).batch(step).items()}


def _grads(model, batch):
    loss, metrics = loss_fn(model, batch)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), metrics, join_reference(dict(zip(params, grads)), model.cfg)


def _reference_spread(tag):
    """The reference's own bf16 spread: its compiled loss and gradients
    against the same run op by op, (loss relative gap, worst relative L2
    of a leaf)."""
    arch, kw = TAGS[tag]
    jcfg = dataclasses.replace(ref_reduced_config(arch), **kw)
    values, _ = init_split(jcfg, jax.random.PRNGKey(SEED))
    batch = {k: jnp.asarray(v) for k, v in
             TokenPipeline(jcfg.vocab_size, S, B, seed=SEED).batch(0).items()}
    fn = jax.value_and_grad(ref_build(jcfg).loss, has_aux=True)
    (l1, _), g1 = jax.jit(fn)(values, batch)
    with jax.disable_jit():
        (l2, _), g2 = fn(values, batch)
    gaps = [T._rel_l2(np.asarray(b, np.float32), np.asarray(a, np.float32))
            for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2))]
    return abs(float(l2) - float(l1)) / abs(float(l1)), max(gaps)


@pytest.mark.parametrize("tag,loss_bar,grad_bar", [
    ("hybrid-f32", 1e-5, 1e-4), ("ssm-f32", 1e-5, 1e-4),
    ("hybrid-bf16", 2e-3, 5e-2), ("ssm-bf16", 2e-3, 5e-2)])
def test_loss_and_gradients_match_reference(ref, tag, loss_bar, grad_bar):
    """Loss and every leaf's gradient through the conv, the RG-LRU scan,
    the chunked SSD (padded: 40 is no multiple of the chunk), the local
    attention past its window and, for mamba2, the tied embedding (the
    gather's gradient plus the unembedding's)."""
    model = T._model_at(ref, _cfg(tag), f"values/{tag}")
    loss, metrics, got = _grads(model, _batch(model.cfg))
    want_loss = float(ref[f"loss/{tag}"])
    want = T._under(ref, f"grads/{tag}")
    assert set(got) == set(want)
    assert float(metrics["aux"]) == 0.0
    assert all(np.isfinite(v).all() for v in got.values())
    loss_err = abs(float(loss) - want_loss) / abs(want_loss)
    errs = {k: T._rel_l2(got[k], want[k]) for k in want}
    widened = loss_err > loss_bar or max(errs.values()) > grad_bar
    if widened:
        assert tag.endswith("bf16"), (loss_err, errs)
        loss_spread, grad_spread = _reference_spread(tag)
        loss_bar, grad_bar = max(loss_bar, loss_spread), max(grad_bar, grad_spread)
    print(f"{tag}: loss {loss_err:.3g}, worst gradient {max(errs.values()):.3g} (bars "
          f"{loss_bar:.3g} / {grad_bar:.3g}{', the reference spread' if widened else ''})")
    assert loss_err <= loss_bar
    assert max(errs.values()) <= grad_bar, errs


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_baseline_trainer_matches_reference(ref, tag, monkeypatch):
    """The launcher's trainer (AdamW: clip, decay by the reference leaf,
    the stacked RG-LRU / SSD vectors decayed as the reference's (L, .)
    leaves are) for 8 steps from the reference's parameters."""
    model = T._model_at(ref, _cfg(tag), f"values/{tag}")
    monkeypatch.setattr(ttrain, "build", lambda cfg, **kw: model)
    _, opt, losses = ttrain.train(model.cfg, device="cpu", **TRAIN)
    np.testing.assert_allclose(losses, ref[f"train/{tag}"], rtol=0, atol=1e-4)
    assert int(opt["step"]) == TRAIN["steps"]
    got = join_reference(dict(model.named_parameters()), model.cfg)
    want = T._under(ref, f"trained/{tag}")
    errs = {k: T._rel_l2(got[k], want[k]) for k in want}
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_eigen_steps_match_reference_stacked(ref, tag):
    """Every refresh and train step of the reference's eigen run, each
    from the reference's state before it, stacked on 4 shards, each shard
    its rows (``test_torch_train.py``'s bars).  At rank 8 mamba2's wdt
    (64, 8) has r = n: its compression is lossless."""
    cfg = _cfg(tag)
    comp = tsteps.compressed_paths(cfg, EC.EigenCompressConfig(rank=8, min_dim=64))
    if tag == "ssm-f32":
        assert comp["blocks.0.mixer.wdt"] == (64, 8) and "embed" in comp
    readings = []
    worst = T._teacher_forced(T._under(ref, f"{tag}/"), cfg, seq=S, ill_posed=ILL_POSED[tag],
                              ref_grads=True, readings=readings)
    print(f"{tag}: refreshed bases over the f32 probe's bar, worst "
          f"{max(r['ratio_f32'] for r in readings):.3g}; probes f32 up to "
          f"{max(r['f32'] for r in readings):.3g}, gradients up to "
          f"{max(r['grads'] for r in readings):.3g}")
    T._assert_within(worst)


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_refresh_bar_is_the_references_own_summation_order(ref, tag):
    """Why the refreshed bases' probe above counts the gradients (ROADMAP
    C15), at the first refresh, with the reference's per-shard gradients
    compiled and op by op (``WITNESS_CODE``: two f32 summation orders of
    one function).  Pushed through the same f64 refresh they move some
    held leaf's basis past the dense bar, max(1e-5, 4 x the f32 probe):
    that bar fails the reference against itself.  And each of the port's
    per-shard gradients lies within 4 x (the bars' factor on a probe) the
    reference's own compiled-vs-op-by-op gap of its compiled one, leaf by
    leaf: the port's gradients differ from the reference's by a summation
    order, no more."""
    cfg = _cfg(tag)
    ecfg = EC.EigenCompressConfig(rank=EIGEN["eigen_rank"], refresh_every=EIGEN["eigen_refresh"],
                                  min_dim=64)
    mine = T._under(ref, f"{tag}/")
    starts = T._starts(mine, cfg)(0)
    model, opt = T._ref_state(mine, cfg, "distinct/state0/")
    jit, eager = ([split_reference(T._under(ref, f"witness/{tag}/{kind}/{i}/"), cfg)
                   for i in range(4)] for kind in ("jit", "eager"))
    probes = T._probes(model, _batch(cfg), starts, opt, ecfg, jit)
    a, b = (T._refresh64(g, starts, opt, ecfg) for g in (jit, eager))
    own = {n: T.subspace_dist64(a[n], b[n]) for n in probes if n not in ILL_POSED[tag]}
    over = {n: d / max(1e-5, 4 * probes[n]["f32"]) for n, d in own.items()}
    spread = {n: max(T._rel_l2(e[n], j[n]) for e, j in zip(eager, jit)) for n in probes}
    gaps = {n: probes[n]["gap"] / spread[n] for n in probes}
    print(f"{tag}: the reference's compiled vs op-by-op gradients move the refreshed bases up "
          f"to {max(own.values()):.3g}, {max(over.values()):.3g} x the dense bar; the port's "
          f"gradients move them up to {max(probes[n]['grads'] for n in own):.3g}; the "
          f"port's gradient gap over the reference's own, up to {max(gaps.values()):.3g}")
    assert max(over.values()) > 1.0, over
    assert max(gaps.values()) <= 4.0, gaps


def test_tied_embedding_refresh_is_well_posed_on_distinct_rows(ref):
    """mamba2's embedding is tied: its gradient is the gather's (the rows
    of the shard's own tokens) plus the unembedding's (every row), so
    each shard's local basis meets shard 0's in every direction (V_iᵀ V_0
    has no zero singular value) and the Procrustes polar factor of that
    Gram is defined: the teacher-forced test holds that leaf.  The untied
    hybrid's V_iᵀ V_0 is singular on these rows, as the dense family's
    (``test_torch_train.py::test_embedding_refresh_is_ill_posed_on_disjoint_tokens``),
    so its refresh is not defined and that test leaves it out."""
    smallest = {}
    for tag in FAMILIES:
        model = T._model_at(ref, _cfg(tag), f"values/{tag}")
        embed = dict(model.named_parameters())["embed"]
        batch = _batch(model.cfg)
        start = torch.randn(embed.shape[0], 8, generator=torch.Generator().manual_seed(0))
        vs = []
        for i in range(4):
            loss, _ = loss_fn(model, tsteps.shard_rows(batch, i, 4))
            vs.append(EC._local_basis(torch.autograd.grad(loss, [embed])[0], 8, 4, start))
        smallest[tag] = min(torch.linalg.svdvals(v.T @ vs[0]).min().item() for v in vs[1:])
    assert smallest["ssm-f32"] > 1e-5 and smallest["hybrid-f32"] < 1e-6, smallest


def test_local_basis_keeps_its_rank_when_r_equals_n():
    """mamba2's wdt at r = n (its heads): a shard's gradient (d, n) of
    rank below n still gets an orthonormal (d, n) basis from the
    subspace iteration (Householder QR pads the null directions), which
    spans the gradient's columns, so compressing it loses nothing."""
    rng = np.random.default_rng(4)
    g = torch.from_numpy((rng.standard_normal((64, 5)) @ rng.standard_normal((5, 8)))
                         .astype(np.float32))  # rank 5 of 8
    start = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    q = EC._local_basis(g, 8, 4, start)
    assert torch.allclose(q.T @ q, torch.eye(8), atol=1e-5)
    state = EC.init_state(64, 8, EC.EigenCompressConfig(rank=8))
    state["basis"].copy_(q)
    err = torch.zeros(64, 8)
    low = EC.compress(g, state, err)
    assert low.shape == (8, 8) and float(err.norm() / g.norm()) <= 1e-5


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_opt_state_crosses_both_ways(ref, tag):
    """The reference-form eigen state after the last step into the port's
    stacked form and back bit for bit, and one rank's slice of it: the
    hybrid's two stages (L = 1 each) and the SSM's r = n leaf."""
    cfg = _cfg(tag)
    pre = f"{tag}/distinct/state{EIGEN['steps']}/"
    paths = set(T._under(ref, pre + "eigen/m/"))
    ref_opt = {
        "eigen": {p: {f: ref[f"{pre}eigen/{f}/{p}"] for f in
                      ("basis", "m", "v", "err", "initialized")} for p in paths},
        "full_m": T._under(ref, pre + "full_m/"), "full_v": T._under(ref, pre + "full_v/"),
        "step": ref[pre + "step"]}
    opt = opt_state_from_reference(ref_opt, cfg, device="cpu")
    assert set(opt["eigen"]) == set(tsteps.compressed_paths(
        cfg, EC.EigenCompressConfig(rank=8, min_dim=64)))
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
    assert np.array_equal(one["eigen"]["embed"]["err"].numpy(),
                          ref_opt["eigen"]["['embed']"]["err"][2])


@pytest.mark.parametrize("arch", [HYBRID, SSM])
def test_remat_gives_the_same_gradients(arch):
    """Each recurrent block under torch.utils.checkpoint (the full
    configs' ``remat == "full"``): the same loss and gradients bit for bit
    on the CPU."""
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(get_reduced_config(arch), remat=remat, **F32)
        model = LM(cfg, device="cpu", param_dtype=torch.float32)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        loss, _ = loss_fn(model, _batch(cfg))
        out[remat] = (loss.detach(), torch.autograd.grad(loss, list(model.parameters())))
    assert torch.equal(out["none"][0], out["full"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["none"][1], out["full"][1]))


# ---------------------------------------------------------- primitives ----
def _rel(got: torch.Tensor, want) -> float:
    return T._rel_l2(got.detach().double().numpy(), np.asarray(want, np.float64))


def test_causal_conv_gradient_matches_reference():
    """d<y, cot>/dx and /dw of the depthwise causal conv (K = 4, zero
    tail) against ``jax.grad`` of the reference's ``_causal_conv``."""
    rng = np.random.default_rng(1)
    x, w, cot = (rng.standard_normal(s).astype(np.float32)
                 for s in ((2, S, 24), (4, 24), (2, S, 24)))
    want = jax.jit(jax.grad(lambda x, w: jnp.sum(JL._causal_conv(x, w, None)[0] * cot),
                            argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = torch.autograd.grad((TL.causal_conv(xt, wt, None)[0] * torch.from_numpy(cot)).sum(),
                              (xt, wt))
    assert max(_rel(g, v) for g, v in zip(got, want)) <= 1e-5


def _scan_f64(a, b):
    """h_t = a_t h_{t-1} + b_t one step at a time, in f64."""
    h, hs = torch.zeros_like(b[:, 0]), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _scan_inputs(s, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (2, s, 8)).astype(np.float32)  # RG-LRU's a in (0, 1)
    b = rng.standard_normal((2, s, 8)).astype(np.float32)
    cot = rng.standard_normal((2, s, 8)).astype(np.float32)
    return a, b, cot


@pytest.mark.parametrize("s", [1, 7, 64, 4096])
def test_doubling_scan_gradient_matches_a_sequential_loop(s):
    """The doubling scan's gradient wrt a and b against autograd through
    the sequential recurrence in f64: within 1e-5 relative L2 (the scan
    sums in another order, a few f32 roundings a pass)."""
    a, b, cot = _scan_inputs(s, s)
    got_in = [torch.from_numpy(v).requires_grad_() for v in (a, b)]
    got = torch.autograd.grad((TL.doubling_scan(*got_in) * torch.from_numpy(cot)).sum(), got_in,
                              allow_unused=True, materialize_grads=True)  # S = 1 uses no a
    want_in = [torch.from_numpy(v).double().requires_grad_() for v in (a, b)]
    want = torch.autograd.grad((_scan_f64(*want_in) * torch.from_numpy(cot).double()).sum(),
                               want_in)
    assert max(_rel(g, w.numpy()) for g, w in zip(got, want)) <= 1e-5


def test_doubling_scan_gradient_matches_associative_scan():
    """The same gradient against ``jax.grad`` through the reference's
    ``associative_scan`` (its RG-LRU combine): two summation orders,
    within 1e-5 relative L2."""
    a, b, cot = _scan_inputs(64, 5)

    def comb(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    want = jax.jit(jax.grad(lambda a, b: jnp.sum(
        jax.lax.associative_scan(comb, (a, b), axis=1)[1] * cot), argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    xs = [torch.from_numpy(v).requires_grad_() for v in (a, b)]
    got = torch.autograd.grad((TL.doubling_scan(*xs) * torch.from_numpy(cot)).sum(), xs)
    assert max(_rel(g, w) for g, w in zip(got, want)) <= 1e-5


@pytest.mark.parametrize("regime", ["moderate", "overflow"])
def test_ssd_scan_gradient_matches_reference_without_nan(regime):
    """``_ssd_scan_chunked``'s gradient wrt a, u, B, C and the entering
    state against ``jax.grad`` of the reference's, every gradient finite.
    Moderate decays (a in [0.3, 0.99]): within 1e-5 relative L2.  Decays
    of e^-4 .. e^-10, where the unmasked exponent above the diagonal
    would overflow f32 (cum_t - cum_tau passes +88 within a chunk of 16):
    the gradient wrt a cancels (each f32 result lies ~5e-4 from the f64
    one, the reference's too), so each gradient within max(1e-5, 4 x the
    reference's own f32 error against the same gradient in f64, the
    port's function carried out in f64)."""
    rng = np.random.default_rng(2)
    bsz, s, h, p, n, q = 2, 48, 3, 4, 5, 16
    if regime == "moderate":
        a = rng.uniform(0.3, 0.99, (bsz, s, h)).astype(np.float32)
    else:
        a = np.exp(-rng.uniform(4.0, 10.0, (bsz, s, h))).astype(np.float32)
        assert (-np.log(a[:, :q])).sum(axis=1).max() > 88.0  # exp would overflow unmasked
    u, bm, cm, s0 = (rng.standard_normal(sh).astype(np.float32) for sh in
                     ((bsz, s, h, p), (bsz, s, n), (bsz, s, n), (bsz, h, p, n)))
    cy = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    cs = rng.standard_normal((bsz, h, p, n)).astype(np.float32)

    def ref_loss(*xs):
        y, last = JL._ssd_scan_chunked(*xs[:4], xs[4], q)
        return jnp.sum(y * cy) + jnp.sum(last * cs)

    want = jax.jit(jax.grad(ref_loss, argnums=tuple(range(5))))(
        *(jnp.asarray(v) for v in (a, u, bm, cm, s0)))

    def port(dtype):
        xs = [torch.from_numpy(v).to(dtype).requires_grad_() for v in (a, u, bm, cm, s0)]
        y, last = TL._ssd_scan_chunked(*xs[:4], xs[4], q)
        return torch.autograd.grad((y * torch.from_numpy(cy).to(dtype)).sum()
                                   + (last * torch.from_numpy(cs).to(dtype)).sum(), xs)

    got = port(torch.float32)
    assert all(torch.isfinite(g).all() for g in got)
    exact = port(torch.float64) if regime == "overflow" else None
    for i, (g, w) in enumerate(zip(got, want)):
        bar = 1e-5 if exact is None else max(1e-5, 4 * _rel(exact[i], w))
        assert _rel(g, w) <= bar, (i, _rel(g, w), bar)


# ---------------------------------------------------------- rank world ----
WORKER = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, {tests!r})
import test_torch_recurrent_train as R
import test_torch_train as T
from repro_torch.launch.mesh import make_aggregation_mesh

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
agg = make_aggregation_mesh(device="cpu", rank=rank, world_size=world, init_method=init)
with np.load({ref!r}) as data:
    ref = dict(data)
worst = T._teacher_forced(ref, R._cfg("ssm-f32"), group=agg.group, rank=rank, seq=R.S,
                          ill_posed=R.ILL_POSED["ssm-f32"], ref_grads=True)
with open(out, "w") as f:
    json.dump(worst, f)
torch.distributed.destroy_process_group()
"""


@pytest.mark.slow
def test_eigen_trainer_rank_world_matches_reference(ref, tmp_path):
    """mamba2 on 4 gloo ranks, one shard each, each its rows: every
    refresh (the tied embedding's included) and step from the
    reference's state, each rank's error feedback against the
    reference's shard."""
    np.savez(tmp_path / "ref.npz", **T._under(ref, "ssm-f32/"))
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
    for k in range(4):
        T._assert_within(json.loads((tmp_path / f"rank{k}.json").read_text()))

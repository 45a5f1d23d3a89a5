"""Port parity of training the MoE family on the CPU: qwen3-moe-30b-a3b and
kimi-k2-1t-a32b at their reduced configs (2 layers, d_model 64, 8
experts top-2, d_ff 32, capacity factor 1.25; the two are one config
field for field but the name, ``test_reduced_configs_differ_only_in_name``,
so the reference runs each form once and both archs' port runs are held
to it), B = 4 rows of S = 32 tokens, in both dispatch forms (the
config's einsum form, a capacity per row, and ``moe_impl="sort"``, one
capacity over the batch).

The reference runs once for the module: two subprocesses side by side on
4 fake CPU devices (a data axis of 4), one a form, each computing the
loss and its gradients (``jax.value_and_grad`` of the reference's loss:
CE plus 0.01 times the layers' Switch aux loss) at the reduced config
and at the mid-width model whose routing collapses (qwen3's blocks at 6
layers, d_model 256, 32 experts top-8, d_ff 64, 2 x 256 tokens), its
baseline trainer (AdamW, 8 steps: losses, parameters and moments), and
its eigen trainer with every state before and after each refresh and
step saved and each shard's gradients at each refresh, as
``test_torch_recurrent_train.py``'s reference run does.

Bars (f32 with f32 attention probabilities):
  * one MoE layer against ``jax.grad`` of ``apply_moe_einsum`` /
    ``apply_moe_sort`` (in this process, on the same numpy inputs), with
    drops (capacity factor 1.0, asserted) and without (100): the loss
    ``sum(out * cot) + 0.01 aux`` within 1e-5 relative, the gradients of
    x, ``router``, ``wi``, ``wg`` and ``wo`` within 1e-4 relative L2;
  * dropped pairs: a token whose pairs were all dropped gets exactly zero
    gradient (no aux), and every gradient equals autograd of the kept
    pairs written out in f64 (gate x SwiGLU, the gates renormalised over
    all K) within 1e-5 relative L2;
  * bf16 (the configs' dtype): each leaf's gradient lies no further from
    the reference's f32 gradient than the reference's own bf16 gradient
    does (its bf16-vs-f32 gap), up to 1e-6 in relative L2 (leaves the port
    computes bit for bit give the same gap up to the norms' last digits);
  * the LM's loss within 1e-5 relative and every gradient within 1e-4
    relative L2, leaf by leaf through the interop path map, at the
    reduced configs and at the mid-width model (28-49 % of its last
    layer's pairs dropped);
  * remat "full" against "none": the same loss and gradients bit for bit;
  * ``compressed_paths`` equal to the reference's for both archs at their
    full and reduced configs, at a rank where the router (L, d, e) is
    compressed and one where it is not; the experts never;
  * the baseline trainer, 8 AdamW steps from the reference's parameters:
    losses within 1e-4, every parameter and both moments after the last
    step within 1e-4 relative L2;
  * the eigen trainer (rank 4: the router (64, 8) is compressed, below
    its gradient's rank e - 1; min_dim 64, a refresh every 2 steps, 6
    steps) teacher-forced on the
    pipeline's own batches, each shard its rows, stacked on 4 shards and
    (the einsum form) on 4 gloo ranks: ``test_torch_train.py``'s bars,
    the refreshed bases' probe counting the gradients' own difference
    (``ref_grads=True``), the untied embedding's refreshed basis left out
    (ill-posed on distinct rows, ROADMAP C7);
  * the optimizer states (AdamW's 4-D expert moments, the eigen state of
    the router and of the attention views) into the port's form and back
    bit for bit.
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
from repro.configs import get_config as ref_config
from repro.configs import get_reduced_config as ref_reduced_config
from repro.launch.steps import compressed_paths as ref_compressed_paths
from repro.models import layers as JL
from repro.models.registry import abstract_params
from repro.optim.eigen_compress import EigenCompressConfig as RefECfg
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.interop import (
    join_reference,
    opt_state_from_reference,
    opt_state_to_reference,
    reference_leaves,
)
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import LM, loss_fn
from repro_torch.models import layers as TL
from repro_torch.optim import eigen_compress as EC

QWEN, KIMI = "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"
ARCHS = [QWEN, KIMI]
IMPLS = ["einsum", "sort"]
B, S, SEED = 4, 32, 0
F32 = dict(dtype="float32", attn_probs_bf16=False)
TAGS = {"einsum-f32": (QWEN, {**F32, "moe_impl": "einsum"}),
        "sort-f32": (QWEN, {**F32, "moe_impl": "sort"})}
# The mid-width model of tests/test_torch_moe.py, whose random routing
# concentrates on a few experts as depth grows (ROADMAP C12).
MID = dict(num_layers=6, d_model=256, num_heads=4, num_kv_heads=1, d_ff=64, vocab_size=1024,
           num_experts=32, **F32)
MID_B, MID_S = 2, 256
TRAIN = dict(steps=8, batch=B, seq=S, lr=1e-3, warmup=2, log_every=100)
# Rank 4: the router (64, 8) is compressed below e - 1 = 7, its
# gradient's rank (test_router_gradient_has_rank_below_its_experts).
EIGEN = {**T.EIGEN, "seq": S, "eigen_rank": 4}
ILL_POSED = ("embed",)  # the untied embedding (test_torch_train.py::ILL_POSED)
REF_CODE = r'''
import dataclasses, sys, types
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import registry, get_config, get_reduced_config
from repro.data.tokens import TokenPipeline
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import eigen_opt_init, jit_eigen_steps
from repro.launch.train import train
from repro.models import init_split
from repro.models.registry import build
from repro.optim.adamw import AdamWConfig
from repro.optim.eigen_compress import EigenCompressConfig
from repro.optim.schedule import warmup_cosine

OUT, B, S, SEED, TAG = {out!r}, {B}, {S}, {SEED}, {tag!r}
ARCH, KW = {arch!r}, {kw!r}
TRAIN, EIGEN, MID, MID_B, MID_S = {train!r}, {eigen!r}, {mid!r}, {mid_b}, {mid_s}
out = {{}}


def put(prefix, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(k)] = np.asarray(v, np.float32)


# train() takes an arch id: register the variant as examples/train_lm.py does.
cfg = dataclasses.replace(get_reduced_config(ARCH), name=TAG, **KW)
mod = types.ModuleType("cfg_" + TAG.replace("-", "_"))
mod.CONFIG, mod.reduced = cfg, (lambda: cfg)
sys.modules["repro.configs." + mod.__name__] = mod
registry.ARCHS[TAG] = mod.__name__


def loss_and_grads(cfg, batch, prefix):
    values, _ = init_split(cfg, jax.random.PRNGKey(SEED))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(build(cfg).loss, has_aux=True))(
        values, batch)
    put(f"values/{{prefix}}", values)
    put(f"grads/{{prefix}}", grads)
    out[f"loss/{{prefix}}"] = np.asarray(loss)
    out[f"aux/{{prefix}}"] = np.asarray(metrics["aux"])


loss_and_grads(cfg, {{k: jnp.asarray(v) for k, v in
                     TokenPipeline(cfg.vocab_size, S, B, seed=SEED).batch(0).items()}}, TAG)
mid = dataclasses.replace(get_config(ARCH), moe_impl=KW["moe_impl"], **MID)
rng = np.random.default_rng(0)
tokens = rng.integers(0, mid.vocab_size, (MID_B, MID_S)).astype(np.int32)
labels = rng.integers(0, mid.vocab_size, (MID_B, MID_S)).astype(np.int32)
loss_and_grads(mid, {{"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}}, "mid")
out["mid/tokens"], out["mid/labels"] = tokens, labels

mesh = make_host_mesh(model=1)
params, opt, losses = train(TAG, mesh=mesh, **TRAIN)
out["train/losses"] = np.asarray(losses)
put("trained/params", params)
put("trained/m", opt["m"])
put("trained/v", opt["v"])
out["trained/step"] = np.asarray(opt["step"])

# The eigen trainer: train()'s loop on the pipeline's own batches (each
# shard its rows), with each refresh's start bases, each shard's gradients
# at each refresh and every state before and after each refresh and step.
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
    save_state(f"distinct/state{{step}}/", params, opt)
    if step % ecfg.refresh_every == 0:
        for i in range(4):
            rows = {{k: jnp.asarray(v[i * B // 4:(i + 1) * B // 4])
                    for k, v in pipe.batch(step).items()}}
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


def _cfg(tag, arch=QWEN):
    """The port's reduced config of ``arch`` in the form and dtype of
    ``tag``, named ``tag``."""
    return dataclasses.replace(get_reduced_config(arch), name=tag, **TAGS[tag][1])


def _tag(impl):
    return f"{impl}-f32"


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
    """The reference's runs, one subprocess a form, side by side; keys
    are prefixed with the form's tag."""
    tmp = tmp_path_factory.mktemp("moe-train-ref")
    codes = {tag: REF_CODE.format(out=str(tmp / f"{tag}.npz"), B=B, S=S, SEED=SEED, tag=tag,
                                  arch=arch, kw=kw, train=TRAIN, eigen=EIGEN, mid=MID,
                                  mid_b=MID_B, mid_s=MID_S)
             for tag, (arch, kw) in TAGS.items()}
    with pytest.MonkeyPatch.context() as mp:
        # One Eigen thread a device in the reference's processes, for the same reason.
        mp.setenv("XLA_FLAGS", " ".join(
            [os.environ.get("XLA_FLAGS", ""), "--xla_cpu_multi_thread_eigen=false"]).strip())
        with concurrent.futures.ThreadPoolExecutor(len(codes)) as pool:
            for job in [pool.submit(run_with_devices, code, n_devices=4)
                        for code in codes.values()]:
                job.result()
    out = {}
    for tag in TAGS:
        with np.load(tmp / f"{tag}.npz") as data:
            out.update({f"{tag}/{k}": v for k, v in data.items()})
    return out


def _batch(cfg, step=0):
    return {k: torch.from_numpy(v).long()
            for k, v in TokenPipeline(cfg.vocab_size, S, B, seed=SEED).batch(step).items()}


def _grads(model, batch):
    loss, metrics = loss_fn(model, batch)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), metrics, join_reference(dict(zip(params, grads)), model.cfg)


def test_reduced_configs_differ_only_in_name():
    """Why one reference run a form holds both archs: their reduced
    configs (the port's copies and the reference's) are one config but
    for the name."""
    for get in (get_reduced_config, ref_reduced_config):
        assert dataclasses.replace(get(KIMI), name=QWEN) == get(QWEN)


# ------------------------------------------------------------ one layer ----
def _layer_case(impl, dtype, cf, *, seed=0, s=64):
    """(config, the layer's f32 parameters, x, cot) of one MoE layer of
    the reduced config in ``dtype`` and form ``impl`` at capacity factor
    ``cf``, drawn from numpy seeds."""
    jcfg = dataclasses.replace(ref_reduced_config(QWEN), moe_impl=impl, capacity_factor=cf,
                               dtype=dtype)
    values, _ = JL.split_params(JL.init_moe(jax.random.PRNGKey(seed), jcfg))
    values = {k: np.asarray(v, np.float32) for k, v in values.items()}
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    return jcfg, values, x, cot


def _ref_layer(jcfg, values, x, cot):
    """(loss, {x, router, wi, wg, wo} gradients) of ``sum(out * cot) +
    0.01 aux`` through the reference's form, in f32 numpy."""
    fn = JL.apply_moe_sort if jcfg.moe_impl == "sort" else JL.apply_moe_einsum

    def loss(p, x):
        out, aux = fn(p, jcfg, x.astype(jcfg.dtype))
        return jnp.sum(out.astype(jnp.float32) * cot) + 0.01 * aux

    val, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(values, jnp.asarray(x))
    return float(val), {"x": np.asarray(gx, np.float32),
                        **{k: np.asarray(v, np.float32) for k, v in gp.items()}}


def _port_layer(jcfg, values, x, cot, *, aux_coef=0.01):
    """The port's (loss, gradients, routing) of the same function."""
    tcfg = dataclasses.replace(get_reduced_config(QWEN), moe_impl=jcfg.moe_impl,
                               capacity_factor=jcfg.capacity_factor, dtype=jcfg.dtype)
    mod = TL.MoE(tcfg, dtype=torch.float32)
    with torch.no_grad():
        for name, arr in values.items():
            getattr(mod, name).copy_(torch.from_numpy(np.array(arr)))
    tx = torch.from_numpy(x).requires_grad_()
    xc = tx.to(getattr(torch, jcfg.dtype))
    out, aux = mod(xc)
    loss = (out.float() * torch.from_numpy(cot)).sum() + aux_coef * aux
    leaves = [tx, mod.router, mod.wi, mod.wg, mod.wo]
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        rt = mod.routing(xc)
    return loss.item(), dict(zip(["x", "router", "wi", "wg", "wo"],
                                 [g.numpy() for g in grads])), rt, mod


@pytest.mark.parametrize("cf", [1.0, 100.0])
@pytest.mark.parametrize("impl", IMPLS)
def test_layer_gradients_match_reference(impl, cf):
    """One layer in f32, (2, 64) tokens: the loss within 1e-5 relative and
    the gradients of x, the router and the experts within 1e-4 relative
    L2 of ``jax.grad``'s, with drops at capacity factor 1.0 and none at
    100."""
    case = _layer_case(impl, "float32", cf)
    want_loss, want = _ref_layer(*case)
    loss, got, rt, _ = _port_layer(*case)
    drops = int((~rt.keep).sum())
    assert (drops > 0) if cf == 1.0 else (drops == 0), drops
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
    errs = {k: T._rel_l2(got[k], want[k]) for k in want}
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.parametrize("impl", IMPLS)
def test_dropped_pairs_send_no_gradient(impl):
    """At capacity factor 0.25 (4 slots an expert a row in the einsum
    form, 8 over the batch in the sort form) most pairs are dropped: the
    loss ``sum(out * cot)`` (no aux) gives exactly zero gradient to each
    token whose pairs were all dropped (its output is zero and its gates
    weigh nothing), and every gradient equals autograd of the kept pairs
    written out in f64 (each kept pair's gate, renormalised over all K of
    its token's, times its expert's SwiGLU of the token) within 1e-5
    relative L2."""
    jcfg, values, x, cot = _layer_case(impl, "float32", 0.25)
    _, got, rt, mod = _port_layer(jcfg, values, x, cot, aux_coef=0.0)
    keep, experts = rt.keep.numpy(), rt.experts
    gone = ~keep.any(-1)
    assert gone.sum() > 0 and keep.sum() > 0, (gone.sum(), keep.sum())
    assert np.all(got["x"][gone] == 0.0)
    p = {k: torch.from_numpy(v).double().requires_grad_() for k, v in values.items()}
    x64 = torch.from_numpy(x).double().requires_grad_()
    probs = torch.softmax(x64 @ p["router"], dim=-1)
    gates = probs.gather(-1, experts)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(x64)
    for j in range(experts.shape[-1]):
        ex = experts[..., j]
        h = torch.einsum("bsm,bsmf->bsf", x64, p["wi"][ex])
        g = torch.einsum("bsm,bsmf->bsf", x64, p["wg"][ex])
        y = torch.einsum("bsf,bsfm->bsm", g * torch.sigmoid(g) * h, p["wo"][ex])
        out = out + torch.from_numpy(keep[..., j:j + 1]) * gates[..., j:j + 1] * y
    want = torch.autograd.grad((out * torch.from_numpy(cot).double()).sum(),
                               [x64, p["router"], p["wi"], p["wg"], p["wo"]])
    for name, w in zip(["x", "router", "wi", "wg", "wo"], want):
        assert T._rel_l2(got[name], w.numpy()) <= 1e-5, name


@pytest.mark.parametrize("cf", [1.0, 100.0])
@pytest.mark.parametrize("impl", IMPLS)
def test_layer_bf16_gradients_within_the_references_own_gap(impl, cf):
    """bf16, the configs' dtype: each gradient lies no further from the
    reference's f32 gradient than the reference's own bf16 gradient does
    (up to 1e-6 relative L2).  The port rounds where the reference does:
    ``silu_ref``'s backward in the reference's order (``wg``'s gradient
    is the reference's bits), and x's gradient summed over the kept pairs
    and the router in f32 and rounded once (index-adds in bf16 rounded
    after each pair and gave 7.38e-3 against the reference's own 6.84e-3
    in the einsum form)."""
    _, want = _ref_layer(*_layer_case(impl, "float32", cf))
    _, ref_bf16 = _ref_layer(*_layer_case(impl, "bfloat16", cf))
    _, got, _, _ = _port_layer(*_layer_case(impl, "bfloat16", cf))
    for name in want:
        own = T._rel_l2(ref_bf16[name], want[name])
        mine = T._rel_l2(got[name], want[name])
        assert mine <= own + 1e-6, (name, mine, own)


def test_silu_ref_gradient_is_the_references():
    """``silu_ref``'s gradient against ``jax.grad`` of ``jax.nn.silu``: in
    bf16 the same bits; in f32 within 1e-6 of the largest (the reference's
    f32 logistic is another formula: its forward differs from
    ``silu_ref``'s in the last bit of ~4 % of the values, as before)."""
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32) * 4
    cot = np.random.default_rng(4).standard_normal(4096).astype(np.float32)
    for dtype in ("bfloat16", "float32"):
        want = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(
            jax.nn.silu(v).astype(jnp.float32) * cot)))(jnp.asarray(x, dtype)), np.float32)
        tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
        got = torch.autograd.grad((TL.silu_ref(tx).float() * torch.from_numpy(cot)).sum(),
                                  tx)[0].float().numpy()
        if dtype == "bfloat16":
            assert np.array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


# ---------------------------------------------------------------- the LM ----
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(ref, arch, impl):
    """The reduced LM's loss (CE + 0.01 aux, both layers' aux within 1e-6)
    and every leaf's gradient through attention, the routing, the
    dispatch and the combine."""
    tag = _tag(impl)
    model = T._model_at(ref, _cfg(tag, arch), f"{tag}/values/{tag}")
    loss, metrics, got = _grads(model, _batch(model.cfg))
    want = T._under(ref, f"{tag}/grads/{tag}")
    assert set(got) == set(want)
    assert abs(metrics["aux"].item() - float(ref[f"{tag}/aux/{tag}"])) <= 1e-6
    want_loss = float(ref[f"{tag}/loss/{tag}"])
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    errs = {k: T._rel_l2(got[k], want[k]) for k in want}
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.parametrize("impl", IMPLS)
def test_collapsed_mid_width_model_gradients_match_reference(ref, impl):
    """The mid-width model (6 layers, d_model 256, 32 experts top-8) over
    2 x 256 tokens, whose routing collapses with depth (the last layer
    drops 49 % of its pairs in the einsum form, 28 % in the sort form,
    whose capacity is the batch's): loss within 1e-5 relative, every
    gradient within 1e-4 relative L2.  Remat is the full config's: the
    pre-hooks see the forward's layers, then the backward's recompute."""
    tag = _tag(impl)
    cfg = dataclasses.replace(get_config(QWEN), moe_impl=impl, **MID)
    model = T._model_at(ref, cfg, f"{tag}/values/mid")
    shares = []
    for blk in model.blocks:
        blk.mlp.register_forward_pre_hook(
            lambda m, i: shares.append((~m.routing(i[0]).keep).float().mean().item()))
    batch = {k: torch.from_numpy(ref[f"{tag}/mid/{k}"]).long() for k in ("tokens", "labels")}
    loss, _, got = _grads(model, batch)
    assert shares[len(model.blocks) - 1] > 0.25, shares  # the forward's last layer
    want_loss = float(ref[f"{tag}/loss/mid"])
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    want = T._under(ref, f"{tag}/grads/mid")
    errs = {k: T._rel_l2(got[k], want[k]) for k in want}
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.parametrize("impl", IMPLS)
def test_remat_gives_the_same_gradients(impl):
    """Each MoE block under torch.utils.checkpoint (the full configs'
    ``remat == "full"``, which routes again in the backward): the same
    loss and gradients bit for bit on the CPU."""
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(get_reduced_config(QWEN), remat=remat, moe_impl=impl, **F32)
        model = LM(cfg, device="cpu", param_dtype=torch.float32)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        loss, _ = loss_fn(model, _batch(cfg))
        out[remat] = (loss.detach(), torch.autograd.grad(loss, list(model.parameters())))
    assert torch.equal(out["none"][0], out["full"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["none"][1], out["full"][1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_compressed_paths_match_reference(arch):
    """The port's compressed leaves are the reference's, on its own tree
    (abstract shapes): full and reduced configs, at a rank where the
    router (L, d, e) is compressed (e >= rank) and one where it is not;
    the expert leaves (L, E, d, f) / (L, E, f, d) never (4-D, not an
    attention view)."""
    e_full = get_config(arch).num_experts
    for reduced, ranks in ((True, (8, 32)), (False, (32, 2 * e_full))):
        jcfg = ref_reduced_config(arch) if reduced else ref_config(arch)
        cfg = get_reduced_config(arch) if reduced else get_config(arch)
        values, axes = abstract_params(jcfg)
        leaves = reference_leaves(cfg)
        routed = []
        for rank in ranks:
            want = ref_compressed_paths(values, axes, RefECfg(rank=rank, min_dim=64))
            got = tsteps.compressed_paths(cfg, EC.EigenCompressConfig(rank=rank, min_dim=64))
            assert {leaves[n].path for n in got} == set(want), (arch, reduced, rank)
            assert not any(n.split(".")[-1] in ("wi", "wg") or n.endswith("mlp.wo")
                           for n in got)
            routed.append("blocks.0.mlp.router" in got)
        assert routed == [True, False], (arch, reduced, routed)


# ------------------------------------------------------------- trainers ----
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_baseline_trainer_matches_reference(ref, arch, impl, monkeypatch):
    """The launcher's trainer (AdamW: clip, decay by the reference leaf)
    for 8 steps from the reference's parameters: losses within 1e-4,
    every parameter and both moments (the experts' 4-D ones through
    ``opt_state_to_reference``) within 1e-4 relative L2."""
    tag = _tag(impl)
    model = T._model_at(ref, _cfg(tag, arch), f"{tag}/values/{tag}")
    monkeypatch.setattr(ttrain, "build", lambda cfg, **kw: model)
    _, opt, losses = ttrain.train(model.cfg, device="cpu", **TRAIN)
    np.testing.assert_allclose(losses, ref[f"{tag}/train/losses"], rtol=0, atol=1e-4)
    assert int(opt["step"]) == TRAIN["steps"] == int(ref[f"{tag}/trained/step"])
    got = {"params": join_reference(dict(model.named_parameters()), model.cfg),
           **{k: v for k, v in opt_state_to_reference(opt, model.cfg).items() if k != "step"}}
    for what in ("params", "m", "v"):
        want = T._under(ref, f"{tag}/trained/{what}")
        assert set(got[what]) == set(want)
        errs = {k: T._rel_l2(got[what][k], want[k]) for k in want}
        assert max(errs.values()) <= 1e-4, (what, errs)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_eigen_steps_match_reference_stacked(ref, arch, impl):
    """Every refresh and train step of the reference's eigen run, each
    from the reference's state before it, stacked on 4 shards, each shard
    its rows (``test_torch_train.py``'s bars; the sort form's capacity is
    then a shard's, as in the reference's per-shard loss).  The router
    (64, 8) is compressed at r = 4; its refreshed basis is held."""
    tag = _tag(impl)
    cfg = _cfg(tag, arch)
    comp = tsteps.compressed_paths(cfg, EC.EigenCompressConfig(rank=EIGEN["eigen_rank"],
                                                                 min_dim=64))
    assert comp["blocks.1.mlp.router"] == (64, 8) and "blocks.1.mlp.wi" not in comp
    readings = []
    worst = T._teacher_forced(T._under(ref, f"{tag}/"), cfg, seq=S, ill_posed=ILL_POSED,
                              ref_grads=True, readings=readings,
                              eigen_rank=EIGEN["eigen_rank"])
    print(f"{arch} {impl}: refreshed bases over the f32 probe's bar, worst "
          f"{max(r['ratio_f32'] for r in readings):.3g}; gradients up to "
          f"{max(r['grads'] for r in readings):.3g}")
    T._assert_within(worst)


def test_router_gradient_has_rank_below_its_experts():
    """Why the eigen tests run at a rank below the router's e - 1 = 7: a
    router's gradient ``xᵀ d logits`` has columns summing to zero (the
    softmax's Jacobian takes every row of ``d logits`` to sum zero, for
    the gates and the aux loss alike), so its rank is at most e - 1.  At
    r = e each shard's local basis then holds a direction the gradient
    does not reach (``Vᵀ G`` has a zero singular value): a direction made
    by rounding alone, which the refresh averages in.  (At rank 8 the
    teacher-forced refresh of the router lay 0.8-0.99 from the same
    refresh in f64, in the reference's run as in the port's.)"""
    cfg = _cfg("einsum-f32")
    model = LM(cfg, device="cpu", param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    router = dict(model.named_parameters())["blocks.0.mlp.router"]
    batch = _batch(cfg)
    e = cfg.num_experts
    for i in range(4):
        loss, _ = loss_fn(model, tsteps.shard_rows(batch, i, 4))
        g = torch.autograd.grad(loss, [router])[0]
        sv = torch.linalg.svdvals(g.double())
        assert sv[-1] <= 1e-5 * sv[0] and sv[-2] > 1e-3 * sv[0], sv
        assert g.sum(-1).abs().max() <= 1e-6 * g.abs().max()
        for r in (4, e):
            start = torch.randn(g.shape[0], r, generator=torch.Generator().manual_seed(i))
            v = EC._local_basis(g, r, 4, start)
            reach = torch.linalg.svdvals((v.T @ g).double())
            if r < e:
                assert reach[-1] > 1e-3 * sv[0], (r, reach)
            else:
                assert reach[-1] <= 1e-5 * sv[0], (r, reach)


@pytest.mark.parametrize("impl", IMPLS)
def test_opt_state_crosses_both_ways(ref, impl):
    """The reference's optimizer states into the port's form and back bit
    for bit: AdamW's after 8 steps (the 4-D expert moments (L, E, d, f)
    unstacked to each layer's (E, d, f)), and the eigen state after the
    last step (the router's (L, 64, 4) basis, its low-rank moments, its
    4 shards' error feedback) with one rank's slice of it."""
    tag = _tag(impl)
    cfg = _cfg(tag)
    adam = {"m": T._under(ref, f"{tag}/trained/m"), "v": T._under(ref, f"{tag}/trained/v"),
            "step": ref[f"{tag}/trained/step"]}
    port = opt_state_from_reference(adam, cfg, device="cpu")
    assert tuple(port["m"]["blocks.1.mlp.wi"].shape) == (8, 64, 32)
    back = opt_state_to_reference(port, cfg)
    for f in ("m", "v"):
        assert set(back[f]) == set(adam[f])
        assert all(np.array_equal(back[f][p], v) for p, v in adam[f].items()), f
    pre = f"{tag}/distinct/state{EIGEN['steps']}/"
    paths = set(T._under(ref, pre + "eigen/m/"))
    ref_opt = {
        "eigen": {p: {f: ref[f"{pre}eigen/{f}/{p}"] for f in
                      ("basis", "m", "v", "err", "initialized")} for p in paths},
        "full_m": T._under(ref, pre + "full_m/"), "full_v": T._under(ref, pre + "full_v/"),
        "step": ref[pre + "step"]}
    router = "['stages'][0]['block0']['mlp']['router']"
    assert router in paths and ref_opt["eigen"][router]["err"].shape == (4, 2, 64, 8)
    opt = opt_state_from_reference(ref_opt, cfg, device="cpu")
    assert set(opt["eigen"]) == set(tsteps.compressed_paths(
        cfg, EC.EigenCompressConfig(rank=EIGEN["eigen_rank"], min_dim=64)))
    back = opt_state_to_reference(opt, cfg)
    assert set(back["eigen"]) == paths
    for p in paths:
        for f in ("basis", "m", "v", "err"):
            assert np.array_equal(back["eigen"][p][f], ref_opt["eigen"][p][f]), (p, f)
    for f in ("full_m", "full_v"):
        assert set(back[f]) == set(ref_opt[f])
        assert all(np.array_equal(back[f][p], v) for p, v in ref_opt[f].items()), f
    one = opt_state_from_reference(ref_opt, cfg, device="cpu", shard=2)
    assert np.array_equal(one["eigen"]["blocks.1.mlp.router"]["err"].numpy(),
                          ref_opt["eigen"][router]["err"][2, 1])


@pytest.mark.parametrize("eigen", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_moe_on_cpu(arch, eigen, capsys):
    """``python -m repro_torch.launch.train --arch <moe> --device cpu``
    (the reduced config, its einsum form, the launcher's 8 x 128 tokens
    a step), with and without ``--eigen``: 8 finite losses, the last below
    the first."""
    ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "8",
                 *(["--eigen"] if eigen else [])])
    stats = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines()
                 if ": " in line)
    assert stats["config"].startswith(arch) and stats["eigen"] == str(eigen)
    assert stats["losses"] == "8" and stats["device"] == "cpu"
    final, start = stats["final loss"].split(" (start ")
    assert np.isfinite(float(stats["final_loss_exact"])) and float(final) < float(start[:-1])


# ---------------------------------------------------------- rank world ----
WORKER = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, {tests!r})
import test_torch_moe_train as M
import test_torch_train as T
from repro_torch.launch.mesh import make_aggregation_mesh

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
agg = make_aggregation_mesh(device="cpu", rank=rank, world_size=world, init_method=init)
with np.load({ref!r}) as data:
    ref = dict(data)
worst = T._teacher_forced(ref, M._cfg("einsum-f32"), group=agg.group, rank=rank, seq=M.S,
                          ill_posed=M.ILL_POSED, ref_grads=True,
                          eigen_rank=M.EIGEN["eigen_rank"])
with open(out, "w") as f:
    json.dump(worst, f)
torch.distributed.destroy_process_group()
"""


@pytest.mark.slow
def test_eigen_trainer_rank_world_matches_reference(ref, tmp_path):
    """qwen3-moe-30b-a3b reduced, einsum form, on 4 gloo ranks, one shard
    each, each its rows: every refresh (the router's among them) and step
    from the reference's state, each rank's error feedback against the
    reference's shard."""
    np.savez(tmp_path / "ref.npz", **T._under(ref, "einsum-f32/"))
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

"""Port parity of the VLM family (internvl2-2b: the patch-stub prefix on
the dense backbone) on the CPU, serving and training.

The reference's parameters cross into the port's ``LM`` through
``interop.lm_params_from_reference``; tokens come from the token
pipeline, patch embeddings (B, P, patch_embed_dim) from a numpy
generator seeded by (SEED, step) (``stub_inputs``).  Two variants of the
reduced config: ``vlm-f32`` (f32 with f32 attention probabilities, and
patch_embed_dim 64, so that the eigen trainer at min_dim 64 compresses
``patch_proj``) and ``vlm-bf16`` (the reduced config as it is).

The reference runs in this process for the forward, loss, gradients and
serving, and once for the module in one subprocess on 4 fake CPU devices
for its trainers: its launcher's ``train`` (AdamW on the pipeline's text
batches) and its eigen trainer on 4 data shards, on text batches and on
batches with patches, every state before and after each refresh and step
saved (``test_torch_train.py``'s run, whose teacher-forced check this
file reuses).

Bars:
  * forward and loss: f32 within 1e-5 (logits of their largest
    magnitude, loss relative); bf16 at the dense family's bars, logits
    within 2^-5 of their largest magnitude, loss 2e-3 relative;
  * gradients against ``jax.grad``: f32 1e-5 (loss) / 1e-4 (relative L2
    of every leaf), bf16 2e-3 / 5e-2;
  * serving: the port's prefill (prompt after its patches) and
    teacher-forced decode steps against the reference's teacher-forced
    forward logits, f32 within 1e-4, bf16 within 2^-5 of their largest
    magnitude; and the port's own prefill + decode against its own
    forward within 1e-4 (``tests/test_serving.py``'s bar);
  * the trainers: ``test_torch_train.py``'s (launcher losses within 1e-4
    and parameters within 1e-4 relative L2; the eigen steps teacher-
    forced, ``_teacher_forced``'s bars with the reference's per-shard
    gradients, as ``test_torch_recurrent_train.py`` holds them).  On text batches ``patch_proj``
    has a zero gradient in both packages: AdamW only decays it, and its
    refreshed basis (the local bases of a zero matrix), moments and
    error feedback are held with every other leaf's.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
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
from repro.models import init_split
from repro.models import lm as jlm
from repro.models.registry import abstract_params
from repro.models.registry import build as ref_build
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.interop import (
    join_reference,
    lm_params_from_reference,
    reference_leaves,
    to_numpy,
)
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import build, loss, model_class, param_count
from repro_torch.optim import eigen_compress as EC
from repro_torch.optim.adamw import AdamWConfig, adamw_init

ARCH = "internvl2-2b"
B, S, SEED, PROMPT = T.B, T.S, T.SEED, 10
F32 = {**T.F32, "patch_embed_dim": 64}
TAGS = {"vlm-f32": F32, "vlm-bf16": {}}
TRAIN = dict(steps=6, batch=B, seq=S, lr=1e-3, warmup=2, log_every=100)
RUNS = ("text", "patches")


def stub_inputs(cfg, step, kind):
    """The numpy arrays a batch of ``kind`` carries beside its tokens at
    ``step`` (the reference's run builds the same)."""
    if kind != "patches":
        return {}
    rng = np.random.default_rng([SEED, step])
    return {"patch_embeds": rng.standard_normal(
        (B, cfg.num_patches, cfg.patch_embed_dim)).astype(np.float32)}


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
ARCH, KW, TRAIN, EIGEN, RUNS = {arch!r}, {kw!r}, {train!r}, {eigen!r}, {runs!r}
out = {{}}
{stub}

def put(prefix, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(k)] = np.asarray(v, np.float32)


# train() takes an arch id: register the variant as examples/train_lm.py does.
cfg = dataclasses.replace(get_reduced_config(ARCH), name="vlm-f32", **KW)
mod = types.ModuleType("cfg_vlm_f32")
mod.CONFIG, mod.reduced = cfg, (lambda: cfg)
sys.modules["repro.configs." + mod.__name__] = mod
registry.ARCHS["vlm-f32"] = mod.__name__

mesh = make_host_mesh(model=1)
params, _, losses = train("vlm-f32", mesh=mesh, **TRAIN)
out["train/losses"] = np.asarray(losses)
put("trained/", params)

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
for run in RUNS:
    def batch(step):
        return {{**pipe.batch(step), **stub_inputs(cfg, step, run)}}

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
        save_state(f"{{run}}/distinct/state{{step}}/", params, opt)
        if step % ecfg.refresh_every == 0:
            for i in range(4):
                rows = {{k: jnp.asarray(v[i * B // 4:(i + 1) * B // 4])
                        for k, v in batch(step).items()}}
                put(f"{{run}}/distinct/grads{{step}}/{{i}}/", shard_grad(params, rows))
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
                out[f"{{run}}/eigen/starts{{k}}/{{path}}"] = np.asarray(start)
            opt = refresh_jit(params, opt, b, sub)
            save_state(f"{{run}}/distinct/refreshed{{step}}/", params, opt)
        params, opt, metrics = train_jit(params, opt, b)
        losses.append(float(metrics["loss"]))
    save_state(f"{{run}}/distinct/state{{EIGEN['steps']}}/", params, opt)
    out[f"{{run}}/distinct/losses"] = np.asarray(losses)
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
    path = tmp_path_factory.mktemp("vlm-ref") / "ref.npz"
    code = REF_CODE.format(out=str(path), B=B, S=S, SEED=SEED, arch=ARCH, kw=F32,
                           train=TRAIN, eigen=T.EIGEN, runs=RUNS,
                           stub=inspect.getsource(stub_inputs))
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


def _pair(tag):
    jcfg, tcfg = _cfgs(tag)
    values = jax.tree.map(np.asarray, init_split(jcfg, jax.random.PRNGKey(SEED))[0])
    return jcfg, values, lm_params_from_reference(values, tcfg, device="cpu",
                                                  param_dtype=torch.float32)


def _batches(cfg, kind="patches", step=0):
    """(reference batch, port batch) of the pipeline's tokens at ``step``
    and the stub inputs of ``kind``."""
    arrays = {**T.TokenPipeline(cfg.vocab_size, S, B, seed=SEED).batch(step),
              **stub_inputs(cfg, step, kind)}
    port = {k: torch.from_numpy(v).long() if v.dtype.kind in "iu" else torch.from_numpy(v)
            for k, v in arrays.items()}
    return {k: jnp.asarray(v) for k, v in arrays.items()}, port


def _scaled(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# -------------------------------------------------------- model parity ----
@pytest.mark.parametrize("tag,logit_bar,loss_bar", [
    ("vlm-f32", 1e-5, 1e-5), ("vlm-bf16", 2.0 ** -5, 2e-3)])
def test_forward_and_loss_match_reference(tag, logit_bar, loss_bar):
    """The whole sequence's logits (P patch positions, then the text) and
    the loss over the text positions."""
    jcfg, values, model = _pair(tag)
    jb, tb = _batches(jcfg)
    want, _, _ = jax.jit(lambda v, b: jlm.forward(v, jcfg, b["tokens"],
                                                  patch_embeds=b["patch_embeds"]))(values, jb)
    want_loss, _ = jax.jit(lambda v, b: jlm.loss_fn(v, jcfg, b))(values, jb)
    with torch.no_grad():
        got, _ = model(tb["tokens"], patch_embeds=tb["patch_embeds"])
        got_loss, _ = loss(model, tb)
    assert got.shape == (B, jcfg.num_patches + S, jcfg.padded_vocab)
    vocab = jcfg.vocab_size
    assert _scaled(to_numpy(got)[..., :vocab], np.asarray(want)[..., :vocab]) <= logit_bar
    assert abs(float(got_loss) - float(want_loss)) / float(want_loss) <= loss_bar


@pytest.mark.parametrize("tag,loss_bar,grad_bar", [
    ("vlm-f32", 1e-5, 1e-4), ("vlm-bf16", 2e-3, 5e-2)])
def test_gradients_match_reference(tag, loss_bar, grad_bar):
    """Every leaf's gradient through the patch projection and the text
    stack, against ``jax.grad``; on a text batch ``patch_proj``'s is zero
    in both."""
    jcfg, values, model = _pair(tag)
    jb, tb = _batches(jcfg)
    (want_loss, _), want = jax.jit(jax.value_and_grad(ref_build(jcfg).loss, has_aux=True))(
        values, jb)
    want = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    params = dict(model.named_parameters())
    got_loss, _ = loss(model, tb)
    got = join_reference(dict(zip(params, torch.autograd.grad(got_loss, list(params.values())))),
                         model.cfg)
    assert set(got) == set(want)
    assert abs(float(got_loss) - float(want_loss)) / float(want_loss) <= loss_bar
    errs = {k: T._rel_l2(got[k], want[k]) for k in want}
    assert max(errs.values()) <= grad_bar, errs
    assert np.abs(want["['patch_proj']"]).max() > 0

    jtext, ttext = _batches(jcfg, kind="text")
    want_text = jax.jit(jax.grad(lambda v, b: ref_build(jcfg).loss(v, b)[0]))(values, jtext)
    text_loss, _ = loss(model, ttext)
    g = tsteps._grads(text_loss, [params["patch_proj"]])[0]
    assert not g.any() and not np.asarray(want_text["patch_proj"]).any()


@functools.lru_cache(maxsize=None)
def _serve_errors(tag):
    """The port's prefill of the prompt after its patches, then teacher-
    forced decode steps at positions P + t: (errors against the
    reference's forward logits, the largest of those, errors against the
    port's own forward)."""
    jcfg, values, model = _pair(tag)
    tcfg = model.cfg
    cdt = getattr(torch, tcfg.dtype)
    model = lm_params_from_reference(values, tcfg, device="cpu")  # the config's dtype
    jb, tb = _batches(jcfg)
    p = jcfg.num_patches
    want, _, _ = jax.jit(lambda v, b: jlm.forward(v, jcfg, b["tokens"],
                                                  patch_embeds=b["patch_embeds"]))(values, jb)
    want = np.asarray(want)[:, p:]
    tokens, pe = tb["tokens"], tb["patch_embeds"].to(cdt)
    with torch.no_grad():
        own, _ = model(tokens, patch_embeds=pe)
    own = own[:, p:]
    last, cache = model.prefill(tokens[:, :PROMPT], patch_embeds=pe, cache_len=S + p)
    outs = [last]
    for t in range(PROMPT, S):
        logit, cache = model.decode_step(tokens[:, t:t + 1], cache, p + t)
        outs.append(logit)
    vocab = jcfg.vocab_size
    errs, mine = [], []
    for i, t in enumerate(range(PROMPT - 1, S)):
        got = to_numpy(outs[i])[:, :vocab]
        errs.append(np.abs(got - want[:, t, :vocab]).max())
        mine.append((outs[i] - own[:, t]).abs().max().item())
    return errs, np.abs(want[..., :vocab]).max(), mine


@pytest.mark.parametrize("tag,bar", [("vlm-f32", 1e-4), ("vlm-bf16", 2.0 ** -5)])
def test_serving_matches_reference_teacher_forced(tag, bar):
    errs, scale, _ = _serve_errors(tag)
    assert max(errs) <= bar * (1.0 if tag.endswith("f32") else scale), (errs, scale)


@pytest.mark.parametrize("tag", list(TAGS))
def test_prefill_decode_matches_forward(tag):
    """The port's golden serving test with patches: the decode positions
    offset by P, the cache P + S long (the reference's serve)."""
    _, _, mine = _serve_errors(tag)
    assert max(mine) < 1e-4, mine


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
@pytest.mark.parametrize("kind", RUNS)
def test_adamw_step_matches_reference(kind):
    """One AdamW step of ``make_train_step`` (clip, decay by the
    reference leaf) against the reference's ``adamw_update`` on its
    gradient: with patches, and on a text batch, where ``patch_proj``
    keeps zero moments and is only decayed."""
    jcfg, values, model = _pair("vlm-f32")
    jb, tb = _batches(jcfg, kind=kind)
    acfg = RefAdamWConfig()
    grads = jax.jit(jax.grad(lambda v, b: ref_build(jcfg).loss(v, b)[0]))(values, jb)
    p, st, _ = jax.jit(lambda g, s, p: ref_adamw_update(g, s, p, lr=1e-3, cfg=acfg))(
        grads, ref_adamw_init(values), values)
    params = dict(model.named_parameters())
    before = params["patch_proj"].detach().clone()
    opt = adamw_init(params)
    tsteps.make_train_step(model, adamw_cfg=AdamWConfig(), schedule=lambda s: 1e-3)(opt, tb)
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    got = join_reference(params, model.cfg)
    errs = {k: T._rel_l2(got[k], flat[k]) for k in flat}
    assert max(errs.values()) <= 1e-4, errs
    mom = join_reference(opt["m"], model.cfg)
    want_m = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_flatten_with_path(st["m"])[0]}
    assert max(T._scaled_err(mom[k], want_m[k]) if want_m[k].any() else np.abs(mom[k]).max()
               for k in want_m) <= 1e-4
    if kind == "text":
        assert not opt["m"]["patch_proj"].any() and not opt["v"]["patch_proj"].any()
        decayed = before * (1 - 1e-3 * AdamWConfig().weight_decay)
        assert torch.allclose(params["patch_proj"].detach(), decayed, rtol=0, atol=1e-7)


def test_launcher_trainer_matches_reference(ref, monkeypatch):
    """The launcher's trainer on the pipeline's text batches, as the
    reference's launcher trains internvl2-2b: losses and every parameter
    after the last step, ``patch_proj`` (decayed only) included."""
    jcfg, values, model = _pair("vlm-f32")
    monkeypatch.setattr(ttrain, "build", lambda cfg, **kw: model)
    _, opt, losses = ttrain.train(model.cfg, device="cpu", **TRAIN)
    np.testing.assert_allclose(losses, ref["train/losses"], rtol=0, atol=1e-4)
    got = join_reference(dict(model.named_parameters()), model.cfg)
    want = T._under(ref, "trained/")
    errs = {k: T._rel_l2(got[k], want[k]) for k in want}
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.parametrize("run", RUNS)
def test_eigen_steps_match_reference_stacked(ref, run):
    """Every refresh and train step of the reference's eigen run (rank 8,
    a refresh every 2 steps) from the reference's state before it,
    stacked on 4 shards, each its rows.  ``patch_proj`` (64, 64) is
    compressed; on text batches its gradient is zero on every shard, and
    its refreshed basis, moments and error feedback are held.  The
    refreshed bases' probe counts the gradients' own difference (the
    reference saves each shard's gradients at each refresh), as the
    recurrent families' does (ROADMAP C15): with patches the backbone's
    gradients over P + S positions differ from the reference's by f32
    summation order, and the 4-step local solve amplifies that past the
    f32 probe's bar in some attention leaves."""
    _, cfg = _cfgs("vlm-f32")
    comp = tsteps.compressed_paths(cfg, EC.EigenCompressConfig(rank=8, min_dim=64))
    assert comp["patch_proj"] == (64, 64)
    readings = []
    worst = T._teacher_forced(T._under(ref, f"{run}/"), cfg, ref_grads=True,
                              readings=readings, stub=lambda t: stub_inputs(cfg, t, run))
    print(f"{run}: patch_proj's refreshed basis from the reference's at each refresh "
          f"(f64 subspace distance): "
          f"{[r['basis_gap'] for r in readings if r['leaf'] == 'patch_proj']}; worst {worst}")
    T._assert_within(worst)


def test_text_run_keeps_patch_proj_error_feedback_zero(ref):
    """With no patches ever, the reference's ``patch_proj`` error feedback
    and low-rank moments stay zero through the run, and its basis is
    orthonormal after each refresh: what the teacher-forced test holds
    the port's against."""
    pre = "text/distinct/"
    for t in range(T.EIGEN["steps"] + 1):
        for f in ("err", "m", "v"):
            assert not ref[f"{pre}state{t}/eigen/{f}/['patch_proj']"].any()
    for t in range(0, T.EIGEN["steps"], T.EIGEN["eigen_refresh"]):
        q = ref[f"{pre}refreshed{t}/eigen/basis/['patch_proj']"]
        assert np.allclose(q.T @ q, np.eye(q.shape[1]), atol=1e-5)


# ------------------------------------------------- counts, init, paths ----
def test_config_matches_reference():
    for got, want in ((get_config(ARCH), ref_config(ARCH)),
                      (get_reduced_config(ARCH), ref_reduced_config(ARCH))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_full_config_on_meta_matches_reference_tree():
    """The full config on the meta device: 1,891,244,032 parameters
    (``param_count``, the logical vocab), and every leaf, padded vocab
    rows included, with the reference's ``abstract_params`` path, shape
    and axes."""
    cfg = get_config(ARCH)
    assert param_count(cfg) == 1_891_244_032
    model = model_class(cfg)(cfg, device="meta")
    values, axes = abstract_params(ref_config(ARCH))
    shapes = {jax.tree_util.keystr(k): tuple(v.shape)
              for k, v in jax.tree_util.tree_flatten_with_path(values)[0]}
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for s in shapes.values())
    leaves = reference_leaves(cfg)
    assert {leaf.path for leaf in leaves.values()} == set(shapes)
    params = dict(model.named_parameters())
    assert set(params) == set(leaves)
    for name, leaf in leaves.items():
        assert leaf.shape == shapes[leaf.path], name
        assert params[name].numel() == int(np.prod(leaf.layer_shape)), name
    assert leaves["patch_proj"].axes == (None, "embed")


def test_patch_proj_init_follows_reference_distribution():
    """``patch_proj`` (patch_embed_dim, d): the truncated normal scaled by
    1/sqrt(patch_embed_dim), in the config's dtype."""
    cfg = dataclasses.replace(get_reduced_config(ARCH), patch_embed_dim=256, d_model=256)
    model = build(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    w = model.patch_proj
    assert w.dtype == torch.bfloat16 and w.shape == (256, 256)
    std = w.float().std().item() * 256 ** 0.5
    assert abs(std - 0.8796256610342398) < 0.02, std
    assert w.float().abs().max().item() <= 2.0 / 16 * (1 + 2 ** -8)


def test_text_lm_refuses_patches():
    model = build(get_reduced_config("llama3.2-3b"), device="cpu")
    with pytest.raises(ValueError, match="takes no patch embeddings"):
        model.prefill(torch.zeros(1, 4, dtype=torch.long), patch_embeds=torch.zeros(1, 2, 8))


# ------------------------------------------------------------ launchers ----
def _train_cli(*args):
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", ARCH,
         "--steps", "3", "--batch", "4", "--seq", "16", *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)


@pytest.mark.parametrize("eigen", [False, True])
def test_train_cli_trains_on_cpu(eigen):
    proc = _train_cli(*(["--eigen", "--shards", "2"] if eigen else []))
    assert proc.returncode == 0, proc.stderr
    stats = dict(line.split(": ", 1) for line in proc.stdout.splitlines()[1:])
    assert stats["config"] == f"{ARCH} (141632 parameters)"
    assert stats["eigen"] == str(eigen) and stats["losses"] == "3"
    assert np.isfinite(float(stats["final_loss_exact"]))

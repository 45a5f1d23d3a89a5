"""Training on a ``(data, model)`` mesh (``launch/train.py::train(mesh=)``,
``launch/steps.py``'s ``mesh=`` steps) against the reference's
``jit_train_step`` / ``jit_eigen_steps`` on ``make_host_mesh(model=2)``.

The reference runs once, in one subprocess on 4 fake CPU devices: the
reduced llama3.2-3b in f32 (f32 attention probabilities) on the (2, 2)
mesh, 4 AdamW steps (its parameters, moments and losses after each, and
the gradient of step 0), and the eigen trainer (rank 8, a refresh every
2 steps, 4 steps) on the pipeline's own batches with every state before
and after each refresh and step saved, as ``tests/test_torch_train.py``
saves its 4-shard run.  One 4-rank gloo CPU world runs the port on the
same (2, 2) mesh and holds:

  * AdamW: the 4 losses of ``train(mesh=)`` within 1e-5 relative; one
    step from the reference's parameters within the bars of
    ``test_torch_sharding.py`` (c) (1e-6 where the gradient clears twice
    its leaf's mesh-vs-reference gap and 1e3 eps, 2 lr elsewhere); every
    parameter and moment a DTensor on the whole mesh (FSDP as the
    config's);
  * the eigen trainer teacher-forced (ROADMAP C8): every refresh and step
    from the reference's own state, each data rank its rows, with
    ``test_torch_train._teacher_forced``'s bars (bases max(1e-5, 4 x the
    refresh's f32 error) f64 subspace distance, loss 1e-5 relative,
    error feedback and moments 1e-4 of the largest magnitude), the
    embedding's refreshed basis left out (ill-posed on distinct rows);
  * the bytes one eigen step hands to ``torch.distributed`` on the data
    group, exactly: 4 (r n) a compressed leaf (its coordinates are whole
    on each data rank, so n is the leaf's whole n), the local block of
    every uncompressed gradient, and the 4-byte loss; parameters on the
    model submesh with FSDP off, the eigen state replicated;
  * the reduced qwen3-moe-30b-a3b (einsum form, rank 4), internvl2-2b
    (rank 8, patch embeddings in the batch), recurrentgemma-2b and
    mamba2-370m (rank 8; the RG-LRU and SSD on each model rank's width
    block, ``models/layers.py``'s regions): one refresh and one eigen
    step on the mesh against the port's stacked form (2 shards) from
    the same state, at the same bars (the recurrent families' bases
    probed also by their gradients' gap, as their stacked form is held
    to the reference's, ``GRAD_PROBED``) (the stacked form is held against
    the reference in ``test_torch_moe_train.py``, ``test_torch_vlm.py``
    and ``test_torch_recurrent_train.py``); the step starts from the
    stacked form's refreshed embedding state, as the teacher-forced runs
    start from the reference's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import SRC, run_with_devices

B, S, SEED = 4, 16, 0
TAG = "llama-f32"
ARCH, KW = "llama3.2-3b", dict(dtype="float32", attn_probs_bf16=False)
TRAIN = dict(steps=4, batch=B, seq=S, lr=1e-3, warmup=2, log_every=100)
EIGEN = dict(TRAIN, eigen=True, eigen_rank=8, eigen_refresh=2)
MESH = (2, 2)

REF_CODE = r'''
import dataclasses, sys, types
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import registry, get_reduced_config
from repro.data.tokens import TokenPipeline
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import eigen_opt_init, jit_eigen_steps, jit_train_step
from repro.models import init_split
from repro.models.registry import build
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.optim.eigen_compress import EigenCompressConfig
from repro.optim.schedule import warmup_cosine

OUT, B, S, SEED, TAG, ARCH, KW = {out!r}, {B}, {S}, {SEED}, {tag!r}, {arch!r}, {kw!r}
TRAIN, EIGEN = {train!r}, {eigen!r}
out = {{}}


def put(prefix, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(k)] = np.asarray(v)


cfg = dataclasses.replace(get_reduced_config(ARCH), name=TAG, **KW)
mesh = make_host_mesh(model=2)
assert tuple(mesh.shape.values()) == (2, 2), mesh.shape
values, axes = init_split(cfg, jax.random.PRNGKey(SEED))
values = jax.tree.map(np.asarray, values)
put("values", values)
pipe = TokenPipeline(cfg.vocab_size, S, B, seed=SEED)
put("grads0", jax.jit(jax.grad(lambda v: build(cfg).loss(v, pipe.batch(0))[0]))(values))

# AdamW: jit_train_step on the mesh, the state after each step.
sched = warmup_cosine(TRAIN["lr"], TRAIN["warmup"], TRAIN["steps"])
step_jit, (ps, os_, bs) = jit_train_step(cfg, mesh, values, axes, pipe.batch(0),
                                         adamw_cfg=AdamWConfig(), schedule=sched)
params, opt, losses = jax.device_put(values, ps), jax.device_put(adamw_init(values), os_), []
for step in range(TRAIN["steps"]):
    params, opt, metrics = step_jit(params, opt, jax.device_put(pipe.batch(step), bs))
    losses.append(float(metrics["loss"]))
    put(f"adamw/p{{step}}", params)
out["adamw/losses"] = np.asarray(losses)

# The eigen trainer on the pipeline's own batches, every state saved.
ecfg = EigenCompressConfig(rank=EIGEN["eigen_rank"], refresh_every=EIGEN["eigen_refresh"],
                           min_dim=64)
train_jit, refresh_jit, (ps, os_, bs) = jit_eigen_steps(
    cfg, mesh, values, axes, pipe.batch(0), adamw_cfg=AdamWConfig(),
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


opt = jax.device_put(eigen_opt_init(values, ecfg, 2, axes), os_)
params = jax.device_put(values, ps)
key = jax.random.PRNGKey(SEED + 1)
losses = []
for step in range(EIGEN["steps"]):
    b = jax.device_put(pipe.batch(step), bs)
    save_state(f"distinct/state{{step}}/", params, opt)
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
        save_state(f"distinct/refreshed{{step}}/", params, opt)
    params, opt, metrics = train_jit(params, opt, b)
    losses.append(float(metrics["loss"]))
save_state(f"distinct/state{{EIGEN['steps']}}/", params, opt)
out["distinct/losses"] = np.asarray(losses)
np.savez(OUT, **out)
'''

WORKER = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, {tests!r})
import test_torch_train as T
import test_torch_sharded_train as ST
from repro_torch.comm import transport
from repro_torch.configs import get_reduced_config
from repro_torch.interop import split_reference
from repro_torch.launch import sharding as S
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import data_rank, make_mesh, model_submesh
from repro_torch.models import build, loss as model_loss
from repro_torch.optim import EigenCompressConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.eigen_compress import draw_starts
from repro_torch.optim.schedule import warmup_cosine
from torch.distributed.tensor import DTensor

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
mesh = make_mesh(ST.MESH, ("data", "model"), device="cpu")
me = data_rank(mesh)
with np.load({ref!r}) as data:
    ref = dict(data)
cfg = ST.cfg()
res = {{}}


def ref_model():
    return T._model_at(ref, cfg, "values")


# AdamW: the end-to-end trainer, then one step from the reference's start.
model = ref_model()
real = ttrain.build
ttrain.build = lambda c, **k: model
try:
    _, opt, losses = ttrain.train(cfg, device="cpu", mesh=mesh, **ST.TRAIN)
finally:
    ttrain.build = real
res["adamw_losses"] = losses
res["adamw_dtensors"] = all(isinstance(t, DTensor) for t in [
    *dict(model.named_parameters()).values(), *opt["m"].values(), *opt["v"].values()])
res["adamw_fsdp"] = any(p.placements[0].is_shard() for p in model.parameters())
model = S.shard_model(ref_model(), cfg, mesh)
params = dict(model.named_parameters())
batch = T._batch(cfg, 0)
with S.sharded(mesh):
    loss, _ = model_loss(model, S.shard_batch(batch, mesh))
    grads = torch.autograd.grad(loss, list(params.values()))
g_ref = split_reference(T._under(ref, "grads0"), cfg)
gap = {{n: (S.whole(g) - torch.from_numpy(g_ref[n])).abs().max().item()
       for n, g in zip(params, grads)}}
step = tsteps.make_train_step(model, adamw_cfg=AdamWConfig(), mesh=mesh,
                              schedule=warmup_cosine(ST.TRAIN["lr"], ST.TRAIN["warmup"],
                                                     ST.TRAIN["steps"]))
step(adamw_init(params), batch)
want = split_reference(T._under(ref, "adamw/p0"), cfg)
sure = near = 0.0
for n, p in params.items():
    d = (S.whole(p).detach() - torch.from_numpy(want[n])).abs()
    agree = torch.from_numpy(g_ref[n]).abs() > max(2 * gap[n], 1e3 * AdamWConfig().eps)
    sure = max(sure, d[agree].max().item() if agree.any() else 0.0)
    near = max(near, d[~agree].max().item() if (~agree).any() else 0.0)
res["adamw_step"] = {{"sure": sure, "near": near}}

# The eigen trainer, teacher-forced, each data rank its rows.
res["eigen_worst"] = T._teacher_forced(ref, cfg, rank=me, m=2, eigen=ST.EIGEN_T, mesh=mesh)

# The bytes one eigen step hands over on the data group.
ecfg = EigenCompressConfig(rank=ST.EIGEN["eigen_rank"], refresh_every=2, min_dim=64)
model = S.shard_model(ref_model(), cfg, mesh, eigen=True)
opt = tsteps.eigen_opt_init(model, ecfg, 2, mesh=mesh)
sub = model_submesh(mesh)
res["eigen_layout"] = {{
    "params_on_model": all(p.device_mesh == sub for p in model.parameters()),
    "state_replicated": all(t.placements[0].is_replicate() for st in opt["eigen"].values()
                            for f, t in st.items() if f != "initialized"),
    "err_shape": list(opt["eigen"]["embed"]["err"].shape)}}
comp = tsteps.compressed_paths(cfg, ecfg)
want = 4 + sum(4 * min(ecfg.rank, d, n) * n for d, n in comp.values())
want += sum(S.local_bytes([p]) for n, p in model.named_parameters() if n not in comp)
transport.reset_handed_bytes()
tsteps.make_eigen_train_step(model, adamw_cfg=AdamWConfig(), schedule=lambda s: 1e-3,
                             mesh=mesh)(opt, batch)
res["bytes"] = {{"handed": transport.handed_bytes(), "want": want}}

# The MoE, VLM, hybrid and SSM families: one refresh and one step, mesh vs
# stacked.
res["families"] = {{}}
for tag, arch, kw, r in ST.FAMILIES:
    fcfg = dataclasses.replace(get_reduced_config(arch), **kw)
    fecfg = EigenCompressConfig(rank=r, refresh_every=2, min_dim=64)
    mk = lambda: build(fcfg, device="cpu", param_dtype=torch.float32,
                       generator=torch.Generator().manual_seed(ST.SEED))
    fb = ST.family_batch(fcfg)
    stacked, meshed = mk(), S.shard_model(mk(), fcfg, mesh, eigen=True)
    so = tsteps.eigen_opt_init(stacked, fecfg, 2)
    mo = tsteps.eigen_opt_init(meshed, fecfg, 2, mesh=mesh)
    starts = draw_starts(tsteps.start_shapes(so), seed=ST.SEED + 1, step=0, device="cpu")
    mesh_grads = None
    if tag in ST.GRAD_PROBED:
        # Each data rank's gradients on the mesh, whole, every rank given both.
        _, rows, ctx = tsteps._eigen_form(None, None, mesh)
        names = sorted(mo["eigen"])
        mparams = dict(meshed.named_parameters())
        with ctx():
            loss, _ = model_loss(meshed, rows(fb, me, 2))
            gs = torch.autograd.grad(loss, [mparams[n] for n in names], allow_unused=True,
                                     materialize_grads=True)
        mine = {{n: S.whole(g).detach().numpy() for n, g in zip(names, gs)}}
        every = [None] * world
        dist.all_gather_object(every, (me, mine))
        mesh_grads = [next(g for r, g in every if r == i) for i in range(2)]
    probes = T._probes(stacked, fb, starts, so, fecfg, m=2, ref_grads=mesh_grads)
    tsteps.make_eigen_refresh_step(stacked, ecfg=fecfg, shards=2)(so, fb, starts)
    tsteps.make_eigen_refresh_step(meshed, ecfg=fecfg, mesh=mesh)(mo, fb, starts)
    basis = max(T.subspace_dist64(S.whole(mo["eigen"][n]["basis"]).numpy(),
                                  so["eigen"][n]["basis"].numpy())
                / max(1e-5, 4 * max(probes[n]["f32"], probes[n].get("grads", 0.0)))
                for n in so["eigen"] if n != "embed")
    # The embedding's refresh is ill-posed on distinct rows: the step
    # starts from the stacked form's refreshed embedding state.
    with torch.no_grad():
        for f in ("basis", "m", "v"):
            S.local(mo["eigen"]["embed"][f]).copy_(so["eigen"]["embed"][f])
    sched = warmup_cosine(1e-3, 2, 4)
    ls = tsteps.make_eigen_train_step(stacked, adamw_cfg=AdamWConfig(), schedule=sched,
                                      shards=2)(so, fb)["loss"]
    lm = tsteps.make_eigen_train_step(meshed, adamw_cfg=AdamWConfig(), schedule=sched,
                                      mesh=mesh)(mo, fb)["loss"]
    state, worst_leaf = 0.0, None
    for n, st in so["eigen"].items():
        for f in ("m", "v", "err"):
            want_t = st[f][me] if f == "err" else st[f]
            got_t = S.whole(mo["eigen"][n][f])
            state = max(state, T._scaled_err(got_t.numpy(), want_t.numpy()))
            worst_leaf = worst_leaf if state > T._scaled_err(got_t.numpy(), want_t.numpy()) \
                else f"{{n}}/{{f}}"
    for f in ("full_m", "full_v"):
        for n, t in so[f].items():
            state = max(state, T._scaled_err(S.whole(mo[f][n]).numpy(), t.numpy()))
    res["families"][tag] = {{"basis": basis, "state": state, "leaf": worst_leaf,
                             "grad_gap": max((p.get("gap", 0.0) for p in probes.values()),
                                             default=0.0),
                             "loss": abs(float(lm) - float(ls)) / abs(float(ls))}}

with open(f"{{out}}.{{rank}}", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
'''

EIGEN_T = {**EIGEN, "seq": S}
# The recurrent families' refreshes amplify their gradients' summation
# order (ROADMAP C15): their bases' probe also takes how far the f64
# refresh of the mesh form's per-shard gradients lies from that of the
# stacked form's, as ``test_torch_recurrent_train.py`` probes them against
# the reference's (``test_torch_train._probes``' ``ref_grads``).
GRAD_PROBED = ("recurrentgemma-2b", "mamba2-370m")
FAMILIES = (("qwen3-moe-einsum", "qwen3-moe-30b-a3b",
             dict(dtype="float32", attn_probs_bf16=False, moe_impl="einsum"), 4),
            ("internvl2-2b", "internvl2-2b", dict(dtype="float32", attn_probs_bf16=False), 8),
            ("recurrentgemma-2b", "recurrentgemma-2b",
             dict(dtype="float32", attn_probs_bf16=False), 8),
            ("mamba2-370m", "mamba2-370m", dict(dtype="float32"), 8))


def cfg():
    import dataclasses

    from repro_torch.configs import get_reduced_config

    return dataclasses.replace(get_reduced_config(ARCH), name=TAG, **KW)


def family_batch(fcfg):
    """The pipeline's batch 0, and for a VLM seeded patch embeddings."""
    import torch

    from repro_torch.data.tokens import TokenPipeline

    batch = {k: torch.from_numpy(v).long()
             for k, v in TokenPipeline(fcfg.vocab_size, S, B, seed=SEED).batch(0).items()}
    if fcfg.num_patches:
        gen = torch.Generator().manual_seed(SEED + 5)
        batch["patch_embeds"] = torch.randn(B, fcfg.num_patches, fcfg.patch_embed_dim,
                                            generator=gen)
    return batch


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded-train-ref") / "ref.npz"
    run_with_devices(REF_CODE.format(out=str(path), B=B, S=S, SEED=SEED, tag=TAG, arch=ARCH,
                                     kw=KW, train=TRAIN, eigen=EIGEN), n_devices=4)
    with np.load(path) as data:
        return dict(data)


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded-train")
    np.savez(tmp / "ref.npz", **ref)
    (tmp / "worker.py").write_text(WORKER.format(
        tests=os.path.dirname(os.path.abspath(__file__)), ref=str(tmp / "ref.npz")))
    init, out = f"file://{tmp / 'rdv'}", str(tmp / "out.json")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(k), "4", init, out],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for k in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    return [json.loads(open(f"{out}.{k}").read()) for k in range(4)]


@pytest.mark.parametrize("k", range(4))
def test_adamw_trainer_on_the_mesh_matches_reference(ref, ranks, k):
    got = ranks[k]
    np.testing.assert_allclose(got["adamw_losses"], ref["adamw/losses"], rtol=1e-5, atol=0)
    assert got["adamw_dtensors"] and got["adamw_fsdp"]
    assert got["adamw_step"]["sure"] <= 1e-6, got["adamw_step"]
    assert got["adamw_step"]["near"] <= 2 * TRAIN["lr"] * (1 + 1e-3), got["adamw_step"]


@pytest.mark.parametrize("k", range(4))
def test_eigen_trainer_on_the_mesh_matches_reference_teacher_forced(ranks, k):
    worst = ranks[k]["eigen_worst"]
    assert all(v <= 1.0 for v in worst.values()), worst


@pytest.mark.parametrize("k", range(4))
def test_eigen_step_hands_the_reckoned_bytes_on_the_data_group(ranks, k):
    got = ranks[k]
    assert got["bytes"]["handed"] == {"all_reduce": got["bytes"]["want"]}, got["bytes"]
    lay = got["eigen_layout"]
    assert lay["params_on_model"] and lay["state_replicated"], lay
    assert lay["err_shape"] == [512, 96]  # this data rank's own: no shard axis


@pytest.mark.parametrize("tag", [f[0] for f in FAMILIES])
def test_moe_and_vlm_eigen_steps_on_the_mesh_match_the_stacked_form(ranks, tag):
    for k in range(4):
        got = ranks[k]["families"][tag]
        assert got["basis"] <= 1.0 and got["state"] <= 1e-4 and got["loss"] <= 1e-5, (k, got)

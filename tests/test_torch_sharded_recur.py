"""The recurrent, SSM and encoder-decoder families on a ``(data, model)``
mesh: the sharded forward (``models/layers.py``'s RG-LRU and SSD regions,
local attention with one KV head, ``models/encdec.py``), serving
(``launch/serve.py``) and AdamW training (``launch/train.py::train(mesh=)``,
``launch/steps.make_train_step(mesh=)`` for whisper's batches with
frames) against the reference's on ``make_host_mesh(model=2)``.

The reference runs once, in one subprocess on 4 fake CPU devices: the
reduced recurrentgemma-2b, mamba2-370m and whisper-tiny in f32 (f32
attention probabilities) on the (2, 2) mesh, each its jitted prefill with
the reference's parameter and batch shardings under its activation
constraints (a prompt of T = 20 tokens, past the hybrid's window of 16;
whisper 12 frames), 2 teacher-forced ``jit_decode_step`` steps, and 2
``jit_train_step`` AdamW steps.  Beside it one 4-rank gloo CPU world runs
the port on the same mesh; both take the port's seeded parameters (the
reference's tree through ``interop.join_reference``), so neither waits
for the other.  The tests hold:

  * serving: the sharded prefill's last logits and both decode steps
    within 1e-5 of the unsharded port's, every cache leaf a DTensor in
    ``cache_placements``' placements (whisper's cross K/V too), and within
    each family's f32 bar (1e-4, ``tests/test_torch_recurrent.py`` and
    ``tests/test_torch_encdec.py``) of the reference's sharded ones;
  * training: the 2 AdamW losses within 1e-5 relative of the
    reference's; one step's gradients against the unsharded port's within
    ``test_torch_sharding.py`` (c)'s bars (1e-5 of each leaf's largest
    magnitude, 1e-3 for the leaves there named);
  * the (2, 2) layout: the hybrid's 4 query heads split 2 a rank over its
    one KV head, which stays whole; the SSD's 8 heads 4 a rank; whisper's
    4 / 4 heads 2 a rank.

And under ``torchrun`` on 4 CPU ranks the serve launcher serves
whisper-tiny sharded and the train launcher trains mamba2-370m with
``--mesh-shape 2,2``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import SRC

B, T, GEN, S_ENC, SEED = 4, 20, 2, 12, 0
TRAIN = dict(steps=2, batch=B, seq=16, lr=1e-3, warmup=2, log_every=100)
FAMILIES = {"hybrid": "recurrentgemma-2b", "ssm": "mamba2-370m", "encdec": "whisper-tiny"}
KW = dict(dtype="float32", attn_probs_bf16=False)
# test_torch_sharding.py (c): these leaves at 1e-3 of their largest
# magnitude (block 0's near one-hot softmax amplifies the all-reduces'
# order), every other at 1e-5.
LOOSE = ("blocks.0.mixer.wq", "blocks.0.mixer.wk", "blocks.0.norm1", "embed")

REF_CODE = r'''
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_reduced_config
from repro.launch.mesh import data_axes, make_host_mesh
from repro.launch.sharding import batch_shardings, param_shardings
from repro.launch.steps import jit_decode_step, jit_train_step
from repro.models import init_split
from repro.models.registry import build
from repro.models.sharding_ctx import activation_sharding
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.optim.schedule import warmup_cosine

OUT, INPUTS, FAMILIES, KW = {out!r}, {inputs!r}, {families!r}, {kw!r}
T, GEN, SEED, TRAIN = {T}, {GEN}, {SEED}, {train!r}
with np.load(INPUTS) as f:
    inputs = dict(f)
keystr = jax.tree_util.keystr
mesh = make_host_mesh(model=2)
assert tuple(mesh.shape.values()) == (2, 2), mesh.shape
out = {{}}
for tag, arch in FAMILIES.items():
    cfg = dataclasses.replace(get_reduced_config(arch), name=tag, **KW)
    values, axes = init_split(cfg, jax.random.PRNGKey(SEED))
    # The port's parameters, in the reference's tree.
    values = jax.tree_util.tree_map_with_path(
        lambda k, v: inputs[f"{{tag}}/ref" + keystr(k)].astype(v.dtype), values)
    api = build(cfg)
    ps = param_shardings(values, axes, mesh, cfg)
    pb = {{"tokens": inputs[f"{{tag}}/tokens"]}}
    if cfg.is_encoder_decoder:
        pb["frames"] = inputs[f"{{tag}}/frames"]
    with activation_sharding(mesh, data_axes(mesh)):
        logits, cache = jax.jit(
            lambda v, b: api.prefill(v, {{**b, "cache_len": T + GEN}}),
            in_shardings=(ps, batch_shardings(pb, mesh)))(values, pb)
    out[f"{{tag}}/prefill"] = np.asarray(logits)
    decode, _ = jit_decode_step(cfg, mesh, values, axes, cache)
    params = jax.device_put(values, ps)
    for i in range(GEN):
        tok = jnp.asarray(inputs[f"{{tag}}/next"][:, i:i + 1], jnp.int32)
        logits, cache = decode(params, tok, cache, jnp.asarray(T + i, jnp.int32))
        out[f"{{tag}}/decode{{i}}"] = np.asarray(logits)
    batches = [{{k[len(f"{{tag}}/train{{s}}/"):]: v for k, v in inputs.items()
                if k.startswith(f"{{tag}}/train{{s}}/")}} for s in range(TRAIN["steps"])]
    sched = warmup_cosine(TRAIN["lr"], TRAIN["warmup"], TRAIN["steps"])
    step_jit, (ps_, os_, bs_) = jit_train_step(cfg, mesh, values, axes, batches[0],
                                               adamw_cfg=AdamWConfig(), schedule=sched)
    params, opt, losses = jax.device_put(values, ps_), jax.device_put(adamw_init(values), os_), []
    for b in batches:
        params, opt, metrics = step_jit(params, opt, jax.device_put(b, bs_))
        losses.append(float(metrics["loss"]))
    out[f"{{tag}}/losses"] = np.asarray(losses)
np.savez(OUT, **out)
'''

WORKER = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, {tests!r})
import test_torch_sharded_recur as M
from repro_torch.configs import get_reduced_config
from repro_torch.launch import sharding as S
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import prefill
from repro_torch.launch.steps import make_train_step
from repro_torch.models import loss as model_loss
from repro_torch.models.registry import model_class
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.schedule import warmup_cosine
from torch.distributed.tensor import DTensor

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
with np.load({inputs!r}) as f:
    inputs = dict(f)
res, served = {{}}, {{}}


def model_at(cfg, tag):
    model = model_class(cfg)(cfg, device="cpu", param_dtype=torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(inputs[f"{{tag}}/port/{{name}}"]))
    return model


def gap(got, want):
    return float((S.whole(got) - torch.as_tensor(want)).abs().max())


for tag, arch in M.FAMILIES.items():
    cfg = dataclasses.replace(get_reduced_config(arch), name=tag, **M.KW)
    r = res[tag] = {{}}
    # Serving: unsharded, then sharded, the same prompts and fed tokens.
    tokens = torch.from_numpy(inputs[f"{{tag}}/tokens"]).long()
    nxt = torch.from_numpy(inputs[f"{{tag}}/next"]).long()
    stub = {{"frames": torch.from_numpy(inputs[f"{{tag}}/frames"])}} if cfg.is_encoder_decoder \
        else {{}}
    plain, sharded = model_at(cfg, tag), S.shard_model(model_at(cfg, tag), cfg, mesh)
    want, cache = prefill(plain, tokens, cache_len=M.T + M.GEN, **stub)
    wants = [want]
    for i in range(M.GEN):
        logits, cache = plain.decode_step(nxt[:, i:i + 1], cache, M.T + i)
        wants.append(logits)
    with S.sharded(mesh):
        placed = S.shard_batch({{"tokens": tokens, **stub}}, mesh)
        lead = (placed.pop("frames"),) if "frames" in placed else ()
        got, cache = sharded.prefill(*lead, placed["tokens"], cache_len=M.T + M.GEN)
        gots = [got]
        for i in range(M.GEN):
            tok = S.shard_batch({{"t": nxt[:, i:i + 1]}}, mesh)["t"]
            logits, cache = sharded.decode_step(tok, cache, M.T + i)
            gots.append(logits)
    r["port"] = max(gap(g, w) for g, w in zip(gots, wants))
    for k, g in zip(["prefill"] + [f"decode{{i}}" for i in range(M.GEN)], gots):
        served[f"{{tag}}/{{k}}"] = S.whole(g).numpy()
    def pairs(c, p):  # (cache leaf, its placements by cache_placements)
        if isinstance(c, dict):
            return [x for k in c for x in pairs(c[k], p[k])]
        if isinstance(c, list):
            return [x for a, b in zip(c, p) for x in pairs(a, b)]
        return [(c, p)]

    leaves = pairs(cache, S.cache_placements(cache, cfg, mesh))
    r["cache_dtensor"] = all(isinstance(t, DTensor) for t, _ in leaves)
    r["cache_placed"] = all(list(t.placements) == p for t, p in leaves)
    r["cache_leaves"] = len(leaves)
    # The layout: this rank's local heads of the first attention or mixer.
    blk = (sharded.decoder[0].self_attn if cfg.is_encoder_decoder else
           next(b.mixer for b in sharded.blocks if b.kind in ("local_attn", "ssd")))
    if hasattr(blk, "wq"):
        r["local"] = [blk.wq.to_local().shape[1] // cfg.head_dim,
                      blk.wk.to_local().shape[1] // cfg.head_dim]
    else:
        r["local"] = [blk.wx.to_local().shape[1] // cfg.ssm_head_dim]

    # AdamW on the mesh: the launcher's trainer (whisper: make_train_step
    # on batches with frames).
    batches = [{{k[len(f"{{tag}}/train{{s}}/"):]: torch.from_numpy(v).long() if v.dtype.kind == "i"
                else torch.from_numpy(v) for k, v in inputs.items()
                if k.startswith(f"{{tag}}/train{{s}}/")}} for s in range(M.TRAIN["steps"])]
    if cfg.is_encoder_decoder:
        model = S.shard_model(model_at(cfg, tag), cfg, mesh)
        sched = warmup_cosine(M.TRAIN["lr"], M.TRAIN["warmup"], M.TRAIN["steps"])
        step = make_train_step(model, adamw_cfg=AdamWConfig(), schedule=sched, mesh=mesh)
        opt = adamw_init(dict(model.named_parameters()))
        losses = [float(step(opt, b)["loss"]) for b in batches]
    else:
        model = model_at(cfg, tag)
        real = ttrain.build
        ttrain.build = lambda c, **k: model
        try:
            _, opt, losses = ttrain.train(cfg, device="cpu", mesh=mesh, **M.TRAIN)
        finally:
            ttrain.build = real
    r["losses"] = losses
    r["moments_dtensor"] = all(isinstance(t, DTensor) for t in [*opt["m"].values(),
                                                                 *opt["v"].values()])
    # One step's gradients, sharded against unsharded.
    plain, sharded = model_at(cfg, tag), S.shard_model(model_at(cfg, tag), cfg, mesh)
    l_u, _ = model_loss(plain, batches[0])
    g_u = torch.autograd.grad(l_u, list(plain.parameters()))
    with S.sharded(mesh):
        l_s, _ = model_loss(sharded, S.shard_batch(batches[0], mesh))
        g_s = torch.autograd.grad(l_s, list(sharded.parameters()))
    r["loss_gap"] = abs(float(S.whole(l_s)) - float(l_u))
    r["grad_rel"] = {{n: gap(b, a) / max(float(a.abs().max()), 1e-30)
                     for (n, _), a, b in zip(plain.named_parameters(), g_u, g_s)}}

with open(f"{{out}}.{{rank}}", "w") as f:
    json.dump(res, f)
np.savez(f"{{out}}.{{rank}}.npz", **served)
dist.destroy_process_group()
'''


def _inputs(path):
    """Every input both sides take: each family's seeded f32 parameters
    (the port's names, and the reference's key paths), and from one seeded
    numpy generator the prompts, the fed decode tokens, whisper's frames
    and each train step's batch (the token pipeline's, and frames for
    whisper)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.interop import join_reference
    from repro_torch.models import build

    rng = np.random.default_rng(SEED)
    out = {}
    for tag, arch in FAMILIES.items():
        cfg = dataclasses.replace(get_reduced_config(arch), name=tag, **KW)
        model = build(cfg, device="cpu", param_dtype=torch.float32,
                      generator=torch.Generator().manual_seed(SEED))
        named = {n: p.detach().numpy() for n, p in model.named_parameters()}
        out.update({f"{tag}/port/{n}": v for n, v in named.items()})
        out.update({f"{tag}/ref{k}": v for k, v in join_reference(named, cfg).items()})
        out[f"{tag}/tokens"] = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
        out[f"{tag}/next"] = rng.integers(0, cfg.vocab_size, (B, GEN), dtype=np.int32)
        if cfg.is_encoder_decoder:
            out[f"{tag}/frames"] = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
        pipe = TokenPipeline(cfg.vocab_size, TRAIN["seq"], B, seed=SEED)
        for s in range(TRAIN["steps"]):
            for k, v in pipe.batch(s).items():
                out[f"{tag}/train{s}/{k}"] = v
            if cfg.is_encoder_decoder:
                out[f"{tag}/train{s}/frames"] = rng.standard_normal(
                    (B, S_ENC, cfg.d_model)).astype(np.float32)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the 4 rank processes, side by side:
    (the reference's arrays, each rank's results, each rank's sharded
    logits)."""
    tmp = tmp_path_factory.mktemp("sharded-recur")
    _inputs(tmp / "inputs.npz")
    code = REF_CODE.format(out=str(tmp / "ref.npz"), inputs=str(tmp / "inputs.npz"),
                           families=FAMILIES, kw=KW, T=T, GEN=GEN, SEED=SEED, train=TRAIN)
    (tmp / "worker.py").write_text(WORKER.format(
        tests=os.path.dirname(os.path.abspath(__file__)), inputs=str(tmp / "inputs.npz")))
    init, out = f"file://{tmp / 'rdv'}", str(tmp / "out.json")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    # run_with_devices' environment, in the background.
    ref_env = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    ref_env.pop("OMP_NUM_THREADS")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=ref_env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(k), "4", init, out],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True) for k in range(4)]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    with np.load(tmp / "ref.npz") as data:
        ref = dict(data)
    ranks = [json.loads(open(f"{out}.{k}").read()) for k in range(4)]
    logits = []
    for k in range(4):
        with np.load(f"{out}.{k}.npz") as data:
            logits.append(dict(data))
    return ref, ranks, logits


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[1]


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_sharded_serving_matches_the_unsharded_port(ranks, tag):
    for k in range(4):
        got = ranks[k][tag]
        assert got["port"] <= 1e-5, (k, got["port"])
        assert got["cache_dtensor"] and got["cache_placed"], (k, got)


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_sharded_serving_matches_the_references_sharded_forward(runs, tag):
    ref, _, logits = runs
    for k in range(4):
        for step in ["prefill"] + [f"decode{i}" for i in range(GEN)]:
            got, want = logits[k][f"{tag}/{step}"], ref[f"{tag}/{step}"]
            assert got.shape == want.shape and np.abs(got - want).max() <= 1e-4, (k, step)


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_adamw_losses_on_the_mesh_match_the_reference(ref, ranks, tag):
    for k in range(4):
        np.testing.assert_allclose(ranks[k][tag]["losses"], ref[f"{tag}/losses"], rtol=1e-5,
                                   atol=0)
        assert ranks[k][tag]["moments_dtensor"]


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_sharded_gradients_match_the_unsharded_port(ranks, tag):
    for k in range(4):
        got = ranks[k][tag]
        assert got["loss_gap"] <= 1e-6, (k, got["loss_gap"])
        for name, rel in got["grad_rel"].items():
            assert rel <= (1e-3 if name in LOOSE else 1e-5), (k, name, rel)


def test_heads_split_as_the_reference_places_them(ranks):
    """(2, 2): the hybrid's 4 query heads 2 a rank over its one KV head,
    whole on every rank; the SSD's 8 heads 4 a rank; whisper's 4 / 4
    heads 2 a rank.  The caches: the hybrid's 5 blocks 2 leaves each,
    the SSD's 3, whisper's 2 layers' self and cross K/V."""
    got = ranks[0]
    assert got["hybrid"]["local"] == [2, 1]
    assert got["ssm"]["local"] == [4]
    assert got["encdec"]["local"] == [2, 2]
    assert [got[t]["cache_leaves"] for t in FAMILIES] == [10, 6, 8]


@pytest.mark.parametrize("module, args", [
    ("serve", ["--arch", "whisper-tiny", "--batch", "4", "--prompt-len", "12", "--gen", "3"]),
    ("train", ["--arch", "mamba2-370m", "--steps", "2", "--batch", "4", "--seq", "16",
               "--mesh-shape", "2,2"]),
], ids=["serve-whisper-tiny", "train-mamba2-370m"])
def test_launchers_run_the_families_on_a_mesh_under_torchrun(tmp_path, module, args):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", f"repro_torch.launch.{module}", "--device", "cpu", *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(": ", 1) for line in proc.stdout.splitlines() if ": " in line)
    if module == "serve":
        assert lines["mesh"].startswith("{'data': 1, 'model': 4}"), lines
        assert lines["generated token matrix"] == "(4, 3)"
        assert lines["attention_blocks"] == "4"
    else:
        assert lines["mesh"] == "(2, 2) ('data', 'model')" and lines["losses"] == "2", lines
        assert np.isfinite(float(lines["final_loss_exact"]))

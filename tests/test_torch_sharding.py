"""The port's distribution layer (``launch/sharding.py``,
``models/sharding_ctx.py``, ``launch/mesh.py``'s model meshes) against
the reference's ``repro/launch/sharding.py``.

(a) Placements.  The reference runs once, in one subprocess on 8 fake CPU
    devices: for all 10 archs at their full configs (abstract, nothing
    allocated), on the (2, 4) and (1, 8) ``(data, model)`` meshes and the
    (2, 2, 2) ``(pod, data, model)`` one, and for the two MoE archs also
    in the two serving layouts (``serve_ep_over_data``,
    ``serve_mlp_over_data``), it records every leaf's ``PartitionSpec``
    and ``NamedSharding.shard_shape``, and every decode-cache leaf's spec
    (``cache_shardings`` at batch 8, 64 slots).  Every port leaf's spec
    (``param_specs``, the stacked layer axis dropped) equals its
    reference leaf's, every cache leaf's spec (``cache_specs``) equals
    the reference's, and the bytes a device of the parameters (f32
    masters) and of AdamW's two moments equal the sum of the reference's
    shard shapes' bytes, exactly.
(b) On 4 gloo CPU ranks over a (2, 2) mesh, the reduced llama3.2-3b,
    qwen3-moe-30b-a3b (einsum and sort dispatch) and internvl2-2b in f32:
    the sharded prefill's last logits and one decode step's logits within
    1e-5 of the unsharded port's.
    The reduced qwen3-moe-30b-a3b's loss (CE + the aux, whose two factors
    the einsum form averages over the data ranks) within 1e-5, the MoE
    layers' gradients (router and experts) within 1e-4 of their leaf's
    largest magnitude and the others within 1e-3 (as (c)), in both forms.
(c) One AdamW step of the sharded reduced llama3.2-3b:
    * from the unsharded step's gradients (placed as the parameters):
      the parameters within 1e-6 of the unsharded step's (the optimizer
      over DTensors: the global norm, the clip and the moments in place);
    * end to end (``launch/steps.make_train_step`` on the sharded model):
      the loss within 1e-6; the gradients of block 0's wq and wk lie up
      to ~1e-5 from the unsharded ones (the all-reduces sum in another
      order, and block 0's near one-hot softmax amplifies it in dq, dk;
      the other leaves within 1e-6 of their largest magnitude); Adam's
      first step is g / (|g| + eps), ~the gradient's sign, so the
      parameters are held within 1e-6 wherever |g| clears twice its
      leaf's sharded-vs-unsharded gap and 1e3 eps, and within 2 lr
      elsewhere.
(d) With no context, or on a plain tensor, ``sharding_ctx``'s
    constraints return their input itself; ``make_host_mesh``'s
    factorisation is the reference's; importing ``launch.mesh`` starts no
    process group; ``make_production_mesh`` gives (16, 16) and (2, 16, 16).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from conftest import SRC, run_with_devices
from repro_torch.configs import ARCHS, get_config
from repro_torch.interop import reference_leaves
from repro_torch.launch import sharding as S
from repro_torch.models.registry import model_class

MESHES = [((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
LAYOUTS = ("serve_ep_over_data", "serve_mlp_over_data")
CACHE_B, CACHE_T = 8, 64


def _layouts(arch):
    return ("default",) + (LAYOUTS if get_config(arch).is_moe else ())


def _cfg(arch, layout):
    cfg = get_config(arch)
    return cfg if layout == "default" else dataclasses.replace(cfg, **{layout: True})


REF = r"""
import dataclasses, json, math
import jax
from jax.tree_util import keystr, tree_flatten_with_path
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.launch.sharding import cache_shardings, param_shardings
from repro.launch.specs import decode_state_specs
from repro.models import abstract_params
from repro.models.config import ShapeConfig

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

out = {}
for arch, layouts in %(cells)r:
    for layout in layouts:
        cfg = get_config(arch)
        if layout != "default":
            cfg = dataclasses.replace(cfg, **{layout: True})
        values, axes = abstract_params(cfg)
        _, cache, _ = decode_state_specs(cfg, ShapeConfig("t", %(t)d, %(b)d, "decode"))
        for shape, names in %(meshes)r:
            mesh = make_mesh(tuple(shape), tuple(names))
            ps = param_shardings(values, axes, mesh, cfg)
            vals = dict((keystr(p), v) for p, v in tree_flatten_with_path(values)[0])
            rec = {"params": {}, "bytes": 0, "cache": {}}
            for p, s in tree_flatten_with_path(ps)[0]:
                k = keystr(p)
                rec["params"][k] = spec(s)
                rec["bytes"] += math.prod(s.shard_shape(vals[k].shape)) * vals[k].dtype.itemsize
            cs = cache_shardings(cache, cfg, mesh)
            for p, s in tree_flatten_with_path(cs)[0]:
                rec["cache"][keystr(p)] = spec(s)
            out[f"{arch}|{layout}|{'x'.join(map(str, shape))}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    cells = [(a, list(_layouts(a))) for a in sorted(ARCHS)]
    code = REF % {"cells": cells, "meshes": [(list(s), list(n)) for s, n in MESHES],
                  "t": CACHE_T, "b": CACHE_B}
    return json.loads(run_with_devices(code, n_devices=8, timeout=600).strip().splitlines()[-1])


def _norm(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


CASES = [(a, layout, m) for a in sorted(ARCHS) for layout in _layouts(a) for m in range(3)]


@pytest.mark.parametrize("arch, layout, m", CASES,
                         ids=[f"{a}-{lay}-{'x'.join(map(str, MESHES[m][0]))}"
                              for a, lay, m in CASES])
def test_placements_and_bytes_equal_the_references(ref, arch, layout, m):
    shape, names = MESHES[m]
    mesh = dict(zip(names, shape))
    cfg = _cfg(arch, layout)
    rec = ref[f"{arch}|{layout}|{'x'.join(map(str, shape))}"]
    leaves = reference_leaves(cfg)
    specs = S.param_specs(cfg, mesh)
    model = model_class(cfg)(cfg, device="meta", param_dtype=torch.float32)
    total = 0
    for name, p in model.named_parameters():
        leaf = leaves[name]
        want = _norm(rec["params"][leaf.path])
        if leaf.layer is not None:
            assert want[:1] in ((), (None,)), (name, want)
            want = want[1:]
        assert specs[name] == want, (name, specs[name], want)
        # This rank's block of the port tensor: each sharded reference
        # dim divides the port dim it lies in.
        local = list(p.shape)
        for i, entry in enumerate(specs[name]):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                local[S.port_dims(leaf)[i]] //= math.prod(mesh[a] for a in axes)
        total += math.prod(local) * p.element_size()
    assert total == rec["bytes"]
    opt = 2 * total  # AdamW's m and v, f32 beside every parameter
    assert opt == 2 * rec["bytes"]
    # The decode cache.
    cache = model_class(cfg)(cfg, device="meta").init_cache(CACHE_B, CACHE_T)
    if cfg.is_encoder_decoder:
        for layer in cache:
            layer["cross"] = dict(layer["self"])
    got = S.cache_specs(cache, cfg, mesh)
    blocks = [(s, j) for s, (pattern, count) in enumerate(cfg.stages())
              for _ in range(count) for j in range(len(pattern))]
    for b, block in enumerate(got):
        for key, val in block.items():
            items = val.items() if isinstance(val, dict) else [(None, val)]
            for sub, sp in items:
                path = (f"['{key}']['{sub}']" if cfg.is_encoder_decoder
                        else f"[{blocks[b][0]}]['block{blocks[b][1]}']['{key}']")
                want = _norm(rec["cache"][path])
                assert want[:1] in ((), (None,)) and sp == want[1:], (b, key, sub, sp, want)


WORKER = r"""
import dataclasses, json, sys
import torch, torch.distributed as dist
rank, world, init, out_path = sys.argv[1:5]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch.configs import get_reduced_config
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build, loss
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.interop import decays

mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
out = {"serve": {}}
B, T = 4, 8
for arch, impl in (("llama3.2-3b", "einsum"), ("qwen3-moe-30b-a3b", "einsum"),
                   ("qwen3-moe-30b-a3b", "sort"), ("internvl2-2b", "einsum")):
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32", moe_impl=impl)
    ref = build(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    mdl = S.shard_model(build(cfg, device="cpu", generator=torch.Generator().manual_seed(0)),
                        cfg, mesh)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen)
    stub = {}
    if cfg.num_patches:
        stub["patch_embeds"] = torch.randn(B, cfg.num_patches, cfg.patch_embed_dim,
                                           generator=gen)
    P = cfg.num_patches or 0
    want, wcache = ref.prefill(toks, cache_len=P + T + 2, **stub)
    nxt = torch.argmax(want, -1)[:, None]
    want2, _ = ref.decode_step(nxt, wcache, P + T)
    with S.sharded(mesh):
        placed = S.shard_batch({"tokens": toks, **stub}, mesh)
        got, cache = mdl.prefill(placed.pop("tokens"), cache_len=P + T + 2, **placed)
        got2, _ = mdl.decode_step(S.shard_batch({"t": nxt}, mesh)["t"], cache, P + T)
        kinds = sorted({type(t).__name__ for blk in cache for t in blk.values()})
        out["serve"][f"{arch}/{impl}"] = {
            "prefill": (whole(got) - want).abs().max().item(),
            "decode": (whole(got2) - want2).abs().max().item(), "cache": kinds}

# The MoE layer's loss (CE + aux) and gradients, both dispatch forms: the
# einsum form routes each data rank's rows, the sort form all of them.
out["moe_grad"] = {}
for impl in ("einsum", "sort"):
    cfg = dataclasses.replace(get_reduced_config("qwen3-moe-30b-a3b"), dtype="float32",
                              moe_impl=impl)
    mk = lambda: build(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                       param_dtype=torch.float32)
    ref, mdl = mk(), S.shard_model(mk(), cfg, mesh)
    toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=torch.Generator().manual_seed(3))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    l_u, m_u = loss(ref, batch)
    g_u = torch.autograd.grad(l_u, list(ref.parameters()))
    with S.sharded(mesh):
        l_s, m_s = loss(mdl, S.shard_batch(batch, mesh))
        g_s = torch.autograd.grad(l_s, list(mdl.parameters()))
    out["moe_grad"][impl] = {
        "loss": abs(float(whole(l_s)) - float(l_u)),
        "aux": abs(float(whole(m_s["aux"])) - float(m_u["aux"])),
        "grad_rel": {n: (whole(b) - a).abs().max().item() / a.abs().max().item()
                     for (n, _), a, b in zip(ref.named_parameters(), g_u, g_s)}}

# (c) AdamW: the reduced llama in f32 masters.
cfg = dataclasses.replace(get_reduced_config("llama3.2-3b"), dtype="float32")
LR = 1e-3
mk = lambda: build(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                   param_dtype=torch.float32)
gen = torch.Generator().manual_seed(2)
toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen)
batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
sched = lambda step: LR
acfg = AdamWConfig()
ref, mdl = mk(), S.shard_model(mk(), cfg, mesh)
l_u, _ = loss(ref, batch)
g_u = dict(zip(dict(ref.named_parameters()), torch.autograd.grad(l_u, list(ref.parameters()))))
with S.sharded(mesh):
    l_s, _ = loss(mdl, S.shard_batch(batch, mesh))
    g_s = torch.autograd.grad(l_s, list(mdl.parameters()))
gap = {n: (whole(g) - g_u[n]).abs().max().item() for n, g in zip(g_u, g_s)}
rel = {n: gap[n] / g_u[n].abs().max().item() for n in gap}
# c1: the same gradients into both optimizers.
pu = {n: p.detach().clone() for n, p in ref.named_parameters()}
ps = {n: p for n, p in mdl.named_parameters()}
su, ss = adamw_init(pu), adamw_init(ps)
gu = {n: g.clone() for n, g in g_u.items()}
gs = {n: distribute_tensor(g_u[n].clone(), mesh, ps[n].placements, src_data_rank=None)
      for n in ps}
adamw_update(gu, su, pu, lr=LR, cfg=acfg, decays=decays(cfg))
with S.sharded(mesh):
    adamw_update(gs, ss, ps, lr=LR, cfg=acfg, decays=decays(cfg))
c1 = max((whole(ps[n]) - pu[n]).abs().max().item() for n in pu)
c1m = max((whole(ss["m"][n]) - su["m"][n]).abs().max().item() for n in pu)
# c2: the whole sharded train step.
ref, mdl = mk(), S.shard_model(mk(), cfg, mesh)
mu = make_train_step(ref, adamw_cfg=acfg, schedule=sched)(adamw_init(dict(ref.named_parameters())), batch)
with S.sharded(mesh):
    ms = make_train_step(mdl, adamw_cfg=acfg, schedule=sched)(
        adamw_init(dict(mdl.named_parameters())), S.shard_batch(batch, mesh))
sure, near = 0.0, 0.0
for (n, p), (_, q) in zip(mdl.named_parameters(), ref.named_parameters()):
    d = (whole(p) - q).abs()
    # Adam's first step is g / (|g| + eps): two gradients a gap apart give
    # steps within 1e-6 once |g| clears twice the gap and 1e3 eps.
    agree = g_u[n].abs() > max(2 * gap[n], 1e3 * acfg.eps)
    sure = max(sure, d[agree].max().item() if agree.any() else 0.0)
    near = max(near, d[~agree].max().item() if (~agree).any() else 0.0)
out["adamw"] = {"c1_params": c1, "c1_m": c1m,
                "loss": abs(float(whole(ms["loss"])) - float(mu["loss"])),
                "gnorm_rel": abs(ms["grad_norm"] - mu["grad_norm"]) / mu["grad_norm"],
                "params_where_sign_agrees": sure, "params_elsewhere": near,
                "grad_rel": rel, "lr": LR}
dist.destroy_process_group()
if rank == 0:
    with open(out_path, "w") as f:
        json.dump(out, f)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard")
    script, out = tmp / "worker.py", tmp / "out.json"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rdv'}"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "4", init, str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", ["llama3.2-3b/einsum", "qwen3-moe-30b-a3b/einsum",
                                  "qwen3-moe-30b-a3b/sort", "internvl2-2b/einsum"])
def test_sharded_serving_matches_the_unsharded_port(ranks, case):
    got = ranks["serve"][case]
    assert got["prefill"] <= 1e-5 and got["decode"] <= 1e-5, got
    assert got["cache"] == ["DTensor"]


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_sharded_moe_loss_and_gradients(ranks, impl):
    got = ranks["moe_grad"][impl]
    assert got["loss"] <= 1e-5 and got["aux"] <= 1e-6, got
    for name, rel in got["grad_rel"].items():
        # The MoE layers' leaves at 1e-4; the rest as the dense model's
        # (block 0's attention amplifies the all-reduces' order, (c)).
        assert rel <= (1e-4 if ".mlp." in name else 1e-3), (name, rel)


def test_sharded_adamw_step_from_the_same_gradients(ranks):
    a = ranks["adamw"]
    assert a["c1_params"] <= 1e-6 and a["c1_m"] <= 1e-6, a


def test_sharded_train_step_end_to_end(ranks):
    a = ranks["adamw"]
    assert a["loss"] <= 1e-6 and a["gnorm_rel"] <= 1e-5, a
    for name, rel in a["grad_rel"].items():
        bar = 1e-3 if name in ("blocks.0.mixer.wq", "blocks.0.mixer.wk", "blocks.0.norm1",
                               "embed") else 1e-5
        assert rel <= bar, (name, rel)
    assert a["params_where_sign_agrees"] <= 1e-6, a
    assert a["params_elsewhere"] <= 2 * a["lr"] * (1 + 1e-3), a


def test_constraints_are_the_identity_without_a_context():
    from repro_torch.models import sharding_ctx as ctx

    x = torch.randn(4, 6, 8, 16)
    assert ctx.current() is None
    assert ctx.constrain_batch(x) is x
    assert ctx.constrain_batch_heads(x) is x
    assert ctx.constrain_expert_dim(x, 1) is x
    with ctx.activation_sharding(object(), ("data",)):
        # a plain tensor under a context: still itself
        assert ctx.constrain_batch(x) is x and ctx.constrain_batch_heads(x) is x
        with ctx.no_activation_sharding():
            assert ctx.current() is None
    assert ctx.current() is None


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 24, 256])
def test_host_mesh_shape_is_the_references(n):
    from repro_torch.launch.mesh import host_mesh_shape

    model = next((c for c in (8, 4, 2) if n % c == 0), 1)
    assert host_mesh_shape(n) == (n // model, model)


def test_mesh_module_starts_no_process_group_and_production_shapes():
    code = (
        "import torch.distributed as dist\n"
        "import repro_torch.launch.mesh as M\n"
        "assert not dist.is_initialized()\n"
        "from repro_torch.launch.dryrun import fake_world\n"
        "for mp, world in ((False, 256), (True, 512)):\n"
        "    with fake_world(world):\n"
        "        mesh = M.make_production_mesh(multi_pod=mp, device='cpu')\n"
        "        print(tuple(mesh.shape), mesh.mesh_dim_names, M.data_axes(mesh))\n"
        "    assert not dist.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "(16, 16) ('data', 'model') ('data',)",
        "(2, 16, 16) ('pod', 'data', 'model') ('pod', 'data')"]

"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro/launch/dryrun.py``, both at 8 ranks / devices.

The reference runs once, in one subprocess on 8 fake CPU devices
(``run_with_devices``): llama3.2-3b x {train_4k, decode_32k} cut to 2
layers (``overrides``, on both sides) with ``accounting="unrolled"``, and
paper-pca on the single-pod (2, 4) and multi-pod (2, 2, 2) meshes over
the ring, the ring with shard 1 dead, and hier.  The port runs the same
cells on a fake process group of 8 ranks under ``FakeTensorMode``.

* ``model_flops_global`` is equal exactly.
* Parameter and AdamW-state bytes a device are equal exactly: the train
  cell's argument bytes plus the reference's int32 step counter are its
  ``argument_size_bytes``.  The decode cell's equal it but for the port's
  f32 norm scales (the reference serves every leaf in bf16; the port
  keeps norm scales in f32, ``models/layers.py``): 2 bytes more an
  element, exactly.
* paper-pca's collective bytes a device (rank 0's payloads handed to
  ``torch.distributed``) equal ``comm_cost(...).bits / 8``, the port's
  and the reference's; the reference's HLO bytes are no oracle (ROADMAP
  C2), so they are not compared.
* The counted FLOPs a device lie between mf, the model FLOPs a device
  (6 N D or 2 N D), and ref, the reference's ``flops_per_device``:
  ``min(mf, ref) <= counted <= max(mf, ref)``.  At train_4k mf counts the
  embedding table's parameters, whose lookup takes no products, and both
  counts lie below it (the port 0.81 mf with remat's recompute and its
  plain attention's whole (S, S) products; XLA's 0.72 mf); at decode_32k
  the port counts 1.01 mf and XLA 2.79 mf.
* The ``--eigen`` train cell (the eigen train step, parameters on the
  model submesh with FSDP off, the eigen state replicated, ``err`` this
  data rank's own): its argument bytes plus the reference's 4-byte step
  and its one-byte ``initialized`` flag a stacked compressed leaf (the
  port's flags are host scalars, one a layer's leaf) equal the
  reference's ``argument_size_bytes`` exactly, and ``model_flops_global``
  is equal.  Its data-axis bytes are the compressed coordinates, the
  uncompressed gradients' local blocks and the loss, exactly.
* The recurrent, SSM and encoder-decoder families (``FAMILY_CELLS``, cut
  to the fewest layers that keep each block kind: recurrentgemma-2b 3,
  rglru, rglru, local_attn; mamba2-370m 1; whisper-tiny 1 + 1), in the
  same reference subprocess: recurrentgemma-2b and whisper-tiny
  train_4k, mamba2-370m decode_32k and long_500k (its batch of 1
  replicated over 'data'), and mamba2-370m and whisper-tiny train_4k
  ``--eigen`` (whisper's config says ``eigen_compress=False``, which
  neither trainer reads; the reference lowers the cell).
  ``model_flops_global`` is equal; train and eigen argument bytes equal
  the reference's as llama's are held; decode's equal it but for the
  leaves the port keeps in f32 (norm scales and SSD's ``wb``, ``wc``,
  ``wdt``, ``a_log``, ``dt_bias``, ``dskip``: 2 bytes more an element of
  this device's block; and ``jax.jit`` prunes the decode position, which
  reaches no block of an attention-free model).
* ``--accounting extrapolate`` / ``scan-only`` are refused by name (exit 2
  from the CLI); mamba2-370m, refused before the SSM family's sharded
  forward, counts (with and without ``--eigen``, exit 0 from the CLI with
  its record); and no global process group outlives a dry run, a refused
  or failing one included.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from conftest import SRC
from repro_torch.comm import comm_cost
from repro_torch.configs import get_config
from repro_torch.configs.paper_pca import CONFIG as PCFG
from repro_torch.interop import reference_leaves
from repro_torch.launch import dryrun as D
from repro_torch.launch.sharding import param_specs, port_dims
from repro_torch.launch.steps import compressed_paths
from repro_torch.models.registry import model_class
from repro_torch.optim import EigenCompressConfig

N = 8
CUT = {"num_layers": 2}
# (arch, shape, eigen, cut) of the families' cells.
FAMILY_CELLS = [("recurrentgemma-2b", "train_4k", False, {"num_layers": 3}),
                ("whisper-tiny", "train_4k", False, {"num_layers": 1, "num_encoder_layers": 1}),
                ("mamba2-370m", "decode_32k", False, {"num_layers": 1}),
                ("mamba2-370m", "long_500k", False, {"num_layers": 1}),
                ("mamba2-370m", "train_4k", True, {"num_layers": 1}),
                ("whisper-tiny", "train_4k", True, {"num_layers": 1, "num_encoder_layers": 1})]


def _family_key(arch, shape, eigen):
    return f"{arch}/{shape}" + ("_eigen" if eigen else "")
PCA_CELLS = [  # (multi_pod, topology, drop_shards)
    (False, "ring", None), (True, "ring", None), (False, "ring", "1"), (True, "hier", None)]

REF = r"""
import json, os
os.environ["REPRO_DRYRUN_DEVICES"] = "8"
from repro.launch import dryrun as D
out = {"cells": {}, "pca": []}
for shape in ("train_4k", "decode_32k"):
    r = D.dryrun_cell("llama3.2-3b", shape, device_count=8, verbose=False,
                      accounting="unrolled", overrides=%(cut)r)
    out["cells"][shape] = {k: r[k] for k in ("flops_per_device", "model_flops_global",
                                            "model_flops_per_device", "memory_analysis")}
r = D.dryrun_cell("llama3.2-3b", "train_4k", device_count=8, verbose=False, eigen=True,
                  accounting="unrolled", overrides=%(cut)r)
out["cells"]["train_4k_eigen"] = {k: r[k] for k in ("model_flops_global", "memory_analysis")}
out["families"] = {}
for arch, shape, eigen, cut in %(families)r:
    r = D.dryrun_cell(arch, shape, device_count=8, verbose=False, eigen=eigen,
                      accounting="unrolled", overrides=cut)
    out["families"][arch + "/" + shape + ("_eigen" if eigen else "")] = {
        k: r[k] for k in ("model_flops_global", "memory_analysis")}
for mp, topo, drop in %(pca)r:
    r = D.dryrun_paper_pca(multi_pod=mp, device_count=8, verbose=False, topology=topo,
                           drop_shards=drop)
    out["pca"].append({k: r[k] for k in ("predicted_collective_bits", "m_active",
                                         "topology", "mesh")})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_proc():
    """The reference's dry run (``run_with_devices``' environment), started
    before the port counts its cells, so the two run side by side."""
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    code = REF % {"cut": CUT, "pca": PCA_CELLS, "families": FAMILY_CELLS}
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc, port):
    out, err = ref_proc.communicate(timeout=600)
    assert ref_proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port(ref_proc):
    cells = {s: D.dryrun_cell("llama3.2-3b", s, device_count=N, verbose=False,
                              overrides=CUT) for s in ("train_4k", "decode_32k")}
    cells["train_4k_eigen"] = D.dryrun_cell("llama3.2-3b", "train_4k", device_count=N,
                                            verbose=False, overrides=CUT, eigen=True)
    pca = [D.dryrun_paper_pca(multi_pod=mp, device_count=N, verbose=False, topology=topo,
                              drop_shards=drop) for mp, topo, drop in PCA_CELLS]
    families = {_family_key(a, s, e): D.dryrun_cell(a, s, device_count=N, verbose=False,
                                                    eigen=e, overrides=cut)
                for a, s, e, cut in FAMILY_CELLS}
    return {"cells": cells, "pca": pca, "families": families}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "train_4k_eigen"])
def test_model_flops_equal_the_references(ref, port, shape):
    assert port["cells"][shape]["model_flops_global"] == ref["cells"][shape]["model_flops_global"]
    if "model_flops_per_device" in ref["cells"][shape]:
        assert port["cells"][shape]["model_flops_per_device"] == \
            ref["cells"][shape]["model_flops_per_device"]


def _eigen_leaves(cut):
    """(config, compressed leaves) of the eigen cell at the reference's
    ``EigenCompressConfig()``."""
    cfg = dataclasses.replace(get_config("llama3.2-3b"), **cut)
    return cfg, compressed_paths(cfg, EigenCompressConfig())


def test_eigen_train_argument_bytes_equal_the_references(ref, port):
    cfg, comp = _eigen_leaves(CUT)
    flags = len({reference_leaves(cfg)[n].path for n in comp})  # one a stacked leaf
    step = 4
    mem = port["cells"]["train_4k_eigen"]["memory"]
    assert mem["argument_bytes"] + step + flags == \
        ref["cells"]["train_4k_eigen"]["memory_analysis"]["argument_size_bytes"]
    # No FSDP: the parameters' bytes are the baseline cell's times the data axis.
    assert mem["param_bytes"] == 2 * port["cells"]["train_4k"]["memory"]["param_bytes"]


def test_eigen_train_data_axis_bytes_are_the_compressed_step(port):
    cfg, comp = _eigen_leaves(CUT)
    rec = port["cells"]["train_4k_eigen"]
    words = rec["data_axis_words"]
    assert words["compressed"] == sum(min(128, d, n) * n for d, n in comp.values())
    # The uncompressed leaves' local blocks on the (2, 4) mesh's model axis.
    specs = param_specs(dataclasses.replace(cfg, fsdp=False), {"model": 4})
    leaves = reference_leaves(cfg)
    model = model_class(cfg)(cfg, device="meta", param_dtype=torch.float32)
    other = 0
    for name, p in model.named_parameters():
        if name in comp:
            continue
        local = list(p.shape)
        for i, entry in enumerate(specs[name]):
            if entry is not None:
                local[port_dims(leaves[name])[i]] //= 4
        other += math.prod(local) * 4
    assert rec["data_axis_handed"] == {"all_reduce": 4 * words["compressed"] + other + 4}
    assert rec["data_axis_bytes"] == 4 * words["compressed"] + other + 4


def test_train_argument_bytes_equal_the_references(ref, port):
    mem = port["cells"]["train_4k"]["memory"]
    assert mem["opt_state_bytes"] == 2 * mem["param_bytes"]
    step = 4  # the reference's int32 step counter, replicated
    assert mem["argument_bytes"] + step == \
        ref["cells"]["train_4k"]["memory_analysis"]["argument_size_bytes"]


def test_decode_argument_bytes_equal_but_the_f32_norm_scales(ref, port):
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import param_specs

    import dataclasses

    cfg = dataclasses.replace(get_config("llama3.2-3b"), **CUT)
    mesh = {"data": 2, "model": 4}
    specs = param_specs(cfg, mesh)
    norms = [n for n in specs if n.endswith("norm") or n.endswith("norm1")
             or n.endswith("norm2")]
    # Each norm scale (d,) shards over 'data' (embed, FSDP): d / 2 a device.
    norm_elems = sum(cfg.d_model // (2 if specs[n] == ("data",) else 1) for n in norms)
    mem = port["cells"]["decode_32k"]["memory"]
    pos = 4  # the reference's int32 position
    assert mem["argument_bytes"] + pos - 2 * norm_elems == \
        ref["cells"]["decode_32k"]["memory_analysis"]["argument_size_bytes"]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_counted_flops_lie_between_the_model_and_the_reference(ref, port, shape):
    mine = port["cells"][shape]["flops_per_device"]
    mf = port["cells"][shape]["model_flops_per_device"]
    theirs = ref["cells"][shape]["flops_per_device"]
    assert min(mf, theirs) <= mine <= max(mf, theirs), (mine, mf, theirs)


@pytest.mark.parametrize("i", range(len(PCA_CELLS)), ids=lambda i: "-".join(
    str(x) for x in PCA_CELLS[i]))
def test_paper_pca_collective_bytes_equal_comm_cost(ref, port, i):
    mp, topo, drop = PCA_CELLS[i]
    rec, theirs = port["pca"][i], ref["pca"][i]
    assert rec["topology"] == theirs["topology"] == topo
    assert rec["mesh"]["shape"] == theirs["mesh"]["shape"]
    assert rec["predicted_collective_bits"] == theirs["predicted_collective_bits"]
    m = 4 if topo == "hier" else 2  # pod x data, or the data axis alone
    mem = None
    if drop:
        from repro_torch.comm import Membership

        mem = Membership.from_dead(m, [int(drop)])
    cost = comm_cost(topo, m=m, d=PCFG.d, r=PCFG.r, n_iter=PCFG.n_iter, membership=mem,
                     pods=2 if topo == "hier" else None)
    assert rec["collective_bytes_per_device"] * 8 == cost.bits == \
        theirs["predicted_collective_bits"]
    assert rec["m_active"] == theirs["m_active"]


def test_stream_query_moves_no_bytes():
    rec = D.dryrun_paper_pca(device_count=N, verbose=False, topology="psum", stream_steps=4)
    cost = comm_cost("psum", m=2, d=PCFG.d, r=PCFG.r, n_iter=PCFG.n_iter,
                     ref_broadcast=False)
    assert rec["collective_bytes_per_device"] * 8 == cost.bits
    assert rec["query_collective_bytes_per_device"] == 0
    assert not dist.is_initialized()


def test_hlo_only_outputs_are_refused_by_name(port):
    rec = port["cells"]["train_4k"]
    assert set(rec["refused"]) == {"generated_code_size_bytes", "lower_s", "compile_s"}
    assert not any(k in rec for k in rec["refused"])


@pytest.mark.parametrize("arch, kw, word", [
    ("llama3.2-3b", dict(accounting="extrapolate"), "extrapolate"),
    ("llama3.2-3b", dict(accounting="scan-only"), "scan-only"),
    ("mamba2-370m", dict(eigen=True), "mamba2-370m"),
])
def test_refusals_name_what_they_refuse(arch, kw, word):
    """The accounting modes are refused by name; mamba2-370m's ``--eigen``
    cell, refused until the SSM family's sharded forward, counts (cut to
    one layer)."""
    if word in D.ACCOUNTING_REFUSED:
        with pytest.raises(D.RefusedCell, match=word):
            D.dryrun_cell(arch, "train_4k", device_count=N, verbose=False, **kw)
    else:
        rec = D.dryrun_cell(arch, "train_4k", device_count=N, verbose=False,
                            overrides={"num_layers": 1}, **kw)
        assert rec["arch"] == word and rec["eigen"] and rec["model_flops_global"] > 0
        assert rec["data_axis_bytes"] == sum(rec["data_axis_handed"].values()) > 0
    assert not dist.is_initialized()


def test_cli_exits_2_on_refusals(tmp_path):
    """``--accounting extrapolate`` exits 2 naming it; the two mamba2-370m
    commands that exited 2 before the SSM family's sharded forward now
    exit 0 with their record written (cut to one layer)."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = []
    for extra, word in ((["--arch", "mamba2-370m"], None),
                        (["--arch", "mamba2-370m", "--eigen"], None),
                        (["--arch", "llama3.2-3b", "--accounting", "extrapolate"],
                         "extrapolate")):
        out = tmp_path / str(len(extra))
        if word is None:
            extra = [*extra, "--set", "num_layers=1"]
        proc = subprocess.Popen(  # the three commands side by side
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--shape", "train_4k",
             "--device-count", "8", "--out", str(out), *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        runs.append((extra, word, out, proc))
    for extra, word, out, proc in runs:
        stdout, stderr = proc.communicate(timeout=120)
        if word is not None:
            assert proc.returncode == 2 and word in stderr, (extra, stderr)
            continue
        assert proc.returncode == 0 and "failures=0 refused=0" in stdout, (extra, stderr[-3000:])
        [rec] = [json.loads(f.read_text()) for f in out.glob("*.json")]
        assert rec["arch"] == "mamba2-370m" and rec["model_flops_global"] > 0, rec
        assert rec["eigen"] == ("--eigen" in extra)


def _local_f32_elems(cfg, mesh) -> int:
    """Elements of this device's blocks of the parameters a bf16 config's
    port keeps in f32 (``models/layers.py``), on ``mesh`` ({axis: size})."""
    specs = param_specs(cfg, mesh)
    leaves = reference_leaves(cfg)
    model = model_class(cfg)(cfg, device="meta")
    n = 0
    for name, p in model.named_parameters():
        if p.dtype != torch.float32:
            continue
        local = list(p.shape)
        for i, entry in enumerate(specs[name]):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                local[port_dims(leaves[name])[i]] //= math.prod(mesh[a] for a in axes)
        n += math.prod(local)
    return n


@pytest.mark.parametrize("cell", [c for c in FAMILY_CELLS],
                         ids=[_family_key(*c[:3]) for c in FAMILY_CELLS])
def test_family_cells_equal_the_references(ref, port, cell):
    arch, shape, eigen, cut = cell
    key = _family_key(arch, shape, eigen)
    rec, theirs = port["families"][key], ref["families"][key]
    assert "skipped" not in rec and rec["mesh"]["shape"] == [2, 4], rec.get("mesh")
    assert rec["model_flops_global"] == theirs["model_flops_global"]
    args = theirs["memory_analysis"]["argument_size_bytes"]
    mem = rec["memory"]
    step_or_pos = 4  # the reference's int32 step counter, or decode position
    cfg = dataclasses.replace(get_config(arch), **cut)
    if shape.startswith("train") and not eigen:
        assert mem["opt_state_bytes"] == 2 * mem["param_bytes"]
        assert mem["argument_bytes"] + step_or_pos == args
    elif eigen:
        comp = compressed_paths(cfg, EigenCompressConfig())
        flags = len({reference_leaves(cfg)[n].path for n in comp})
        assert mem["argument_bytes"] + step_or_pos + flags == args
    else:
        # jax.jit prunes an unused argument: the position reaches no block
        # of an attention-free model.
        if not any(kind in ("attn", "local_attn") for kind in cfg.block_pattern):
            step_or_pos = 0
        f32 = _local_f32_elems(cfg, {"data": 2, "model": 4})
        assert mem["argument_bytes"] + step_or_pos - 2 * f32 == args


def test_no_process_group_outlives_a_failing_dry_run():
    with pytest.raises(ValueError):
        D.dryrun_paper_pca(device_count=N, verbose=False, topology="hier")  # no pod axis
    assert not dist.is_initialized()

"""Port parity of the spectral-init path (``repro_torch.optim``), the rest
of the synthetic data (``repro_torch.data.synthetic``), the graph data
(``repro_torch.data.graphs``) and the examples (``repro_torch.examples``).

* ``truncated_second_moment`` (D_N) against the reference's on the same
  numpy measurements; the samplers (``make_dk_atoms``, ``sample_dk``,
  ``quadratic_sensing_measurements``) at the level of distributions,
  beside the reference's draws (torch and ``jax.random`` give different
  numbers from one seed).
* ``distributed_spectral_init``: the stacked form (``shards=8``) against
  the reference's on 8 fake CPU devices, the same numpy measurements:
  <= 1e-4 f64 subspace distance (an f32 eigensolve of each D_N, amplified
  by 1/gap), through the torch backend, the fused cell on CPU tensors
  and the planner; the collective form on 4 gloo ranks (psum, gather,
  ring) against the reference on 4 fake devices and against the stacked
  form.
* ``data.graphs``: the numpy copy equals the reference's bit for bit.
* Each example runs as ``python -m repro_torch.examples.<name> --device
  cpu`` in a subprocess; node embeddings prints the reference example's
  numbers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO, SRC, run_with_devices
from repro.data import graphs as jgraphs
from repro.data import synthetic as jsyn
from repro_torch.core.metrics import subspace_dist64
from repro_torch.data import graphs as tgraphs
from repro_torch.data import synthetic as tsyn
from repro_torch.optim import distributed_spectral_init

D, R, NPER, N_ITER = 40, 3, 2000, 10
TOL = 1e-4


def _measurements(m: int, seed: int = 3):
    """(m NPER, D) Gaussian designs and y = ||X#^T a||^2 for an orthonormal X#."""
    rng = np.random.default_rng(seed)
    x = np.linalg.qr(rng.standard_normal((D, R)))[0].astype(np.float32)
    a = rng.standard_normal((m * NPER, D)).astype(np.float32)
    y = ((a @ x) ** 2).sum(1).astype(np.float32)
    return x, a, y


# ---------------------------------------------------------------------------
# Samplers and D_N
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tau", [None, 2.0])
def test_truncated_second_moment_matches_reference(tau):
    _, a, y = _measurements(1)
    want = np.asarray(jsyn.truncated_second_moment(jnp.asarray(a), jnp.asarray(y), tau=tau))
    got = tsyn.truncated_second_moment(torch.from_numpy(a), torch.from_numpy(y), tau=tau)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_quadratic_sensing_measurements_distribution():
    """y_i = ||X#^T a_i||^2 exactly; a ~ N(0, I): E y = r, Var y = 2r for
    orthonormal X#, as the reference's draws show; noise adds its
    variance."""
    import jax

    gen = torch.Generator().manual_seed(0)
    x = torch.linalg.qr(torch.randn((D, R), generator=gen))[0]
    n = 40000
    a, y = tsyn.quadratic_sensing_measurements(x, n, generator=gen)
    assert a.shape == (n, D) and y.shape == (n,)
    torch.testing.assert_close(y, ((a @ x) ** 2).sum(1))
    assert abs(float(a.mean())) < 0.01 and abs(float(a.var()) - 1) < 0.02
    ja, jy = jsyn.quadratic_sensing_measurements(jax.random.PRNGKey(0), jnp.asarray(x.numpy()), n)
    for got, want in ((float(y.mean()), float(jnp.mean(jy))), (float(y.var()), float(jnp.var(jy)))):
        assert abs(got - want) < 0.1 * want
    assert abs(float(y.mean()) - R) < 0.1 and abs(float(y.var()) - 2 * R) < 0.4
    _, yn = tsyn.quadratic_sensing_measurements(x, n, noise=0.5, generator=gen)
    assert abs(float(yn.var()) - (2 * R + 0.25)) < 0.4


def test_dk_atoms_and_samples_distribution():
    """Atoms on sqrt(d) S^{d-1} (their second moment ~ I, as the
    reference's); samples are atoms, drawn uniformly."""
    import jax

    d, k, n = 16, 12, 24000
    gen = torch.Generator().manual_seed(1)
    atoms = tsyn.make_dk_atoms(d, k, generator=gen, device="cpu")
    assert atoms.shape == (k, d)
    torch.testing.assert_close(torch.linalg.norm(atoms, dim=1), torch.full((k,), d ** 0.5))
    many = tsyn.make_dk_atoms(d, 20000, generator=gen, device="cpu")
    jmany = np.asarray(jsyn.make_dk_atoms(jax.random.PRNGKey(1), d, 20000))
    for m2 in (many.T @ many / 20000, torch.from_numpy(jmany.T @ jmany / 20000)):
        assert float((m2 - torch.eye(d)).abs().max()) < 0.1
    x = tsyn.sample_dk(atoms, n, generator=gen)
    match = (x[:, None, :] == atoms[None]).all(-1)
    assert bool((match.sum(1) == 1).all())
    freq = match.sum(0).double()
    chi2 = float(((freq - n / k) ** 2 / (n / k)).sum())
    assert chi2 < 40  # k - 1 = 11 degrees of freedom: p < 1e-4 beyond 40


# ---------------------------------------------------------------------------
# Spectral init
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("spectral") / "qs.npz"
    x, a, y = _measurements(8)
    np.savez(path, x=x, a=a, y=y)
    return path


@pytest.fixture(scope="module")
def reference(data_path):
    """The reference's spectral init on 8 and on 4 fake CPU devices."""
    out = run_with_devices(f"""
        import json
        import numpy as np, jax.numpy as jnp
        from repro.compat import make_mesh
        from repro.optim.spectral_init import distributed_spectral_init

        f = np.load({str(data_path)!r})
        res = {{}}
        for m in (8, 4):
            mesh = make_mesh((m,), ("data",))
            n = m * {NPER}
            x0 = distributed_spectral_init(jnp.asarray(f["a"][:n]), jnp.asarray(f["y"][:n]),
                                           {R}, mesh, n_iter={N_ITER})
            res[m] = np.asarray(x0).tolist()
        print("RESULT", json.dumps(res))
        """, n_devices=8)
    return {int(k): np.asarray(v) for k, v in json.loads(out.split("RESULT ", 1)[1]).items()}


@pytest.mark.parametrize("knobs", [
    {},
    {"backend": "cuda", "polar": "newton-schulz", "orth": "cholesky-qr2"},
    {"plan": "auto"},
], ids=["plain", "fused", "planned"])
def test_stacked_spectral_init_matches_reference(data_path, reference, knobs):
    f = np.load(data_path)
    x0 = distributed_spectral_init(torch.from_numpy(f["a"]), torch.from_numpy(f["y"]), R,
                                   shards=8, device="cpu", n_iter=N_ITER, **knobs)
    assert x0.shape == (D, R) and torch.isfinite(x0).all()
    assert subspace_dist64(x0, reference[8]) <= TOL
    # The estimate recovers X#: well inside the paper's initialization bar.
    assert subspace_dist64(x0, f["x"]) < 0.5


def test_spectral_init_guards():
    a, y = torch.zeros((10, 4)), torch.zeros((10,))
    with pytest.raises(ValueError, match="shards="):
        distributed_spectral_init(a, y, 2, device="cpu")
    with pytest.raises(ValueError, match="equal shards"):
        distributed_spectral_init(a, y, 2, shards=3, device="cpu")
    with pytest.raises(ValueError, match="stacked one-process form"):
        distributed_spectral_init(a, y, 2, shards=2, device="cpu", topology="psum")


WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, out_path, data_path, nper, r, n_iter = sys.argv[1:9]
rank, world, nper, r, n_iter = int(rank), int(world), int(nper), int(r), int(n_iter)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
from repro_torch.optim import distributed_spectral_init

f = np.load(data_path)
lo, hi = rank * nper, (rank + 1) * nper
a, y = torch.from_numpy(f["a"][lo:hi]), torch.from_numpy(f["y"][lo:hi])
res = {}
for topo in ("psum", "gather", "ring"):
    res[topo] = distributed_spectral_init(a, y, r, group=dist.group.WORLD, device="cpu",
                                          n_iter=n_iter, topology=topo).tolist()
dist.destroy_process_group()
with open(out_path, "w") as fh:
    json.dump(res, fh)
"""


def test_collective_spectral_init_matches_reference_and_stacked(tmp_path, data_path,
                                                                reference):
    world = 4
    (tmp_path / "worker.py").write_text(WORKER)
    init = f"file://{tmp_path / 'rendezvous'}"
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(k), str(world), init,
         str(tmp_path / f"rank{k}.json"), str(data_path), str(NPER), str(R), str(N_ITER)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    f = np.load(data_path)
    n = world * NPER
    stacked = distributed_spectral_init(torch.from_numpy(f["a"][:n]), torch.from_numpy(f["y"][:n]),
                                        R, shards=world, device="cpu", n_iter=N_ITER)
    for k in range(world):
        res = json.loads((tmp_path / f"rank{k}.json").read_text())
        for topo, got in res.items():
            assert subspace_dist64(got, reference[world]) <= TOL, (k, topo)
            assert subspace_dist64(got, stacked) <= TOL, (k, topo)


# ---------------------------------------------------------------------------
# Graphs and examples
# ---------------------------------------------------------------------------


def test_graphs_copy_matches_reference_bitwise():
    for seed in (0, 1):
        a1, l1 = tgraphs.sbm_graph(np.random.default_rng(seed), n_nodes=90, n_blocks=4)
        a2, l2 = jgraphs.sbm_graph(np.random.default_rng(seed), n_nodes=90, n_blocks=4)
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(l1, l2)
        c1 = tgraphs.censor_graph(np.random.default_rng(seed + 5), a1, 0.2)
        c2 = jgraphs.censor_graph(np.random.default_rng(seed + 5), a2, 0.2)
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(tgraphs.hope_embedding(c1, 8),
                                      jgraphs.hope_embedding(c2, 8))


def _example(*args, env_extra=None):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "2", **(env_extra or {})}
    proc = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _floats(line: str) -> list[float]:
    return [float(t.split("=")[-1].rstrip("%")) for t in line.split()
            if "=" in t and t.split("=")[-1].rstrip("%").replace(".", "", 1).isdigit()]


def test_example_quickstart():
    out = _example("-m", "repro_torch.examples.quickstart", "--device", "cpu",
                   env_extra={"REPRO_QUICKSTART_SCALE": "tiny"})
    dist = {line.split("=")[0].split("(")[1].split(",")[0].strip(): float(line.split("=")[1].split()[0])
            for line in out.splitlines() if line.startswith("dist(")}
    assert set(dist) == {"central", "Alg 1", "Alg 2", "naive"}
    assert dist["Alg 1"] < dist["naive"] and abs(dist["Alg 2"] - dist["central"]) < 0.2


def test_example_node_embeddings_prints_the_reference_numbers():
    got = _example("-m", "repro_torch.examples.node_embeddings", "--device", "cpu")
    want = _example(os.path.join("examples", "node_embeddings.py"))
    got_lines, want_lines = got.strip().splitlines(), want.strip().splitlines()
    assert got_lines[0] == want_lines[0]
    assert len(got_lines) == len(want_lines) == 4
    for g, w in zip(got_lines[1:3], want_lines[1:3]):
        assert len(_floats(g)) in (2, 3)
        np.testing.assert_allclose(_floats(g), _floats(w), atol=2e-3)
    loss = [float(line.rsplit(" ", 1)[1].rstrip("%")) for line in (got_lines[3], want_lines[3])]
    assert abs(loss[0] - loss[1]) < 0.5


def test_example_quadratic_sensing():
    out = _example("-m", "repro_torch.examples.quadratic_sensing", "--device", "cpu")
    errs = [float(line.rsplit("=", 1)[1]) for line in out.splitlines() if "||(I-P)X0||_2" in line]
    assert len(errs) == 4 and all(0 <= e <= 1 + 1e-6 for e in errs)
    assert errs[-1] < errs[0]

"""Port parity of the estimators and the stacked distributed-PCA path.

* The (polar x orth) cube on the ragged, padded and near-deficient stacks
  of ``tests/test_backend_invariance.py``, through the torch backend and
  the cuda backend (whose kernel wrappers run their plain versions on CPU
  tensors), against the reference's ``backend="xla", polar="svd",
  orth="qr"`` cell: <= 1e-5 f64 subspace distance.
* ``distributed_pca(device="cpu", solver="eigh")`` against the reference's
  serial composition ``local_bases(vmap(empirical_covariance)(xs)) ->
  iterative_refinement``: <= 1e-4, since f32 covariance summation order
  passes through an eigensolve, amplified by 1/gap (gap 0.2).
* The fused (cuda, newton-schulz, cholesky-qr2) cell routes to the fused
  round (B5), not to the per-stage kernels.
* ``plan="auto"`` runs the planner's cell; the refusals: psum, ring and
  hier in the stacked one-process form (they run across ranks),
  ``device="cuda"`` with no card, and the streaming flags' misuses
  (``--stream`` that does not divide the shard, ``--cadence`` alone).  The launcher's planner and elastic
  flags (``--plan``, ``--explain``, ``--calibrate``, ``--fail-at``,
  ``--comm-bits auto`` and 8 in one process) run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO
from repro.core import eigenspace as jeig
from repro.core.covariance import empirical_covariance as j_empirical_covariance
from repro.data import synthetic as jsyn
from repro_torch.core import distributed as tdist
from repro_torch.core import eigenspace as teig
from repro_torch.core.metrics import subspace_dist64
from repro_torch.interop import from_reference
from repro_torch.launch import eigen as tlaunch

CUBE_TOL = 1e-5
E2E_TOL = 1e-4
CELLS = [
    (backend, polar, orth)
    for backend in ("torch", "cuda")
    for polar in ("svd", "newton-schulz")
    for orth in ("qr", "cholesky-qr2")
]
CLI_KEYS = [
    "m", "n", "d", "r", "backend", "polar", "orth", "topology", "pods", "ring_chunk",
    "comm_bits", "plan_source", "predicted_words", "predicted_bits",
    "dist_aligned", "dist_central", "dist_naive", "dist_local0", "wall_s",
]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _orthonormal_stack(seed, m, d, r):
    return np.linalg.qr(_normal(seed, m, d, r))[0].astype(np.float32)


def _weak_direction_stack(seed, m, d, r, eps=0.05):
    """r - 1 strong common directions plus one weak one (kappa(V̄) ~ 20):
    the CholeskyQR2 conditioning rule is live (test_backend_invariance)."""
    q = np.linalg.qr(_normal(seed, d, r))[0]
    noise = 0.01 * _normal(seed + 1, m, d, r)
    return ((q[None] + noise) * np.r_[np.ones(r - 1), eps]).astype(np.float32)


STACKS = {
    "ragged": lambda: _orthonormal_stack(42, 3, 205, 5),
    "padded": lambda: _orthonormal_stack(43, 2, 2100, 5),
    "near-deficient": lambda: _weak_direction_stack(44, 8, 160, 4),
}


def _tvs(vs):
    return from_reference({"vs": vs}, device="cpu")["vs"]


@pytest.mark.parametrize("stack", sorted(STACKS))
@pytest.mark.parametrize("backend,polar,orth", CELLS)
def test_polar_orth_cube_matches_reference(backend, polar, orth, stack):
    vs = STACKS[stack]()
    want = jeig.procrustes_fix_average(
        jnp.asarray(vs), backend="xla", polar="svd", orth="qr"
    )
    got = teig.procrustes_fix_average(_tvs(vs), backend=backend, polar=polar, orth=orth)
    assert got.shape == want.shape
    assert subspace_dist64(got, want) <= CUBE_TOL, (backend, polar, orth, stack)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("polar", ["svd", "newton-schulz"])
def test_iterative_refinement_matches_reference(backend, polar):
    vs = _orthonormal_stack(11, 4, 130, 4)
    want = jeig.iterative_refinement(jnp.asarray(vs), n_iter=3, backend="xla")
    got = teig.iterative_refinement(_tvs(vs), n_iter=3, backend=backend, polar=polar)
    assert subspace_dist64(got, want) <= CUBE_TOL


def test_baselines_match_reference():
    vs = _orthonormal_stack(12, 4, 60, 3)
    j, t = jnp.asarray(vs), _tvs(vs)
    assert subspace_dist64(teig.naive_average(t), jeig.naive_average(j)) <= CUBE_TOL
    assert subspace_dist64(
        teig.naive_average(t, orth="cholesky-qr2"), jeig.naive_average(j)
    ) <= CUBE_TOL
    assert subspace_dist64(
        teig.projector_average(t, 3), jeig.projector_average(j, 3)
    ) <= CUBE_TOL


def _spiked_samples(seed, m, n, d, r, delta=0.2):
    """(m * n, d) Gaussian samples of an (M1) covariance, made in numpy."""
    tau = np.asarray(jsyn.spectrum_m1(d, r, delta=delta), np.float64)
    u = np.linalg.qr(np.random.default_rng(seed).standard_normal((d, d)))[0]
    z = np.random.default_rng(seed + 1).standard_normal((m * n, d))
    return (z @ (u * np.sqrt(tau)).T).astype(np.float32), u[:, :r]


def test_local_bases_and_central_estimate_match_reference():
    x, _ = _spiked_samples(1, 3, 400, 40, 4)
    xs = x.reshape(3, 400, 40)
    covs = jax.vmap(j_empirical_covariance)(jnp.asarray(xs))
    tcovs = from_reference({"c": np.asarray(covs)}, device="cpu")["c"]
    got, want = teig.local_bases(tcovs, 4), jeig.local_bases(covs, 4)
    for i in range(3):
        assert subspace_dist64(got[i], want[i]) <= CUBE_TOL
    assert subspace_dist64(
        teig.central_estimate(tcovs, 4)[0], jeig.central_estimate(covs, 4)[0]
    ) <= CUBE_TOL


@pytest.mark.parametrize("backend", ["torch", "cuda", "auto"])
@pytest.mark.parametrize("polar", ["svd", "newton-schulz"])
def test_distributed_pca_matches_reference_serial(backend, polar):
    m, n, d, r = 4, 512, 64, 4
    x, v_true = _spiked_samples(7, m, n, d, r)
    covs = jax.vmap(j_empirical_covariance)(jnp.asarray(x.reshape(m, n, d)))
    want = jeig.iterative_refinement(
        jeig.local_bases(covs, r), n_iter=2, backend="xla", polar=polar
    )
    got = tdist.distributed_pca(
        torch.from_numpy(x), r, shards=m, device="cpu", n_iter=2,
        solver="eigh", backend=backend, polar=polar, topology="gather",
    )
    assert got.shape == (d, r) and bool(torch.isfinite(got).all())
    assert subspace_dist64(got, want) <= E2E_TOL
    assert subspace_dist64(got, v_true) < 0.5  # it estimates the spike


def test_distributed_pca_subspace_solver_tracks_eigh():
    """Subspace iteration (torch start block, not jax's) converges to the
    same local bases, so the estimate matches the eigh path."""
    x, _ = _spiked_samples(8, 2, 600, 48, 3)
    kw = dict(shards=2, device="cpu", n_iter=2, backend="cuda")
    a = tdist.distributed_pca(torch.from_numpy(x), 3, solver="eigh", **kw)
    b = tdist.distributed_pca(torch.from_numpy(x), 3, solver="subspace", iters=60, **kw)
    assert subspace_dist64(a, b) <= E2E_TOL


# ------------------------------------------------------------ refusals ----
def test_fused_cell_is_refused_not_rerouted(monkeypatch):
    """The (cuda, newton-schulz, cholesky-qr2) cell goes to the fused
    round (one call for all rounds) and never to the per-stage kernels.
    (Named when the port refused this cell; it now checks the routing.)"""
    from repro_torch.kernels import ops as tops

    vs = _tvs(_orthonormal_stack(0, 2, 16, 2))
    calls = []
    fused = tops.fused_round
    monkeypatch.setattr(tops, "fused_round",
                        lambda *a, **k: calls.append(k) or fused(*a, **k))
    for stage in ("batched_gram", "batched_gram_polar", "align_average"):
        monkeypatch.setattr(tops, stage, lambda *a, **k: pytest.fail("per-stage"))
    got = teig.refinement_rounds(vs, backend="cuda", polar="newton-schulz",
                                 orth="cholesky-qr2", n_iter=2)
    assert calls == [{"n_iter": 2, "use_kernel": True}]
    # The same cell on the plain backend is an ordinary cube cell.
    want = teig.refinement_rounds(vs, backend="torch", polar="newton-schulz",
                                  orth="cholesky-qr2", n_iter=2)
    assert subspace_dist64(got, want) <= CUBE_TOL


def test_plan_auto_is_refused():
    """plan="auto" runs the planner's cell (on the CPU model: the plain
    backend's svd/qr, the reference's pick) and equals that cell's legacy
    run; an unknown plan is still refused."""
    vs = _tvs(_orthonormal_stack(0, 2, 16, 2))
    got = teig.procrustes_fix_average(vs, plan="auto")
    want = jeig.procrustes_fix_average(_orthonormal_stack(0, 2, 16, 2), plan="auto")
    assert torch.equal(got, teig.procrustes_fix_average(vs, backend="torch", polar="svd",
                                                        orth="qr"))
    assert subspace_dist64(got, np.asarray(want)) <= CUBE_TOL
    with pytest.raises(ValueError):
        teig.iterative_refinement(vs, plan="fast")


@pytest.mark.parametrize("topology", ["psum", "ring", "hier"])
def test_cross_rank_topologies_are_refused(topology):
    """The stacked one-process form has only the gather schedule: psum,
    ring and hier name the collective form."""
    x = torch.from_numpy(_normal(1, 64, 8))
    with pytest.raises(ValueError, match="distributed_pca_collective"):
        tdist.distributed_pca(x, 2, shards=2, device="cpu", topology=topology)


def test_distributed_pca_argument_checks(monkeypatch):
    x = torch.from_numpy(_normal(1, 63, 8))
    with pytest.raises(ValueError):
        tdist.distributed_pca(x, 2, shards=2, device="cpu")
    with pytest.raises(ValueError):
        tdist.distributed_pca(x[:62], 2, shards=2, device="cpu", topology="mesh")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.distributed_pca(x[:62], 2, shards=2)  # default device: the card


# ------------------------------------------------------------ launcher ----
def test_launcher_run_reports_reference_keys():
    v, stats = tlaunch.run(64, 4, 512, shards=4, device="cpu", backend="auto",
                           polar="newton-schulz")
    assert list(stats) == CLI_KEYS
    assert stats["backend"] == "torch" and stats["topology"] == "gather"
    assert v.shape == (64, 4)
    assert stats["dist_aligned"] < stats["dist_naive"]
    assert abs(stats["dist_aligned"] - stats["dist_central"]) < 0.2


def test_launcher_main_prints_keys(capsys):
    tlaunch.main(["--device", "cpu", "--d", "48", "--r", "3",
                  "--n-per-shard", "256", "--shards", "3", "--backend", "cuda"])
    out = capsys.readouterr().out
    keys = [line.split(": ", 1)[0] for line in out.strip().splitlines()]
    assert keys == CLI_KEYS
    assert "backend: cuda" in out


@pytest.mark.parametrize("argv,says", [
    (["--stream", "3"], "must divide --n-per-shard 1024"),
    (["--cadence", "2"], "--cadence goes with --stream"),
])
def test_launcher_refuses_later_flags(argv, says, capsys):
    """The streaming flags run (their lane's tests are in
    tests/test_torch_stream.py); what stays refused: a step count that
    does not divide the shard, and a cadence without a stream."""
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    assert says in capsys.readouterr().err


def test_launcher_width_flags_pass_through_torchrun():
    """torchrun's parser abbreviates its own options ("--d" and "--r" are
    prefixes of some), so every launcher flag but those two must be a
    prefix of none of them, and ``--dim``/``--subspace-rank`` reach the
    launcher as d and r."""
    from torch.distributed.run import get_args_parser

    outer = get_args_parser()
    theirs = [o for a in outer._actions for o in a.option_strings if o.startswith("--")]
    ours = [o for a in tlaunch.build_parser()._actions for o in a.option_strings
            if o.startswith("--") and o not in ("--d", "--r", "--help")]
    assert any(o.startswith("--d") for o in theirs)
    assert any(o.startswith("--r") for o in theirs)
    assert [o for o in ours if any(t.startswith(o) for t in theirs)] == []
    tail = ["--device", "cpu", "--topology", "ring", "--dim", "512",
            "--subspace-rank", "16", "--n-per-shard", "64"]
    got = outer.parse_args(["--standalone", "--nproc-per-node", "2", "-m",
                            "repro_torch.launch.eigen", *tail])
    assert got.training_script_args == tail
    args = tlaunch.build_parser().parse_args(got.training_script_args)
    assert (args.d, args.r, args.n_per_shard) == (512, 16, 64)
    assert tlaunch.build_parser().parse_args(["--d", "512", "--r", "16"]).r == 16


@pytest.mark.parametrize("argv,says", [
    (["--topology", "ring"], "torchrun"),
    (["--topology", "psum"], "torchrun"),
    (["--topology", "hier", "--pods", "2"], "torchrun"),
    (["--topology", "hier"], "go together"),
    (["--pods", "2"], "go together"),
])
def test_launcher_refuses_what_one_process_cannot_run(argv, says, capsys):
    """Outside torchrun the launcher stacks the shards in one process:
    the cross-rank schedules need ranks; --topology hier and --pods go
    together."""
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    assert says in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--plan", "auto"],
    ["--explain"],
    ["--calibrate", os.path.join(REPO, "BENCH_aggregate.json"), "--plan", "auto"],
    ["--fail-at", "2:1"],
    ["--comm-bits", "auto"],
    ["--comm-bits", "8"],
], ids=lambda a: " ".join(a).replace(REPO + os.sep, ""))
def test_launcher_runs_planner_and_elastic_flags(argv, capsys):
    """The flags the planner and the elastic runtime brought run in one
    process: the stacked form plans in the stacked context, --explain
    prints the table first, --fail-at reports the re-plan, and a lossy
    wire passes each basis through the gather wire's codec."""
    tlaunch.main(["--device", "cpu", "--d", "48", "--r", "3", "--n-per-shard", "256",
                  "--shards", "4", "--solver", "eigh", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    stats = dict(line.split(": ", 1) for line in lines if ": " in line
                 and line.split(": ", 1)[0] in CLI_KEYS + ["replans", "final_m_active", "events"])
    assert list(stats)[:len(CLI_KEYS)] == CLI_KEYS
    assert stats["topology"] == "gather" and float(stats["dist_aligned"]) < 0.5
    if "--plan" in argv:
        assert stats["plan_source"] == "planner" and stats["backend"] == "torch"
    if "--explain" in argv:
        assert lines[0].startswith("# plan[legacy]: m=4 d=48 r=3 n_iter=2 device=cpu")
        assert any(line.startswith("chosen: torch/gather/svd/qr ") for line in lines)
    if "--fail-at" in argv:
        assert (stats["replans"], stats["final_m_active"]) == ("1", "3")
        assert "round 1: failure (m'=3, dead=[2]" in stats["events"]
    if "--comm-bits" in argv:
        assert stats["comm_bits"] == ("32" if "auto" in argv else "8")

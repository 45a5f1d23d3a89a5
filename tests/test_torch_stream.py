"""Port parity of the streaming service (``repro_torch.stream``), stacked
form, against the reference (``repro.stream``) on the same numpy inputs.

* Accumulator: chunked equals one shot (f32 within 1e-6 of the
  reference's ``empirical_covariance``; f64 on integer-valued rows bit for
  bit, against the port's own one-shot covariance and against the
  reference's f64 one, run with x64 in a subprocess), under the "torch"
  backend and under "cuda" on CPU tensors (B1's plain version); merge
  equals concatenation; the centered covariance; the guards; the
  exactness laws of ``tests/test_stream_properties.py`` as hypothesis
  tests on the port; and a reference ``Accumulator``'s state carried
  across with ``interop.from_reference``, which then continues exactly as
  the reference does.
* ``SubspaceService(shards=8)`` against the reference's service on 8
  fake devices (topology gather, the stacked form's schedule), through
  shard 2's death before step 4, across the (polar x orth) cube with the
  port's "torch" backend and "cuda" on CPU tensors, plus an 8-bit wire:
  every refresh's basis within 1e-5 f64 subspace distance
  (``PARITY_TOL[8]`` on the 8-bit wire), equal ``step``, ``rows_seen``,
  ``refreshes``, ``staleness``, ``m_active``, ``replans`` and ``events``,
  drift within 1e-5.
* Triggers and queries: refresh continuity (a same-state re-refresh
  moves the basis by <= ``PARITY_TOL[32]``; stationary jumps stay under
  0.5 and shrink), the drift positive control, the drift trigger, the
  stats and guards, and the query path making zero ``torch.distributed``
  calls.
* ``launch.eigen --stream/--cadence`` in one process (with and without
  ``--fail-at``) against the reference launcher's stream keys.

The collective form and the launchers under ``torchrun`` are in
``tests/test_torch_stream_ranks.py``.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import run_with_devices
from repro.core.covariance import empirical_covariance as j_empirical_covariance
from repro.stream import Accumulator as JAccumulator
from repro_torch.comm import PARITY_TOL, Membership
from repro_torch.core.covariance import empirical_covariance
from repro_torch.core.metrics import subspace_dist64
from repro_torch.interop import from_reference
from repro_torch.launch import eigen as tlaunch
from repro_torch.stream import (
    Accumulator,
    SubspaceService,
    basis_jump,
    init_state,
    merge,
    to_cov,
    update,
)

BACKENDS = ("torch", "cuda")
M, D, R, STEPS, NPER, CADENCE, N_ITER = 8, 48, 3, 8, 256, 2, 2
KILL_STEP, KILL_SHARD = 4, 2
CUBE = [("svd", "qr"), ("svd", "cholesky-qr2"), ("newton-schulz", "qr"),
        ("newton-schulz", "cholesky-qr2")]
STAT_KEYS = ("step", "rows_seen", "refreshes", "staleness", "m_active", "replans",
             "events")


def _int_rows(seed: int, n: int, d: int, dtype=np.float64) -> np.ndarray:
    """Integer-valued rows: every Gram partial sum is an exact integer."""
    return np.random.default_rng(seed).integers(-8, 9, size=(n, d)).astype(dtype)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# Accumulator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k", [1, 3, 7])
def test_chunked_equals_oneshot_f32(backend, k):
    """f32 chunking only reorders additions: <= 1e-6 of the reference's
    one-shot covariance."""
    x = np.random.default_rng(1).standard_normal((513, 32)).astype(np.float32)
    want = np.asarray(j_empirical_covariance(jnp.asarray(x)))
    acc = Accumulator(32, device="cpu", backend=backend)
    for c in np.array_split(x, k):
        acc.update(_t(c))
    assert acc.dtype == torch.float32
    np.testing.assert_allclose(acc.to_cov().numpy(), want, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_chunked_equals_oneshot_bitwise_f64(backend):
    """k-chunked f64 accumulation of integer rows equals the one-shot
    covariance bit for bit (an f64 state stays on the plain path)."""
    x = _int_rows(0, 257, 24)
    want = empirical_covariance(_t(x)).numpy()
    assert want.dtype == np.float64
    for k in (1, 2, 5, 8):
        acc = Accumulator(24, dtype=torch.float64, device="cpu", backend=backend)
        for c in np.array_split(x, k):
            acc.update(_t(c))
        got = acc.to_cov().numpy()
        assert got.dtype == np.float64
        assert np.array_equal(got.view(np.uint64), want.view(np.uint64)), k


def test_chunked_f64_matches_reference_f64_bitwise():
    """The reference's f64 one-shot covariance (x64 on, in a subprocess)
    and the port's chunked f64 accumulation agree bit for bit."""
    x = _int_rows(0, 257, 24)
    out = run_with_devices(f"""
        import jax
        jax.config.update("jax_enable_x64", True)
        import json, numpy as np, jax.numpy as jnp
        from repro.core.covariance import empirical_covariance
        x = np.random.default_rng(0).integers(-8, 9, size=(257, 24)).astype(np.float64)
        c = np.asarray(empirical_covariance(jnp.asarray(x)))
        assert c.dtype == np.float64
        print("RESULT", json.dumps(c.view(np.uint64).tolist()))
        """, n_devices=1)
    want = np.asarray(json.loads(out.split("RESULT ", 1)[1]), np.uint64)
    acc = Accumulator(24, dtype=torch.float64, device="cpu")
    for c in np.array_split(x, 5):
        acc.update(_t(c))
    assert np.array_equal(acc.to_cov().numpy().view(np.uint64), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_merge_equals_concat(backend):
    x = _int_rows(2, 96, 16, np.float32)
    a = Accumulator(16, device="cpu", backend=backend).update(_t(x[:40]))
    b = Accumulator(16, device="cpu", backend=backend).update(_t(x[40:]))
    both = Accumulator(16, device="cpu", backend=backend).update(_t(x))
    a.merge(b)
    assert int(a.count) == 96 and int(b.count) == 56
    assert torch.equal(a.to_cov(), both.to_cov())


def test_centered_covariance_matches_numpy_and_reference():
    x = np.random.default_rng(3).standard_normal((400, 12)).astype(np.float32) + 2.5
    acc = Accumulator(12, device="cpu").update(_t(x))
    want = (x.T @ x) / 400 - np.outer(x.mean(0), x.mean(0))
    got = acc.to_cov(center=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    ref = JAccumulator(d=12).update(jnp.asarray(x)).to_cov(center=True)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


def test_accumulator_guards():
    acc = Accumulator(8, device="cpu")
    with pytest.raises(ValueError, match="empty accumulator"):
        acc.to_cov()
    with pytest.raises(ValueError, match=r"\(n, 8\) chunk"):
        acc.update(torch.zeros((4, 9)))
    with pytest.raises(ValueError, match="different feature dims"):
        merge(init_state(8, device="cpu"), init_state(9, device="cpu"))
    with pytest.raises(ValueError, match="f32 or f64"):
        init_state(8, dtype=torch.bfloat16, device="cpu")


def test_functional_core_is_pure_and_empty_chunk_is_identity():
    """``update`` returns a new state and leaves its input untouched; an
    empty chunk changes nothing."""
    x = _t(_int_rows(4, 10, 6, np.float32))
    s0 = init_state(6, device="cpu")
    s1 = update(s0, x)
    assert int(s0["count"]) == 0 and not s0["gram"].any()
    s2 = update(s1, torch.zeros((0, 6)), backend="cuda")
    assert s2 is not s1 and all(torch.equal(s1[k], s2[k]) for k in s1)
    assert torch.equal(to_cov(s1), x.T @ x / 10)


@pytest.mark.parametrize("backend", BACKENDS)
def test_state_carried_from_reference_continues_identically(backend):
    """A reference ``Accumulator``'s state, carried across as numpy with
    ``interop.from_reference``, continues in the port exactly as in the
    reference (integer rows: every sum exact)."""
    x = _int_rows(5, 120, 10, np.float32)
    ref = JAccumulator(d=10)
    for c in np.array_split(x[:70], 3):
        ref.update(jnp.asarray(c))
    state = from_reference({k: np.asarray(v) for k, v in ref.state.items()},
                           device="cpu")
    port = Accumulator(10, device="cpu", backend=backend, state=state)
    for c in np.array_split(x[70:], 2):
        ref.update(jnp.asarray(c))
        port.update(_t(c))
    for k in ("count", "sum", "gram"):
        np.testing.assert_array_equal(port.state[k].numpy(), np.asarray(ref.state[k]))
    np.testing.assert_array_equal(port.to_cov().numpy(), np.asarray(ref.to_cov()))


# The exactness laws of tests/test_stream_properties.py, on the port.
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


@pytest.mark.parametrize("backend", BACKENDS)
@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**16), d=st.integers(1, 12),
       sizes=st.lists(st.integers(0, 24), min_size=3, max_size=3))
def test_merge_associative_exact(backend, seed, d, sizes):
    a, b, c = (update(init_state(d, device="cpu"),
                      _t(_int_rows(seed + i, n, d, np.float32)), backend=backend)
               for i, n in enumerate(sizes))
    left, right = merge(merge(a, b), c), merge(a, merge(b, c))
    for k in ("count", "sum", "gram"):
        assert torch.equal(left[k], right[k])


@pytest.mark.parametrize("backend", BACKENDS)
@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**16), k=st.integers(1, 6), perm_seed=st.integers(0, 2**16))
def test_chunk_order_invariance_exact(backend, seed, k, perm_seed):
    chunks = np.array_split(_int_rows(seed, 60, 10, np.float32), k)
    order = np.random.default_rng(perm_seed).permutation(len(chunks))
    s1, s2 = init_state(10, device="cpu"), init_state(10, device="cpu")
    for c in chunks:
        s1 = update(s1, _t(c), backend=backend)
    for i in order:
        s2 = update(s2, _t(chunks[i]), backend=backend)
    assert torch.equal(s1["gram"], s2["gram"]) and torch.equal(s1["count"], s2["count"])


@pytest.mark.parametrize("backend", BACKENDS)
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16), d=st.integers(1, 12))
def test_empty_and_single_row_edges(backend, seed, d):
    s = update(init_state(d, device="cpu"), torch.zeros((0, d)), backend=backend)
    assert int(s["count"]) == 0 and not s["gram"].any()
    row = _int_rows(seed, 1, d, np.float32)
    s = update(s, _t(row), backend=backend)
    s = update(s, torch.zeros((0, d)), backend=backend)
    np.testing.assert_array_equal(to_cov(s).numpy(), np.outer(row[0], row[0]))


@pytest.mark.parametrize("backend", BACKENDS)
@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(1, 32))
def test_bf16_payload_accumulates_at_f32(backend, seed, n):
    x = _int_rows(seed, n, 8, np.float32)  # |x| <= 8: exact in bf16
    s16 = update(init_state(8, device="cpu"), _t(x).to(torch.bfloat16), backend=backend)
    s32 = update(init_state(8, device="cpu"), _t(x), backend=backend)
    assert s16["gram"].dtype == torch.float32 and s16["sum"].dtype == torch.float32
    assert torch.equal(s16["gram"], s32["gram"])


# ---------------------------------------------------------------------------
# The stacked service against the reference's
# ---------------------------------------------------------------------------


def _stream_rows(seed=7) -> np.ndarray:
    """(STEPS, M, NPER, D) f32 Gaussian rows with a clear gap after the top R."""
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((D, D)))[0]
    spec = np.concatenate([np.linspace(4.0, 3.0, R), np.linspace(0.5, 0.1, D - R)])
    x = (rng.standard_normal((STEPS * M * NPER, D)) * np.sqrt(spec)) @ q.T
    return x.astype(np.float32).reshape(STEPS, M, NPER, D)


# (name, polar, orth, comm_bits); the port runs each under both backends.
SVC_CELLS = [(f"{p}/{o}", p, o, 32) for p, o in CUBE] + [("svd/qr/8", "svd", "qr", 8)]


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    path = tmp_path_factory.mktemp("stream") / "rows.npy"
    np.save(path, _stream_rows())
    return path


@pytest.fixture(scope="module")
def reference_service(rows):
    """The reference's service on 8 fake devices, topology gather, each
    cell: the basis at every refresh, the stats and the drift."""
    out = run_with_devices(f"""
        import json
        import numpy as np, jax.numpy as jnp
        from repro.comm import Membership
        from repro.launch.mesh import make_aggregation_mesh
        from repro.stream import SubspaceService

        rows = np.load({str(rows)!r})
        mesh = make_aggregation_mesh({M})
        res = {{}}
        for name, polar, orth, bits in {[list(c) for c in SVC_CELLS]!r}:
            svc = SubspaceService(mesh, {D}, {R}, n_iter={N_ITER}, cadence={CADENCE},
                                  solver="eigh", topology="gather", polar=polar,
                                  orth=orth, comm_bits=bits)
            bases = []
            for t in range({STEPS}):
                if t == {KILL_STEP}:
                    svc.set_membership(Membership.from_dead({M}, [{KILL_SHARD}]))
                    if svc.stats["refreshes"] > len(bases):
                        bases.append(np.asarray(svc.basis).tolist())
                svc.observe(jnp.asarray(rows[t]))
                if svc.stats["refreshes"] > len(bases):
                    bases.append(np.asarray(svc.basis).tolist())
            stats = {{k: svc.stats[k] for k in {list(STAT_KEYS)!r}}}
            res[name] = {{"bases": bases, "stats": stats, "drift": svc.drift()}}
        print("RESULT", json.dumps(res))
        """, n_devices=M)
    return json.loads(out.split("RESULT ", 1)[1])


def _drive(svc: SubspaceService, rows: np.ndarray):
    """Feed ``rows`` step by step with shard KILL_SHARD dying before step
    KILL_STEP; the basis after every refresh."""
    bases = []
    for t in range(STEPS):
        if t == KILL_STEP:
            svc.set_membership(Membership.from_dead(M, [KILL_SHARD]))
            if svc.stats["refreshes"] > len(bases):
                bases.append(svc.basis.clone())
        svc.observe(_t(rows[t]))
        if svc.stats["refreshes"] > len(bases):
            bases.append(svc.basis.clone())
    return bases


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("cell", SVC_CELLS, ids=lambda c: c[0])
def test_stacked_service_matches_reference(rows, reference_service, cell, backend):
    name, polar, orth, bits = cell
    svc = SubspaceService(D, R, shards=M, device="cpu", n_iter=N_ITER, cadence=CADENCE,
                          solver="eigh", backend=backend, polar=polar, orth=orth,
                          comm_bits=bits)
    bases = _drive(svc, np.load(rows))
    want = reference_service[name]
    assert len(bases) == len(want["bases"]) == want["stats"]["refreshes"]
    tol = max(1e-5, PARITY_TOL[bits])
    for k, (got, ref) in enumerate(zip(bases, want["bases"])):
        assert got.shape == (D, R) and torch.isfinite(got).all()
        assert subspace_dist64(got, np.asarray(ref)) <= tol, (name, backend, k)
    stats = svc.stats
    assert {k: stats[k] for k in STAT_KEYS} == want["stats"]
    assert stats["events"] == ["failure"] and stats["m_active"] == M - 1
    assert svc.plan.backend == backend and svc.plan.topology == "gather"
    if bits == 32:
        assert abs(svc.drift() - want["drift"]) <= 1e-5


# ---------------------------------------------------------------------------
# Triggers and queries
# ---------------------------------------------------------------------------


def _spiked(seed: int, n: int, d: int = 96, r: int = 4, rot=None) -> torch.Tensor:
    """n rows of the (M1) spiked covariance (eigengap 0.2) drawn from
    ``seed``; ``rot`` rotates the spectrum."""
    rng = np.random.default_rng(0)
    q = np.linalg.qr(rng.standard_normal((d, d)))[0]
    tau = np.concatenate([np.linspace(1.0, 0.5, r), 0.3 * 0.9 ** np.arange(d - r)])
    z = np.random.default_rng(seed).standard_normal((n, d))
    x = (z * np.sqrt(tau)) @ q.T
    if rot is not None:
        x = x @ rot.T
    return _t(x.astype(np.float32))


def _fed(d=96, r=4, steps=8, nper=512, **kw):
    rows = _spiked(1, steps * nper, d, r)
    svc = SubspaceService(d, r, shards=1, device="cpu", cadence=kw.pop("cadence", 1), **kw)
    jumps = []
    for t in range(steps):
        svc.observe(rows[t * nper:(t + 1) * nper][None])
        if svc.stats["last_jump"] is not None:
            jumps.append(svc.stats["last_jump"])
    return svc, jumps


def test_refresh_continuity_stationary():
    """A same-state re-refresh reproduces the basis element-wise to the
    exact wire's tolerance; stationary jumps stay far under a flip's 2 a
    column and shrink as rows accumulate."""
    svc, jumps = _fed()
    v0 = svc.basis
    svc.refresh()
    assert basis_jump(v0, svc.basis) <= PARITY_TOL[32]
    assert jumps and max(jumps) <= 0.5
    assert jumps[-1] < jumps[0]


def test_drift_metric_separates_stationary_from_shifted():
    svc, _ = _fed()
    assert svc.drift() <= 1e-4
    svc.cadence = 10**9  # freeze refreshes; watch the metric alone
    rot = np.linalg.qr(np.random.default_rng(7).standard_normal((96, 96)))[0]
    shifted = _spiked(8, 8 * 512, rot=rot)
    for t in range(8):
        svc.observe(shifted[t * 512:(t + 1) * 512][None])
    assert svc.drift() >= 0.05


def test_drift_threshold_triggers_refresh():
    d, r, nper = 64, 4, 512
    rows = _spiked(2, 4 * nper, d, r)
    svc = SubspaceService(d, r, shards=1, device="cpu", cadence=10**9,
                          drift_threshold=0.05)
    for t in range(4):
        svc.observe(rows[t * nper:(t + 1) * nper][None])
    base = svc.stats["refreshes"]
    rot = np.linalg.qr(np.random.default_rng(9).standard_normal((d, d)))[0]
    shifted = _spiked(10, 8 * nper, d, r, rot=rot)
    for t in range(8):
        svc.observe(shifted[t * nper:(t + 1) * nper][None])
    assert svc.stats["refreshes"] > base, "drift trigger never fired"
    assert svc.stats["events"] == [] and svc.stats["drift"] is not None


def test_service_stats_and_guards():
    svc = SubspaceService(32, 2, shards=1, device="cpu", cadence=4)
    with pytest.raises(RuntimeError, match="no basis served"):
        svc.project(torch.zeros((1, 32)))
    with pytest.raises(RuntimeError, match="no basis served"):
        svc.drift()
    with pytest.raises(ValueError, match="observe"):
        svc.refresh()
    with pytest.raises(ValueError, match="cadence"):
        SubspaceService(32, 2, shards=1, device="cpu", cadence=0)
    with pytest.raises(ValueError, match="shards="):
        SubspaceService(32, 2, device="cpu")
    with pytest.raises(ValueError, match="stacked one-process form"):
        SubspaceService(32, 2, shards=2, device="cpu", topology="ring")
    with pytest.raises(ValueError, match=r"per-shard chunks"):
        svc.observe(torch.zeros((2, 4, 32)))
    rows = _spiked(4, 6 * 64, 32, 2)
    for t in range(6):
        svc.observe(rows[t * 64:(t + 1) * 64][None])
    s = svc.stats
    assert s["step"] == 6 and s["rows_seen"] == 6 * 64
    # bootstrap at step 1, cadence refresh at step 5 -> staleness 1
    assert s["refreshes"] == 2 and s["staleness"] == 1
    assert set(s) == {"step", "rows_seen", "refreshes", "staleness", "cadence", "drift",
                      "drift_threshold", "last_jump", "m_active", "replans", "events",
                      "plan"}
    assert svc.project(rows[:10]).shape == (10, 2)


def test_dead_shard_is_frozen_and_recovery_waits_for_cadence():
    """A dead shard's state neither grows nor moves; a recovery is logged
    and re-planned but refreshes only on the cadence."""
    rows = torch.from_numpy(_stream_rows()[:4, :4])
    svc = SubspaceService(D, R, shards=4, device="cpu", cadence=3)
    svc.observe(rows[0])
    svc.set_membership(Membership.from_dead(4, [1]))
    frozen = {k: v[1].clone() for k, v in svc.state.items()}
    svc.observe(rows[1])
    assert all(torch.equal(svc.state[k][1], frozen[k]) for k in frozen)
    assert svc.stats["rows_seen"] == NPER * (4 + 3)
    refreshes = svc.stats["refreshes"]
    svc.set_membership(Membership.full(4))
    assert svc.stats["refreshes"] == refreshes
    assert svc.stats["events"] == ["failure", "recovery"] and svc.stats["replans"] == 2
    svc.set_membership(Membership.full(4))  # no edge: nothing logged
    assert svc.stats["replans"] == 2


def test_query_path_makes_no_collective_call(monkeypatch):
    """The serving claim: ``project`` is a plain product; no function of
    ``torch.distributed`` is called on the query path."""
    svc, _ = _fed(d=48, steps=2)
    calls = []
    for name in dir(dist):
        fn = getattr(dist, name)
        if callable(fn) and not isinstance(fn, type) and not name.startswith("_"):
            monkeypatch.setattr(dist, name, lambda *a, _n=name, **k: calls.append(_n))
    out = svc.project(torch.ones((64, 48)))
    assert calls == [] and out.shape == (64, 4)
    assert torch.equal(out, torch.ones((64, 48)) @ svc.basis)


# ---------------------------------------------------------------------------
# The eigen launcher's stream lane in one process
# ---------------------------------------------------------------------------


def _launch(argv, capsys):
    tlaunch.main(["--device", "cpu", "--d", "48", "--r", "3", "--n-per-shard", "512",
                  "--shards", "4", "--solver", "eigh", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    return dict(line.split(": ", 1) for line in lines if ": " in line)


@pytest.mark.parametrize("extra", [[], ["--fail-at", "2:5"]], ids=["healthy", "fail-at"])
def test_launcher_stream_lane(extra, capsys):
    """``--stream 8 --cadence 2``: the reference's stream keys, the
    full-data basis served at the end, and with ``--fail-at`` the service's
    re-plan; the estimate as good as the one-shot run's on the same rows."""
    stats = _launch(["--stream", "8", "--cadence", "2", *extra], capsys)
    oneshot = _launch(extra[:0], capsys)
    for key in ("stream_steps", "stream_rows_seen", "stream_refreshes", "stream_cadence",
                "stream_staleness", "stream_last_jump", "stream_drift", "replans"):
        assert key in stats, key
    assert stats["stream_steps"] == "8" and stats["stream_staleness"] == "0"
    assert stats["stream_cadence"] == "2"
    if extra:
        assert stats["replans"] == "1" and stats["events"] == "['failure']"
        assert stats["stream_rows_seen"] == str(512 * 4 - 3 * 64)
        assert float(stats["dist_aligned"]) < 0.5
    else:
        assert stats["replans"] == "0" and "events" not in stats
        assert stats["stream_rows_seen"] == str(512 * 4)
        assert stats["stream_refreshes"] == "5"
        assert abs(float(stats["dist_aligned"]) - float(oneshot["dist_aligned"])) < 1e-4

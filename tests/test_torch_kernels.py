"""Port parity of the kernels' plain versions and wrappers on the CPU.

The same numpy-seeded inputs go through the reference's Pallas kernels
(interpret mode, as ``tests/test_kernels.py`` runs them), the reference's
oracles (``repro.kernels.ref``) and the port: the plain PyTorch versions
(``repro_torch.kernels.ref``) and the CUDA wrappers, which on CPU tensors
run the plain version and launch nothing.  The CUDA kernels themselves are
held against the plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.

Tolerances: Gram f32 ``2e-4 * d`` (rtol 1e-2) and bf16 ``2e-1 * d`` as in
``tests/test_kernels.py``; the Gram stages and ``align_average`` 1e-5 on
orthonormal stacks; Newton-Schulz polar 1e-4, since 24 steps amplify
summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import covariance as jcov
from repro.kernels import ops as jops
from repro.kernels import procrustes_align as jpa
from repro.kernels import ref as jref
from repro_torch import kernels as tkernels
from repro_torch.interop import from_reference, to_numpy
from repro_torch.kernels import _build
from repro_torch.kernels import covariance as tcov
from repro_torch.kernels import ops as tops
from repro_torch.kernels import procrustes_align as tpa
from repro_torch.kernels import ref as tref

GRAM_TOL = {"float32": 2e-4, "bfloat16": 2e-1}
STAGE_TOL = 1e-5
NS_TOL = 1e-4
# (m, d, r, bk): block-misaligned d, r < 8, m == 1, as test_kernels_ragged.
STACKS = [(2, 64, 4, 64), (3, 205, 5, 64), (1, 130, 3, 128), (4, 200, 16, 128)]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _noisy_stack(seed, m, d, r, noise=0.1):
    """Noisy orthonormal copies of one r-dim subspace (the paper's setting):
    an (m, d, r) f32 stack whose Grams are near the identity."""
    base = np.linalg.qr(_normal(seed, d, r))[0]
    vs = np.linalg.qr(base[None] + noise * _normal(seed + 1, m, d, r))[0]
    return vs.astype(np.float32)


def _both(**arrays):
    """The same arrays as jnp (reference) and torch CPU tensors (port)."""
    t = from_reference(arrays, device="cpu")
    return {k: jnp.asarray(v) for k, v in arrays.items()}, t


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(
        to_numpy(got), np.asarray(want, np.float32), atol=atol, rtol=rtol
    )


# ------------------------------------------------------------------ B1 ----
@pytest.mark.parametrize("n,d", [(64, 64), (300, 200), (257, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_plain_matches_pallas_and_oracle(n, d, dtype):
    j, t = _both(x=_normal(n + d, n, d))
    jx = j["x"].astype(dtype)
    tx = t["x"].to(getattr(torch, dtype))
    got = tref.gram(tx)
    assert got.dtype == torch.float32 and got.shape == (d, d)
    tol = GRAM_TOL[dtype] * d
    _close(got, jcov.gram(jx, bn=128, bd=128, interpret=True), tol, 1e-2)
    _close(got, jref.gram(jx), tol, 1e-2)


@pytest.mark.parametrize("symmetric", [False, True])
def test_gram_wrapper_on_cpu_runs_plain_version(symmetric):
    """The wrapper takes a CPU tensor to the plain version (no launch),
    and matches the reference's symmetric triangle-skip kernel."""
    j, t = _both(x=_normal(7, 192, 136))
    tkernels.reset_launch_counts()
    got = tcov.gram(t["x"], symmetric=symmetric)
    want = jcov.gram(j["x"], bn=64, bd=64, symmetric=symmetric, interpret=True)
    _close(got, want, GRAM_TOL["float32"] * 136, 1e-2)
    assert tkernels.launch_counts()["gram"] == 0


def test_gram_wrapper_stack_is_per_shard():
    """An (m, n, d) stack gives one Gram per leading index."""
    x = _normal(3, 3, 50, 20)
    got = tcov.gram(torch.from_numpy(x))
    for i in range(3):
        _close(got[i], jref.gram(jnp.asarray(x[i])), 1e-4)


# --------------------------------------------------------------- B2-B4 ----
@pytest.mark.parametrize("m,d,r,bk", STACKS)
def test_batched_gram_plain_matches_pallas(m, d, r, bk):
    j, t = _both(vs=_noisy_stack(m, m, d, r), ref=_noisy_stack(9, 1, d, r)[0])
    got = tpa.batched_gram(t["vs"], t["ref"])  # CPU: the plain version
    assert got.shape == (m, r, r) and got.dtype == torch.float32
    _close(got, jpa.batched_gram(j["vs"], j["ref"], bk=bk, interpret=True), STAGE_TOL)
    _close(got, jref.batched_gram(j["vs"], j["ref"]), STAGE_TOL)


@pytest.mark.parametrize("m,d,r,bk", STACKS)
def test_batched_gram_polar_plain_matches_pallas(m, d, r, bk):
    vs = _noisy_stack(d, m, d, r)
    j, t = _both(vs=vs, ref=vs[0])
    got = tpa.batched_gram_polar(t["vs"], t["ref"])
    assert got.shape == (m, r, r) and got.dtype == torch.float32
    _close(got, jpa.batched_gram_polar(j["vs"], j["ref"], bk=bk, interpret=True), NS_TOL)
    _close(got, jref.batched_gram_polar(j["vs"], j["ref"]), NS_TOL)


@pytest.mark.parametrize("m,d,r,bk", STACKS)
def test_align_average_plain_matches_pallas(m, d, r, bk):
    vs = _noisy_stack(r, m, d, r)
    zs = np.linalg.qr(_normal(5, m, r, r))[0].astype(np.float32)
    j, t = _both(vs=vs, zs=zs)
    got = tpa.align_average(t["vs"], t["zs"])
    assert got.shape == (d, r) and got.dtype == torch.float32
    _close(got, jpa.align_average(j["vs"], j["zs"], bd=bk, interpret=True), STAGE_TOL)
    _close(got, jref.align_average(j["vs"], j["zs"]), STAGE_TOL)


# m r across several 16-deep slices of the CUDA kernel's reduction (r off
# the slice edge, so each machine ends on a short slice), d off its
# 64-row block edge.
@pytest.mark.parametrize("m,d,r", [(3, 205, 40), (2, 130, 33), (5, 65, 16)])
def test_align_average_plain_matches_pallas_over_slices(m, d, r):
    vs = _noisy_stack(m + r, m, d, r)
    zs = np.linalg.qr(_normal(6, m, r, r))[0].astype(np.float32)
    j, t = _both(vs=vs, zs=zs)
    got = tpa.align_average(t["vs"], t["zs"])
    assert got.shape == (d, r) and got.dtype == torch.float32
    _close(got, jpa.align_average(j["vs"], j["zs"], bd=64, interpret=True), STAGE_TOL)
    _close(got, jref.align_average(j["vs"], j["zs"]), STAGE_TOL)


@pytest.mark.parametrize("polar", ["svd", "newton-schulz"])
def test_align_one_matches_reference(polar):
    vs = _noisy_stack(21, 2, 97, 6)
    j, t = _both(v=vs[0], ref=vs[1])
    got = tops.align_one(t["v"], t["ref"], polar=polar, use_kernel=True)
    want = jops.align_one(j["v"], j["ref"], polar=polar, use_kernel=False)
    _close(got, want, NS_TOL if polar == "newton-schulz" else STAGE_TOL)


def test_cpu_wrappers_launch_nothing():
    vs = torch.from_numpy(_noisy_stack(2, 3, 40, 4))
    tkernels.reset_launch_counts()
    tops.gram(vs[0], use_kernel=True)
    tops.batched_gram(vs, vs[0], use_kernel=True)
    z = tops.batched_gram_polar(vs, vs[0], use_kernel=True)
    tops.align_average(vs, z, use_kernel=True)
    tops.fused_round(vs, vs[0], n_iter=2, use_kernel=True)
    tops.fused_ring_round(vs.to(torch.bfloat16), vs[0], use_kernel=True)
    qkv = torch.from_numpy(_normal(3, 1, 2, 8, 16))
    tops.attention(qkv, qkv, qkv, use_kernel=True)
    assert tkernels.launch_counts() == {
        "gram": 0, "batched_gram": 0, "batched_gram_polar": 0, "align_average": 0,
        "fused_round": 0, "fused_ring_round": 0, "fused_ring_round_remote": 0,
        "flash_attention": 0,
    }


# ------------------------------------------------- dispatch and planning ----
def test_resolve_backend():
    assert tops.resolve_backend("auto", "cpu") == "torch"
    assert tops.resolve_backend("auto", torch.device("cuda", 0)) == "cuda"
    assert tops.resolve_backend("cuda", "cpu") == "cuda"
    assert tops.resolve_backend("torch", "cuda") == "torch"
    with pytest.raises(ValueError):
        tops.resolve_backend("pallas", "cpu")


def test_dispatch_defaults_to_plain_off_hopper(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not tops.on_sm90()
    x = torch.from_numpy(_normal(1, 30, 12))
    _close(tops.gram(x), jref.gram(jnp.asarray(x.numpy())), 1e-4)


@pytest.mark.parametrize("d", [1, 15, 16, 17, 8192])
@pytest.mark.parametrize("m", [1, 8, 17])
@pytest.mark.parametrize("r", [5, 128, 256])
def test_split_rows_cover_d(d, m, r):
    """B2's plan: one cluster of k blocks per (machine, tile), k a power of
    two up to 16 (so it divides the 128-row tile the blocks share out),
    at most one block per 32-row slice of d, the k splits of ``rows``
    covering d with none empty; a cluster size the card refuses is never
    taken."""
    for active in (lambda k: 132 // k, lambda k: 0 if k > 8 else 132 // k):
        rows, k = tpa._gram_plan(d, m, r, active)
        assert k in (1, 2, 4, 8, 16) and tpa._GRAM_TILE % k == 0
        assert active(k) >= 1
        assert k <= max(1, -(-d // tpa._GRAM_SLICE))
        assert (k - 1) * rows < d <= k * rows
    assert tpa._gram_plan(8192, 8, 128, lambda k: 132 // k) == (512, 16)


def test_split_then_reduce_equals_plain():
    """B2's split of d over a cluster (a partial per block, summed in rank
    order) is the plain Gram: the wrapper's row arithmetic."""
    vs = torch.from_numpy(_noisy_stack(4, 3, 205, 5))
    ref = vs[0]
    rows, k = tpa._gram_plan(205, 3, 5, lambda c: 132 // c)
    parts = [
        torch.einsum("mdr,ds->mrs", vs[:, q * rows:(q + 1) * rows],
                     ref[q * rows:(q + 1) * rows])
        for q in range(k)
    ]
    assert k > 1
    _close(sum(parts), tref.batched_gram(vs, ref), 1e-6)


@pytest.mark.parametrize("m,d,r", [
    (8, 8192, 128), (1, 7, 3), (33, 8192, 128), (8, 8192, 136), (8, 8192, 137),
    (8, 8192, 256), (3, 205, 5), (1, 8192, 129), (200, 300, 16), (4, 300, 136),
])
@pytest.mark.parametrize("coresident", [132, 114, 8])
def test_round_plan_groups_cover_r(m, d, r, coresident):
    """The round's plan: a grid no larger than the card holds at once;
    every machine's Newton-Schulz group has at least one block, covers r,
    and gives each block rows; a group of more than one block has a
    machine to itself (m g <= grid), and past NS_SMEM_MAX_R the group is
    one block; both d-splits cover d."""
    grid, rows1, splits1, rows2, splits2, g = tpa._round_plan(m, d, r, coresident)
    assert 1 <= grid <= coresident
    assert g >= 1 and (g == 1 or m * g <= grid)
    rb = -(-r // g)
    assert (g - 1) * rb < r <= g * rb
    if r > tpa.NS_SMEM_MAX_R:
        assert g == 1
    for rows, splits in ((rows1, splits1), (rows2, splits2)):
        assert (splits - 1) * rows < d <= splits * rows
    if (m, d, r, coresident) == (8, 8192, 128, 132):
        assert (g, rows1, splits1) == (16, 512, 16)
    # A ring's whole chunks, divided evenly only as far as they fill the grid.
    tiles = (-(-r // tpa._GRAM_TILE)) ** 2
    for chunk in (1000, 2048, 33):
        rows1, splits1 = tpa._round_plan(m, d, r, coresident, rows1=chunk)[1:3]
        assert chunk % rows1 == 0 and (splits1 - 1) * rows1 < d <= splits1 * rows1
        assert rows1 == chunk or m * tiles * splits1 <= coresident
    assert tpa._round_plan(8, 8192, 128, 132, rows1=2048)[1:3] == (512, 16)


def _blocks_of(r, group):
    """Each block's [first, last) iterate columns, as the device cuts them."""
    cols = tpa._ns_cols(r, group)
    return [(min(r, q * cols), min(r, (q + 1) * cols)) for q in range(group)]


@pytest.mark.parametrize("m,r", [
    (8, 128), (8, 192), (8, 256), (3, 5), (3, 137), (1, 7), (33, 128), (33, 137),
    (200, 16), (200, 256), (4, 136), (8, 255), (1, 2248), (17, 130),
])
@pytest.mark.parametrize("coresident", [132, 264, 114, 8, 1])
def test_polar_plan_groups_cover_r(m, r, coresident):
    """B3's Newton-Schulz launch: a grid of whole groups no larger than the
    card holds at once; every machine's group has at least one block, each
    block has columns, together they cover r (a multiple of 4 each past
    NS_SMEM_MAX_R, the streamed form's aligned reads), at least
    _NS_GROUP_COLS (_NS_WIDE_COLS streamed) each unless the group is one
    block; and when the groups are fewer than the machines they take the
    machines in turn, each machine once."""
    grid, group = tpa._polar_plan(m, r, coresident)
    assert 1 <= group <= grid <= coresident and grid % group == 0
    spans = _blocks_of(r, group)
    assert spans[0][0] == 0 and spans[-1][1] == r
    assert all(a < b for a, b in spans) and all(
        b == c for (_, b), (c, _) in zip(spans, spans[1:]))
    wide = r > tpa.NS_SMEM_MAX_R
    if wide:
        assert tpa._ns_cols(r, group) % 4 == 0
    if group > 1:
        fewest = tpa._NS_WIDE_COLS if wide else tpa._NS_GROUP_COLS
        assert tpa._ns_cols(r, group) >= min(fewest, r)
    groups = grid // group
    taken = sorted(z for j in range(groups) for z in range(j, m, groups))
    assert taken == list(range(m))
    assert groups == min(m, coresident // group)
    if (m, r, coresident) in ((8, 128, 132), (8, 256, 132)):
        assert (grid, group) == (128, 16)


@pytest.mark.parametrize("d,r", [(8192, 128), (1000, 7), (205, 5), (300, 137),
                                 (300, 192), (300, 256), (96, 4), (1, 1)])
@pytest.mark.parametrize("coresident", [132, 114, 8])
def test_hop_plan_covers_d_and_r(d, r, coresident):
    """B7's hop launch: the round's plan for one machine (both d-splits
    cover d, a grid the card holds), and the polar step on a group of the
    grid's blocks, each with columns, together covering r."""
    grid, rows1, splits1, rows2, splits2, group = tpa._hop_plan(d, r, coresident)
    assert 1 <= group <= grid <= coresident
    for rows, splits in ((rows1, splits1), (rows2, splits2)):
        assert (splits - 1) * rows < d <= splits * rows
    spans = _blocks_of(r, group)
    assert spans[-1][1] == r and all(a < b for a, b in spans)
    assert (grid, rows1, splits1) == tpa._round_plan(1, d, r, coresident)[:3]
    if (d, r, coresident) == (8192, 128, 132):
        assert group == 16


def test_round_plan_keeps_its_groups():
    """B5/B6 keep their plan: the grouped rule up to NS_SMEM_MAX_R (shared
    with B3's and B7's plans), one block a machine past it."""
    for m, r, blocks in ((8, 128, 132), (33, 128, 132), (3, 5, 132), (200, 16, 132),
                         (4, 136, 114)):
        want = max(1, min(blocks // m, -(-r // tpa._NS_GROUP_COLS)))
        assert tpa._round_plan(m, 8192, r, blocks)[5] == -(-r // -(-r // want))
    assert tpa._round_plan(8, 8192, 256, 132)[5] == 1


def test_watch_bounds_each_hop():
    """The host's watch over B7's hop events: it returns None once every
    hop is done, and the index of the first hop that stays pending past
    ``wait_s`` after the previous hop was seen done."""

    class Clock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

    class Hop:
        def __init__(self, clock, at):
            self.clock, self.at = clock, at

        def query(self):
            self.clock.t += 1.0  # one second passes at every poll
            return self.at is not None and self.clock.t >= self.at

    clock = Clock()
    assert tpa._watch([Hop(clock, 3), Hop(clock, 9), Hop(clock, 14)], 10.0,
                      clock=clock, pause=0.0) is None
    clock = Clock()
    assert tpa._watch([Hop(clock, 3), Hop(clock, None), Hop(clock, 5)], 10.0,
                      clock=clock, pause=0.0) == 1
    clock = Clock()
    assert tpa._watch([Hop(clock, 30)], 10.0, clock=clock, pause=0.0) == 0
    assert tpa._watch([], 1.0) is None


def test_ns_form_names_every_form():
    assert tpa._ns_form(0) == "one block a machine, workspace tiles"
    assert tpa._ns_form(1) == "one block a machine, shared-memory tiles"
    assert tpa._ns_form(16) == "grouped, 16 blocks a machine"
    assert tpa._ns_form(-1) == "one block a machine, iterate streamed from L2"
    assert tpa._ns_form(-16) == "grouped, 16 blocks a machine, iterate streamed from L2"


def test_wrappers_refuse_other_devices():
    x = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError):
        tcov.gram(x)
    with pytest.raises(ValueError):
        tpa.batched_gram(torch.empty((2, 8, 4), device="meta"), x)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_load_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _build.load.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load()

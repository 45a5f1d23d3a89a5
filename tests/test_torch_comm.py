"""Port parity of the comm layer's plain parts (no process group): the
codecs, the message and cost formulas, the topology registry, shard
membership, and the transport rule of the launcher.

Held against the reference package: ``comm_cost`` for every flat
topology x wire tier x membership case (words and bits exactly, and the
per-kind split against the reference's ``hlo_bits``), ``message_bits``,
``Membership`` / ``pod_membership``, and the bf16 codec bit for bit.  The
int8 codec draws from ``torch.Generator``s, so it is held to its
properties (the per-element bound, unbiasedness) instead of the
reference's ``jax.random`` bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import membership as jmem
from repro.comm import quantize as jq
from repro.comm import topology as jtopo
from repro_torch.comm import membership as tmem
from repro_torch.comm import quantize as tq
from repro_torch.comm import topology as ttopo
from repro_torch.launch.mesh import transport_rule

BITS = (32, 16, 8)
MEMBERSHIPS = [None, (4,), (0,), (1, 6)]  # dead shards of m = 8


def _x(seed, d=64, r=6):
    return np.random.default_rng(seed).standard_normal((d, r)).astype(np.float32)


# ------------------------------------------------------------ codecs ------
def test_registry_and_resolution():
    assert tq.COMM_BITS == jq.COMM_BITS and tq.PARITY_TOL == jq.PARITY_TOL
    assert tq.COMM_BITS_CHOICES == jq.COMM_BITS_CHOICES
    assert tq.resolve_comm_bits(None) == 32 and tq.resolve_comm_bits("16") == 16
    with pytest.raises(NotImplementedError, match="A7"):
        tq.resolve_comm_bits("auto")
    for bad in (12, "12", "fast"):
        with pytest.raises(ValueError):
            tq.resolve_comm_bits(bad)


@pytest.mark.parametrize("bits", BITS)
def test_codec_properties(bits):
    t, j = tq.get_codec(bits), jq.get_codec(bits)
    assert (t.lossy, t.stochastic) == (j.lossy, j.stochastic)
    assert torch.empty(0, dtype=t.wire_dtype).element_size() * 8 == bits


@pytest.mark.parametrize("d,r", [(64, 6), (4096, 16), (7, 1)])
@pytest.mark.parametrize("bits", BITS)
def test_message_bits_matches_reference(d, r, bits):
    assert tq.message_bits(d, r, bits) == jq.message_bits(d, r, bits)


def test_identity_and_bf16_round_trips_match_reference():
    x = _x(0)
    c32 = tq.get_codec(32)
    data, scale = c32.encode(torch.from_numpy(x))
    assert scale is None and torch.equal(c32.decode(data), torch.from_numpy(x))
    c16, j16 = tq.get_codec(16), jq.get_codec(16)
    data, scale = c16.encode(torch.from_numpy(x))
    want = np.asarray(j16.decode(j16.encode(jnp.asarray(x))[0]))
    assert data.dtype == torch.bfloat16 and scale is None
    np.testing.assert_array_equal(c16.decode(data).numpy(), want)  # RNE both
    np.testing.assert_array_equal(
        c16.residual(torch.from_numpy(x), data).numpy(), x - want)


def test_int8_codec_bound_and_residual():
    x = torch.from_numpy(_x(1, 200, 5))
    c8 = tq.get_codec(8)
    with pytest.raises(ValueError):
        c8.encode(x)
    data, scale = c8.encode(x, tq.shard_generator(7, 0, 0, "cpu"))
    assert data.dtype == torch.int8 and scale.shape == (5,)
    dec = c8.decode(data, scale)
    assert bool((dec - x).abs().le(scale * (1 + 1e-6)).all())  # one step
    torch.testing.assert_close(c8.residual(x, data, scale), x - dec)
    z = torch.zeros(10, 3)
    zd, zs = c8.encode(z, tq.shard_generator(7, 0, 0, "cpu"))
    assert not zd.any() and torch.equal(zs, torch.full((3,), 1 / 127.0))


def test_int8_stochastic_rounding_is_unbiased():
    x = torch.from_numpy(_x(2, 32, 4))
    c8 = tq.get_codec(8)
    mean = torch.zeros_like(x)
    n = 400
    for k in range(n):
        mean += c8.decode(*c8.encode(x, tq.shard_generator(9, 0, k, "cpu"))) / n
    step = x.abs().amax(dim=0) / 127.0
    assert bool(((mean - x).abs() <= 0.15 * step).all())


def test_shard_generators_are_deterministic_and_distinct():
    draw = lambda *a: torch.rand(4, generator=tq.shard_generator(*a, "cpu"))
    assert torch.equal(draw(1, 2, 3), draw(1, 2, 3))
    others = [draw(1, 3, 3), draw(1, 2, 4), draw(2, 2, 3)]
    assert not any(torch.equal(draw(1, 2, 3), o) for o in others)


# ------------------------------------------------------------ topology ----
def test_topologies_registry_and_auto_pairing():
    """The collective form pairs "auto" with the backend as the reference
    does ("cuda" in place of "pallas"); the stacked form keeps gather."""
    from repro_torch.core.distributed import resolve_stacked_topology

    assert ttopo.TOPOLOGIES == ("psum", "gather", "ring")
    assert ttopo.resolve_topology("auto", "cuda") == jtopo.resolve_topology("auto", "pallas") == "gather"
    assert ttopo.resolve_topology("auto", "torch") == jtopo.resolve_topology("auto", "xla") == "psum"
    assert ttopo.resolve_topology(None) == "psum"
    for topo in ttopo.TOPOLOGIES:
        for backend in ("torch", "cuda"):
            assert ttopo.resolve_topology(topo, backend) == topo
    for topo in (None, "auto", "gather"):
        assert resolve_stacked_topology(topo) == "gather"
    with pytest.raises(ValueError):
        ttopo.resolve_topology("coordinator")


def test_hier_raises_and_names_the_next_slice():
    with pytest.raises(NotImplementedError, match="A5-hier"):
        ttopo.resolve_topology("hier")
    with pytest.raises(NotImplementedError, match="next slice"):
        ttopo.comm_cost("hier", m=8, d=64, r=4)


@pytest.mark.parametrize("dead", MEMBERSHIPS)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("topology", ["psum", "gather", "ring"])
def test_comm_cost_matches_reference(topology, bits, dead):
    m, d, r = 8, 96, 4
    tm = None if dead is None else tmem.Membership.from_dead(m, dead)
    jm = None if dead is None else jmem.Membership.from_dead(m, dead)
    for n_iter in (1, 3):
        for ref_broadcast in (True, False):
            kw = dict(m=m, d=d, r=r, n_iter=n_iter, ref_broadcast=ref_broadcast,
                      comm_bits=bits)
            got = ttopo.comm_cost(topology, membership=tm, **kw)
            want = jtopo.comm_cost(topology, membership=jm, **kw)
            assert (got.topology, got.comm_bits, got.words, got.bits) == (
                want.topology, want.comm_bits, want.words, want.bits)
            assert got.kind_bits == want.hlo_bits


def test_comm_cost_baselines():
    assert ttopo.paper_coordinator_words(8, 64, 4) == jtopo.paper_coordinator_words(8, 64, 4)
    assert ttopo.fan_projector_words(64) == jtopo.fan_projector_words(64)
    assert ttopo.comm_cost("ring", m=8, d=64, r=4, comm_bits=32).bits == \
        ttopo.comm_cost("ring", m=8, d=64, r=4).words * 32


# ------------------------------------------------------------ membership --
@pytest.mark.parametrize("m,dead", [(8, ()), (8, (0,)), (8, (3, 5)), (1, ())])
def test_membership_matches_reference(m, dead):
    t, j = tmem.Membership.from_dead(m, dead), jmem.Membership.from_dead(m, dead)
    assert t.active == j.active
    for attr in ("m", "m_active", "is_full", "indices", "dead"):
        assert getattr(t, attr) == getattr(j, attr)
    if t.m_active:
        assert t.first_active == j.first_active
    assert hash(t) == hash(tmem.Membership(active=t.active))
    assert t.drop(*t.indices[1:]).recover(*t.indices[1:]) == t
    if m % 2 == 0:
        assert tmem.pod_membership(t, 2).active == jmem.pod_membership(j, 2).active


def test_membership_validation():
    with pytest.raises(ValueError):
        tmem.Membership(active=())
    with pytest.raises(ValueError):
        tmem.Membership(active=(False, False))
    with pytest.raises(ValueError):
        tmem.Membership.from_dead(4, [4])
    with pytest.raises(ValueError):
        tmem.resolve_membership(tmem.Membership.full(3), 4)
    with pytest.raises(TypeError):
        tmem.resolve_membership((True,) * 4, 4)
    assert tmem.resolve_membership(None, 4) == tmem.Membership.full(4)
    with pytest.raises(ValueError):
        tmem.pod_membership(tmem.Membership.full(6), 4)


# ------------------------------------------------------------ transport ---
def test_transport_rule():
    assert transport_rule("cuda", 8, 1)[0] == "gloo"  # eight ranks, one card
    assert "NCCL refuses" in transport_rule("cuda", 8, 1)[1]
    assert transport_rule("cuda", 2, 2)[0] == "nccl"
    assert transport_rule("cuda", 4, 8)[0] == "nccl"
    assert transport_rule("cpu", 4, 0)[0] == "gloo"

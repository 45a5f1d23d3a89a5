"""Wire-precision codecs for the aggregation collectives (``comm_bits=``;
port of ``repro/comm/quantize.py``).

==========  ==========  =====================================================
comm_bits   wire dtype  codec
==========  ==========  =====================================================
32          f32         identity
16          bf16        round-to-nearest-even cast (deterministic)
8           int8        per-column scale (f32[r]) + stochastic rounding, so
                        E[decode(encode(x))] == x
==========  ==========  =====================================================

Error feedback: the lossy codecs return the residual
``x - decode(encode(x))``, and the psum and ring schedules add it to the
next round's send, so the decoded payloads telescope across rounds.

The int8 psum sums int8 payloads on the wire under one shared per-column
scale (a max all-reduce of f32[r]) with headroom for the sum:
``qscale = colmax * m / (127 - m)`` keeps ``|sum_i q_i| <= 127``; it needs
m <= 126 contributors.

Randomness: ``shard_generator(salt, rank, round_index)`` is a
``torch.Generator`` seeded from the three, the counterpart of the
reference's ``fold_in(fold_in(PRNGKey(salt), axis_index), round)``.  It
cannot replay ``jax.random``, so 8-bit results match the reference within
``PARITY_TOL[8]``, not bit for bit.

bf16 payloads move as bf16: ``torch.distributed`` (gloo and NCCL) moves
bf16 tensors at two bytes an element, so the reference's u16 carrier
(``to_wire``/``from_wire``, an XLA-CPU workaround) is not carried over.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.comm import transport

__all__ = [
    "COMM_BITS",
    "COMM_BITS_CHOICES",
    "PARITY_TOL",
    "Codec",
    "get_codec",
    "resolve_comm_bits",
    "message_bits",
    "shard_generator",
    "wire_broadcast",
    "wire_psum_mean",
]

COMM_BITS = (32, 16, 8)

# Knob spellings; "auto" needs the planner (ROADMAP A7) and is refused.
COMM_BITS_CHOICES = ("32", "16", "8", "auto")

# f64 subspace distance to the serial f32 oracle, by wire tier.
PARITY_TOL = {32: 1e-5, 16: 2e-2, 8: 2.5e-1}

_INT8_QMAX = 127.0
_SEED_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant mixing the seed parts


def resolve_comm_bits(comm_bits) -> int:
    """Normalise a ``comm_bits`` knob (None -> 32, int or digit string)."""
    if comm_bits is None:
        return 32
    if isinstance(comm_bits, str):
        if comm_bits == "auto":
            raise NotImplementedError(
                "comm_bits='auto' needs the cost-model planner, not ported "
                "yet (ROADMAP A7); pass 32, 16 or 8"
            )
        if not comm_bits.isdigit():
            raise ValueError(
                f"unknown comm_bits {comm_bits!r}; choose from {COMM_BITS}"
            )
        comm_bits = int(comm_bits)
    if comm_bits not in COMM_BITS:
        raise ValueError(f"unknown comm_bits {comm_bits!r}; choose from {COMM_BITS}")
    return int(comm_bits)


def message_bits(d: int, r: int, comm_bits=32) -> int:
    """Wire bits of one (d, r) basis message: ``d * r * bits``, plus the
    f32[r] column scale that rides with every int8 message."""
    bits = resolve_comm_bits(comm_bits)
    return d * r * bits + (32 * r if bits == 8 else 0)


def shard_generator(
    salt: int, rank: int, round_index: int, device: torch.device | str
) -> torch.Generator:
    """The stochastic-rounding stream of one rank in one round of one
    collective site (``salt``)."""
    seed = salt
    for part in (rank, round_index):
        seed = (seed * _SEED_MIX + part + 1) % (1 << 63)
    return torch.Generator(device=device).manual_seed(seed)


@dataclasses.dataclass(frozen=True)
class Codec:
    """One wire tier: ``encode`` maps f32 (d, r) to ``(data, scale)``,
    ``data`` in ``wire_dtype`` and ``scale`` the f32[r] column scale (None
    for the scale-free tiers); ``decode`` inverts to f32."""

    bits: int

    @property
    def wire_dtype(self) -> torch.dtype:
        return {32: torch.float32, 16: torch.bfloat16, 8: torch.int8}[self.bits]

    @property
    def stochastic(self) -> bool:
        return self.bits == 8

    @property
    def lossy(self) -> bool:
        return self.bits != 32

    def encode(self, x: torch.Tensor, generator: torch.Generator | None = None):
        if self.bits == 32:
            return x, None
        if self.bits == 16:
            return x.to(torch.bfloat16).contiguous(), None
        if generator is None:
            raise ValueError(
                "the int8 codec uses stochastic rounding and needs a generator"
            )
        x = x.to(torch.float32)
        colmax = x.abs().amax(dim=0)
        scale = torch.where(colmax > 0, colmax, torch.ones_like(colmax)) / _INT8_QMAX
        u = torch.rand(x.shape, generator=generator, device=x.device)
        q = torch.clamp(torch.floor(x / scale + u), -_INT8_QMAX, _INT8_QMAX)
        return q.to(torch.int8).contiguous(), scale

    def decode(self, data: torch.Tensor, scale: torch.Tensor | None = None):
        if self.bits == 32:
            return data
        if self.bits == 16:
            return data.to(torch.float32)
        return data.to(torch.float32) * scale

    def residual(self, x, data, scale=None):
        """Error-feedback state: what encoding dropped (zeros at 32 bits)."""
        return x - self.decode(data, scale)


_CODECS = {b: Codec(b) for b in COMM_BITS}


def get_codec(comm_bits) -> Codec:
    return _CODECS[resolve_comm_bits(comm_bits)]


def wire_broadcast(
    x: torch.Tensor,
    codec: Codec,
    *,
    src: int,
    group,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Broadcast group rank ``src``'s (d, r) basis at wire precision; every
    rank returns the decoded f32 payload (``x`` unchanged in dtype at 32
    bits).  Only ``src`` encodes, with its own ``generator``."""
    from repro_torch.comm.topology import broadcast_from

    if not codec.lossy:
        return broadcast_from(x, src=src, group=group)
    if dist.get_rank(group) == src:
        data, scale = codec.encode(x.to(torch.float32), generator)
    else:
        data = torch.empty(x.shape, dtype=codec.wire_dtype, device=x.device)
        scale = (torch.empty(x.shape[-1], dtype=torch.float32, device=x.device)
                 if codec.stochastic else None)
    transport.broadcast(data, src=src, group=group)
    if scale is not None:
        transport.broadcast(scale, src=src, group=group)
    return codec.decode(data, scale)


def wire_psum_mean(
    x: torch.Tensor,
    m: int,
    codec: Codec,
    *,
    group,
    generator: torch.Generator | None = None,
):
    """Mean over the group with the sum taken at wire precision.

    ``m`` is the contributor count (under a degraded membership the caller
    zeroes the dead ranks' ``x``, which quantizes to zero at every tier,
    and passes m').  Returns ``(mean, residual)``, the residual being this
    rank's error-feedback state (None at 32 bits)."""
    if not codec.lossy:
        return transport.all_reduce(x.clone(), group=group) / m, None
    x = x.to(torch.float32)
    if codec.bits == 16:
        w = x.to(torch.bfloat16)
        total = transport.all_reduce(w.clone(), group=group)
        return total.to(torch.float32) / m, x - w.to(torch.float32)
    if m > 126:
        raise ValueError(
            f"int8 psum needs m <= 126 contributors for overflow headroom "
            f"(got m={m}); use topology='gather'/'ring' or comm_bits >= 16"
        )
    colmax = transport.all_reduce(x.abs().amax(dim=0), group=group, op="max")
    qscale = torch.where(colmax > 0, colmax, torch.ones_like(colmax)) * m / (
        _INT8_QMAX - m)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    q = torch.clamp(torch.floor(x / qscale + u), -_INT8_QMAX, _INT8_QMAX)
    q = q.to(torch.int8)
    total = transport.all_reduce(q.clone(), group=group).to(torch.float32) * qscale
    return total / m, x - q.to(torch.float32) * qscale

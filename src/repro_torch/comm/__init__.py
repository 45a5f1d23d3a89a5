"""Communication layer of the port (mirrors ``repro.comm``): how the
refinement rounds talk across ranks of a ``torch.distributed`` process
group.

``topology=`` ("psum" | "gather" | "ring" | "auto") picks the schedule,
independent of ``backend=`` (the compute path); ``comm_bits=`` (32 | 16 |
8) the wire precision; ``membership=`` masks dead ranks out.  The
registry and the cost model live in ``topology``, the codecs in
``quantize``, the ring in ``ring``, and every call into
``torch.distributed`` in ``transport``.  Each function takes its
``ProcessGroup`` explicitly; nothing here holds mesh state.  This package
sits below ``repro_torch.core`` (core imports are function-level).
"""

from repro_torch.comm.membership import (  # noqa: F401
    Membership,
    pod_membership,
    resolve_membership,
)
from repro_torch.comm.quantize import (  # noqa: F401
    COMM_BITS,
    COMM_BITS_CHOICES,
    PARITY_TOL,
    Codec,
    get_codec,
    message_bits,
    resolve_comm_bits,
    shard_generator,
    wire_broadcast,
    wire_psum_mean,
)
from repro_torch.comm.topology import (  # noqa: F401
    TOPOLOGIES,
    TOPOLOGY_CHOICES,
    CommCost,
    axis_size,
    broadcast_from,
    comm_cost,
    fan_projector_words,
    paper_coordinator_words,
    resolve_topology,
)
from repro_torch.comm.ring import (  # noqa: F401
    DEFAULT_RING_CHUNK,
    chunk_spans,
    fused_ring_rounds,
    ring_rounds,
)

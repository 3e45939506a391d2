"""P2P communication: the inter-stage activation transport and the control
RPCs of a scheduler-less swarm (port of ``parallax_tpu/p2p``).

The same RPC surface and frames as the JAX package over a pluggable
transport: in-process loopback, and length-prefixed msgpack over TCP
(``p2p/wire.py`` writes msgpack itself). ``node.WorkerNode`` serves a
layer range, gossips block announcements and forwards activations;
``join.join_main`` is the ``join`` command.
"""

from parallax_tpu_torch.p2p.proto import decode_frame, encode_frame
from parallax_tpu_torch.p2p.transport import (
    LoopbackTransport,
    TcpTransport,
    Transport,
)

__all__ = [
    "Transport",
    "LoopbackTransport",
    "TcpTransport",
    "encode_frame",
    "decode_frame",
]

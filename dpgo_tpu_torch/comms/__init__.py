"""Fault-tolerant deployment transport (``dpgo_tpu_torch.comms``).

The per-robot runtime (``dpgo_tpu_torch.agent``) deliberately owns no transport:
the reference delegates it to the external ``dpgo_ros`` wrapper, and our
deployment examples used to carry their own ad-hoc socket code that assumed
a perfect network — blocking reads with no deadline, no retries, no
staleness bookkeeping, and a hang if any robot process died.  The RA-L 2020
asynchronous DPGO convergence result holds precisely *because* messages may
be delayed, stale, or lost; this package makes the deployment path live up
to that claim:

* ``protocol`` — the wire format: length-prefixed frames (arrays only, no
  pickle) in the packed columnar v2 codec (CRC32-protected, zero-copy
  ``frombuffer`` decode, columnar pose sets with an opt-in bf16 payload)
  with the v1 ``npz`` archive as a versioned fallback (receivers sniff
  the magic, so mixed-version fleets interoperate), a validated
  frame-size cap (a corrupt or malicious length header raises
  ``ProtocolError`` instead of attempting an OOM-sized allocation) and an
  incremental ``FrameAssembler`` so a read deadline can interrupt and
  later resume a partially received frame.
* ``transport`` — the ``Transport`` abstraction plus the two shipped
  implementations: ``LoopbackTransport`` (in-process pair, delay-aware
  inboxes) and ``TcpTransport`` (localhost/TCP, lifted out of
  ``examples/tcp_deployment_example.py``).  Both thread every outgoing
  frame through an optional ``FaultInjector``.
* ``faults`` — deterministic, seeded fault injection: drop / delay /
  reorder / corrupt / partition, with per-link RNG streams so results do
  not depend on thread scheduling across links.
* ``reliable`` — the fault-tolerance layer: ``ReliableChannel`` wraps any
  transport with per-message send/recv deadlines, bounded retry with
  exponential backoff + jitter, monotonic sequence numbers (stale and
  reordered frames are dropped, counted), corrupt-frame rejection,
  heartbeat-based peer liveness, and ``dpgo_tpu_torch.obs`` instrumentation
  (``comms_retries`` / ``comms_timeouts`` / ``comms_stale_dropped`` /
  ``comms_corrupt_dropped`` counters, terminal ``run_summary`` event)
  behind the same zero-overhead telemetry-off fence as the solver paths.
* ``bus`` — the hub role the launcher plays (what dpgo_ros' pub/sub does in
  the reference's deployments): ``RoundBus`` gathers one fresh frame per
  live robot per round and rebroadcasts the union; a silent or dead robot
  is detected (closed transport, or consecutive misses with a stale
  heartbeat), excluded, and announced to the survivors, so the solve
  degrades gracefully instead of hanging.  ``BusClient`` is the robot-side
  counterpart, with an overlapped mode (``start_overlap``) that
  double-buffers the publish/collect round against the caller's compute
  under a bounded-staleness knob; ``pack_agent_frame`` /
  ``apply_peer_frame`` serialize the ``PGOAgent`` message vocabulary onto
  the wire.

Failure semantics on peer death: in async mode the dead robot's cached
poses stay frozen in every survivor (the RA-L delay-tolerance argument —
optimization continues against the last received iterate); in sync mode
the dead robot is excluded from the ``should_terminate`` quorum
(``PGOAgent.mark_neighbor_lost``) so the remaining team can still reach
consensus and finish.

The PyTorch port's copy of ``dpgo_tpu.comms``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

from .faults import FaultInjector, FaultSpec
from .protocol import (
    BF16_REL_ERR,
    CLOCK_KEY,
    DEFAULT_MAX_FRAME_BYTES,
    PACKED_MAGIC,
    TRACE_IDS_KEY,
    TRACE_T_KEY,
    FrameAssembler,
    ProtocolError,
    bf16_decode,
    bf16_encode,
    decode_payload,
    encode_payload,
    pack_pose_arrays,
    pack_pose_dict,
    pack_pose_set,
    pack_trace_entries,
    pose_payload_nbytes,
    recv_frame,
    send_frame,
    unpack_pose_arrays,
    unpack_pose_dict,
    unpack_pose_set,
    unpack_trace_entries,
)
from .reliable import ChannelTotals, ReliableChannel, RetryPolicy
from .transport import (
    LoopbackTransport,
    TcpTransport,
    Transport,
    TransportClosed,
    TransportError,
    TransportTimeout,
    connect_tcp,
    listen_tcp,
)
from .bus import (BusClient, RoundBus, apply_peer_frame,
                  loopback_fleet, pack_agent_frame)

__all__ = [
    "BF16_REL_ERR",
    "BusClient",
    "CLOCK_KEY",
    "ChannelTotals",
    "DEFAULT_MAX_FRAME_BYTES",
    "FaultInjector",
    "FaultSpec",
    "FrameAssembler",
    "LoopbackTransport",
    "PACKED_MAGIC",
    "ProtocolError",
    "ReliableChannel",
    "RetryPolicy",
    "RoundBus",
    "TRACE_IDS_KEY",
    "TRACE_T_KEY",
    "TcpTransport",
    "Transport",
    "TransportClosed",
    "TransportError",
    "TransportTimeout",
    "apply_peer_frame",
    "bf16_decode",
    "bf16_encode",
    "connect_tcp",
    "decode_payload",
    "encode_payload",
    "listen_tcp",
    "loopback_fleet",
    "pack_agent_frame",
    "pack_pose_arrays",
    "pack_pose_dict",
    "pack_pose_set",
    "pack_trace_entries",
    "pose_payload_nbytes",
    "recv_frame",
    "send_frame",
    "unpack_pose_arrays",
    "unpack_pose_dict",
    "unpack_pose_set",
    "unpack_trace_entries",
]

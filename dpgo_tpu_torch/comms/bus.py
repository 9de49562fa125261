"""The round bus: hub-and-spoke relay with graceful agent dropout.

The launcher of ``examples/tcp_deployment_example.py`` plays the pub/sub
role the reference delegates to ``dpgo_ros``: it accepts one connection per
robot and, each round, collects one frame from every robot and rebroadcasts
the union (keys namespaced ``r{id}|...``).  ``RoundBus`` is that loop as a
library, made fault-tolerant:

* A robot whose frame misses the round deadline is *not* waited on forever:
  its last known frame is rebroadcast (its poses freeze — the RA-L delay
  tolerance), and a miss is counted.
* A robot is declared **lost** when its transport closes, or after
  ``miss_limit`` consecutive misses with a stale heartbeat (silence, not
  slowness).  Lost robots are excluded from the gather, announced to the
  survivors in the ``_lost`` broadcast key, and the solve continues.
* ``poll`` draining after each fresh frame re-synchronizes a link that
  delay faults pushed a round behind.

``BusClient`` is the robot side: stamp-and-publish, collect with a
deadline (a missed broadcast skips one update, it does not deadlock), and
surface the bus's lost-peer announcements so the agent can adjust its
termination quorum (``PGOAgent.mark_neighbor_lost``).

``pack_agent_frame`` / ``apply_peer_frame`` serialize the ``PGOAgent``
message vocabulary (status gossip, public poses, GNC weights, global
anchor) onto the wire — shared by the TCP example, the in-process async
example, and the chaos tests so every path speaks the same protocol.

The PyTorch port's copy of ``dpgo_tpu.comms.bus``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from .. import obs
from ..obs import trace
from .protocol import (pack_pose_arrays, pack_pose_dict,
                       pack_trace_entries, unpack_pose_arrays,
                       unpack_pose_set, unpack_trace_entries)
from .reliable import ChannelTotals, ReliableChannel, RetryPolicy
from .transport import TcpTransport, TransportClosed, TransportTimeout


# ---------------------------------------------------------------------------
# Hub side
# ---------------------------------------------------------------------------

def accept_robots(srv, num_robots: int, injector=None,
                  policy: RetryPolicy | None = None,
                  hello_timeout_s: float = 30.0,
                  max_frame_bytes: int | None = None,
                  wire_format: str = "packed"
                  ) -> dict[int, ReliableChannel]:
    """Accept one TCP connection per robot; each must introduce itself with
    a ``{"hello": robot_id}`` frame within the deadline."""
    import socket as _socket

    channels: dict[int, ReliableChannel] = {}
    srv.settimeout(hello_timeout_s)
    while len(channels) < num_robots:
        try:
            conn, _ = srv.accept()
        except _socket.timeout:
            raise ConnectionError(
                f"only {len(channels)}/{num_robots} robots connected "
                f"within {hello_timeout_s}s") from None
        kw = {} if max_frame_bytes is None else \
            {"max_frame_bytes": max_frame_bytes}
        t = TcpTransport(conn, src="bus", dst="?", injector=injector,
                         wire_format=wire_format, **kw)
        ch = ReliableChannel(t, policy=policy, origin=-1)
        hello = ch.recv(timeout=hello_timeout_s)
        rid = int(hello["hello"])
        t.dst = f"robot{rid}"
        ch.name = f"bus->robot{rid}"
        channels[rid] = ch
    return channels


class RoundBus:
    """Gather one fresh frame per live robot, rebroadcast the union."""

    def __init__(self, channels: dict[int, ReliableChannel],
                 round_timeout_s: float = 5.0, miss_limit: int = 3,
                 liveness_timeout_s: float = 2.0):
        self.channels = channels
        self.round_timeout_s = round_timeout_s
        self.miss_limit = miss_limit
        self.liveness_timeout_s = liveness_timeout_s
        self.lost: set[int] = set()
        #: Robots admitted AFTER the bus started (the join handshake);
        #: rebroadcast cumulatively in the ``_joined`` key — like
        #: ``_lost`` — so a drop-lossy link still learns about every
        #: joiner eventually.
        self.joined: set[int] = set()
        self._last_frames: dict[int, dict] = {}
        self._last_seqs: dict[int, int] = {}
        self._misses: dict[int, int] = {rid: 0 for rid in channels}
        self._anom_seen: dict[int, int] = {}  # rid -> last gossiped count
        self.rounds_served = 0
        # Joins land between rounds from any thread (a launcher's accept
        # loop); the relay drains them at the top of its next round.
        self._admit_lock = threading.Lock()
        self._admit_pending: list[tuple[int, ReliableChannel]] = []

    def _mark_lost(self, rid: int, reason: str) -> None:
        if rid in self.lost:
            return
        self.lost.add(rid)
        run = obs.get_run()
        if run is not None:
            run.event("peer_lost", phase="comms", peer=rid, reason=reason,
                      round=self.rounds_served)

    def _gather_one(self, rid: int) -> None:
        ch = self.channels[rid]
        try:
            frame = ch.recv(timeout=self.round_timeout_s)
        except TransportTimeout:
            self._misses[rid] += 1
            age = ch.last_seen_age()
            hb_stale = age is None or age > self.liveness_timeout_s
            if self._misses[rid] >= self.miss_limit and hb_stale:
                self._mark_lost(rid, "silent")
            return
        except TransportClosed:
            self._mark_lost(rid, "closed")
            return
        # Drain to the freshest queued frame: delay faults can leave a link
        # a round behind; the channel's sequence check guarantees each
        # poll() result is strictly newer.  A peer that closed right after
        # its last frame is marked lost here instead of crashing the round.
        try:
            while True:
                newer = ch.poll()
                if newer is None:
                    break
                frame = newer
        except TransportClosed:
            self._mark_lost(rid, "closed")
        self._misses[rid] = 0
        self._last_frames[rid] = frame
        self._last_seqs[rid] = ch.last_recv_seq
        # Fleet-wide numerical health: a robot whose frame gossips a grown
        # anomaly counter gets surfaced on the HUB's event stream (the
        # hub's report renders the fleet view; the robot's own run dir has
        # the detailed anomaly events).
        if "anom" in frame:
            run = obs.get_run()
            count, worst = (int(x) for x in np.asarray(frame["anom"])[:2])
            if run is not None and count > self._anom_seen.get(rid, 0):
                run.event("peer_anomaly", phase="health", peer=rid,
                          count=count,
                          severity=("critical" if worst >= 2 else "warning"),
                          round=self.rounds_served)
            self._anom_seen[rid] = max(self._anom_seen.get(rid, 0), count)

    def admit(self, rid: int, channel: ReliableChannel) -> None:
        """The join handshake, hub side: attach a robot's channel to the
        live relay.  Effective at the start of the next round; the robot
        is announced to the fleet in the cumulative ``_joined`` broadcast
        key so survivors can grow their problems
        (``PGOAgent.admit_neighbor``).  Re-admitting a previously-lost
        robot revives it (fresh channel, miss counters reset)."""
        with self._admit_lock:
            self._admit_pending.append((int(rid), channel))

    def admit_hello(self, channel: ReliableChannel,
                    timeout: float | None = None) -> int:
        """Receive the joiner's ``{"hello": robot_id}`` introduction frame
        (the same vocabulary ``accept_robots`` uses at launch) and admit
        it.  Returns the robot id — the TCP launcher's accept-loop
        helper."""
        hello = channel.recv(timeout=timeout)
        rid = int(hello["hello"])
        channel.name = f"bus->robot{rid}"
        self.admit(rid, channel)
        return rid

    def _drain_admissions(self) -> None:
        with self._admit_lock:
            pending, self._admit_pending = self._admit_pending, []
        for rid, ch in pending:
            stale = self.channels.pop(rid, None)
            if stale is not None and stale is not ch:
                try:
                    stale.close(emit_summary=False)
                except Exception:
                    pass
            self.channels[rid] = ch
            self.lost.discard(rid)
            self._misses[rid] = 0
            self._last_frames.pop(rid, None)
            self._last_seqs.pop(rid, None)
            self.joined.add(rid)
            run = obs.get_run()
            if run is not None:
                run.event("peer_joined", phase="comms", peer=rid,
                          round=self.rounds_served)

    def round(self) -> dict:
        """One relay round; returns the merged broadcast frame."""
        self._drain_admissions()
        # The hub's span (robot = -1): gather + rebroadcast wall-clock,
        # the wire half of every round's critical path.
        sp = trace.span("bus_round", phase="comms", robot=-1,
                        round=self.rounds_served)
        with sp:
            for rid in sorted(self.channels):
                if rid not in self.lost:
                    self._gather_one(rid)
            merged: dict = {}
            for rid, frame in sorted(self._last_frames.items()):
                if rid in self.lost:
                    continue
                merged.update({f"r{rid}|{k}": v for k, v in frame.items()})
                merged[f"r{rid}|_pseq"] = np.asarray(
                    self._last_seqs.get(rid, -1), np.int64)
            merged["_lost"] = np.asarray(sorted(self.lost), np.int64)
            if self.joined:
                merged["_joined"] = np.asarray(sorted(self.joined),
                                               np.int64)
            for rid, ch in sorted(self.channels.items()):
                if rid in self.lost:
                    continue
                try:
                    ch.send(merged, timeout=self.round_timeout_s)
                except (TransportClosed, TransportTimeout):
                    self._mark_lost(rid, "broadcast_failed")
            self.rounds_served += 1
            sp.add(lost=len(self.lost))
        return merged

    def serve(self, total_rounds: int) -> None:
        """Relay ``total_rounds`` rounds, stopping early if every robot is
        gone (nothing left to serve — never hang on a dead fleet)."""
        for _ in range(total_rounds):
            if len(self.lost) == len(self.channels):
                break
            self.round()

    def totals(self) -> ChannelTotals:
        agg = ChannelTotals()
        for ch in self.channels.values():
            agg.add(ch.totals)
        return agg

    def close(self) -> None:
        """Emit one aggregated ``run_summary`` for the hub, close links."""
        run = obs.get_run()
        if run is not None:
            run.event("run_summary", phase="comms", channel="bus",
                      peers_lost=sorted(self.lost),
                      rounds_served=self.rounds_served,
                      **self.totals().as_dict())
        for ch in self.channels.values():
            ch.close(emit_summary=False)


# ---------------------------------------------------------------------------
# Robot side
# ---------------------------------------------------------------------------

class BusClient:
    """A robot's view of the bus: publish, collect, track lost peers.

    **Overlap mode** (``start_overlap``): a background exchange thread
    double-buffers the publish/collect round so the caller's compute (the
    RTR step) runs concurrently with the wire round.  ``exchange`` then
    submits round k's frame and returns the freshest broadcast already
    collected — typically round k-1's — blocking only when the number of
    in-flight exchanges would exceed the ``staleness`` bound.  RBCD's
    convergence is unchanged under bounded staleness (the RA-L 2020 async
    DPGO model), so ``staleness=1`` overlaps compute and comms for free;
    ``staleness=0`` (the default, no thread) is today's lockstep.  The
    overlap composes with the sequence-number/dropout machinery unchanged:
    publishes still ride the ``ReliableChannel`` (stamped ``_seq``), and
    the worker's ``collect`` keeps ``lost`` current.
    """

    def __init__(self, channel: ReliableChannel, robot_id: int):
        self.channel = channel
        self.robot_id = int(robot_id)
        if channel.origin is None:
            channel.origin = self.robot_id  # clock-domain identity
        self.lost: set[int] = set()
        #: Robots the hub admitted mid-run (the ``_joined`` broadcast key);
        #: the driver reacts by growing its agent's problem
        #: (``PGOAgent.admit_neighbor``) for joiners it has not seen.
        self.joined: set[int] = set()
        self.staleness = 0
        # Overlap state is shared between the caller's compute thread and
        # the exchange worker; everything below rides one condition.
        self._ov_cond = threading.Condition()
        self._ov_thread: threading.Thread | None = None
        self._ov_queue: list[dict] = []                # guarded-by: _ov_cond
        self._ov_merged: dict | None = None            # guarded-by: _ov_cond
        self._ov_submitted = 0                         # guarded-by: _ov_cond
        self._ov_done = 0                              # guarded-by: _ov_cond
        self._ov_stop = False                          # guarded-by: _ov_cond
        self._ov_error: Exception | None = None        # guarded-by: _ov_cond

    def hello(self, timeout: float | None = None) -> None:
        self.channel.send({"hello": np.asarray(self.robot_id, np.int64)},
                          timeout=timeout)

    def publish(self, frame: dict, timeout: float | None = None) -> int:
        sp = trace.start_span("publish", phase="comms",
                              robot=self.robot_id)
        if sp is None:
            return self.channel.send(frame, timeout=timeout)
        # The publish span's context rides the frame (both wire codecs,
        # ignored by untraced peers): receivers link their scatter spans
        # to it, which is what joins a round's publish -> exchange ->
        # scatter chain into one causal trace across robots.
        frame = dict(frame)
        frame.update(pack_trace_entries(sp.trace_id, sp.span_id,
                                        self.robot_id))
        try:
            n = self.channel.send(frame, timeout=timeout)
        except Exception:
            sp.end(ok=False)
            raise
        sp.end(bytes=n)
        return n

    def collect(self, timeout: float | None = None) -> dict | None:
        """The next broadcast, or None when the deadline passed (skip this
        round's updates and carry on — the bus caches our last frame).
        Raises ``TransportClosed`` when the bus itself is gone."""
        with trace.span("collect", phase="comms",
                        robot=self.robot_id) as sp:
            try:
                merged = self.channel.recv(timeout=timeout)
            except TransportTimeout:
                sp.add(got=False)
                return None
            sp.add(got=True)
        if "_lost" in merged:
            self.lost = {int(x) for x in np.asarray(merged["_lost"]).ravel()}
        if "_joined" in merged:
            self.joined = {int(x)
                           for x in np.asarray(merged["_joined"]).ravel()}
        return merged

    def exchange(self, frame: dict,
                 timeout: float | None = None) -> dict | None:
        """One round's publish + broadcast.  Lockstep when no overlap
        worker is running; with ``start_overlap`` the call returns the
        freshest collected broadcast within the staleness bound (possibly
        None before the first broadcast lands)."""
        if self._ov_thread is None:
            self.publish(frame, timeout=timeout)
            return self.collect(timeout=timeout)
        # The ONLY time the caller's compute thread blocks on the wire in
        # overlap mode is this staleness gate — its span duration is the
        # un-hidden remainder of the exchange, the number the overlap
        # efficiency report divides by the worker's wire_round time.
        with trace.span("exchange_wait", phase="comms",
                        robot=self.robot_id) as sp:
            with self._ov_cond:
                if self._ov_error is not None:
                    raise self._ov_error
                self._ov_queue.append(frame)
                self._ov_submitted += 1
                sp.add(in_flight=self._ov_submitted - self._ov_done)
                self._ov_cond.notify_all()
                while (self._ov_submitted - self._ov_done > self.staleness
                       and self._ov_error is None):
                    self._ov_cond.wait(timeout=1.0)
                if self._ov_error is not None:
                    raise self._ov_error
                return self._ov_merged

    # -- overlap worker -----------------------------------------------------

    def start_overlap(self, staleness: int = 1,
                      timeout: float | None = None) -> None:
        """Enable double-buffered exchange with the given staleness bound
        (max broadcast rounds the caller may run ahead of the wire;
        ``staleness=0`` keeps lockstep and starts no thread)."""
        if staleness <= 0 or self._ov_thread is not None:
            self.staleness = max(0, int(staleness))
            return
        self.staleness = int(staleness)
        run = obs.get_run()
        if run is not None:
            # Staleness is a convergence-relevant knob: stamp it into the
            # fingerprint so --compare refuses lockstep-vs-overlap deltas.
            run.set_fingerprint(staleness=self.staleness)
        with self._ov_cond:
            # A previous worker may have died on an error mid-run; reset
            # the shared flags under the lock it shares with exchange().
            self._ov_stop = False

        def run():
            while True:
                with self._ov_cond:
                    while not self._ov_queue and not self._ov_stop:
                        self._ov_cond.wait()
                    if self._ov_stop and not self._ov_queue:
                        return
                    frame = self._ov_queue.pop(0)
                merged = None
                err = None
                try:
                    # wire_round parents the publish/collect spans it
                    # drives (same thread) — the worker's whole round is
                    # one span, the hidden half of the overlap.
                    with trace.span("wire_round", phase="comms",
                                    robot=self.robot_id):
                        self.publish(frame, timeout=timeout)
                        merged = self.collect(timeout=timeout)
                except TransportClosed as e:
                    err = e
                except Exception as e:  # surfaced to the next exchange()
                    err = e
                with self._ov_cond:
                    self._ov_done += 1
                    if merged is not None:
                        self._ov_merged = merged
                    if err is not None:
                        self._ov_error = err
                    self._ov_cond.notify_all()
                    if err is not None:
                        return

        self._ov_thread = threading.Thread(
            target=run, name=f"bus-overlap-{self.robot_id}", daemon=True)
        self._ov_thread.start()

    def drain_overlap(self, timeout: float = 30.0) -> dict | None:
        """Block until every submitted exchange completed (the lockstep
        barrier at the end of an overlapped run); returns the last
        broadcast.  Raises the worker's pending error, if any."""
        if self._ov_thread is None:
            with self._ov_cond:
                return self._ov_merged
        end = time.monotonic() + timeout
        with trace.span("drain", phase="comms", robot=self.robot_id):
            with self._ov_cond:
                while self._ov_submitted > self._ov_done:
                    if self._ov_error is not None:
                        raise self._ov_error
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._ov_cond.wait(timeout=remaining)
                return self._ov_merged

    def stop_overlap(self) -> None:
        if self._ov_thread is None:
            return
        with self._ov_cond:
            self._ov_stop = True
            self._ov_cond.notify_all()
        self._ov_thread.join(timeout=10.0)
        self._ov_thread = None

    def peer_frames(self, merged: dict) -> dict[int, dict]:
        """Split a broadcast into per-peer sub-frames (self excluded)."""
        out: dict[int, dict] = {}
        for key, v in merged.items():
            if not key.startswith("r") or "|" not in key:
                continue
            rid_s, sub = key.split("|", 1)
            rid = int(rid_s[1:])
            if rid == self.robot_id:
                continue
            out.setdefault(rid, {})[sub] = v
        return out

    def close(self) -> None:
        self.stop_overlap()
        self.channel.close()


def loopback_fleet(num_robots: int, injector=None,
                   policy: RetryPolicy | None = None,
                   round_timeout_s: float = 2.0, miss_limit: int = 3,
                   liveness_timeout_s: float = 2.0,
                   wire_format: str = "packed"
                   ) -> tuple[RoundBus, dict[int, BusClient]]:
    """An in-process fleet: one ``LoopbackTransport`` pair per robot, the
    hub ends assembled into a ``RoundBus``, the robot ends into
    ``BusClient``s.  The chaos tests and the async example run on this —
    same framing, fault, retry, and dropout code paths as TCP, no
    sockets."""
    from .transport import LoopbackTransport

    channels: dict[int, ReliableChannel] = {}
    clients: dict[int, BusClient] = {}
    for rid in range(num_robots):
        t_bus, t_robot = LoopbackTransport.pair(
            "bus", f"robot{rid}", injector=injector,
            wire_format=wire_format)
        channels[rid] = ReliableChannel(t_bus, f"bus->robot{rid}", policy,
                                        origin=-1)
        clients[rid] = BusClient(
            ReliableChannel(t_robot, f"robot{rid}->bus", policy), rid)
    bus = RoundBus(channels, round_timeout_s=round_timeout_s,
                   miss_limit=miss_limit,
                   liveness_timeout_s=liveness_timeout_s)
    return bus, clients


# ---------------------------------------------------------------------------
# Agent frame vocabulary
# ---------------------------------------------------------------------------

def pack_agent_frame(agent, robust: bool = False,
                     include_anchor: bool = False,
                     wire_dtype: str = "f64",
                     packed: bool = True) -> dict:
    """One round's outgoing frame for a ``PGOAgent``: status gossip, public
    poses, owned GNC weights, and (robot 0) the global anchor.

    ``packed=True`` (default) ships the public poses as one columnar
    ``pose:r/pose:p/pose:x`` set (``wire_dtype`` selects f64/f32/bf16 on
    the wire); ``packed=False`` keeps the per-pose v1 keys for old peers.
    ``apply_peer_frame`` ingests either."""
    st = agent.get_status()
    frame = {"status": np.asarray(
        [st.robot_id, st.state.value, st.instance_number,
         st.iteration_number, int(st.ready_to_terminate)], np.int64),
        "relchange": np.asarray(st.relative_change, np.float64)}
    # Numerical-health gossip: anomaly counters detected locally
    # (obs.health via PGOAgent._obs_anomaly) ride the round frame so the
    # hub's report sees fleet-wide health.  Counters are only ever nonzero
    # when telemetry was on (detection is fenced), so the telemetry-off
    # wire is unchanged.
    anom = getattr(agent, "health_counters", lambda: (0, 0))()
    if anom[0]:
        frame["anom"] = np.asarray(anom, np.int64)
    if packed:
        pub = agent.get_public_pose_arrays()
        if pub is not None:
            frame.update(pack_pose_arrays("pose", *pub,
                                          wire_dtype=wire_dtype))
    else:
        frame.update(pack_pose_dict("pose", agent.get_shared_pose_dict()))
    if robust:
        frame.update({
            f"wt_{r1}_{p1}_{r2}_{p2}": np.asarray(w, np.float64)
            for ((r1, p1), (r2, p2)), w in
            agent.get_shared_weight_dict().items()})
    if include_anchor:
        anchor = agent.get_global_anchor()
        if anchor is not None:
            frame["anchor"] = np.asarray(anchor)
    return frame


def apply_peer_frame(agent, peer_id: int, pf: dict, robust: bool = False,
                     accept_anchor: bool = False) -> None:
    """Ingest one peer's sub-frame into a ``PGOAgent``: status, poses
    (sequence-checked via the bus's ``_pseq`` tag), weights, anchor.

    A trace context riding the sub-frame (the sender's publish span,
    rebroadcast under its ``r{id}|`` namespace) is popped uncondition-
    ally and, when telemetry is on, lands on this ingest's ``scatter``
    span as the ``link_*`` fields the timeline renders as a cross-robot
    flow arrow."""
    ctx = unpack_trace_entries(pf)  # popped even with telemetry off
    anom = pf.pop("anom", None)  # health gossip: popped even with obs off
    if anom is not None:
        run = obs.get_run()
        if run is not None:
            run.gauge("peer_anomalies_seen",
                      "anomaly count gossiped by each peer").set(
                float(np.asarray(anom)[0]), robot=agent.robot_id,
                peer=peer_id)
    sp = trace.start_span("scatter", phase="comms", robot=agent.robot_id,
                          link=ctx)
    try:
        _apply_peer_frame(agent, peer_id, pf, robust, accept_anchor)
    finally:
        if sp is not None:
            sp.end(peer=peer_id)


def _apply_peer_frame(agent, peer_id: int, pf: dict, robust: bool,
                      accept_anchor: bool) -> None:
    from ..agent import AgentState, PGOAgentStatus

    if "status" in pf:
        ps = np.asarray(pf["status"], np.int64)
        agent.set_neighbor_status(PGOAgentStatus(
            robot_id=int(ps[0]), state=AgentState(int(ps[1])),
            instance_number=int(ps[2]), iteration_number=int(ps[3]),
            ready_to_terminate=bool(ps[4]),
            relative_change=float(pf.get("relchange", np.inf))))
    seq = int(pf["_pseq"]) if "_pseq" in pf else None
    packed = unpack_pose_arrays(pf, "pose")
    if packed is not None:
        # Fast path: the columnar set feeds the agent's vectorized
        # neighbor-buffer scatter with no per-pose dict materialization.
        agent.update_neighbor_poses_packed(peer_id, *packed, sequence=seq)
    else:
        agent.update_neighbor_poses(peer_id, unpack_pose_set(pf, "pose"),
                                    sequence=seq)
    if robust:
        wd = {}
        for k, v in pf.items():
            if k.startswith("wt_"):
                _, r1, p1, r2, p2 = k.split("_")
                wd[((int(r1), int(p1)), (int(r2), int(p2)))] = float(v)
        if wd:
            agent.update_shared_weights(wd)
    if accept_anchor and "anchor" in pf:
        agent.set_global_anchor(pf["anchor"])

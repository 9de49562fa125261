"""The port's comms (``dpgo_tpu_torch.comms``): the cases of the JAX
package's ``tests/test_comms.py`` and ``tests/test_wire_format.py`` that
need no ``obs.report``, on the port's modules and agents (``device="cpu"``),
and wire compatibility with the JAX package: a frame packed by either
package is byte-identical to the other's, each decodes the other's frames,
and ``FaultInjector`` gives the same stream per link and seed."""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from dpgo_tpu_torch import obs
from dpgo_tpu_torch.agent import AgentState, PGOAgent
from dpgo_tpu_torch.comms import (BF16_REL_ERR, PACKED_MAGIC, FaultInjector,
                                  FaultSpec, LoopbackTransport,
                                  ProtocolError, ReliableChannel,
                                  RetryPolicy, TcpTransport, Transport,
                                  TransportClosed, TransportTimeout,
                                  apply_peer_frame, bf16_decode, bf16_encode,
                                  loopback_fleet, pack_agent_frame)
from dpgo_tpu_torch.comms.protocol import (HEADER, FrameAssembler,
                                           decode_payload,
                                           decode_payload_packed,
                                           encode_frame, encode_payload,
                                           pack_pose_dict, pack_pose_set,
                                           pose_payload_nbytes, recv_frame,
                                           send_frame, unpack_pose_arrays,
                                           unpack_pose_set)
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.obs import metrics as obs_metrics_mod
from dpgo_tpu_torch.obs import run as obs_run_mod
from dpgo_tpu_torch.obs.events import EventStream, read_events
from dpgo_tpu_torch.utils.partition import (agent_measurements,
                                            partition_contiguous)
from dpgo_tpu_torch.utils.synthetic import make_measurements

@pytest.fixture(autouse=True)
def _no_leaked_ambient_run():
    obs.end_run()
    yield
    obs.end_run()


FAST = RetryPolicy(max_attempts=3, base_delay_s=0.005, max_delay_s=0.02,
                   send_timeout_s=1.0, recv_timeout_s=1.0)


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------

def test_payload_roundtrip_and_corrupt_rejection():
    arrays = {"a": np.arange(5), "b": np.eye(3)}
    data = encode_payload(arrays)
    out = decode_payload(data)
    assert out["a"].tolist() == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(out["b"], np.eye(3))
    # Bit-flipped archives raise ProtocolError, not random zipfile errors.
    bad = bytearray(data)
    for k in (1, len(bad) // 2, len(bad) - 2):
        bad[k] ^= 0xFF
    with pytest.raises(ProtocolError):
        decode_payload(bytes(bad))


def test_frame_assembler_incremental_and_cap():
    fa = FrameAssembler(max_frame_bytes=1 << 20)
    frame = encode_frame({"x": np.arange(10)})
    # Byte-at-a-time feeding (a recv deadline can strike anywhere).
    got = []
    for i in range(len(frame)):
        got += fa.feed(frame[i:i + 1])
    (payload,) = got
    assert decode_payload(payload)["x"].tolist() == list(range(10))
    assert fa.pending_bytes == 0
    # Two frames in one read.
    assert len(fa.feed(frame + frame)) == 2
    # An absurd length header dies cleanly instead of allocating 2**60.
    with pytest.raises(ProtocolError, match="cap"):
        fa.feed(struct.pack("<Q", 1 << 60))


def test_recv_frame_rejects_oversized_header():
    """The satellite fix: a corrupt/malicious 8-byte length prefix must
    raise ProtocolError before any allocation is sized from it."""
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("<Q", 1 << 60) + b"junk")
        with pytest.raises(ProtocolError, match="cap"):
            recv_frame(b)
    finally:
        a.close()
        b.close()
    # Sane frames round-trip with the default cap (fresh stream — a raw
    # blocking socket has no reassembly to resynchronize after garbage;
    # that is TcpTransport's FrameAssembler job).
    a, b = socket.socketpair()
    try:
        send_frame(a, {"v": np.asarray([7.0])})
        assert recv_frame(b)["v"].tolist() == [7.0]
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# Fault injector
# ---------------------------------------------------------------------------

def test_fault_injector_is_deterministic_per_link():
    spec = FaultSpec(drop=0.3, delay=0.2, delay_s=(0.01, 0.02),
                     corrupt=0.1)
    data = b"x" * 64

    def decisions(seed):
        inj = FaultInjector(spec, seed=seed)
        return [tuple((d, bytes(p)) for d, p in inj.apply("a", "b", data))
                for _ in range(200)]

    assert decisions(7) == decisions(7)
    assert decisions(7) != decisions(8)
    # Per-link independence: interleaving another link's traffic does not
    # shift this link's stream.
    inj1, inj2 = FaultInjector(spec, seed=7), FaultInjector(spec, seed=7)
    out1 = [inj1.apply("a", "b", data) for _ in range(50)]
    out2 = []
    for _ in range(50):
        inj2.apply("c", "d", data)
        out2.append(inj2.apply("a", "b", data))
    assert [[(d, bytes(p)) for d, p in o] for o in out1] == \
        [[(d, bytes(p)) for d, p in o] for o in out2]


def test_fault_injector_modes():
    # Drop everything.
    inj = FaultInjector(FaultSpec(drop=1.0), seed=0)
    assert inj.apply("a", "b", b"data") == []
    assert inj.stats["dropped"] == 1
    # Partition: a<->b cut, a<->c free.
    inj = FaultInjector(FaultSpec(partitions=(("a",),)), seed=0)
    assert inj.apply("a", "b", b"d") == []
    assert inj.partitioned("b", "a")
    assert not inj.partitioned("b", "c")
    # Reorder: first held, released behind the second (newer first).
    inj = FaultInjector(FaultSpec(reorder=1.0), seed=0)
    assert inj.apply("a", "b", b"one") == []
    out = inj.apply("a", "b", b"two")
    assert [p for _, p in out] == [b"two", b"one"]
    # Disabled: pure passthrough regardless of spec.
    inj = FaultInjector(FaultSpec(drop=1.0), seed=0)
    inj.enabled = False
    assert inj.apply("a", "b", b"d") == [(0.0, b"d")]


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

def test_loopback_transport_deadline_and_close():
    a, b = LoopbackTransport.pair()
    a.send({"v": np.asarray(1)})
    assert int(b.recv(timeout=1.0)["v"]) == 1
    t0 = time.monotonic()
    with pytest.raises(TransportTimeout):
        b.recv(timeout=0.05)
    assert time.monotonic() - t0 < 1.0
    a.close()
    with pytest.raises(TransportClosed):
        b.recv(timeout=1.0)


def test_loopback_delay_fault_delivers_late():
    inj = FaultInjector(FaultSpec(delay=1.0, delay_s=(0.08, 0.1)), seed=0)
    a, b = LoopbackTransport.pair(injector=inj)
    a.send({"v": np.asarray(1)})
    with pytest.raises(TransportTimeout):
        b.recv(timeout=0.01)  # not there yet
    assert int(b.recv(timeout=1.0)["v"]) == 1  # arrives once due


def _tcp_pair(**kw):
    a, b = socket.socketpair()
    return TcpTransport(a, src="a", dst="b", **kw), \
        TcpTransport(b, src="b", dst="a", **kw)


def test_tcp_transport_roundtrip_deadline_resume_and_close():
    ta, tb = _tcp_pair()
    try:
        ta.send({"v": np.arange(4)})
        assert tb.recv(timeout=1.0)["v"].tolist() == [0, 1, 2, 3]
        # Deadline strikes mid-frame: the partial bytes stay buffered and
        # the next recv resumes the same frame — no stream desync.
        frame = encode_frame({"w": np.arange(8)})
        ta._sock.sendall(HEADER.pack(len(frame) - HEADER.size))
        ta._sock.sendall(frame[HEADER.size:HEADER.size + 5])
        with pytest.raises(TransportTimeout):
            tb.recv(timeout=0.05)
        ta._sock.sendall(frame[HEADER.size + 5:])
        assert tb.recv(timeout=1.0)["w"].tolist() == list(range(8))
        ta.close()
        with pytest.raises(TransportClosed):
            tb.recv(timeout=1.0)
    finally:
        ta.close()
        tb.close()


def test_tcp_transport_oversized_header_raises():
    ta, tb = _tcp_pair(max_frame_bytes=1024)
    try:
        ta._sock.sendall(struct.pack("<Q", 1 << 40))
        with pytest.raises(ProtocolError, match="cap"):
            tb.recv(timeout=1.0)
        with pytest.raises(ProtocolError, match="cap"):
            ta.send({"big": np.zeros(4096)})  # send-side cap too
    finally:
        ta.close()
        tb.close()


# ---------------------------------------------------------------------------
# Reliable channel
# ---------------------------------------------------------------------------

class _FlakySendTransport(Transport):
    """Times out the first ``fails`` sends, then succeeds."""

    def __init__(self, fails):
        super().__init__("a", "b")
        self.fails = fails
        self.sent = []

    def send(self, arrays, timeout=None):
        if self.fails:
            self.fails -= 1
            raise TransportTimeout("injected")
        self.sent.append(arrays)
        return 1

    def recv(self, timeout=None):
        raise TransportTimeout("nothing")

    def close(self):
        pass


def test_send_retries_with_backoff_then_succeeds():
    ch = ReliableChannel(_FlakySendTransport(2), "flaky", FAST)
    ch.send({"v": np.asarray(1)})
    assert len(ch.transport.sent) == 1
    assert ch.totals.retries == 2
    assert ch.totals.timeouts == 2
    assert ch.totals.messages_sent == 1


def test_send_gives_up_after_max_attempts():
    ch = ReliableChannel(_FlakySendTransport(99), "dead", FAST)
    with pytest.raises(TransportTimeout):
        ch.send({"v": np.asarray(1)})
    assert ch.totals.retries == FAST.max_attempts - 1
    assert ch.totals.messages_sent == 0


def _channel_pair(injector=None, policy=FAST):
    a, b = LoopbackTransport.pair(injector=injector)
    return ReliableChannel(a, "a->b", policy), \
        ReliableChannel(b, "b->a", policy)


def test_sequence_numbers_drop_stale_and_reordered():
    inj = FaultInjector(FaultSpec(reorder=1.0), seed=0)
    ca, cb = _channel_pair(injector=inj)
    ca.send({"i": np.asarray(1)})  # held by the injector
    ca.send({"i": np.asarray(2)})  # released as [2, then 1]
    assert int(cb.recv(timeout=1.0)["i"]) == 2
    with pytest.raises(TransportTimeout):
        cb.recv(timeout=0.05)  # the late 1 was dropped as stale
    assert cb.totals.stale_dropped == 1
    assert cb.last_recv_seq == 1  # channel seq of the frame carrying i=2


def test_corrupt_frames_are_counted_and_skipped():
    inj = FaultInjector(FaultSpec(corrupt=1.0), seed=0)
    ca, cb = _channel_pair(injector=inj)
    ca.send({"i": np.asarray(1)})
    inj.enabled = False
    ca.send({"i": np.asarray(2)})
    assert int(cb.recv(timeout=1.0)["i"]) == 2
    assert cb.totals.corrupt_dropped == 1


def test_heartbeat_liveness():
    ca, cb = _channel_pair()
    assert cb.last_seen_age() is None
    ca.start_heartbeat(0.02)
    deadline = time.monotonic() + 2.0
    while cb.last_seen_age() is None and time.monotonic() < deadline:
        with pytest.raises(TransportTimeout):
            cb.recv(timeout=0.05)
    age = cb.last_seen_age()
    assert age is not None and age < 1.0
    assert cb.totals.heartbeats_received >= 1
    ca.close()
    cb.close()


def test_run_summary_and_counters_with_telemetry_on(tmp_path):
    inj = FaultInjector(FaultSpec(reorder=1.0), seed=0)
    with obs.run_scope(str(tmp_path / "run")) as run:
        ca, cb = _channel_pair(injector=inj)
        ca.send({"i": np.asarray(1)})
        ca.send({"i": np.asarray(2)})
        cb.recv(timeout=1.0)
        with pytest.raises(TransportTimeout):
            cb.recv(timeout=0.05)
        snap_counter = run.registry.counter("comms_stale_dropped").value(
            channel="b->a")
        ca.close()
        cb.close()
    evs = read_events(str(tmp_path / "run" / "events.jsonl"))
    summaries = {e["channel"]: e for e in evs
                 if e["event"] == "run_summary"
                 and e.get("channel") != "config"}  # fingerprint rides too
    assert set(summaries) == {"a->b", "b->a"}
    # The transport stamped its wire format into the config fingerprint.
    configs = [e for e in evs if e.get("channel") == "config"]
    assert configs and configs[-1]["fingerprint"]["wire_format"]
    assert summaries["a->b"]["messages_sent"] == 2
    assert summaries["b->a"]["messages_received"] == 1
    assert summaries["b->a"]["stale_dropped"] == 1
    assert summaries["b->a"]["timeouts"] == 1
    assert snap_counter == 1


# ---------------------------------------------------------------------------
# Round bus + graceful dropout
# ---------------------------------------------------------------------------

def _fleet(n=3, **kw):
    kw.setdefault("policy", FAST)
    kw.setdefault("round_timeout_s", 0.2)
    kw.setdefault("liveness_timeout_s", 0.15)
    return loopback_fleet(n, **kw)


def test_round_bus_merges_and_broadcasts():
    bus, clients = _fleet(3)
    for rid, c in clients.items():
        c.publish({"v": np.asarray(rid * 10)})
    merged = bus.round()
    assert {k for k in merged if k.endswith("|v")} == \
        {"r0|v", "r1|v", "r2|v"}
    for rid, c in clients.items():
        got = c.collect(timeout=1.0)
        peers = c.peer_frames(got)
        assert set(peers) == {0, 1, 2} - {rid}
        for p, pf in peers.items():
            assert int(pf["v"]) == p * 10
            assert int(pf["_pseq"]) >= 0
    assert bus.lost == set()
    bus.close()


def test_round_bus_detects_closed_robot_and_continues():
    bus, clients = _fleet(3)
    for c in clients.values():
        c.publish({"v": np.asarray(1)})
    bus.round()
    clients[1].close()  # robot 1 dies
    for rid in (0, 2):
        clients[rid].collect(timeout=1.0)
        clients[rid].publish({"v": np.asarray(2)})
    bus.round()
    assert bus.lost == {1}
    for rid in (0, 2):
        merged = clients[rid].collect(timeout=1.0)
        assert merged is not None
        assert clients[rid].lost == {1}
        assert not any(k.startswith("r1|") for k in merged)
    bus.close()


def test_round_bus_declares_silent_robot_lost_by_heartbeat():
    bus, clients = _fleet(2, miss_limit=2)
    clients[0].channel.start_heartbeat(0.02)  # robot 0 stays alive, mute-ish
    for c in clients.values():
        c.publish({"v": np.asarray(1)})
    bus.round()
    # Robot 1 goes silent WITHOUT closing: no frames, no heartbeat.  Robot 0
    # keeps publishing.  After miss_limit rounds with a stale heartbeat the
    # bus declares robot 1 lost; robot 0 (fresh heartbeat) is kept even when
    # its *data* frames miss a round.
    for _ in range(3):
        clients[0].collect(timeout=1.0)
        clients[0].publish({"v": np.asarray(2)})
        bus.round()
        if bus.lost:
            break
    assert bus.lost == {1}
    clients[0].collect(timeout=1.0)
    assert clients[0].lost == {1}
    bus.close()


def test_bus_serve_stops_when_everyone_is_gone():
    bus, clients = _fleet(2, round_timeout_s=0.05)
    for c in clients.values():
        c.close()
    t0 = time.monotonic()
    bus.serve(10_000)  # must return promptly, not spin 10k timeouts
    assert time.monotonic() - t0 < 5.0
    assert bus.lost == {0, 1}
    bus.close()


def test_bus_emits_peer_lost_event_and_aggregated_summary(tmp_path):
    with obs.run_scope(str(tmp_path / "run")):
        bus, clients = _fleet(2)
        for c in clients.values():
            c.publish({"v": np.asarray(1)})
        bus.round()
        clients[1].close()
        clients[0].collect(timeout=1.0)
        clients[0].publish({"v": np.asarray(2)})
        bus.round()
        bus.close()
        clients[0].close()
    evs = read_events(str(tmp_path / "run" / "events.jsonl"))
    (lost_ev,) = [e for e in evs if e["event"] == "peer_lost"]
    assert lost_ev["peer"] == 1 and lost_ev["reason"] == "closed"
    (bus_summary,) = [e for e in evs if e["event"] == "run_summary"
                      and e["channel"] == "bus"]
    assert bus_summary["peers_lost"] == [1]
    assert bus_summary["rounds_served"] == 2
    assert bus_summary["messages_received"] >= 3


def test_comms_telemetry_off_emits_zero_obs_events(monkeypatch):
    """Same fence-throw pattern as PR 1: with no ambient run, a faulty
    exchange — retries, stale drops, corrupt drops, a dead peer, channel
    close — must emit ZERO events, make ZERO registry calls, and perform
    ZERO obs-owned transfers.  Plain-int ChannelTotals still count."""

    def boom(*a, **kw):
        raise AssertionError("telemetry path taken while disabled")

    monkeypatch.setattr(EventStream, "emit", boom)
    monkeypatch.setattr(obs_run_mod, "materialize", boom)
    monkeypatch.setattr(obs, "materialize", boom)
    monkeypatch.setattr(obs_metrics_mod.Counter, "inc", boom)
    monkeypatch.setattr(obs_metrics_mod.Gauge, "set", boom)
    monkeypatch.setattr(obs_metrics_mod.Histogram, "observe", boom)
    monkeypatch.setattr(obs_metrics_mod.Histogram, "observe_many", boom)

    assert obs.get_run() is None
    inj = FaultInjector(FaultSpec(reorder=1.0, corrupt=0.2), seed=3)
    bus, clients = _fleet(3, injector=inj)
    for _ in range(4):
        for c in clients.values():
            c.publish({"v": np.asarray(1)})
        bus.round()
        for c in clients.values():
            c.collect(timeout=0.3)
    clients[2].close()
    for rid in (0, 1):
        clients[rid].publish({"v": np.asarray(2)})
    bus.round()
    assert bus.lost == {2}
    bus.close()
    for c in clients.values():
        c.close()
    # The always-on accounting still worked.
    totals = bus.totals()
    assert totals.messages_received > 0
    # Retry path too.
    ch = ReliableChannel(_FlakySendTransport(1), "flaky", FAST)
    ch.send({"v": np.asarray(1)})
    assert ch.totals.retries == 1
    ch.close()


def test_transport_frame_cap_constructor_validation():
    """The frame-size cap is a constructor knob on every transport (the
    serving front-end threads --max-frame-mb through it); a non-positive
    cap is a configuration error, caught at construction."""
    a, b = LoopbackTransport.pair(max_frame_bytes=512)
    try:
        assert a.max_frame_bytes == b.max_frame_bytes == 512
        with pytest.raises(ProtocolError, match="cap"):
            a.send({"big": np.zeros(4096)})
        a.send({"ok": np.zeros(4)})  # link still usable under the cap
        assert "ok" in b.recv(timeout=5)
    finally:
        a.close()
        b.close()
    with pytest.raises(ValueError, match="positive"):
        LoopbackTransport.pair(max_frame_bytes=0)
    with pytest.raises(ValueError, match="positive"):
        LoopbackTransport.pair(max_frame_bytes=-1)


def test_round_bus_admits_joiner_mid_run_and_broadcasts_joined(tmp_path):
    """The join handshake: a robot admitted mid-run via ``admit_hello``
    shows up in the relay from the next round, every client learns about
    it through the cumulative ``_joined`` broadcast key, and the hub emits
    a ``peer_joined`` event."""
    from dpgo_tpu_torch.comms import BusClient

    with obs.run_scope(str(tmp_path / "join")):
        bus, clients = _fleet(2)
        for rid, c in clients.items():
            c.publish({"v": np.asarray(rid)})
        merged = bus.round()
        assert "_joined" not in merged  # nothing joined yet
        for c in clients.values():
            c.collect(timeout=1.0)

        t_bus, t_robot = LoopbackTransport.pair("bus", "robot2")
        hub_ch = ReliableChannel(t_bus, origin=-1)
        joiner = BusClient(ReliableChannel(t_robot, "robot2->bus", FAST), 2)
        joiner.hello()
        assert bus.admit_hello(hub_ch, timeout=1.0) == 2
        assert bus.joined == set()  # effective at the next round

        for rid, c in clients.items():
            c.publish({"v": np.asarray(rid)})
        joiner.publish({"v": np.asarray(2)})
        merged = bus.round()
        assert bus.joined == {2}
        assert "r2|v" in merged
        assert list(np.asarray(merged["_joined"])) == [2]
        for rid, c in clients.items():
            got = c.collect(timeout=1.0)
            assert c.joined == {2}
            assert set(c.peer_frames(got)) == {0, 1, 2} - {rid}
        got = joiner.collect(timeout=1.0)
        assert set(joiner.peer_frames(got)) == {0, 1}

        evs_dir = str(tmp_path / "join" / "events.jsonl")
        bus.close()
        for c in clients.values():
            c.close()
        joiner.close()
    evs = read_events(evs_dir)
    assert any(e["event"] == "peer_joined" and e.get("peer") == 2
               for e in evs)


def test_round_bus_readmission_revives_lost_robot():
    """Re-admitting a robot the hub declared lost clears its lost state
    and resumes gathering from it (the partition-heal rejoin path)."""
    bus, clients = _fleet(2)
    for rid, c in clients.items():
        c.publish({"v": np.asarray(rid)})
    bus.round()
    clients[1].close()
    clients[0].publish({"v": np.asarray(0)})
    bus.round()
    assert bus.lost == {1}

    from dpgo_tpu_torch.comms import BusClient

    t_bus, t_robot = LoopbackTransport.pair("bus", "robot1")
    revived = BusClient(ReliableChannel(t_robot, "robot1->bus", FAST), 1)
    bus.admit(1, ReliableChannel(t_bus, origin=-1))
    clients[0].publish({"v": np.asarray(0)})
    revived.publish({"v": np.asarray(111)})
    merged = bus.round()
    assert bus.lost == set()
    assert int(np.asarray(merged["r1|v"])) == 111
    assert "_joined" in merged and list(np.asarray(merged["_joined"])) == [1]
    bus.close()
    clients[0].close()
    revived.close()


# ---------------------------------------------------------------------------
# connect_tcp: jittered-backoff dial budget (ISSUE 17)
# ---------------------------------------------------------------------------

def _unbound_port():
    """A port that was just free — nothing listens on it."""
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def test_connect_tcp_retries_until_listener_binds():
    """The out-of-process spawn race: the child's listener binds AFTER
    the parent starts dialing; the backoff budget must absorb it."""
    import threading

    from dpgo_tpu_torch.comms.transport import connect_tcp

    port = _unbound_port()
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    accepted = []

    def late_bind():
        time.sleep(0.25)
        srv.bind(("127.0.0.1", port))
        srv.listen(1)
        srv.settimeout(10)  # a dial that never comes fails, never hangs
        conn, _ = srv.accept()
        accepted.append(conn)

    t = threading.Thread(target=late_bind)
    t.start()
    try:
        sock = connect_tcp("127.0.0.1", port,
                           policy=RetryPolicy(base_delay_s=0.05,
                                              max_delay_s=0.2))
        sock.close()
    finally:
        t.join(timeout=10)
        for c in accepted:
            c.close()
        srv.close()
    assert accepted, "the late-bound listener never saw the dial"


def test_connect_tcp_exhausted_budget_raises_structured_error():
    from dpgo_tpu_torch.comms.transport import ConnectError, connect_tcp

    port = _unbound_port()
    with pytest.raises(ConnectError) as ei:
        connect_tcp("127.0.0.1", port, attempts=3,
                    policy=RetryPolicy(base_delay_s=0.005,
                                       max_delay_s=0.02))
    e = ei.value
    assert isinstance(e, ConnectionError)  # callers catching the base see it
    assert e.host == "127.0.0.1" and e.port == port
    assert e.attempts == 3 and e.elapsed_s >= 0.0
    assert "3 connect attempts" in str(e)
    assert isinstance(e.__cause__, ConnectionError)


def test_connect_tcp_backoff_grows_exponentially_with_jitter(monkeypatch):
    from dpgo_tpu_torch.comms import transport as transport_mod
    from dpgo_tpu_torch.comms.transport import ConnectError, connect_tcp

    delays = []
    monkeypatch.setattr(transport_mod.time, "sleep",
                        lambda s: delays.append(s))
    with pytest.raises(ConnectError):
        connect_tcp("127.0.0.1", _unbound_port(), attempts=4,
                    policy=RetryPolicy(base_delay_s=0.1, max_delay_s=10.0,
                                       jitter=0.5),
                    rng=np.random.default_rng(0))
    # No sleep after the final (failed) attempt.
    assert len(delays) == 3
    for d, base in zip(delays, (0.1, 0.2, 0.4)):
        assert base <= d <= base * 1.5  # doubled base, bounded jitter


def _vocab_frame():
    """A frame exercising every dtype the agent vocabulary ships."""
    rng = np.random.default_rng(0)
    return {
        "_seq": np.asarray(7, np.int64),
        "_kind": np.asarray("data"),
        "status": np.arange(5, dtype=np.int64),
        "relchange": np.asarray(0.25),
        "pose:r": np.zeros(3, np.int32),
        "pose:p": np.arange(3, dtype=np.int32),
        "pose:x": rng.standard_normal((3, 5, 4)),
        "anchor": rng.standard_normal((5, 4)).astype(np.float32),
        "_lost": np.zeros(0, np.int64),
        "flag": np.asarray(True),
    }


# ---------------------------------------------------------------------------
# Packed codec
# ---------------------------------------------------------------------------

def test_packed_roundtrip_matches_npz():
    frame = _vocab_frame()
    packed = decode_payload(encode_payload(frame, "packed"))
    npz = decode_payload(encode_payload(frame, "npz"))
    assert set(packed) == set(npz) == set(frame)
    for k in frame:
        np.testing.assert_array_equal(np.asarray(packed[k]),
                                      np.asarray(npz[k]))
        assert np.asarray(packed[k]).dtype == np.asarray(frame[k]).dtype
        assert np.asarray(packed[k]).shape == np.asarray(frame[k]).shape


def test_packed_is_smaller_than_npz_on_pose_frames():
    rng = np.random.default_rng(1)
    pose_dict = {(0, p): rng.standard_normal((5, 4)) for p in range(40)}
    v2 = encode_payload(pack_pose_set("pose", pose_dict), "packed")
    v1 = encode_payload(pack_pose_dict("pose", pose_dict), "npz")
    # The acceptance bar is >= 2x fewer wire bytes per round in f32; the
    # f64 payload alone already clears 2x (npz zip members cost ~hundreds
    # of bytes per pose block).
    assert len(v1) / len(v2) >= 2.0


def test_packed_corruption_and_truncation_raise_protocol_error():
    data = encode_payload(_vocab_frame(), "packed")
    assert data[:4] == PACKED_MAGIC
    # Bit flips anywhere in the body fail the CRC.
    for pos in (5, len(data) // 2, len(data) - 3):
        bad = bytearray(data)
        bad[pos] ^= 0xFF
        with pytest.raises(ProtocolError):
            decode_payload(bytes(bad))
    # Truncation at every region boundary dies cleanly.
    for cut in (2, 6, 11, len(data) // 2, len(data) - 1):
        with pytest.raises(ProtocolError):
            decode_payload_packed(data[:cut])
    # An entry header lying about its size is caught before allocation.
    with pytest.raises(ProtocolError):
        decode_payload_packed(PACKED_MAGIC + struct.pack("<II", 0, 5))


def test_decode_sniffs_format_both_ways():
    """Old/new peer interop: one receiver decodes both encodings."""
    frame = {"v": np.arange(4.0)}
    for fmt in ("packed", "npz"):
        out = decode_payload(encode_payload(frame, fmt))
        np.testing.assert_array_equal(out["v"], frame["v"])
    with pytest.raises(ValueError):
        encode_payload(frame, "protobuf")


def test_mixed_wire_transport_pair_interoperates():
    """A packed sender and an npz sender share one link: each end decodes
    whatever arrives (the rolling-upgrade scenario)."""
    a, b = LoopbackTransport.pair(wire_format="packed")
    b.wire_format = "npz"  # old peer: still sends v1
    a.send({"v": np.asarray(1)})
    assert int(b.recv(timeout=1.0)["v"]) == 1
    b.send({"v": np.asarray(2)})
    assert int(a.recv(timeout=1.0)["v"]) == 2


# ---------------------------------------------------------------------------
# bf16 wire dtype
# ---------------------------------------------------------------------------

def test_bf16_roundtrip_parity_bound():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(4096) * np.exp(rng.uniform(-8, 8, 4096))
    rt = bf16_decode(bf16_encode(x))
    rel = np.abs(rt - x) / np.abs(x)
    assert rel.max() <= BF16_REL_ERR
    # Exact values representable in bf16 survive unchanged.
    exact = np.asarray([0.0, 1.0, -2.0, 0.5, 384.0])
    np.testing.assert_array_equal(bf16_decode(bf16_encode(exact)), exact)


def test_bf16_pose_set_halves_f32_bytes_and_accumulates_f64():
    rng = np.random.default_rng(3)
    pose_dict = {(1, p): rng.standard_normal((5, 4)) for p in range(8)}
    f32 = pack_pose_set("pose", pose_dict, wire_dtype="f32")
    b16 = pack_pose_set("pose", pose_dict, wire_dtype="bf16")
    assert pose_payload_nbytes(b16, "pose") < pose_payload_nbytes(f32, "pose")
    assert b16["pose:xb"].dtype == np.uint16
    robots, poses, vals = unpack_pose_arrays(b16, "pose")
    assert vals.dtype == np.float64  # f32-widened, f64-accumulated
    for i, (r, p) in enumerate(zip(robots, poses)):
        ref = pose_dict[(int(r), int(p))]
        rel = np.abs(vals[i] - ref) / np.maximum(np.abs(ref), 1e-12)
        assert rel.max() <= BF16_REL_ERR + 1e-7


# ---------------------------------------------------------------------------
# Pose vocabulary equivalence
# ---------------------------------------------------------------------------

def test_pose_set_roundtrip_matches_v1_dict():
    rng = np.random.default_rng(4)
    pose_dict = {(2, 11): rng.standard_normal((5, 4)),
                 (0, 3): rng.standard_normal((5, 4))}
    via_v2 = unpack_pose_set(
        decode_payload(encode_payload(pack_pose_set("pose", pose_dict))),
        "pose")
    via_v1 = unpack_pose_set(
        decode_payload(encode_payload(pack_pose_dict("pose", pose_dict),
                                      "npz")), "pose")
    assert set(via_v2) == set(via_v1) == set(pose_dict)
    for k in pose_dict:
        np.testing.assert_allclose(via_v2[k], pose_dict[k])
        np.testing.assert_allclose(via_v1[k], pose_dict[k])
    assert pack_pose_set("pose", {}) == {}
    assert unpack_pose_arrays({"other": np.zeros(1)}, "pose") is None


# ---------------------------------------------------------------------------
# Agent neighbor buffer: vectorized scatter vs the dict path (golden graph)
# ---------------------------------------------------------------------------

def _golden_agents(num_robots=3, n=18, num_lc=12, seed=0):
    rng = np.random.default_rng(seed)
    meas, _ = make_measurements(rng, n=n, d=3, num_lc=num_lc,
                                rot_noise=0.005, trans_noise=0.005)
    part = partition_contiguous(meas, num_robots)
    params = AgentParams(d=3, r=5, num_robots=num_robots)
    agents = [PGOAgent(a, params, device="cpu") for a in range(num_robots)]
    for ag in agents[1:]:
        ag.set_lifting_matrix(agents[0].get_lifting_matrix())
    for ag in agents:
        ag.set_pose_graph(*agent_measurements(part, ag.robot_id))
    return agents


def test_packed_scatter_matches_dict_path_on_golden_graph():
    """The same neighbor poses delivered (a) as per-pose dicts and (b) as
    packed index/value arrays must produce identical neighbor buffers,
    identical initialization, and identical iterates."""
    agents_a = _golden_agents()
    agents_b = _golden_agents()
    for _ in range(3):
        dicts = [ag.get_shared_pose_dict() for ag in agents_a]
        for src in range(len(agents_a)):
            for dst in range(len(agents_a)):
                if src == dst:
                    continue
                # Arm A: v1 dict vocabulary.
                agents_a[dst].update_neighbor_poses(src, dicts[src])
                # Arm B: packed arrays of the SAME payload (an
                # uninitialized sender publishes an empty set).
                keys = list(dicts[src])
                robots = np.asarray([k[0] for k in keys], np.int64)
                poses = np.asarray([k[1] for k in keys], np.int64)
                vals = np.stack([dicts[src][k] for k in keys]) if keys \
                    else np.zeros((0, 5, 4))
                agents_b[dst].update_neighbor_poses_packed(
                    src, robots, poses, vals)
            st = agents_a[src].get_status()
            for dst in range(len(agents_a)):
                if src != dst:
                    agents_a[dst].set_neighbor_status(st)
                    agents_b[dst].set_neighbor_status(
                        agents_b[src].get_status())
        for ag_a, ag_b in zip(agents_a, agents_b):
            ag_a.iterate(True)
            ag_b.iterate(True)
    for ag_a, ag_b in zip(agents_a, agents_b):
        assert ag_a.get_status().state == AgentState.INITIALIZED
        assert ag_b.get_status().state == AgentState.INITIALIZED
        za = ag_a._neighbor_buffer()
        zb = ag_b._neighbor_buffer()
        assert za is not None and zb is not None
        np.testing.assert_array_equal(np.asarray(za), np.asarray(zb))
        np.testing.assert_allclose(ag_a.X, ag_b.X, atol=1e-12)
        # The dict-compat view agrees with the buffer.
        for key, blk in ag_a._neighbor_poses.items():
            np.testing.assert_array_equal(ag_b._nbr_lookup(key), blk)


def test_scatter_ignores_unknown_keys_and_partial_frames():
    agents = _golden_agents()
    ag = agents[0]
    s_before = ag._nbr_have.copy()
    # Keys this agent never references scatter to nothing.
    ag.update_neighbor_poses_packed(
        1, np.asarray([1, 9]), np.asarray([997, 998]),
        np.zeros((2, 5, 4)))
    np.testing.assert_array_equal(ag._nbr_have, s_before)
    # A partial frame fills only its slots; the buffer is still incomplete.
    (key, slot) = next(iter(ag._nbr_slot.items()))
    ag.update_neighbor_poses_packed(
        key[0], np.asarray([key[0]]), np.asarray([key[1]]),
        np.full((1, 5, 4), 3.25))
    assert ag._nbr_have[slot]
    if not ag._nbr_have.all():
        assert ag._neighbor_buffer() is None
    np.testing.assert_array_equal(ag._nbr_lookup(key),
                                  np.full((5, 4), 3.25))


def test_public_pose_arrays_match_shared_pose_dict():
    agents = _golden_agents()
    for ag in agents:
        if ag.get_status().state != AgentState.INITIALIZED:
            continue
        pub = ag.get_public_pose_arrays()
        d = ag.get_shared_pose_dict()
        assert pub is not None
        robots, poses, vals = pub
        assert robots.dtype == np.int32 and poses.dtype == np.int32
        assert len(robots) == len(d)
        for i, (r, p) in enumerate(zip(robots, poses)):
            np.testing.assert_array_equal(vals[i], d[(int(r), int(p))])
    # Uninitialized agents return None (nothing to publish).
    fresh = PGOAgent(1, AgentParams(d=3, r=5, num_robots=2), device="cpu")
    assert fresh.get_public_pose_arrays() is None


def test_packed_agent_frame_roundtrip_equivalent_to_v1():
    """pack_agent_frame(packed) -> wire -> apply_peer_frame lands the same
    state as the v1 frame, including sequence-stamped stale drops."""
    agents_a = _golden_agents(seed=5)
    agents_b = _golden_agents(seed=5)
    src_a, dst_a = agents_a[0], agents_a[1]
    src_b, dst_b = agents_b[0], agents_b[1]
    for packed, (src, dst) in ((False, (src_a, dst_a)),
                               (True, (src_b, dst_b))):
        frame = pack_agent_frame(src, include_anchor=True, packed=packed)
        wire = decode_payload(encode_payload(frame))
        wire["_pseq"] = np.asarray(4, np.int64)
        dst.set_neighbor_status(src.get_status())
        apply_peer_frame(dst, 0, wire, accept_anchor=True)
    assert dst_a.get_status().state == dst_b.get_status().state
    za, zb = dst_a._neighbor_poses, dst_b._neighbor_poses
    assert set(za) == set(zb) and len(za) > 0
    for k in za:
        np.testing.assert_array_equal(za[k], zb[k])
    # Stale packed frame (same sequence) must not roll the cache back.
    frame = pack_agent_frame(src_b, packed=True)
    wire = decode_payload(encode_payload(frame))
    wire["pose:x"] = np.zeros_like(wire["pose:x"])
    wire["_pseq"] = np.asarray(4, np.int64)
    apply_peer_frame(dst_b, 0, wire)
    for k in zb:
        np.testing.assert_array_equal(dst_b._neighbor_poses[k], zb[k])


# ---------------------------------------------------------------------------
# Overlapped bus client
# ---------------------------------------------------------------------------

def test_overlap_client_bounded_staleness_and_drain():
    bus, clients = loopback_fleet(2, policy=FAST, round_timeout_s=1.0)
    stop = threading.Event()

    def bus_loop():
        while not stop.is_set():
            bus.round()

    t = threading.Thread(target=bus_loop, daemon=True)
    t.start()
    try:
        for c in clients.values():
            c.start_overlap(staleness=1, timeout=1.0)

        def robot(rid, log):
            c = clients[rid]
            for it in range(6):
                merged = c.exchange({"v": np.asarray(it)}, timeout=1.0)
                lag = c._ov_submitted - c._ov_done
                assert lag <= 1 + 1  # bound: staleness + the one in flight
                log.append(merged)
            c.drain_overlap(timeout=10.0)

        logs = [[], []]
        rts = [threading.Thread(target=robot, args=(r, logs[r]))
               for r in range(2)]
        for rt in rts:
            rt.start()
        for rt in rts:
            rt.join(timeout=30)
        for rid in (0, 1):
            # After draining, every submitted exchange completed.
            assert clients[rid]._ov_submitted == clients[rid]._ov_done
            # The final broadcast carries the peer's late-round value.
            final = clients[rid].drain_overlap()
            peer = 1 - rid
            assert final is not None
            assert int(final[f"r{peer}|v"]) >= 3
    finally:
        stop.set()
        for c in clients.values():
            c.close()
        bus.close()
        t.join(timeout=5)


def test_overlap_staleness_zero_is_lockstep():
    bus, clients = loopback_fleet(2, policy=FAST, round_timeout_s=1.0)
    for c in clients.values():
        c.start_overlap(staleness=0)  # no thread: exchange == lockstep
        assert c._ov_thread is None
    for c in clients.values():
        c.publish({"v": np.asarray(1)})
    bus.round()
    for c in clients.values():
        got = c.collect(timeout=1.0)
        assert got is not None
    bus.close()
    for c in clients.values():
        c.close()


def test_overlap_surfaces_transport_closed():
    from dpgo_tpu_torch.comms import TransportClosed

    bus, clients = loopback_fleet(1, policy=FAST, round_timeout_s=0.3)
    c = clients[0]
    c.start_overlap(staleness=1, timeout=0.3)
    bus.close()  # the hub dies
    with pytest.raises(TransportClosed):
        for _ in range(50):
            c.exchange({"v": np.asarray(0)}, timeout=0.3)
            time.sleep(0.01)
    c.close()


# ---------------------------------------------------------------------------
# Wire compatibility with the JAX package
# ---------------------------------------------------------------------------

def _jax_comms():
    from dpgo_tpu.comms import protocol as jproto
    from dpgo_tpu.comms import faults as jfaults
    return jproto, jfaults


def test_frames_byte_identical_to_jax():
    """The same arrays packed by the port and by the JAX package give the
    same bytes in the packed v2 format (framing, CRC, packed pose
    vocabulary, protocol magic).  The v1 npz archive carries zip member
    timestamps, so its frames are compared decoded (next test)."""
    from dpgo_tpu_torch.comms import protocol as tproto

    jproto, _ = _jax_comms()
    rng = np.random.default_rng(3)
    frame = _vocab_frame()
    robots = np.full(4, 2, np.int32)
    poses = np.arange(4, dtype=np.int32)
    vals = rng.standard_normal((4, 5, 4))
    for wd in ("f64", "f32", "bf16"):
        frame.update({f"{k}.{wd}": v for k, v in tproto.pack_pose_arrays(
            "pose", robots, poses, vals, wire_dtype=wd).items()})
        jf = jproto.pack_pose_arrays("pose", robots, poses, vals,
                                     wire_dtype=wd)
        tf = tproto.pack_pose_arrays("pose", robots, poses, vals,
                                     wire_dtype=wd)
        assert jf.keys() == tf.keys()
        for k in jf:
            assert np.asarray(jf[k]).dtype == np.asarray(tf[k]).dtype
            assert np.array_equal(np.asarray(jf[k]), np.asarray(tf[k]))
    frame.update(tproto.pack_trace_entries(11, 12, 2))
    assert tproto.encode_frame(frame) == jproto.encode_frame(frame)
    assert tproto.encode_payload(frame) == jproto.encode_payload(frame)
    assert tproto.PACKED_MAGIC == jproto.PACKED_MAGIC
    assert tproto.HEADER.format == jproto.HEADER.format


@pytest.mark.parametrize("wire_format", ["packed", "npz"])
def test_each_package_decodes_the_others_frames(wire_format):
    from dpgo_tpu_torch.comms import protocol as tproto

    jproto, _ = _jax_comms()
    frame = _vocab_frame()
    for enc, dec in ((tproto, jproto), (jproto, tproto)):
        payload = enc.encode_payload(frame, wire_format)
        fa = dec.FrameAssembler()
        (got,) = fa.feed(enc.encode_frame(frame, wire_format))
        for out in (dec.decode_payload(payload), dec.decode_payload(got)):
            assert out.keys() == frame.keys()
            for k, v in frame.items():
                assert np.asarray(out[k]).dtype == np.asarray(v).dtype, k
                assert np.array_equal(np.asarray(out[k]), np.asarray(v)), k


def test_agent_frames_byte_identical_to_jax():
    """``pack_agent_frame`` of a port agent and of a JAX agent in the same
    state (the port agent loaded from the JAX one through ``interop``)
    encode to the same bytes, and each package's ``apply_peer_frame``
    ingests the other's frame into the same neighbor cache."""
    from dpgo_tpu.agent import PGOAgent as JAgent
    from dpgo_tpu.comms import apply_peer_frame as j_apply
    from dpgo_tpu.comms import pack_agent_frame as j_pack
    from dpgo_tpu.comms.protocol import encode_frame as j_encode
    from dpgo_tpu.comms.protocol import encode_payload as j_payload
    from dpgo_tpu.config import AgentParams as JParams
    from dpgo_tpu.utils.partition import agent_measurements as j_am
    from dpgo_tpu.utils.partition import partition_contiguous as j_pc
    from dpgo_tpu.utils.synthetic import make_measurements as j_mm
    from dpgo_tpu_torch import interop
    from dpgo_tpu_torch.comms.protocol import encode_frame

    rng = np.random.default_rng(0)
    jmeas, _ = j_mm(rng, n=18, d=3, num_lc=12, rot_noise=0.005,
                    trans_noise=0.005)
    jpart = j_pc(jmeas, 3)
    jparams = JParams(d=3, r=5, num_robots=3)
    jag = [JAgent(a, jparams) for a in range(3)]
    for ag in jag[1:]:
        ag.set_lifting_matrix(jag[0].get_lifting_matrix())
    for ag in jag:
        ag.set_pose_graph(*j_am(jpart, ag.robot_id))
    tag = _golden_agents()
    for ja, ta in zip(jag, tag):
        interop.agent_state_from_numpy(ta, interop.agent_state_to_numpy(ja))
    for wd in ("f64", "bf16"):
        jf = j_pack(jag[0], include_anchor=True, wire_dtype=wd)
        tf = pack_agent_frame(tag[0], include_anchor=True, wire_dtype=wd)
        assert encode_frame(tf) == j_encode(jf)
    # Cross-ingest: a JAX frame into a port agent and vice versa.
    wire_j = decode_payload(j_payload(j_pack(jag[0], include_anchor=True)))
    wire_t = decode_payload(encode_payload(pack_agent_frame(tag[0])))
    apply_peer_frame(tag[1], 0, dict(wire_j), accept_anchor=True)
    j_apply(jag[2], 0, dict(wire_t))
    apply_peer_frame(tag[2], 0, dict(wire_t))
    assert tag[1].get_status().state == AgentState.INITIALIZED
    for key, blk in tag[2]._neighbor_poses.items():
        np.testing.assert_array_equal(jag[2]._nbr_lookup(key), blk)
    np.testing.assert_array_equal(tag[1].get_global_anchor(),
                                  np.asarray(jag[0].get_global_anchor()))


def test_fault_injector_stream_matches_jax():
    """Per link and seed the port's injector drops, delays, reorders and
    corrupts exactly as the JAX package's does."""
    _, jfaults = _jax_comms()
    spec_kw = dict(drop=0.2, delay=0.3, delay_s=(0.01, 0.03), reorder=0.1,
                   corrupt=0.1)
    data = bytes(range(64))

    def stream(mod, seed):
        inj = mod.FaultInjector(mod.FaultSpec(**spec_kw), seed=seed)
        out = []
        for k in range(150):
            link = ("robot0", "bus") if k % 3 else ("bus", "robot1")
            out.append([(d, bytes(p)) for d, p in inj.apply(*link, data)])
        return out, dict(inj.stats)

    from dpgo_tpu_torch.comms import faults as tfaults
    for seed in (0, 7):
        assert stream(tfaults, seed) == stream(jfaults, seed)

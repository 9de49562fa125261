"""The ``Transport`` abstraction and its two shipped implementations.

A transport moves one npz array-dict frame at a time between two endpoints,
with an optional recv/send deadline and an optional ``FaultInjector`` on
the send side.  It is deliberately dumb: no retries, no sequence numbers,
no liveness — that is ``reliable.ReliableChannel``'s job, layered on top of
any transport.

* ``LoopbackTransport`` — an in-process pair over delay-aware inboxes
  (condition variables, no sockets).  This is what the chaos tests and the
  in-process async example run on: deterministic, fast, and it exercises
  the exact same framing/fault/retry code paths as TCP because frames are
  encoded to bytes even in-process (so corruption faults and the frame cap
  behave identically).
* ``TcpTransport`` — length-prefixed npz over a connected socket (the wire
  code previously living inside ``examples/tcp_deployment_example.py``).
  Receives are ``select``-based so a deadline never touches the socket
  timeout state shared with a concurrently sending heartbeat thread, and a
  deadline that strikes mid-frame leaves the partial bytes buffered in the
  ``FrameAssembler`` — the next recv resumes the same frame.

Error vocabulary: ``TransportTimeout`` (deadline expired — retryable),
``TransportClosed`` (endpoint or peer gone — not retryable),
``ProtocolError`` (this frame is bad; the link may still be fine).

The PyTorch port's copy of ``dpgo_tpu.comms.transport``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import heapq
import itertools
import select
import socket
import threading
import time

from .. import obs
from .faults import FaultInjector
from .protocol import (DEFAULT_MAX_FRAME_BYTES, HEADER, FrameAssembler,
                       ProtocolError, decode_payload, encode_payload)


class TransportError(ConnectionError):
    """Base class for transport failures."""


class TransportClosed(TransportError):
    """This endpoint or its peer is gone; no more frames will flow."""


class TransportTimeout(TimeoutError):
    """The per-message deadline expired before a frame arrived/was sent."""


class Transport:
    """One endpoint of a bidirectional frame link.

    ``wire_format`` selects the OUTGOING payload encoding: ``"packed"``
    (default, the v2 zero-copy columnar codec) or ``"npz"`` (the v1
    archive, kept so a new robot can keep speaking v1 to an old bus).
    Receives always auto-detect the format off the payload magic, so
    mixed-version fleets interoperate.

    ``max_frame_bytes`` bounds frames in BOTH directions (default 64 MiB):
    an outgoing frame over the cap, or an incoming length header claiming
    more, raises ``ProtocolError`` before any buffer is sized from it.
    The serving front-end threads its ``--max-frame-mb`` flag through
    here, so one knob governs problem-upload and result-download sizing.
    """

    def __init__(self, src="", dst="",
                 injector: FaultInjector | None = None,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 wire_format: str = "packed"):
        self.src = src
        self.dst = dst
        self.injector = injector
        if int(max_frame_bytes) <= 0:
            raise ValueError(
                f"max_frame_bytes must be positive, got {max_frame_bytes}")
        self.max_frame_bytes = int(max_frame_bytes)
        self.wire_format = wire_format
        run = obs.get_run()
        if run is not None:
            # Wire identity into the run fingerprint: a v1-npz and a
            # packed-wire run of the same deployment are not comparable
            # runs for the convergence regression gate.
            run.set_fingerprint(wire_format=wire_format)

    def send(self, arrays: dict, timeout: float | None = None) -> int:
        """Send one frame; returns wire bytes of the *intended* frame (what
        the network then does to it is the injector's business)."""
        raise NotImplementedError

    def recv(self, timeout: float | None = None) -> dict:
        """Receive one frame; raises ``TransportTimeout`` at the deadline,
        ``TransportClosed`` when the link is gone, ``ProtocolError`` for a
        corrupt frame (link still usable)."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    # -- shared helpers -----------------------------------------------------

    def _encode_checked(self, arrays: dict) -> bytes:
        data = encode_payload(arrays, self.wire_format)
        if len(data) > self.max_frame_bytes:
            raise ProtocolError(
                f"outgoing frame ({len(data)} bytes) exceeds the "
                f"{self.max_frame_bytes}-byte cap")
        return data

    def _deliveries(self, data: bytes) -> list[tuple[float, bytes]]:
        if self.injector is None:
            return [(0.0, data)]
        return self.injector.apply(self.src, self.dst, data)


# ---------------------------------------------------------------------------
# In-process loopback
# ---------------------------------------------------------------------------

class _Inbox:
    """Delay-aware mailbox: entries become visible at their deliver time."""

    def __init__(self):
        self._cond = threading.Condition()
        self._heap: list[tuple[float, int, bytes]] = []
        self._tie = itertools.count()
        self.closed = False

    def put(self, deliver_time: float, data: bytes) -> None:
        with self._cond:
            if self.closed:
                return  # receiver is gone; the network drops the frame
            heapq.heappush(self._heap, (deliver_time, next(self._tie), data))
            self._cond.notify_all()

    def get(self, timeout: float | None) -> bytes:
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                now = time.monotonic()
                if self._heap and self._heap[0][0] <= now:
                    return heapq.heappop(self._heap)[2]
                if self.closed:
                    raise TransportClosed("loopback peer closed")
                waits = []
                if self._heap:
                    waits.append(self._heap[0][0] - now)
                if end is not None:
                    if now >= end:
                        raise TransportTimeout("loopback recv deadline")
                    waits.append(end - now)
                self._cond.wait(min(waits) if waits else None)

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()


class LoopbackTransport(Transport):
    """One endpoint of an in-process pair (see ``LoopbackTransport.pair``)."""

    def __init__(self, src, dst, inbox: _Inbox, peer_inbox: _Inbox,
                 injector: FaultInjector | None = None,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 wire_format: str = "packed"):
        super().__init__(src, dst, injector, max_frame_bytes, wire_format)
        self._inbox = inbox
        self._peer_inbox = peer_inbox
        self._closed = False

    @classmethod
    def pair(cls, a="a", b="b", injector: FaultInjector | None = None,
             max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
             wire_format: str = "packed"
             ) -> tuple["LoopbackTransport", "LoopbackTransport"]:
        """Two connected endpoints; ``a``/``b`` name the ends for the
        injector's per-link RNG streams and partition groups."""
        ia, ib = _Inbox(), _Inbox()
        return (cls(a, b, ia, ib, injector, max_frame_bytes, wire_format),
                cls(b, a, ib, ia, injector, max_frame_bytes, wire_format))

    def send(self, arrays: dict, timeout: float | None = None) -> int:
        if self._closed:
            raise TransportClosed("transport closed")
        data = self._encode_checked(arrays)
        now = time.monotonic()
        for delay, d in self._deliveries(data):
            self._peer_inbox.put(now + delay, d)
        return HEADER.size + len(data)

    def recv(self, timeout: float | None = None) -> dict:
        if self._closed:
            raise TransportClosed("transport closed")
        return decode_payload(self._inbox.get(timeout))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.injector is not None:
            # A frame held for reordering still reaches the peer.
            now = time.monotonic()
            for delay, d in self.injector.flush(self.src, self.dst):
                self._peer_inbox.put(now + delay, d)
        self._inbox.close()
        self._peer_inbox.close()


# ---------------------------------------------------------------------------
# TCP
# ---------------------------------------------------------------------------

class TcpTransport(Transport):
    """Length-prefixed npz frames over a connected socket."""

    def __init__(self, sock: socket.socket, src="", dst="",
                 injector: FaultInjector | None = None,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 wire_format: str = "packed"):
        super().__init__(src, dst, injector, max_frame_bytes, wire_format)
        self._sock = sock
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # AF_UNIX socketpair (tests) has no Nagle to disable
        self._send_lock = threading.Lock()
        self._assembler = FrameAssembler(max_frame_bytes)
        self._ready: list[bytes] = []
        self._timers: list[threading.Timer] = []
        self._closed = False

    def _raw_send(self, data: bytes, swallow: bool = False) -> None:
        try:
            with self._send_lock:
                self._sock.sendall(HEADER.pack(len(data)) + data)
        except OSError as e:
            if swallow:
                return  # delayed frame into a dead link: the network ate it
            raise TransportClosed(f"send failed: {e}") from e

    def send(self, arrays: dict, timeout: float | None = None) -> int:
        if self._closed:
            raise TransportClosed("transport closed")
        data = self._encode_checked(arrays)
        if timeout is not None:
            _, wlist, _ = select.select([], [self._sock], [], timeout)
            if not wlist:
                raise TransportTimeout("send buffer full past deadline")
        for delay, d in self._deliveries(data):
            if delay > 0:
                t = threading.Timer(delay, self._raw_send, args=(d, True))
                t.daemon = True
                t.start()
                self._timers = [x for x in self._timers if x.is_alive()]
                self._timers.append(t)
            else:
                self._raw_send(d)
        return HEADER.size + len(data)

    def recv(self, timeout: float | None = None) -> dict:
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._ready:
                return decode_payload(self._ready.pop(0))
            if self._closed:
                raise TransportClosed("transport closed")
            remaining = None
            if end is not None:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    raise TransportTimeout("recv deadline")
            try:
                rlist, _, _ = select.select([self._sock], [], [], remaining)
            except (OSError, ValueError) as e:
                raise TransportClosed(f"socket gone: {e}") from e
            if not rlist:
                raise TransportTimeout("recv deadline")
            try:
                chunk = self._sock.recv(1 << 16)
            except OSError as e:
                raise TransportClosed(f"recv failed: {e}") from e
            if not chunk:
                raise TransportClosed("peer closed")
            # May raise ProtocolError (oversized header) — the caller's
            # fault layer decides whether the link is salvageable.
            self._ready.extend(self._assembler.feed(chunk))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for t in self._timers:
            t.cancel()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


def listen_tcp(host: str = "127.0.0.1", port: int = 0) -> socket.socket:
    """Bind and listen; bind FIRST (port 0 = OS-assigned), then hand the
    resolved port to whoever needs it — no pick-then-rebind TOCTOU race."""
    return socket.create_server((host, port))


class ConnectError(ConnectionError):
    """Structured connect failure: the retry budget ran out.

    Carries the dial target and the budget actually spent so callers
    (fleet respawn loops, CI harnesses) can log/decide without parsing
    the message.  ``__cause__`` is the last socket-level error."""

    def __init__(self, host: str, port: int, attempts: int,
                 elapsed_s: float):
        super().__init__(
            f"could not reach {host}:{port} after {attempts} connect "
            f"attempts over {elapsed_s:.2f}s")
        self.host = host
        self.port = int(port)
        self.attempts = int(attempts)
        self.elapsed_s = float(elapsed_s)


#: Dial-retry budget: more attempts than ``RetryPolicy``'s send default
#: (a listener that is still binding is the EXPECTED cold-start case,
#: not a fault), same base/cap/jitter constants.  Total worst-case wait
#: ~= 5-8s depending on jitter draws.
CONNECT_ATTEMPTS = 9


def connect_tcp(host: str, port: int, attempts: int | None = None,
                policy=None, rng=None) -> socket.socket:
    """Dial with bounded connect retries (the listener may not be up yet).

    Backoff is ``reliable.RetryPolicy``'s exponential-plus-jitter
    schedule — the same constants the send-retry path uses — instead of
    a fixed poll interval, so a thundering herd of replicas dialing one
    freshly spawned peer decorrelates.  Raises ``ConnectError`` (a
    ``ConnectionError``) once the budget is spent."""
    from .reliable import RetryPolicy  # lazy: reliable layers on transport

    policy = RetryPolicy() if policy is None else policy
    attempts = CONNECT_ATTEMPTS if attempts is None else int(attempts)
    if rng is None:
        import numpy as np

        rng = np.random.default_rng()
    t0 = time.monotonic()
    last: Exception | None = None
    for attempt in range(attempts):
        try:
            sock = socket.create_connection((host, port))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock
        except (ConnectionRefusedError, ConnectionResetError,
                TimeoutError) as e:
            last = e
            if attempt + 1 < attempts:
                time.sleep(policy.backoff_s(attempt, rng))
    raise ConnectError(host, port, attempts,
                       time.monotonic() - t0) from last

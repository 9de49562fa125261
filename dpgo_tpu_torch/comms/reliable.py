"""``ReliableChannel``: the fault-tolerance layer over any ``Transport``.

What it adds on top of a raw transport:

* **Deadlines** — every send/recv carries a timeout (per-call override or
  the ``RetryPolicy`` default); a silent peer costs a bounded wait, never a
  hang.
* **Bounded retry with exponential backoff + jitter** — sends that time
  out are retried up to ``max_attempts`` with ``base * 2^k`` sleeps,
  jittered so a fleet of robots retrying in lockstep doesn't synchronize.
* **Sequence numbers** — every outgoing frame is stamped with a monotonic
  ``_seq``; the receiver drops frames at or below the highest sequence
  already seen (stale, reordered, or duplicated by the network), so a
  delayed pose frame can never roll an agent's neighbor cache backwards.
* **Corrupt-frame rejection** — ``ProtocolError`` frames are counted and
  skipped; the recv deadline bounds how long a poisoned stream is drained.
* **Heartbeats** — an optional background thread sends tiny ``_kind="hb"``
  frames; any valid incoming frame refreshes ``last_seen_age()``, giving
  the caller (the bus, the launcher) a liveness signal that distinguishes
  a slow peer from a dead one.

Every failure is visible: plain-int ``ChannelTotals`` always count (they
feed the terminal ``run_summary`` event), and when a ``dpgo_tpu_torch.obs`` run
is ambient the channel also records ``comms_retries`` /
``comms_timeouts`` / ``comms_stale_dropped`` / ``comms_corrupt_dropped``
counters — behind the same ``get_run() is None`` early exit as every other
instrumented hot path, so telemetry off adds zero obs work.

The PyTorch port's copy of ``dpgo_tpu.comms.reliable``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib

import numpy as np

from .. import obs
from ..obs import trace
from .protocol import CLOCK_KEY, ProtocolError
from .transport import Transport, TransportClosed, TransportTimeout

_RESERVED = ("_seq", "_kind", CLOCK_KEY)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Send retry and default-deadline knobs."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.5                  # multiplicative jitter fraction
    send_timeout_s: float | None = 5.0   # per-attempt send deadline
    recv_timeout_s: float | None = 5.0   # default recv deadline

    def backoff_s(self, attempt: int, rng: np.random.Generator) -> float:
        base = min(self.max_delay_s, self.base_delay_s * (2.0 ** attempt))
        return base * (1.0 + self.jitter * float(rng.uniform()))


@dataclasses.dataclass
class ChannelTotals:
    """Always-on plain-int accounting (fed to the ``run_summary`` event)."""

    messages_sent: int = 0
    messages_received: int = 0
    bytes_sent: int = 0
    bytes_received: int = 0
    retries: int = 0
    timeouts: int = 0
    stale_dropped: int = 0
    corrupt_dropped: int = 0
    heartbeats_sent: int = 0
    heartbeats_received: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def add(self, other: "ChannelTotals") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


class ReliableChannel:
    """One fault-tolerant endpoint over a ``Transport``."""

    def __init__(self, transport: Transport, name: str = "",
                 policy: RetryPolicy | None = None,
                 origin: int | None = None):
        self.transport = transport
        self.name = name or f"{transport.src}->{transport.dst}"
        self.policy = policy or RetryPolicy()
        # Clock-domain identity stamped on outgoing frames when telemetry
        # is on: the sending robot's id, -1 for the bus hub, None =
        # unknown (stamped as -2; timeline skips such samples).
        self.origin = origin
        self.totals = ChannelTotals()
        self._send_lock = threading.Lock()
        self._seq = 0
        self._last_seq = -1          # highest sequence accepted from peer
        self.last_recv_seq = -1      # sequence of the last returned frame
        self._last_seen: float | None = None
        self._rng = np.random.default_rng(zlib.crc32(self.name.encode()))
        self._hb_stop: threading.Event | None = None
        self._hb_thread: threading.Thread | None = None
        self._closed = False

    # -- obs (zero work when no run is ambient) -----------------------------

    def _obs_inc(self, counter: str, help_: str, n: int = 1) -> None:
        run = obs.get_run()
        if run is None:
            return
        run.counter(counter, help_).inc(n, channel=self.name)

    # -- send ---------------------------------------------------------------

    def send(self, arrays: dict, timeout: float | None = None,
             kind: str = "data", retry: bool = True) -> int:
        """Send one frame with the retry policy; returns wire bytes of the
        successful attempt.  Raises ``TransportTimeout`` when every attempt
        timed out, ``TransportClosed`` when the link is gone (not retried —
        a closed peer does not come back on backoff)."""
        if timeout is None:
            timeout = self.policy.send_timeout_s
        with self._send_lock:
            seq = self._seq
            self._seq += 1
        frame = dict(arrays)
        frame["_seq"] = np.asarray(seq, np.int64)
        frame["_kind"] = np.asarray(kind)
        run = obs.get_run()
        t0_mono = t0_wall = 0.0
        if run is not None:
            t0_mono, t0_wall = time.monotonic(), time.time()
        attempts = self.policy.max_attempts if retry else 1
        for attempt in range(attempts):
            if run is not None:
                # Clock stamp, refreshed per attempt so the receiver's
                # clock_sample pairs the bytes that actually arrived.
                origin = -2 if self.origin is None else int(self.origin)
                frame[CLOCK_KEY] = np.asarray(
                    [float(origin), time.monotonic(), time.time()],
                    np.float64)
            try:
                n = self.transport.send(frame, timeout=timeout)
            except TransportTimeout:
                self.totals.timeouts += 1
                self._obs_inc("comms_timeouts",
                              "send/recv deadline expirations")
                if attempt + 1 >= attempts:
                    if run is not None and kind != "hb":
                        trace.emit_span(
                            run, "send_failed", t0_mono, t0_wall,
                            time.monotonic() - t0_mono, phase="comms",
                            robot=self.origin, channel=self.name,
                            attempts=attempt + 1)
                    raise
                self.totals.retries += 1
                self._obs_inc("comms_retries", "frame send retries")
                time.sleep(self.policy.backoff_s(attempt, self._rng))
                continue
            if kind == "hb":
                self.totals.heartbeats_sent += 1
            else:
                self.totals.messages_sent += 1
                self.totals.bytes_sent += n
            if run is not None and attempt > 0 and kind != "hb":
                # Only retried sends earn a span: the wire round itself is
                # already covered by the bus client's publish span, and a
                # clean send would double the event volume for nothing.
                trace.emit_span(run, "send_retry", t0_mono, t0_wall,
                                time.monotonic() - t0_mono, phase="comms",
                                robot=self.origin, channel=self.name,
                                attempts=attempt + 1, bytes=n)
            return n
        raise AssertionError("unreachable")

    # -- recv ---------------------------------------------------------------

    def recv(self, timeout: float | None = None) -> dict:
        """Receive the next *fresh data* frame (heartbeats refresh liveness
        and are consumed; stale/corrupt frames are counted and skipped).
        Raises ``TransportTimeout`` at the deadline."""
        return self._recv(timeout, count_timeout=True)

    def poll(self) -> dict | None:
        """Non-blocking recv: the freshest immediately-available data frame,
        or None.  Used by the bus to drain a link back to the present after
        delay faults put it behind."""
        try:
            return self._recv(0.0, count_timeout=False)
        except TransportTimeout:
            return None

    def _recv(self, timeout: float | None, count_timeout: bool) -> dict:
        if timeout is None:
            timeout = self.policy.recv_timeout_s
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if end is None else end - time.monotonic()
            try:
                frame = self.transport.recv(
                    timeout=remaining if remaining is None
                    else max(0.0, remaining))
            except ProtocolError:
                self.totals.corrupt_dropped += 1
                self._obs_inc("comms_corrupt_dropped",
                              "frames dropped as undecodable")
                continue
            except TransportTimeout:
                if count_timeout:
                    self.totals.timeouts += 1
                    self._obs_inc("comms_timeouts",
                                  "send/recv deadline expirations")
                raise
            self._last_seen = time.monotonic()
            kind = str(frame.pop("_kind")) if "_kind" in frame else "data"
            seq = int(frame.pop("_seq")) if "_seq" in frame else None
            # The sender's clock stamp is popped unconditionally (a traced
            # peer may be talking to an untraced one) but only becomes a
            # clock_sample event when telemetry is on locally.
            ts = frame.pop(CLOCK_KEY, None)
            if ts is not None:
                run = obs.get_run()
                if run is not None:
                    try:
                        src = int(np.asarray(ts).ravel()[0])
                        if src != -2:
                            run.event(
                                "clock_sample", phase="comms", src=src,
                                dst=(-2 if self.origin is None
                                     else int(self.origin)),
                                channel=self.name, kind=kind,
                                t_send_mono=float(np.asarray(ts)[1]),
                                t_send_wall=float(np.asarray(ts)[2]))
                    except (ValueError, IndexError, TypeError):
                        pass  # mangled stamp: tracing never breaks data
            if kind == "hb":
                self.totals.heartbeats_received += 1
                continue
            if seq is not None:
                if seq <= self._last_seq:
                    self.totals.stale_dropped += 1
                    self._obs_inc("comms_stale_dropped",
                                  "frames dropped as stale/reordered")
                    continue
                self._last_seq = seq
                self.last_recv_seq = seq
            self.totals.messages_received += 1
            self.totals.bytes_received += sum(
                np.asarray(v).nbytes for v in frame.values())
            return frame

    # -- liveness -----------------------------------------------------------

    def start_heartbeat(self, interval_s: float = 0.25) -> None:
        """Background liveness beacon; safe alongside concurrent sends
        (the transport serializes frame writes)."""
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        stop = threading.Event()
        self._hb_stop = stop

        def run():
            while not stop.wait(interval_s):
                try:
                    self.send({}, timeout=interval_s, kind="hb", retry=False)
                except TransportTimeout:
                    continue
                except (TransportClosed, ProtocolError, OSError):
                    return

        self._hb_thread = threading.Thread(
            target=run, name=f"comms-hb-{self.name}", daemon=True)
        self._hb_thread.start()

    def last_seen_age(self) -> float | None:
        """Seconds since the last valid frame (heartbeats count), or None
        when nothing has ever arrived."""
        if self._last_seen is None:
            return None
        return time.monotonic() - self._last_seen

    # -- lifecycle ----------------------------------------------------------

    def close(self, emit_summary: bool = True) -> None:
        """Stop heartbeating, emit the terminal ``run_summary`` obs event
        (when a run is ambient), close the transport.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        if emit_summary:
            run = obs.get_run()
            if run is not None:
                run.event("run_summary", phase="comms", channel=self.name,
                          **self.totals.as_dict())
        self.transport.close()

    @property
    def closed(self) -> bool:
        return self._closed

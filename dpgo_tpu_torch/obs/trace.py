"""Lightweight distributed spans for the deployment plane.

A *span* is one timed unit of work — an ``iterate`` step, a ``publish``,
the blocking part of an overlapped exchange — emitted through the run's
existing ``EventStream`` as a single ``span`` event at close:

``{"event": "span", "name", "phase", "robot", "trace", "span",
"parent"?, "t0_mono", "t0_wall", "dur_s", "link_*"?, **counters}``

Ids are random 63-bit integers rendered as 16-hex-digit strings.  Spans
nest through a thread-local stack (``with span(...)``): a span opened
inside another on the same thread inherits its trace id and records it as
``parent`` — the overlap worker's ``wire_round`` span parents the
``publish``/``collect`` it drives, and the per-thread stacks keep an
agent's optimization thread and its comms thread from cross-linking.

Cross-process causality does NOT ride the thread-local state: a publish
span's context (trace id, span id, sender robot, send time) is packed
into the outgoing frame as an optional wire entry
(``comms.protocol.pack_trace_entries``), survives the bus rebroadcast
under the sender's ``r{id}|`` namespace, and lands on the receiver's
``scatter`` span as ``link_*`` fields.  ``obs.timeline`` turns those
links into Chrome trace *flow* arrows from the sender's publish to the
receiver's ingest — a round's publish→exchange→scatter→step chain becomes
one causal edge set across robots.

Zero-overhead fence: every entry point resolves ``get_run()`` first and
returns the no-op ``NULL_SPAN`` (or emits nothing) when telemetry is off
— the same contract as the rest of ``dpgo_tpu_torch.obs``
(``tests/test_obs.py::test_telemetry_off_is_zero_overhead`` patches
``Span.__init__`` and ``emit_span`` to throw and drives the instrumented
paths with telemetry off).

The PyTorch port's copy of ``dpgo_tpu.obs.trace``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import os
import struct
import threading
import time

from .run import get_run

__all__ = [
    "NULL_SPAN",
    "Span",
    "current_span",
    "emit_span",
    "link_fields",
    "new_id",
    "span",
    "start_span",
]


def new_id() -> int:
    """A random non-zero 63-bit id (fits int64 on the wire)."""
    (v,) = struct.unpack("<Q", os.urandom(8))
    return (v >> 1) or 1


def _hex(i: int) -> str:
    return f"{int(i):016x}"


_tls = threading.local()


def current_span() -> "Span | None":
    """The innermost ``with span(...)`` on THIS thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def link_fields(ctx) -> dict:
    """``link_*`` span fields from a wire trace context tuple
    ``(trace_id, span_id, robot, t_mono, t_wall)`` (the shape
    ``comms.protocol.unpack_trace_entries`` returns)."""
    trace_id, span_id, robot, t_mono, t_wall = ctx
    return {"link_trace": _hex(trace_id), "link_span": _hex(span_id),
            "link_robot": int(robot), "link_t_mono": float(t_mono),
            "link_t_wall": float(t_wall)}


class Span:
    """One open span; emits its ``span`` event exactly once on ``end()``.

    Constructed ONLY behind a ``get_run() is not None`` guard (use
    ``span()`` / ``start_span()``) — construction is the telemetry-on
    path by definition, which is what makes the zero-overhead test's
    ``Span.__init__``-throws patch a complete fence."""

    __slots__ = ("run", "name", "phase", "robot", "trace_id", "span_id",
                 "parent_id", "t0_mono", "t0_wall", "_counters", "_link",
                 "_ended")

    def __init__(self, run, name: str, phase: str | None = None,
                 robot: int | None = None, trace_id: int | None = None,
                 parent_id: int | None = None, link=None):
        self.run = run
        self.name = str(name)
        self.phase = phase
        self.robot = robot
        self.span_id = new_id()
        parent = current_span()
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None else new_id()
        if parent_id is None and parent is not None:
            parent_id = parent.span_id
        self.trace_id = int(trace_id)
        self.parent_id = parent_id
        self._link = link
        self._counters: dict = {}
        self._ended = False
        self.t0_mono = time.monotonic()
        self.t0_wall = time.time()

    def add(self, **counters) -> "Span":
        """Attach counters; they ride the close event."""
        self._counters.update(counters)
        return self

    def end(self, **counters) -> None:
        if self._ended:
            return
        self._ended = True
        if counters:
            self._counters.update(counters)
        fields = {"name": self.name, "trace": _hex(self.trace_id),
                  "span": _hex(self.span_id), "t0_mono": self.t0_mono,
                  "t0_wall": self.t0_wall,
                  "dur_s": time.monotonic() - self.t0_mono}
        if self.robot is not None:
            fields["robot"] = int(self.robot)
        if self.parent_id:
            fields["parent"] = _hex(self.parent_id)
        if self._link is not None:
            fields.update(link_fields(self._link))
        fields.update(self._counters)
        self.run.events.emit("span", phase=self.phase, **fields)

    # -- context manager (pushes onto the thread-local parent stack) --------

    def __enter__(self) -> "Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        self.end(error=repr(exc)) if exc is not None else self.end()
        return False


class _NullSpan:
    """The telemetry-off span: every operation is a no-op."""

    __slots__ = ()
    trace_id = 0
    span_id = 0

    def add(self, **counters):
        return self

    def end(self, **counters):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


def start_span(name: str, phase: str | None = None,
               robot: int | None = None, link=None, run=None):
    """Open a span (NOT pushed on the parent stack), or None with
    telemetry off.  Callers that need the ids (wire stamping) use the
    None return as their fence."""
    run = get_run() if run is None else run
    if run is None:
        return None
    return Span(run, name, phase=phase, robot=robot, link=link)


def span(name: str, phase: str | None = None, robot: int | None = None,
         link=None, **counters):
    """``with span("publish", phase="comms", robot=2): ...`` — a no-op
    context manager with telemetry off, a parent-stack-participating
    ``Span`` otherwise."""
    run = get_run()
    if run is None:
        return NULL_SPAN
    sp = Span(run, name, phase=phase, robot=robot, link=link)
    if counters:
        sp.add(**counters)
    return sp


def emit_span(run, name: str, t0_mono: float, t0_wall: float, dur_s: float,
              phase: str | None = None, robot: int | None = None,
              link=None, trace_id: int | None = None,
              parent_id: int | None = None, **counters) -> None:
    """Emit a complete span from already-measured times — for hot paths
    (``PGOAgent.iterate``, the eval readback) that time themselves and
    must not pay a second clock read.  ``run`` is the caller's
    already-resolved ambient run (the caller's guard IS the fence).

    ``trace_id``/``parent_id`` pin the span into an explicit trace instead
    of the thread-local one — the serving plane's worker thread emits
    per-request spans (queue wait, reply) into each request's trace this
    way, because the request's trace lives on the submitter's thread, not
    the worker's."""
    parent = current_span()
    if trace_id is None:
        trace_id = parent.trace_id if parent is not None else new_id()
    if parent_id is None and parent is not None:
        parent_id = parent.span_id
    fields = {"name": str(name), "t0_mono": float(t0_mono),
              "t0_wall": float(t0_wall), "dur_s": float(dur_s),
              "span": _hex(new_id()), "trace": _hex(trace_id)}
    if parent_id:
        fields["parent"] = _hex(parent_id)
    if robot is not None:
        fields["robot"] = int(robot)
    if link is not None:
        fields.update(link_fields(link))
    fields.update(counters)
    run.events.emit("span", phase=phase, **fields)

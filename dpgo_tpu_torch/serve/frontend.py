"""TCP front-end: g2o problem upload / result download over the packed wire
(port of ``dpgo_tpu.serve.frontend``; frames byte-identical to the JAX
package's, so either package's client talks to either's server).

Reuses the deployment plane's transport stack unchanged: length-prefixed
frames (``comms.transport.TcpTransport``) carrying the v2 packed columnar
payload (``comms.protocol``), with the frame-size cap
constructor-configurable end to end (``--max-frame-mb`` on the CLI).
A request frame is an array dict — the g2o file bytes as a ``uint8``
array plus scalar config entries — and the reply carries the rounded
trajectory, cost/grad-norm histories, and termination info (or a
structured error; shed requests come back with ``shed=1`` and the
admission ``reason`` so clients can back off).

One thread per connection, sequential requests per connection; the actual
queueing/batching discipline lives in ``server.SolveServer``, which this
module only adapts to the wire.
"""

from __future__ import annotations

import json
import threading

import numpy as np

from .. import obs
from ..comms.protocol import (DEFAULT_MAX_FRAME_BYTES, ORIGIN_SERVE_CLIENT,
                              ProtocolError, attach_clock, pack_measurements,
                              pack_trace_entries, pop_clock,
                              proc_replica_actor, unpack_measurements,
                              unpack_trace_entries)
from ..comms.transport import (TcpTransport, TransportClosed,
                               TransportTimeout, connect_tcp, listen_tcp)
from ..config import AgentParams
from ..obs import trace as obs_trace
from ..utils.g2o import read_g2o
from .server import OverCapacityError, SolveRequest, SolveServer


def _pack_str(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), np.uint8)


def _unpack_str(a) -> str:
    return bytes(np.asarray(a, np.uint8)).decode("utf-8")


def handle_request(server: SolveServer, frame: dict) -> dict:
    """One request frame -> one reply frame (in-process; the wire layer
    above is a pass-through).

    Pops the optional wire trace context the client stamped
    (``comms.protocol.unpack_trace_entries`` — old/untraced clients simply
    carry none) and, with telemetry on, wraps the request in a
    ``frontend`` span on the client's trace; ``SolveServer.submit``'s
    admission span then nests under it, so the Perfetto timeline runs
    from TCP receive to reply on one trace id."""
    ctx = unpack_trace_entries(frame)
    # Channel-level clock stamp (the procs heartbeat wire): popped
    # unconditionally so mixed telemetry-on/off peers interoperate;
    # recorded as the forward clock_sample only with a run on.
    ts = pop_clock(frame)
    run = obs.get_run()
    if run is None:
        return _handle_request(server, frame, None)
    if ts is not None:
        run.event("clock_sample", phase="comms", src=ts[0],
                  dst=proc_replica_actor(server.replica_id or "r"),
                  channel="heartbeat", kind="status_poll",
                  t_send_mono=ts[1], t_send_wall=ts[2])
    sp = obs_trace.Span(run, "frontend", phase="serve",
                        trace_id=ctx[0] if ctx is not None else None,
                        link=ctx)
    with sp:
        reply = _handle_request(server, frame, ctx)
        if "ok" in reply:
            sp.add(ok=int(np.asarray(reply["ok"])))
        return reply


def _result_reply(res, ticket=None) -> dict:
    """The success-reply vocabulary shared by the solve ops."""
    reply = {
        "ok": np.int8(1),
        "T": np.asarray(res.T),
        "cost_history": np.asarray(res.cost_history, np.float64),
        "grad_norm_history": np.asarray(res.grad_norm_history, np.float64),
        "iterations": np.int32(res.iterations),
        "terminated_by": _pack_str(res.terminated_by),
        # Crash-recovery disclosure: the solve completed from a session
        # snapshot after a worker death (serve.session).
        "recovered": np.int8(bool(getattr(res, "recovered", False))),
    }
    if ticket is not None and ticket.queue_wait_s is not None:
        # Out-of-process fleets feed the autoscaler from the REPLICA's
        # admission queue, so the wait rides the reply.
        reply["queue_wait_s"] = np.float64(ticket.queue_wait_s)
    cert = getattr(res, "certificate", None)
    if cert is not None:
        from ..models.certify import CERT_STATUS

        reply["certified"] = np.int8(bool(cert.certified))
        reply["cert_status"] = _pack_str(
            CERT_STATUS.get(cert.device_verdict, "none"))
        reply["cert_lambda_min"] = np.float64(cert.lambda_min)
        reply["cert_tol"] = np.float64(cert.tol)
    return reply


def _shed_reply(server, e: OverCapacityError) -> dict:
    reply = {"ok": np.int8(0), "shed": np.int8(1),
             "reason": _pack_str(e.reason), "error": _pack_str(str(e))}
    if e.reason == "closed":
        # Disclose a drain/shutdown shed distinctly: the client should
        # reconnect (to the fleet's next replica), not back off.
        try:
            draining = bool(server.status().get("draining"))
        except Exception:
            draining = False
        reply["draining"] = np.int8(draining)
    return reply


def _handle_solve_m(server: SolveServer, frame: dict, ctx) -> dict:
    """``solve_m``: the in-memory-measurements solve op (the out-of-
    process fleet's RPC surface).  Same reply vocabulary as ``solve``
    plus the replica-side queue wait; the request round-trips the full
    ``Measurements`` batch instead of g2o bytes."""
    try:
        meas = unpack_measurements(frame, "meas")
        if meas is None:
            raise ValueError("solve_m frame carries no 'meas' payload")
        num_robots = int(np.asarray(frame["num_robots"]))
        rank = int(np.asarray(frame["rank"])) if "rank" in frame else 5
        params = AgentParams(
            d=meas.d, r=rank, num_robots=num_robots,
            rel_change_tol=float(np.asarray(frame["rel_change_tol"]))
            if "rel_change_tol" in frame else 5e-3,
            certify_mode=_unpack_str(frame["certify_mode"])
            if "certify_mode" in frame else "off",
            certify_eta=float(np.asarray(frame["certify_eta"]))
            if "certify_eta" in frame else 1e-5)
        req = SolveRequest(
            meas=meas,
            num_robots=num_robots,
            params=params,
            tenant=_unpack_str(frame["tenant"]) if "tenant" in frame
            else "default",
            deadline_s=float(np.asarray(frame["deadline_s"]))
            if "deadline_s" in frame else None,
            max_iters=int(np.asarray(frame["max_iters"]))
            if "max_iters" in frame else None,
            grad_norm_tol=float(np.asarray(frame["grad_norm_tol"]))
            if "grad_norm_tol" in frame else 0.1,
            eval_every=int(np.asarray(frame["eval_every"]))
            if "eval_every" in frame else 1,
            trace_ctx=ctx,
            session_id=_unpack_str(frame["session"])
            if "session" in frame else None,
        )
        ticket = server.submit(req)
        res = ticket.result()
    except OverCapacityError as e:
        return _shed_reply(server, e)
    except Exception as e:
        return {"ok": np.int8(0), "error": _pack_str(f"{type(e).__name__}: {e}")}
    return _result_reply(res, ticket)


def _handle_request(server: SolveServer, frame: dict, ctx) -> dict:
    op = _unpack_str(frame["op"]) if "op" in frame else "solve"
    if op == "ping":
        return {"ok": np.int8(1)}
    if op == "status":
        # The fleet heartbeat: the replica's operational snapshot, JSON-
        # encoded (mixed scalar types) inside one uint8 frame entry.
        # With telemetry on the reply carries this replica's clock stamp
        # — the reverse leg of the heartbeat's clock_sample pair.
        try:
            reply = {"ok": np.int8(1),
                     "status": _pack_str(json.dumps(server.status(),
                                                    default=str))}
            if obs.get_run() is not None:
                attach_clock(reply,
                             proc_replica_actor(server.replica_id or "r"))
            return reply
        except Exception as e:
            return {"ok": np.int8(0),
                    "error": _pack_str(f"{type(e).__name__}: {e}")}
    if op == "drain":
        # Live-migration drain.  The evacuated tickets' WAITERS are this
        # front-end's own handler threads (blocked in solve ops); finish
        # them with the structured drain shed so every in-flight RPC
        # replies "reroute me" instead of hanging — the parent-side
        # ProcServer owns the real re-admission tickets.
        try:
            evacuated = server.drain()
        except Exception as e:
            return {"ok": np.int8(0),
                    "error": _pack_str(f"{type(e).__name__}: {e}")}
        for t in evacuated:
            if not t.done():
                t._finish(exception=OverCapacityError(
                    "evacuated: replica draining for migration",
                    reason="closed"))
        return {"ok": np.int8(1), "evacuated": np.int32(len(evacuated))}
    if op == "solve_m":
        return _handle_solve_m(server, frame, ctx)
    if op != "solve":
        return {"ok": np.int8(0), "error": _pack_str(f"unknown op {op!r}")}
    try:
        # The decode stage as its own span: g2o parse + request build,
        # so a certified request's timeline reads decode -> admission ->
        # dispatch -> certified reply with no unattributed gap.
        with obs_trace.span("decode", phase="serve",
                            bytes=int(np.asarray(frame["g2o"]).size)):
            meas = read_g2o(bytes(np.asarray(frame["g2o"], np.uint8)))
            num_robots = int(np.asarray(frame["num_robots"]))
            rank = int(np.asarray(frame["rank"])) if "rank" in frame else 5
            certify_mode = _unpack_str(frame["certify_mode"]) \
                if "certify_mode" in frame else "off"
            certify_eta = float(np.asarray(frame["certify_eta"])) \
                if "certify_eta" in frame else 1e-5
            req = SolveRequest(
                meas=meas,
                num_robots=num_robots,
                params=AgentParams(d=meas.d, r=rank, num_robots=num_robots,
                                   certify_mode=certify_mode,
                                   certify_eta=certify_eta),
                tenant=_unpack_str(frame["tenant"]) if "tenant" in frame
                else "default",
                deadline_s=float(np.asarray(frame["deadline_s"]))
                if "deadline_s" in frame else None,
                max_iters=int(np.asarray(frame["max_iters"]))
                if "max_iters" in frame else None,
                grad_norm_tol=float(np.asarray(frame["grad_norm_tol"]))
                if "grad_norm_tol" in frame else 0.1,
                eval_every=int(np.asarray(frame["eval_every"]))
                if "eval_every" in frame else 1,
                trace_ctx=ctx,
                session_id=_unpack_str(frame["session"])
                if "session" in frame else None,
            )
        res = server.submit(req).result()
    except OverCapacityError as e:
        return _shed_reply(server, e)
    except Exception as e:  # bad payload, solver failure: structured reply
        return {"ok": np.int8(0), "error": _pack_str(f"{type(e).__name__}: {e}")}
    return _result_reply(res)


class ServeFrontend:
    """TCP listener bound to a ``SolveServer``.  Binds on construction
    (``port=0`` = OS-assigned; read the resolved ``.port``), accepts on a
    daemon thread, one handler thread per connection."""

    def __init__(self, server: SolveServer, host: str = "127.0.0.1",
                 port: int = 0,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 wire_format: str = "packed"):
        self.server = server
        self.max_frame_bytes = int(max_frame_bytes)
        self.wire_format = wire_format
        self._listener = listen_tcp(host, port)
        self.host, self.port = self._listener.getsockname()[:2]
        #: Each connection pairs its transport with a send lock: handler
        #: replies and ``close()``'s teardown serialize on it, so a reply
        #: for a request that was in flight when shutdown began either
        #: lands whole before the socket closes or is skipped cleanly —
        #: never interleaved with the close.
        self._transports: list[tuple[TcpTransport, threading.Lock]] = []
        self._lock = threading.Lock()
        self._closed = False
        self._accepter = threading.Thread(target=self._accept, daemon=True,
                                          name="dpgo-serve-accept")
        self._accepter.start()

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            tr = TcpTransport(sock, src="serve-frontend",
                              max_frame_bytes=self.max_frame_bytes,
                              wire_format=self.wire_format)
            send_lock = threading.Lock()
            with self._lock:
                if self._closed:
                    tr.close()
                    return
                self._transports.append((tr, send_lock))
            threading.Thread(target=self._serve_conn, args=(tr, send_lock),
                             daemon=True).start()

    def _send(self, tr: TcpTransport, send_lock: threading.Lock,
              reply: dict) -> bool:
        """Send one reply under the connection's send lock.  A teardown
        that already began (``close()`` holds the lock while closing the
        socket) makes this a clean no-op instead of a write racing the
        close; returns whether the reply was delivered."""
        with send_lock:
            with self._lock:
                if self._closed:
                    return False
            tr.send(reply)
            return True

    def _serve_conn(self, tr: TcpTransport, send_lock: threading.Lock) -> None:
        while True:
            try:
                frame = tr.recv()
            except (TransportClosed, TransportTimeout):
                return
            except ProtocolError as e:
                try:
                    if not self._send(tr, send_lock, {
                            "ok": np.int8(0),
                            "error": _pack_str(f"protocol error: {e}")}):
                        return
                    continue
                except (TransportClosed, ProtocolError):
                    return
            try:
                if not self._send(tr, send_lock,
                                  handle_request(self.server, frame)):
                    return
            except ProtocolError as e:
                # Reply exceeds the frame cap: report instead of dying.
                try:
                    if not self._send(tr, send_lock, {
                            "ok": np.int8(0),
                            "error": _pack_str(f"reply too large: {e}")}):
                        return
                except (TransportClosed, ProtocolError):
                    return
            except TransportClosed:
                return

    def close(self) -> None:
        with self._lock:
            self._closed = True
            transports = list(self._transports)
        try:
            self._listener.close()
        except OSError:
            pass
        for tr, send_lock in transports:
            # Serialize with any in-flight reply: a handler mid-send
            # finishes its frame first; handlers that arrive after see
            # ``_closed`` and skip the send entirely.
            with send_lock:
                tr.close()

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def solve_m_frame(request) -> dict:
    """The ``solve_m`` request frame for one ``SolveRequest`` — the
    client half of ``_handle_solve_m`` (the out-of-process fleet's RPC
    encoder).  ``params`` fields beyond (d, r, rel_change_tol,
    certify_mode, certify_eta) stay at replica defaults by design: the
    fleet replicas are homogeneous and the bucket fingerprint only keys
    on what rides the wire."""
    frame = {"op": _pack_str("solve_m"),
             "num_robots": np.int32(request.num_robots),
             "tenant": _pack_str(request.tenant),
             "grad_norm_tol": np.float64(request.grad_norm_tol),
             "eval_every": np.int32(request.eval_every)}
    frame.update(pack_measurements("meas", request.meas))
    if request.params is not None:
        frame["rank"] = np.int32(request.params.r)
        frame["rel_change_tol"] = np.float64(request.params.rel_change_tol)
        if request.params.certify_mode != "off":
            frame["certify_mode"] = _pack_str(request.params.certify_mode)
            frame["certify_eta"] = np.float64(request.params.certify_eta)
    if request.max_iters is not None:
        frame["max_iters"] = np.int32(request.max_iters)
    if request.deadline_s is not None:
        frame["deadline_s"] = np.float64(request.deadline_s)
    if request.session_id is not None:
        frame["session"] = _pack_str(request.session_id)
    return frame


def solve_g2o(host: str, port: int, g2o, num_robots: int,
              tenant: str = "default", rank: int = 5,
              max_iters: int | None = None, grad_norm_tol: float = 0.1,
              eval_every: int = 1, deadline_s: float | None = None,
              timeout: float | None = None,
              max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
              wire_format: str = "packed",
              session_id: str | None = None,
              certify_mode: str = "off",
              certify_eta: float = 1e-5) -> dict:
    """Submit one g2o problem to a remote front-end and wait for the
    result.  ``g2o`` is the file's bytes or a path.  Returns a dict with
    ``ok`` plus either the result arrays (``T``, ``cost_history``,
    ``grad_norm_history``, ``iterations``, ``terminated_by``) or the
    structured error (``error``, ``shed``, ``reason``).

    ``certify_mode="device"`` requests a certified reply: the server
    folds the dual certificate into the solve's terminal epilogue and the
    reply carries ``certified`` / ``cert_status`` / ``cert_lambda_min`` /
    ``cert_tol``."""
    if isinstance(g2o, str):
        with open(g2o, "rb") as fh:
            g2o = fh.read()
    frame = {
        "op": _pack_str("solve"),
        "g2o": np.frombuffer(g2o, np.uint8),
        "num_robots": np.int32(num_robots),
        "rank": np.int32(rank),
        "tenant": _pack_str(tenant),
        "grad_norm_tol": np.float64(grad_norm_tol),
        "eval_every": np.int32(eval_every),
    }
    if max_iters is not None:
        frame["max_iters"] = np.int32(max_iters)
    if deadline_s is not None:
        frame["deadline_s"] = np.float64(deadline_s)
    if session_id is not None:
        frame["session"] = _pack_str(session_id)
    if certify_mode != "off":
        frame["certify_mode"] = _pack_str(certify_mode)
        frame["certify_eta"] = np.float64(certify_eta)
    # Request-scoped trace context: with telemetry on in the CLIENT
    # process, the whole round-trip is one span and its ids ride the
    # frame, so the server's spans join this trace (telemetry off:
    # byte-identical frames, no span).
    sp = obs_trace.start_span("solve_g2o", phase="serve")
    if sp is not None:
        frame.update(pack_trace_entries(sp.trace_id, sp.span_id,
                                        ORIGIN_SERVE_CLIENT))
    sock = connect_tcp(host, port)
    tr = TcpTransport(sock, src="serve-client",
                      max_frame_bytes=max_frame_bytes,
                      wire_format=wire_format)
    try:
        tr.send(frame)
        reply = tr.recv(timeout=timeout)
    finally:
        tr.close()
        if sp is not None:
            sp.end(host=host, port=int(port), tenant=tenant)
    out = {"ok": bool(int(np.asarray(reply["ok"])))}
    if out["ok"]:
        out["T"] = np.asarray(reply["T"])
        out["cost_history"] = np.asarray(reply["cost_history"])
        out["grad_norm_history"] = np.asarray(reply["grad_norm_history"])
        out["iterations"] = int(np.asarray(reply["iterations"]))
        out["terminated_by"] = _unpack_str(reply["terminated_by"])
        out["recovered"] = bool(int(np.asarray(reply.get("recovered", 0))))
        if "certified" in reply:
            out["certified"] = bool(int(np.asarray(reply["certified"])))
            out["cert_status"] = _unpack_str(reply["cert_status"])
            out["cert_lambda_min"] = float(np.asarray(
                reply["cert_lambda_min"]))
            out["cert_tol"] = float(np.asarray(reply["cert_tol"]))
    else:
        out["error"] = _unpack_str(reply.get("error", _pack_str("")))
        out["shed"] = bool(int(np.asarray(reply.get("shed", 0))))
        if "reason" in reply:
            out["reason"] = _unpack_str(reply["reason"])
        if "draining" in reply:
            out["draining"] = bool(int(np.asarray(reply["draining"])))
    return out

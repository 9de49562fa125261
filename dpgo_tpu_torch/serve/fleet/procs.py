"""Out-of-process fleet replicas: each replica is its own OS process
(port of ``dpgo_tpu.serve.fleet.procs``), with its own CUDA context.

The in-process fleet (``manager``/``router``) proves the routing,
migration, and autoscale logic, but every replica shares the parent's
address space — a wedged or dying replica can take the whole fleet with
it, and ``kill()`` is a polite in-process shutdown rather than an actual
process death.  ``ProcServer`` closes that gap: it satisfies the exact
server surface ``Replica``/``FleetRouter`` already consume (``submit``/
``status``/``drain``/``close``/``kill`` plus ticket futures), but the
solve happens in a CHILD PROCESS running an ordinary ``SolveServer``
behind an ordinary ``ServeFrontend`` — the packed v2 TCP frames are the
real RPC surface, not a test double.

Wiring:

* **spawn** — the parent launches ``python -m
  dpgo_tpu_torch.serve.fleet.procs --child`` with the replica's config
  and ``--device`` (the card unless ``"cpu"`` is asked for; a child asked
  for CUDA where there is none exits non-zero with ``resolve_device``'s
  error rather than serving on the CPU), and the child reports its
  OS-assigned front-end port through a tmp+rename port file.  The parent
  dials with ``connect_tcp``'s jittered-backoff budget.  Build the kernel
  library in the parent first (``rtr_kernel.build()``) or give the fleet
  a warm ``aot_cache_dir``, so children do not each wait on ``nvcc``.
* **submit** — one local ``ProcTicket`` per request plus a pump thread
  that performs the blocking ``solve_m`` RPC (full ``Measurements``
  round-trip — ``comms.protocol.pack_measurements``) and finishes the
  ticket.  Admission mirrors the child's bounds locally (closed/draining
  and an in-flight cap) so the router's fall-through-the-rendezvous-order
  behavior is preserved synchronously.
* **heartbeat** — a monitor thread polls the child's ``status`` op; the
  parent's ``status()["accepting"]`` (the ``ReplicaManager`` liveness
  probe) goes False the moment the child process dies, the heartbeat
  budget is exhausted, or the child stops accepting.  A ``kill -9``'d
  child therefore reads as dead within one heartbeat and the manager
  respawns a fresh process.
* **drain / migration** — ``drain()`` marks the parent draining, tells
  the child to evacuate (its in-flight batch stops at the next boundary
  snapshot, so session-tagged work leaves a fresh ``SessionStore``
  snapshot in the SHARED store), and hands the unanswered local tickets
  back for the router to re-admit — live migration across real process
  boundaries.
* **kill** — an actual ``SIGKILL`` of the child.  In-flight RPCs see the
  connection die and finish their tickets with the structured
  replica-death error the router reroutes on.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ... import obs
from ...comms.protocol import (DEFAULT_MAX_FRAME_BYTES, ORIGIN_FLEET_PARENT,
                               ProtocolError, attach_clock, pop_clock,
                               proc_replica_actor)
from ...comms.transport import (TcpTransport, TransportClosed,
                                TransportTimeout, connect_tcp)
from ..server import OverCapacityError

#: Child boot budget: a cold child pays ``import torch`` and, on the card,
#: a CUDA context before it can bind; shared-core CI boxes stretch that
#: well past laptop numbers.  (The kernel library is bound at the first
#: solve, not at boot.)
DEFAULT_SPAWN_TIMEOUT_S = 180.0
#: Parent->child liveness poll cadence and the consecutive-miss budget
#: that flips ``accepting`` False (kill -9 detection latency is
#: ``heartbeat_s * heartbeat_misses`` at worst, typically one poll).
DEFAULT_HEARTBEAT_S = 0.2
DEFAULT_HEARTBEAT_MISSES = 3


def _unpack_str(a) -> str:
    return bytes(np.asarray(a, np.uint8)).decode("utf-8")


def _death_error(replica_id: str, detail: str) -> RuntimeError:
    # The message must read as a replica death to the router's
    # ``_is_replica_death`` classifier ("closed"/"died mid-batch").
    return RuntimeError(
        f"replica {replica_id} process closed mid-request: {detail}")


class ProcTicket:
    """Local future for one request pumped to a child replica.

    Satisfies the inner-ticket contract ``FleetRouter`` consumes:
    ``done()``, ``result(timeout=)``, ``_finish(...)`` (first caller
    wins — the router's migration marker and the pump thread may race),
    and ``queue_wait_s`` (the CHILD's admission wait, off the reply)."""

    def __init__(self, request):
        self.request = request
        self.t_submit = time.monotonic()
        self.queue_wait_s: float | None = None
        self._event = threading.Event()
        self._result = None
        self._exception: BaseException | None = None
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("solve not finished within timeout")
        if self._exception is not None:
            raise self._exception
        return self._result

    def _finish(self, result=None, exception=None) -> None:
        with self._lock:
            if self._event.is_set():
                return  # first finisher wins (migration marker vs pump)
            self._result = result
            self._exception = exception
            self._event.set()


def _result_from_reply(reply: dict):
    """An ``RBCDResult`` view of a ``solve_m`` success reply."""
    from ...models.rbcd import RBCDResult

    return RBCDResult(
        T=torch.from_numpy(np.array(reply["T"])),
        X=None,
        cost_history=list(np.asarray(reply["cost_history"], np.float64)),
        grad_norm_history=list(np.asarray(reply["grad_norm_history"],
                                          np.float64)),
        iterations=int(np.asarray(reply["iterations"])),
        terminated_by=_unpack_str(reply["terminated_by"]),
        recovered=bool(int(np.asarray(reply.get("recovered", 0)))),
    )


class ProcServer:
    """One out-of-process solve replica behind the in-process surface.

    Drop-in for ``SolveServer`` wherever a ``ReplicaManager``'s
    ``make_server`` factory is the consumer: the constructor spawns the
    child and blocks until its front-end port lands, so a returned
    ``ProcServer`` is live."""

    def __init__(self, replica_id: str | None = None, *,
                 max_batch: int = 8, max_queue: int = 64,
                 batch_window_s: float = 0.005,
                 aot_cache_dir: str | None = None,
                 session_store: str | None = None,
                 session_every: int = 1,
                 resume_sessions: bool = False,
                 host: str = "127.0.0.1",
                 spawn_timeout_s: float = DEFAULT_SPAWN_TIMEOUT_S,
                 heartbeat_s: float = DEFAULT_HEARTBEAT_S,
                 heartbeat_misses: int = DEFAULT_HEARTBEAT_MISSES,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 workdir: str | None = None,
                 telemetry_dir: str | None = None,
                 device="cuda"):
        self.replica_id = replica_id
        #: The device the child serves on (``torch.device``; the router
        #: keys a request with ``dtype=None`` on its default dtype).
        self.device = torch.device(device)
        self.max_queue = int(max_queue)
        self.host = host
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_misses = int(heartbeat_misses)
        self.max_frame_bytes = int(max_frame_bytes)
        self.telemetry_dir = telemetry_dir
        self.child_metrics_port: int | None = None
        self._lost_emitted = False

        self._lock = threading.Lock()
        self._tickets: dict[int, ProcTicket] = {}  # guarded-by: _lock
        self._closed = False                       # guarded-by: _lock
        self._draining = False                     # guarded-by: _lock
        self._child_status: dict = {}              # guarded-by: _lock
        self._beat_misses = 0                      # guarded-by: _lock
        self._n_requests = 0                       # guarded-by: _lock
        self._pumps: list[threading.Thread] = []   # guarded-by: _lock
        self._stop = threading.Event()

        self._workdir = workdir or tempfile.mkdtemp(prefix="dpgo-proc-")
        port_file = os.path.join(self._workdir,
                                 f"port-{replica_id or 'r'}.json")
        cmd = [sys.executable, "-m", "dpgo_tpu_torch.serve.fleet.procs",
               "--child", "--port-file", port_file,
               "--device", str(self.device),
               "--replica-id", str(replica_id or ""),
               "--max-batch", str(int(max_batch)),
               "--max-queue", str(int(max_queue)),
               "--batch-window", str(float(batch_window_s)),
               "--session-every", str(int(session_every))]
        if aot_cache_dir is not None:
            cmd += ["--aot-cache", str(aot_cache_dir)]
        if session_store is not None:
            cmd += ["--session-store", str(session_store)]
        if resume_sessions:
            cmd += ["--resume-sessions"]
        if telemetry_dir is not None:
            # The child runs inside its own TelemetryRun there (its
            # sidecar port comes back through the port file); the parent
            # harvests the directory post-mortem on a replica death.
            cmd += ["--telemetry-dir", str(telemetry_dir)]
        env = dict(os.environ)
        repo_root = str(Path(__file__).resolve().parents[3])
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        self._log_path = os.path.join(self._workdir,
                                      f"child-{replica_id or 'r'}.log")
        log = open(self._log_path, "w")
        try:
            self.proc = subprocess.Popen(cmd, stdout=log, stderr=log,
                                         cwd=repo_root, env=env)
        finally:
            log.close()
        self.port = self._await_port(port_file, float(spawn_timeout_s))
        self._monitor = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name=f"dpgo-proc-heartbeat-{replica_id or self.proc.pid}")
        self._monitor.start()

    # -- child lifecycle ----------------------------------------------------

    def _await_port(self, port_file: str, timeout_s: float) -> int:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica child exited rc={self.proc.returncode} "
                    f"before binding (log: {self._log_path}):\n"
                    f"{self._log_tail()}")
            try:
                with open(port_file) as fh:
                    record = json.load(fh)
                if record.get("metrics_port"):
                    self.child_metrics_port = int(record["metrics_port"])
                return int(record["port"])
            except (OSError, ValueError, KeyError):
                time.sleep(0.05)
        self.proc.kill()
        self.proc.wait()
        raise TimeoutError(
            f"replica child did not report a port within {timeout_s}s "
            f"(log: {self._log_path})")

    def _log_tail(self, n_bytes: int = 2000) -> str:
        try:
            with open(self._log_path, "rb") as fh:
                return fh.read()[-n_bytes:].decode("utf-8", "replace")
        except OSError:
            return ""

    def _rpc(self, frame: dict, timeout: float | None):
        """One connect-send-recv round trip (its own connection: the
        front-end serves one request at a time per connection, and pumps
        run concurrently)."""
        tr = TcpTransport(connect_tcp(self.host, self.port, attempts=3),
                          src="fleet-proc",
                          max_frame_bytes=self.max_frame_bytes)
        try:
            tr.send(frame)
            return tr.recv(timeout=timeout)
        finally:
            tr.close()

    # -- admission + pump ---------------------------------------------------

    def submit(self, request) -> ProcTicket:
        with self._lock:
            if self._closed or self._draining:
                raise OverCapacityError(
                    f"replica {self.replica_id} is closed", reason="closed")
            if self.proc.poll() is not None:
                raise OverCapacityError(
                    f"replica {self.replica_id} process is dead",
                    reason="closed")
            if len(self._tickets) >= self.max_queue:
                raise OverCapacityError(
                    f"replica {self.replica_id} pump queue full "
                    f"({self.max_queue})", reason="queue")
            ticket = ProcTicket(request)
            self._tickets[id(ticket)] = ticket
            self._n_requests += 1
            pump = threading.Thread(target=self._pump, args=(ticket,),
                                    daemon=True, name="dpgo-proc-pump")
            self._pumps.append(pump)
            self._pumps = [t for t in self._pumps if t.is_alive()]
        pump.start()
        return ticket

    def _pump(self, ticket: ProcTicket) -> None:
        from ..frontend import solve_m_frame

        rid = str(self.replica_id)
        try:
            reply = self._rpc(solve_m_frame(ticket.request), timeout=None)
        except (TransportClosed, TransportTimeout, ProtocolError,
                ConnectionError, OSError) as e:
            ticket._finish(exception=_death_error(
                rid, f"{type(e).__name__}: {e}"))
            self._forget(ticket)
            return
        try:
            if int(np.asarray(reply["ok"])):
                if "queue_wait_s" in reply:
                    ticket.queue_wait_s = float(
                        np.asarray(reply["queue_wait_s"]))
                ticket._finish(result=_result_from_reply(reply))
            elif int(np.asarray(reply.get("shed", 0))):
                ticket._finish(exception=OverCapacityError(
                    _unpack_str(reply.get("error", np.zeros(0, np.uint8))),
                    reason=_unpack_str(reply["reason"])))
            else:
                ticket._finish(exception=RuntimeError(
                    _unpack_str(reply.get("error", np.zeros(0, np.uint8)))
                    or f"replica {rid} returned an empty error"))
        except Exception as e:  # malformed reply: treat as replica death
            ticket._finish(exception=_death_error(
                rid, f"bad reply: {type(e).__name__}: {e}"))
        self._forget(ticket)

    def _forget(self, ticket: ProcTicket) -> None:
        with self._lock:
            self._tickets.pop(id(ticket), None)

    @property
    def metrics_url(self) -> str | None:
        """The CHILD's ``/metrics`` scrape URL (its sidecar only exists
        when the child got a telemetry dir), or None."""
        if self.child_metrics_port is None:
            return None
        return f"http://{self.host}:{self.child_metrics_port}/metrics"

    # -- heartbeat ----------------------------------------------------------

    def _beat_once(self) -> dict | None:
        """One status poll; None on any failure.

        With telemetry on the poll doubles as the procs-plane clock
        channel: the request carries the parent's ``attach_clock`` stamp
        (the child's front end emits the forward ``clock_sample``), and
        the child stamps its status reply (the reverse sample emitted
        here) — bidirectional parent<->replica pairs at the heartbeat
        cadence.  Telemetry off: no stamp, byte-identical wire."""
        from ..frontend import _pack_str

        run = obs.get_run()
        frame = {"op": _pack_str("status")}
        if run is not None:
            attach_clock(frame, ORIGIN_FLEET_PARENT)
        try:
            reply = self._rpc(frame, timeout=2.0)
            ts = pop_clock(reply)
            if run is not None and ts is not None:
                run.event("clock_sample", phase="comms", src=ts[0],
                          dst=ORIGIN_FLEET_PARENT, channel="heartbeat",
                          kind="status_reply", t_send_mono=ts[1],
                          t_send_wall=ts[2])
            if not int(np.asarray(reply["ok"])):
                return None
            return json.loads(_unpack_str(reply["status"]))
        except Exception:
            return None

    def _heartbeat_loop(self) -> None:
        run = obs.get_run()
        rid = str(self.replica_id)
        if run is not None:
            # Satellite: the status-poll fields the parent already
            # fetches become per-replica labeled gauges instead of
            # liveness-only bookkeeping.
            g_queue = run.gauge("fleet_replica_queue_depth",
                                "child admission queue depth per replica")
            g_inflight = run.gauge("fleet_replica_in_flight",
                                   "in-flight requests per replica")
            g_draining = run.gauge("fleet_replica_draining",
                                   "1 while the replica is draining")
            g_accepting = run.gauge("fleet_replica_accepting",
                                    "1 while the replica accepts work")
            g_misses = run.gauge("fleet_replica_heartbeat_misses",
                                 "consecutive missed heartbeats")
        while not self._stop.wait(self.heartbeat_s):
            if self.proc.poll() is not None:
                with self._lock:
                    self._beat_misses = self.heartbeat_misses
                    closed = self._closed
                if run is not None and not closed \
                        and not self._lost_emitted:
                    # An unrequested child death (kill -9, OOM, crash):
                    # the instant lands on the REPLICA's own timeline
                    # track, and whatever the child's run directory
                    # still holds is harvested post-mortem.
                    self._lost_emitted = True
                    self._emit_process_lost(run, rid)
                continue  # dead child: keep reporting it until close()
            st = self._beat_once()
            with self._lock:
                if st is None:
                    self._beat_misses += 1
                else:
                    self._beat_misses = 0
                    self._child_status = st
                misses = self._beat_misses
                inflight = len(self._tickets)
            if run is not None and st is not None:
                tenant_inflight = sum(
                    t.get("in_flight", 0)
                    for t in st.get("tenants", {}).values())
                g_queue.set(st.get("queue_depth", 0) or 0, replica=rid)
                g_inflight.set(tenant_inflight + inflight, replica=rid)
                g_draining.set(1.0 if st.get("draining") else 0.0,
                               replica=rid)
                g_accepting.set(1.0 if st.get("accepting", True) else 0.0,
                                replica=rid)
                g_misses.set(misses, replica=rid)
            elif run is not None:
                g_misses.set(misses, replica=rid)

    def _emit_process_lost(self, run, rid: str) -> None:
        try:
            post = None
            if self.telemetry_dir:
                from ...obs import fleetobs

                post = fleetobs.harvest_run_dir(self.telemetry_dir)
            run.event("process_lost", phase="comms",
                      robot=proc_replica_actor(rid), replica=rid,
                      plane="procs", pid=self.proc.pid,
                      rc=self.proc.returncode)
            if post is not None:
                run.event("replica_postmortem", phase="fleet",
                          replica=rid, **post)
        except Exception:
            pass  # forensics are fail-open by contract

    # -- server surface (Replica/FleetRouter contract) ----------------------

    def status(self) -> dict:
        with self._lock:
            child = dict(self._child_status)
            closed = self._closed
            draining = self._draining
            misses = self._beat_misses
            inflight = len(self._tickets)
            n_requests = self._n_requests
        proc_dead = self.proc.poll() is not None
        beat_dead = misses >= self.heartbeat_misses
        accepting = (not closed and not draining and not proc_dead
                     and not beat_dead and bool(child.get("accepting", True)))
        out = dict(child)
        out.update({
            "accepting": accepting,
            "closed": closed or proc_dead,
            "draining": draining and not closed,
            "out_of_process": True,
            "child_pid": self.proc.pid,
            "child_alive": not proc_dead,
            "heartbeat_misses": misses,
            "parent_inflight": inflight,
            "parent_requests": n_requests,
        })
        out.setdefault("queue_depth", inflight)
        return out

    def drain(self) -> list[ProcTicket]:
        """Live-migration drain: stop admission, evacuate the child (its
        in-flight batch stops after the next boundary snapshot lands in
        the shared session store), and return every unanswered local
        ticket for the caller to re-admit elsewhere."""
        from ..frontend import _pack_str

        with self._lock:
            self._draining = True
            evacuated = [t for t in self._tickets.values() if not t.done()]
        if self.proc.poll() is None:
            try:
                self._rpc({"op": _pack_str("drain")}, timeout=30.0)
            except Exception:
                pass  # child died mid-drain: tickets reroute regardless
        return evacuated

    def kill(self) -> None:
        """An ACTUAL kill: ``SIGKILL`` the child process.  In-flight
        pumps watch their connections die and finish their tickets with
        the structured replica-death error."""
        with self._lock:
            self._closed = True
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        run = obs.get_run()
        if run is not None and not self._lost_emitted:
            self._lost_emitted = True
            self._emit_process_lost(run, str(self.replica_id))
        self._shutdown_threads()

    def close(self, drain: bool = False) -> None:
        if drain:
            self.drain()
        with self._lock:
            if self._closed:
                already = True
            else:
                already = False
                self._closed = True
        if not already and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        self.proc.wait()
        self._shutdown_threads()

    def _shutdown_threads(self) -> None:
        self._stop.set()
        self._monitor.join(timeout=10.0)
        with self._lock:
            pumps = list(self._pumps)
            tickets = list(self._tickets.values())
        for t in pumps:
            t.join(timeout=10.0)
        for ticket in tickets:  # pumps that never got a connection up
            ticket._finish(exception=_death_error(
                str(self.replica_id), "replica shut down"))

    def __enter__(self) -> "ProcServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Child entry point
# ---------------------------------------------------------------------------

def _run_child(args) -> int:
    """The replica process: an ordinary ``SolveServer`` behind an
    ordinary ``ServeFrontend``, plus the port-file handshake.

    With ``--telemetry-dir`` the whole child runs inside its own
    ``TelemetryRun``: its statusz sidecar binds an OS-assigned port
    (reported back through the port file for the fleet aggregator to
    scrape), a ``ResourceSampler`` feeds the soak-gate series, and a
    boot span homes this stream to the replica's timeline actor.  With
    telemetry on, each device-dispatch span of the child's batches carries
    its rounds and the process's B2 launches (``runner.run_bucket``), the
    record a parent reads a child's kernel launches from."""
    import contextlib

    boot = (time.monotonic(), time.time())
    scope = obs.run_scope(args.telemetry_dir) if args.telemetry_dir \
        else contextlib.nullcontext()
    with scope:
        from ..frontend import ServeFrontend
        from ..server import SolveServer

        run = obs.get_run()
        server = SolveServer(
            max_batch=args.max_batch, max_queue=args.max_queue,
            batch_window_s=args.batch_window,
            replica_id=args.replica_id or None,
            device=args.device,
            aot_cache_dir=args.aot_cache,
            session_store=args.session_store,
            session_every=args.session_every,
            resume_sessions=args.resume_sessions,
            metrics_port=0 if run is not None else None)
        sampler = None
        if run is not None:
            from ...obs.fleetobs import start_resource_sampler
            from ...obs.trace import emit_span

            rid = args.replica_id or "r"
            run.set_fingerprint(plane="procs", replica=rid,
                                pid=os.getpid())
            emit_span(run, "replica_boot", boot[0], boot[1],
                      time.monotonic() - boot[0], phase="serve",
                      robot=proc_replica_actor(rid), replica=rid)
            sampler = start_resource_sampler(
                run=run,
                queue_depth=lambda: server.status().get("queue_depth", 0),
                replica=rid)
        frontend = ServeFrontend(server, host=args.host, port=0)
        record = {"port": int(frontend.port), "pid": os.getpid()}
        if server.sidecar is not None:
            record["metrics_port"] = int(server.sidecar.port)
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(record, fh)
        os.replace(tmp, args.port_file)

        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        stop.wait()
        frontend.close()
        if sampler is not None:
            sampler.close()
        try:
            server.kill()  # immediate: queued work reroutes parent-side
        except Exception:
            pass
    return 0


def _build_parser():
    import argparse

    ap = argparse.ArgumentParser(
        description="Out-of-process fleet replica (child entry)")
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--port-file", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--replica-id", default="", help=argparse.SUPPRESS)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda",
                    help="torch device the replica serves on (default "
                         "cuda; cpu runs the plain versions)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--batch-window", type=float, default=0.005)
    ap.add_argument("--aot-cache", default=None)
    ap.add_argument("--session-store", default=None)
    ap.add_argument("--session-every", type=int, default=1)
    ap.add_argument("--resume-sessions", action="store_true")
    ap.add_argument("--telemetry-dir", default="",
                    help="run the child inside its own TelemetryRun "
                         "rooted here (statusz sidecar port reported "
                         "via the port file)")
    return ap


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if not args.child or not args.port_file:
        print("this module is the fleet child entry; use --child "
              "--port-file (spawned by ProcServer)", file=sys.stderr)
        return 2
    return _run_child(args)


if __name__ == "__main__":
    sys.exit(main())

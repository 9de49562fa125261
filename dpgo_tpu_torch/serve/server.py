"""The request plane: queueing, admission control, batching, SLO metrics
(port of ``dpgo_tpu.serve.server``).

``SolveServer`` is the in-process serving API (the TCP front-end in
``frontend`` is a thin shell over it).  ``submit`` performs admission
control synchronously — a bounded queue and per-tenant in-flight quotas
raise ``OverCapacityError`` immediately, so an overloaded server fails
fast instead of buffering unboundedly — and returns a ``SolveTicket``
future.  A single worker thread drains the queue: it prepares each
request (problem build, ``models.rbcd.prepare_problem``), pads it into
its shape bucket (``bucketing``), sheds requests whose deadline expired
while queued (``OverCapacityError`` with ``reason="deadline"``), groups
compatible requests, and dispatches one batched solve per group
(``runner.run_bucket``) through the fingerprint-keyed program cache.  A
server runs on one ``device`` (the card unless ``"cpu"`` is asked for);
on a CUDA device every float32 round of a batch is one launch of the
fused RTR kernel over all the batch's agents.

Warm pools: ``warm(requests)`` runs representative requests through the
full pipeline at ``max_iters=1``, populating the program cache (and
loading the kernel library) before traffic arrives.

Per-tenant SLO metrics ride the ambient telemetry run (``dpgo_tpu.obs``)
when one is installed: ``serve_request`` / ``serve_batch`` /
``serve_shed`` events (the schema the report CLI's "serving" section and
``bench_serving.py`` share) plus queue-wait/latency histograms, an
occupancy gauge, and request/shed counters.  On top of that sit four
operability layers, all telemetry-on only:

* **request tracing** — every request runs on one trace: ``admission``
  (submit), ``prepare``/``queue_wait`` (worker), a shared per-batch
  ``dispatch`` span with ``batch_member`` flow links in and ``reply``
  links out, and a reason-tagged ``shed`` span for requests that never
  dispatch (see ``docs/ARCHITECTURE.md`` "Serving observability");
* **live endpoints** — ``metrics_port`` starts the ``statusz`` sidecar
  (``/metrics``, ``/healthz``, ``/statusz`` from ``status()``);
* **SLO burn-rate alerting** — ``slo=ServeSLO(...)`` (or per-tenant
  dict) evaluates rolling-window latency/shed burn rates, exporting
  ``serve_slo_burn_rate`` gauges and emitting ``slo_burn`` anomalies
  through ``obs.health`` on level transitions;
* **profiling** — the program cache records each program's first call
  (``obs.profile``), and ``profile_dir`` opens a ``torch.profiler``
  window over the first ``profile_batches`` dispatches.

With telemetry off the entire path constructs no obs objects — every
metrics site sits behind ``obs.get_run() is not None``, same fence as
the solver core — and no sidecar thread, profiler, or SLO tracker
exists even when their knobs are set.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque

from .. import obs
from ..comms.protocol import ORIGIN_SERVE_SERVER
from ..config import AgentParams
from ..device import resolve_device
from ..models.rbcd import prepare_problem
from ..obs import trace as obs_trace
from ..types import Measurements
from .bucketing import bucket_shape_of, pad_problem
from .cache import ExecutableCache, fingerprint_key, problem_fingerprint
from .runner import run_bucket
from .session import SessionStore


@dataclasses.dataclass(frozen=True)
class ServeSLO:
    """Per-tenant service-level objectives, evaluated as burn rates.

    A request is *good* when its submit->result latency is at most
    ``latency_s``; the latency objective demands a ``latency_target``
    fraction of good requests, leaving an error budget of
    ``1 - latency_target``.  The burn rate is the observed bad fraction
    over the rolling ``window_s`` window divided by that budget — 1.0
    means exactly consuming budget, 10x means the budget burns in a tenth
    of the window (the classic multi-window alerting vocabulary).  The
    shed objective budgets the fraction of admissions-or-sheds that were
    shed.  Crossing ``burn_warning``/``burn_critical`` emits one
    structured ``slo_burn`` anomaly event per level transition through
    ``obs.health``'s callback/policy machinery; recovery emits
    ``slo_recovered``."""

    latency_s: float = 1.0
    latency_target: float = 0.99
    shed_target: float = 0.01
    window_s: float = 60.0
    burn_warning: float = 1.0
    burn_critical: float = 10.0


class _SloTracker:
    """Rolling-window burn-rate state for one tenant.

    Pure host-side bookkeeping over event timestamps the serving metrics
    already collect; constructed only behind the telemetry fence (the
    zero-overhead boom test patches ``__init__``)."""

    def __init__(self, slo: ServeSLO):
        self.slo = slo
        self._lat: deque = deque()    # (t_mono, was_slow)
        self._shed: deque = deque()   # t_mono
        self.level: dict[str, str | None] = {"latency": None, "shed": None}

    def _trim(self, now: float) -> None:
        cutoff = now - self.slo.window_s
        for dq in (self._lat, self._shed):
            while dq:
                head = dq[0]
                t = head[0] if isinstance(head, tuple) else head
                if t >= cutoff:
                    break
                dq.popleft()

    def observe_request(self, now: float, latency_s: float) -> None:
        self._lat.append((now, latency_s > self.slo.latency_s))
        self._trim(now)

    def observe_shed(self, now: float) -> None:
        self._shed.append(now)
        self._trim(now)

    def burn(self, now: float) -> dict:
        """Current burn rates and window tallies."""
        self._trim(now)
        total = len(self._lat)
        slow = sum(1 for _, bad in self._lat if bad)
        shed = len(self._shed)
        lat_budget = max(1e-9, 1.0 - self.slo.latency_target)
        shed_budget = max(1e-9, self.slo.shed_target)
        lat_burn = (slow / total) / lat_budget if total else 0.0
        seen = total + shed
        shed_burn = (shed / seen) / shed_budget if seen else 0.0
        return {"latency_burn": lat_burn, "shed_burn": shed_burn,
                "requests": total, "slow": slow, "shed": shed,
                "window_s": self.slo.window_s}

    def classify(self, burn: float) -> str | None:
        if burn >= self.slo.burn_critical:
            return "critical"
        if burn >= self.slo.burn_warning:
            return "warning"
        return None


def _state_position(state) -> list:
    """The round index and ASYNC seed a resumed state carries (a batch
    steps its members at one round index, ``runner.stack_states``)."""
    return [int(state.iteration), int(state.seed)]


class OverCapacityError(RuntimeError):
    """The server refused or shed this request.  ``reason`` is one of
    ``"queue"`` (bounded queue full), ``"tenant_quota"`` (per-tenant
    in-flight cap), ``"deadline"`` (shed after waiting past its deadline),
    or ``"closed"`` (server shut down with the request still queued)."""

    def __init__(self, message: str, reason: str = "capacity"):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass
class SolveRequest:
    """One tenant's problem: measurements plus solve/termination config.

    Requests whose built problems round to the same shape bucket AND agree
    on (params, dtype, max_iters, grad_norm_tol, eval_every) batch
    together; anything else dispatches separately."""

    meas: Measurements
    num_robots: int
    params: AgentParams | None = None
    tenant: str = "default"
    #: Relative deadline (seconds from submit).  A request still queued
    #: past its deadline is shed, never solved late.
    deadline_s: float | None = None
    max_iters: int | None = None
    grad_norm_tol: float = 0.1
    eval_every: int = 1
    #: None = the server device's default (float32 on CUDA, the kernel's
    #: type; float64 on the CPU).
    dtype: object = None
    #: Wire trace context ``(trace_id, span_id, origin, t_mono, t_wall)``
    #: from ``comms.protocol.unpack_trace_entries`` — the front-end passes
    #: the client's stamped context through so the request's server-side
    #: spans join the client's trace.  None (default, and always with
    #: telemetry off) starts a fresh trace per request.
    trace_ctx: tuple | None = None
    #: Durable session identity.  When the server carries a
    #: ``SessionStore``, a session-tagged request's solver state is
    #: snapshotted on solve boundaries and, if the worker dies mid-batch,
    #: the request is re-admitted from the last snapshot and completes
    #: with ``RBCDResult.recovered = True`` instead of being lost.
    session_id: str | None = None


class SolveTicket:
    """Future for one submitted request."""

    def __init__(self, request: SolveRequest):
        self.request = request
        self.t_submit = time.monotonic()
        self.t_submit_wall = time.time()
        self.t_dispatch: float | None = None
        self.t_done: float | None = None
        self._event = threading.Event()
        self._result = None
        self._exception: BaseException | None = None
        # worker-side scratch
        self._padded = None
        self._key: str | None = None
        #: set when this request was re-admitted from a session snapshot
        #: after a worker crash; stamped onto its result as ``recovered``.
        self._recovered = False
        #: snapshot iteration this request resumed from (a drained session
        #: re-admitted on a ``resume_sessions`` server picks up
        #: mid-schedule); 0 = cold start.
        self._resumed_from = 0
        # tracing context (set by submit() only when telemetry is on)
        self.trace_id: int | None = None
        self.span_admission: int | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """The ``RBCDResult``; raises the solve's exception (including
        ``OverCapacityError`` for shed requests) or ``TimeoutError``."""
        if not self._event.wait(timeout):
            raise TimeoutError("solve not finished within timeout")
        if self._exception is not None:
            raise self._exception
        return self._result

    @property
    def queue_wait_s(self) -> float | None:
        return None if self.t_dispatch is None \
            else self.t_dispatch - self.t_submit

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit

    def _finish(self, result=None, exception=None) -> None:
        self.t_done = time.monotonic()
        self._result = result
        self._exception = exception
        self._event.set()


class SolveServer:
    """Multi-tenant batched PGO solve server (in-process API).

    Use as a context manager.  ``close()`` sheds queued requests with
    ``reason="closed"``; ``close(drain=True)`` is the graceful variant
    (admission stops with structured sheds, the in-flight batch replies,
    ``/healthz`` reports ``draining`` until shutdown completes).  With a
    ``session_store``, session-tagged requests survive worker deaths: the
    supervisor re-admits them from their last snapshot and the reply
    carries ``recovered=True``."""

    def __init__(self, max_batch: int = 8, max_queue: int = 64,
                 batch_window_s: float = 0.005,
                 tenant_quota: int | None = None, quantum: int = 32,
                 init: str = "chordal",
                 slo: "ServeSLO | dict[str, ServeSLO] | None" = None,
                 metrics_port: int | None = None,
                 metrics_host: str = "127.0.0.1",
                 profile_dir: str | None = None,
                 profile_batches: int = 3,
                 verdict_every: int | None = None,
                 session_store: "SessionStore | str | None" = None,
                 session_every: int = 1,
                 worker_restarts: int = 2,
                 replica_id: str | None = None,
                 device="cuda",
                 resume_sessions: bool = False,
                 aot_cache_dir: str | None = None):
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.batch_window_s = float(batch_window_s)
        self.tenant_quota = tenant_quota
        self.quantum = int(quantum)
        self.init = init
        #: Device-resident termination for dispatched buckets: one packed
        #: [B] verdict-vector readback per this many rounds instead of the
        #: per-eval float stack (``runner.run_bucket``'s verdict mode).
        #: Requests whose ``eval_every`` does not divide it dispatch on
        #: the legacy per-eval loop.  None = legacy everywhere.
        self.verdict_every = verdict_every
        #: One ``ServeSLO`` for every tenant, or a per-tenant dict (the
        #: ``"default"`` key, when present, covers unlisted tenants).
        self.slo = slo
        #: The device every request of this server is prepared and solved
        #: on (a ``torch.device``; the card unless ``"cpu"`` is asked for).
        self.device = resolve_device(device)
        #: Crash-recovery session store (``serve.session``): session-tagged
        #: requests snapshot every ``session_every`` solve boundaries and
        #: are re-admitted from their last snapshot when the worker dies.
        #: A string is treated as the store's root directory.
        self.session_store = SessionStore(session_store, device=self.device) \
            if isinstance(session_store, str) else session_store
        self.session_every = max(int(session_every), 1)
        #: How many unexpected worker deaths the supervisor absorbs before
        #: giving up and shedding the queue (a crash-looping device should
        #: fail loudly, not spin).
        self.worker_restarts = max(int(worker_restarts), 0)
        #: Replica identity, reported by ``status()``/``/healthz`` so a
        #: health poll and ``report --live`` can tell servers apart.
        self.replica_id = replica_id
        #: Migration: admit session-tagged requests from their newest
        #: store snapshot (same bucket) instead of cold — the receiving
        #: half of ``drain()``.  Off by default: the single-server
        #: crash-recovery path re-admits explicitly and must not also
        #: resume retried requests implicitly.
        self.resume_sessions = bool(resume_sessions)
        #: One ``_run_batch`` sets this with the batch still stoppable;
        #: ``drain()``/``kill()`` set it to break the in-flight batch at
        #: its next eval boundary (after the boundary snapshot lands).
        self._interrupt = threading.Event()
        disk = None
        if aot_cache_dir is not None:
            # Lazy import: fleet's router/manager import this module.
            from .fleet.aotcache import AOTDiskCache

            disk = AOTDiskCache(aot_cache_dir)
        #: The bucket-program cache; with ``aot_cache_dir`` it carries the
        #: fleet's artifact tier (``serve.fleet.aotcache``), through which
        #: the first batch on the card binds the kernel library.
        self.cache = ExecutableCache(disk=disk)
        self._kernels_bound = False
        # One condition serializes ALL cross-thread server state: client
        # threads (submit/status/sidecar scrapes), the worker, and close.
        self._cond = threading.Condition()
        self._pending: deque[SolveTicket] = deque()   # guarded-by: _cond
        self._inflight: dict[str, int] = {}           # guarded-by: _cond
        self._closed = False                          # guarded-by: _cond
        self._draining = False                        # guarded-by: _cond
        self._terminated = False                      # guarded-by: _cond
        self._active: list[SolveTicket] = []          # guarded-by: _cond
        self._crashes = 0                             # guarded-by: _cond
        #: Live-migration mode: ``drain()`` collects interrupted and
        #: still-queued tickets here instead of finishing them, so the
        #: caller can re-admit each on another server.
        self._evacuating = False                      # guarded-by: _cond
        self._evacuated: list[SolveTicket] = []       # guarded-by: _cond
        self._t0_mono = time.monotonic()
        self._t0_wall = time.time()
        self._pid = os.getpid()
        self._device_info = {"platform": self.device.type,
                             "ordinal": int(self.device.index or 0)}
        # Plain-int liveness tallies for /statusz (server state, not obs).
        self._n_batches = 0                           # guarded-by: _cond
        self._n_requests = 0                          # guarded-by: _cond
        self._n_shed = 0                              # guarded-by: _cond
        self._last_batch: dict | None = None          # guarded-by: _cond
        self._slo_state: dict[str, _SloTracker] = {}  # guarded-by: _cond
        self.sidecar = None
        self._profiler = None
        run = obs.get_run()
        try:
            if run is not None:
                run.set_fingerprint(serve_max_batch=self.max_batch,
                                    serve_quantum=self.quantum)
                # Live endpoints and the device profiler exist only on the
                # telemetry-on path: with no run there is no registry to
                # scrape and the fence demands zero extra threads.
                if metrics_port is not None:
                    from .statusz import MetricsSidecar

                    self.sidecar = MetricsSidecar(self, run,
                                                  host=metrics_host,
                                                  port=metrics_port)
                if profile_dir is not None:
                    from ..obs.profile import ProfilerWindow

                    self._profiler = ProfilerWindow(
                        profile_dir, num_batches=profile_batches)
            self._worker = threading.Thread(target=self._supervise,
                                            daemon=True,
                                            name="dpgo-serve-worker")
            self._worker.start()
        except BaseException:
            # A half-constructed server must not strand the sidecar's
            # HTTP thread + bound socket (leakcheck-enforced contract).
            if self.sidecar is not None:
                self.sidecar.close()
            if self._profiler is not None:
                self._profiler.close()
            raise

    @property
    def metrics_url(self) -> str | None:
        """This replica's ``/metrics`` scrape URL, or None when the
        sidecar is off (no run / no ``metrics_port``) — the per-replica
        target a fleet-level aggregator merges."""
        if self.sidecar is None:
            return None
        return f"http://{self.sidecar.host}:{self.sidecar.port}/metrics"

    # -- client API ---------------------------------------------------------

    def submit(self, request: SolveRequest) -> SolveTicket:
        """Admit a request (or raise ``OverCapacityError``) and return its
        ticket.  Admission is synchronous and cheap; problem build happens
        on the worker.

        With telemetry on, admission opens the request's root ``admission``
        span: its trace id comes from the submitter's ambient span (the
        front-end's per-connection ``frontend`` span) or the wire trace
        context the client stamped (``request.trace_ctx``), so one trace
        follows the request from TCP accept to reply.  A rejected request
        closes the span tagged with the shed reason."""
        ticket = SolveTicket(request)
        run = obs.get_run()
        sp = None
        if run is not None:
            ctx = request.trace_ctx
            parent = obs_trace.current_span()
            sp = obs_trace.Span(
                run, "admission", phase="serve",
                trace_id=(ctx[0] if ctx is not None and parent is None
                          else None),
                link=ctx if parent is None else None)
            ticket.trace_id = sp.trace_id
            ticket.span_admission = sp.span_id
        try:
            with self._cond:
                if self._closed:
                    if self._draining:
                        # Graceful drain: admission stops with a structured
                        # shed (the TCP front-end turns this into a
                        # shed(reason=closed) reply, not a dropped
                        # connection).
                        self._obs_shed(request.tenant, "closed", 0.0)
                        raise OverCapacityError(
                            "server is draining: admission stopped",
                            reason="closed")
                    raise RuntimeError("server is closed")
                if len(self._pending) >= self.max_queue:
                    self._obs_shed(request.tenant, "queue", 0.0)
                    raise OverCapacityError(
                        f"queue full ({self.max_queue} requests pending)",
                        reason="queue")
                if self.tenant_quota is not None and \
                        self._inflight.get(request.tenant, 0) >= \
                        self.tenant_quota:
                    self._obs_shed(request.tenant, "tenant_quota", 0.0)
                    raise OverCapacityError(
                        f"tenant {request.tenant!r} at its in-flight quota "
                        f"({self.tenant_quota})", reason="tenant_quota")
                self._inflight[request.tenant] = \
                    self._inflight.get(request.tenant, 0) + 1
                self._pending.append(ticket)
                queue_depth = len(self._pending)
                self._cond.notify_all()
        except OverCapacityError as e:
            if sp is not None:
                sp.end(tenant=request.tenant, outcome="rejected",
                       reason=e.reason)
            raise
        except BaseException:
            if sp is not None:
                sp.end(tenant=request.tenant, outcome="error")
            raise
        if sp is not None:
            sp.end(tenant=request.tenant, outcome="queued",
                   queue_depth=queue_depth)
        return ticket

    def solve(self, request: SolveRequest, timeout: float | None = None):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(request).result(timeout)

    def warm(self, requests: list[SolveRequest]) -> int:
        """Warm pool: run representative requests through prepare -> pad ->
        batched dispatch at ``max_iters=1``, so their buckets' executables
        are compiled and cached before real traffic.  Returns the number
        of distinct buckets warmed."""
        groups: dict[str, list] = {}
        for req in requests:
            padded, key, _ = self._prepare(req)
            groups.setdefault(key, []).append((padded, req))
        self._bind_kernels()
        for members in groups.values():
            padded_list = [p for p, _ in members][:self.max_batch]
            req0 = members[0][1]
            run_bucket(padded_list, self.cache, max_iters=1,
                       grad_norm_tol=req0.grad_norm_tol,
                       eval_every=1)
        run = obs.get_run()
        if run is not None:
            run.event("serve_warm", phase="serve", buckets=len(groups),
                      requests=len(requests))
        return len(groups)

    def close(self, drain: bool = False) -> None:
        """Shut down.  ``drain=True`` is the graceful path: admission stops
        with structured ``OverCapacityError(reason="closed")`` sheds, the
        in-flight batch finishes and replies normally, queued requests are
        shed with the same structured reason, and ``/healthz`` reports
        ``draining`` for the whole window before going 503."""
        with self._cond:
            if self._closed:
                already = True
            else:
                already = False
                self._draining = bool(drain)
                self._closed = True
                self._cond.notify_all()
                run = obs.get_run()
                if drain and run is not None:
                    run.event("server_draining", phase="serve",
                              queued=len(self._pending))
        del already
        self._worker.join()
        with self._cond:
            if self._terminated:
                return
            self._terminated = True
        if self.sidecar is not None:
            self.sidecar.close()
        if self._profiler is not None:
            self._profiler.close()

    def drain(self) -> "list[SolveTicket]":
        """Live-migration drain: stop admission, break the in-flight batch
        at its next eval boundary (AFTER that boundary's session snapshot
        lands), and return every unanswered
        ticket — interrupted in-flight members plus still-queued requests
        — for the caller to re-admit elsewhere.  Session-tagged tickets
        leave fresh snapshots in the store, so re-admission on a
        ``resume_sessions`` replica continues mid-schedule.  Unlike
        ``close(drain=True)``, which lets the in-flight batch COMPLETE
        and reply, this hands the work back; the server terminates either
        way."""
        queued = 0
        with self._cond:
            first = not self._closed
            if first:
                self._evacuating = True
                self._draining = True
                self._closed = True
                self._interrupt.set()
                self._cond.notify_all()
                queued = len(self._pending)
        run = obs.get_run()
        if first and run is not None:
            run.event("server_draining", phase="serve", migrate=True,
                      queued=queued, replica=self.replica_id)
        self._worker.join()
        with self._cond:
            evacuated = list(self._evacuated)
            self._evacuated = []
            term, self._terminated = self._terminated, True
        if not term:
            if self.sidecar is not None:
                self.sidecar.close()
            if self._profiler is not None:
                self._profiler.close()
        if run is not None:
            run.event("server_drained", phase="serve",
                      replica=self.replica_id, evacuated=len(evacuated))
        return evacuated

    def kill(self) -> None:
        """Hard stop — the chaos lever and an operator's last resort.
        Admission stops immediately, the in-flight batch is interrupted at
        its next eval boundary and shed with ``reason="closed"``, queued
        requests shed the same way.  Session-tagged requests keep their
        boundary snapshots, so a retry on another server resumes instead
        of restarting."""
        with self._cond:
            if not self._closed:
                self._closed = True
                self._interrupt.set()
                self._cond.notify_all()
        self._worker.join()
        with self._cond:
            if self._terminated:
                return
            self._terminated = True
        if self.sidecar is not None:
            self.sidecar.close()
        if self._profiler is not None:
            self._profiler.close()
        run = obs.get_run()
        if run is not None:
            run.event("replica_killed", phase="serve",
                      replica=self.replica_id)

    def status(self) -> dict:
        """Live operational snapshot — the ``/statusz`` payload, shared
        with ``python -m dpgo_tpu.obs.report --live``.  Plain server
        state; safe to call with telemetry on or off."""
        with self._cond:
            queue_depth = len(self._pending)
            inflight = dict(self._inflight)
            # "closed" is the terminal state (503 on /healthz); a draining
            # server is still finishing work and reports that instead.
            closed = self._terminated
            draining = self._draining and not self._terminated
            # "accepting" is the fleet manager's liveness probe: False the
            # moment admission stops (drain begun, kill, crash-loop
            # give-up), before the terminal "closed" flips.
            accepting = not self._closed
            crashes = self._crashes
            n_requests = self._n_requests
            n_batches = self._n_batches
            n_shed = self._n_shed
            last_batch = dict(self._last_batch) if self._last_batch else None
            slo = None
            if self._slo_state:
                # Burn computation trims the trackers' rolling windows —
                # a mutation, so it stays under the lock with the rest.
                now = time.monotonic()
                slo = {t: {**trk.burn(now),
                           "level": {k: v for k, v in trk.level.items()
                                     if v is not None} or None}
                       for t, trk in sorted(self._slo_state.items())}
        tenants = {
            t: {"in_flight": n, "quota": self.tenant_quota}
            for t, n in sorted(inflight.items())
        }
        out = {
            "uptime_s": time.monotonic() - self._t0_mono,
            "closed": closed,
            "draining": draining,
            "accepting": accepting,
            # Replica identity (fleet satellite): which process/device
            # this server is, so a router health poll or report --live
            # can tell replicas apart.  replica_id is None outside a
            # fleet.
            "replica": {
                "replica_id": self.replica_id,
                "pid": self._pid,
                "start_time": self._t0_wall,
                "device": dict(self._device_info),
            },
            "worker_crashes": crashes,
            "queue_depth": queue_depth,
            "max_queue": self.max_queue,
            "max_batch": self.max_batch,
            "quantum": self.quantum,
            "tenants": tenants,
            "requests_served": n_requests,
            "batches_dispatched": n_batches,
            "requests_shed": n_shed,
            "last_batch": last_batch,
            "cache": self.cache.stats(),
        }
        if slo is not None:
            out["slo"] = slo
        return out

    def __enter__(self) -> "SolveServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker -------------------------------------------------------------

    def _prepare(self, req: SolveRequest):
        """Problem build + bucket padding for one request; returns the
        padded problem, its full batch-compatibility key, and the snapshot
        iteration it resumes from (0 = cold start).

        With ``resume_sessions`` on (the migration path), a
        session-tagged request whose store carries a snapshot of the SAME
        bucket shape resumes from that exact state: ``state0`` is stamped
        and the resume point folds into the batch key, so only requests
        at the same schedule position batch together.  A shape-mismatched
        or absent snapshot falls back to a cold solve — resume is an
        optimization of correctness already guaranteed by re-solving."""
        prob = prepare_problem(req.meas, req.num_robots, params=req.params,
                               dtype=req.dtype, init=None,
                               device=self.device)
        shape = bucket_shape_of(prob, quantum=self.quantum)
        padded = pad_problem(prob, shape, init=self.init)
        fp = problem_fingerprint(padded.meta, prob.params, prob.dtype, shape)
        fp["termination"] = [req.max_iters or prob.params.max_num_iters,
                             req.grad_norm_tol, req.eval_every]
        resumed_from = 0
        if self.resume_sessions and self.session_store is not None \
                and req.session_id is not None:
            snap = self.session_store.load_newest(req.session_id)
            if snap is not None and snap.meta.get("bucket") == list(shape):
                padded = dataclasses.replace(padded, state0=snap.state)
                resumed_from = int(snap.iteration)
        if resumed_from:
            fp["resume"] = resumed_from
            fp["state0"] = _state_position(padded.state0)
        return padded, fingerprint_key(fp), resumed_from

    def _release(self, tickets) -> None:
        with self._cond:
            for t in tickets:
                tenant = t.request.tenant
                n = self._inflight.get(tenant, 1) - 1
                if n <= 0:
                    self._inflight.pop(tenant, None)
                else:
                    self._inflight[tenant] = n

    def _supervise(self) -> None:
        """Worker supervisor: run the drain loop; on an unexpected worker
        death (anything escaping ``_loop`` — ``_run_batch`` already
        contains per-batch solver failures) re-admit the in-flight batch
        from session snapshots and respawn, up to ``worker_restarts``
        times.  A TaskStop-style kill therefore loses no session-tagged
        request and leaks no thread: the supervisor thread IS the next
        worker."""
        while True:
            try:
                self._loop()
                return
            except BaseException as e:  # the worker died mid-batch
                if not self._recover_from_crash(e):
                    return

    def _recover_from_crash(self, exc: BaseException) -> bool:
        """Re-admit the crashed batch (session-tagged tickets resume from
        their newest valid snapshot; the rest fail with the crash), then
        decide whether to respawn.  Returns True to run another worker
        iteration."""
        with self._cond:
            self._crashes += 1
            crashes = self._crashes
            active, self._active = self._active, []
            closed = self._closed
        run = obs.get_run()
        if run is not None:
            run.event("worker_crashed", phase="serve",
                      error=f"{type(exc).__name__}: {exc}",
                      crashes=crashes, in_flight=len(active))
        recovered, lost = [], []
        for t in active:
            snap = None
            sid = t.request.session_id
            if self.session_store is not None and sid is not None:
                snap = self.session_store.load_newest(sid)
            if snap is not None and t._padded is not None:
                t._padded = dataclasses.replace(t._padded,
                                                state0=snap.state)
                # A batch steps its members at one round index: the
                # resumed ticket batches only with tickets at its own.
                t._key = f"{t._key}|{_state_position(snap.state)}"
                t._recovered = True
                recovered.append(t)
            else:
                lost.append(t)
        for t in lost:
            t._finish(exception=RuntimeError(
                f"solve worker died mid-batch "
                f"({type(exc).__name__}: {exc}) and no session snapshot "
                "was available to recover from"))
        self._release(lost)
        with self._cond:
            # Recovered tickets go back to the FRONT of the queue (they
            # were already dispatched once); in-flight accounting never
            # dropped them, so quotas stay consistent.
            for t in reversed(recovered):
                self._pending.appendleft(t)
            if recovered:
                self._cond.notify_all()
        if run is not None and recovered:
            run.counter("session_recoveries_total",
                        "requests re-admitted from session snapshots "
                        "after a worker crash").inc(len(recovered))
            for t in recovered:
                run.event("session_recovered", phase="serve",
                          session=t.request.session_id,
                          tenant=t.request.tenant)
        if closed or crashes > self.worker_restarts:
            # Give up: shed whatever is left so no caller blocks forever.
            with self._cond:
                leftovers = list(self._pending)
                self._pending.clear()
                self._closed = True
            for t in leftovers:
                t._finish(exception=OverCapacityError(
                    "solve worker crash-looped; server gave up",
                    reason="closed"))
            self._release(leftovers)
            return False
        return True

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed:
                    leftovers = list(self._pending)
                    self._pending.clear()
                    evacuate = self._evacuating
                    if evacuate:
                        # Migration drain: queued work is evacuated for
                        # the router to re-admit, not shed.
                        self._evacuated.extend(leftovers)
                    break
                n_pending = len(self._pending)
            # Batching window: give concurrent submitters a moment to
            # coalesce before forming a batch (skip when already full).
            if n_pending < self.max_batch and self.batch_window_s > 0:
                with obs_trace.span("coalesce", phase="serve",
                                    pending=n_pending):
                    time.sleep(self.batch_window_s)
            self._dispatch_once()
        if not evacuate:
            for t in leftovers:
                t._finish(exception=OverCapacityError(
                    "server closed with request still queued",
                    reason="closed"))
        self._release(leftovers)

    def _dispatch_once(self) -> None:
        with self._cond:
            snapshot = list(self._pending)
        if not snapshot:
            return
        now = time.monotonic()
        run = obs.get_run()
        shed, failed = [], []
        for t in snapshot:
            dl = t.request.deadline_s
            if dl is not None and (now - t.t_submit) > dl:
                shed.append(t)
                continue
            if t._padded is None:
                sp = None
                if run is not None and t.trace_id is not None:
                    sp = obs_trace.Span(run, "prepare", phase="serve",
                                        trace_id=t.trace_id,
                                        parent_id=t.span_admission)
                try:
                    with sp or obs_trace.NULL_SPAN:
                        t._padded, t._key, t._resumed_from = \
                            self._prepare(t.request)
                    if t._resumed_from:
                        # Migration resume is a recovery-from-snapshot:
                        # the reply discloses it the same way the crash
                        # path does.
                        t._recovered = True
                except Exception as e:  # bad request: report, don't die
                    t._finish(exception=e)
                    failed.append(t)
        for t in shed:
            waited = now - t.t_submit
            t._finish(exception=OverCapacityError(
                f"deadline ({t.request.deadline_s:.3f}s) expired after "
                f"{waited:.3f}s in queue", reason="deadline"))
            self._obs_shed(t.request.tenant, "deadline", waited)
            if run is not None and t.trace_id is not None:
                # The request's trace closes with a reason-tagged span
                # covering its whole queued life.
                obs_trace.emit_span(
                    run, "shed", t.t_submit, t.t_submit_wall, waited,
                    phase="serve", trace_id=t.trace_id,
                    parent_id=t.span_admission, reason="deadline",
                    tenant=t.request.tenant)
        drop = set(shed) | set(failed)
        ready = [t for t in snapshot if t not in drop and t._padded is not None]
        batch = []
        if ready:
            lead_key = ready[0]._key
            batch = [t for t in ready if t._key == lead_key][:self.max_batch]
        with self._cond:
            for t in list(drop) + batch:
                try:
                    self._pending.remove(t)
                except ValueError:
                    pass
        self._release(list(drop))
        if batch:
            self._run_batch(batch)

    def _bind_kernels(self) -> None:
        """Bind the kernel library through the artifact tier once, before
        the first batch on the card (``aotcache.resolve_kernel_library``:
        bound, else disk, else build and store).  A failed build raises;
        a CPU server, or one without the tier, does nothing."""
        if self._kernels_bound or self.cache.disk is None \
                or self.device.type != "cuda":
            return
        from .fleet.aotcache import resolve_kernel_library

        resolve_kernel_library(self.cache.disk)
        self._kernels_bound = True

    def _run_batch(self, tickets: list[SolveTicket]) -> None:
        t0 = time.monotonic()
        t0_wall = time.time()
        for t in tickets:
            t.t_dispatch = t0
        req0 = tickets[0].request
        run = obs.get_run()
        dsp = None
        if run is not None:
            # One shared dispatch span per batch; the runner's
            # stack/device_dispatch/slice spans nest under it via the
            # worker thread's span stack.  Each batch mate contributes a
            # flow arrow: its queue-wait closes on its own trace, and a
            # batch_member child span here links back to its admission
            # span, so Perfetto draws N request lanes converging on the
            # one batched executable.
            dsp = obs_trace.Span(run, "dispatch", phase="serve")
            dsp.add(size=len(tickets))
            dsp.__enter__()
            for t in tickets:
                if t.trace_id is None:
                    continue
                obs_trace.emit_span(
                    run, "queue_wait", t.t_submit, t.t_submit_wall,
                    t0 - t.t_submit, phase="serve", trace_id=t.trace_id,
                    parent_id=t.span_admission, tenant=t.request.tenant)
                obs_trace.emit_span(
                    run, "batch_member", t0, t0_wall, 0.0, phase="serve",
                    tenant=t.request.tenant,
                    link=(t.trace_id, t.span_admission,
                          ORIGIN_SERVE_SERVER, t.t_submit, t.t_submit_wall))
        if self._profiler is not None:
            self._profiler.batch_begin()
        session_cb = self._session_cb(tickets)
        with self._cond:
            # The crash-recovery set: whatever the supervisor finds here
            # when the worker dies is the batch that was in flight.
            self._active = list(tickets)
        try:
            self._bind_kernels()
            ve = self.verdict_every
            if ve is not None and ve % max(req0.eval_every, 1) != 0:
                ve = None  # incompatible cadence: legacy per-eval loop
            max_iters = req0.max_iters
            resume0 = tickets[0]._resumed_from
            if resume0:
                # Resumed sessions run their REMAINING budget: the batch
                # key folds the resume point in, so every member agrees.
                # Floored at one eval so the reply always carries a
                # history row (extra rounds only polish — monotone under
                # the plain schedule).
                base = max_iters if max_iters is not None \
                    else tickets[0]._padded.prob.params.max_num_iters
                max_iters = max(base - resume0, max(req0.eval_every, 1))
            results, info = run_bucket(
                [t._padded for t in tickets], self.cache,
                max_iters=max_iters, grad_norm_tol=req0.grad_norm_tol,
                eval_every=req0.eval_every, verdict_every=ve,
                session_cb=session_cb, session_every=self.session_every,
                should_stop=self._interrupt.is_set)
        except Exception as e:
            for t in tickets:
                t._finish(exception=e)
            self._release(tickets)
            with self._cond:
                self._active = []
            if dsp is not None:
                dsp.__exit__(type(e), e, None)
            if self._profiler is not None:
                self._profiler.batch_end()
            return
        if info.get("interrupted"):
            # drain()/kill() broke the batch at an eval boundary (the
            # boundary snapshot already landed): nobody gets a reply from
            # this partial solve.  Draining evacuates the tickets for the
            # router to re-admit elsewhere; a kill sheds them (session-
            # tagged requests resume from their snapshots on retry).
            with self._cond:
                self._active = []
                evacuating = self._evacuating
                if evacuating:
                    self._evacuated.extend(tickets)
            if not evacuating:
                for t in tickets:
                    t._finish(exception=OverCapacityError(
                        "replica killed with the batch in flight; "
                        "session-tagged requests resume from their last "
                        "snapshot", reason="closed"))
            self._release(tickets)
            if run is not None:
                run.event("batch_interrupted", phase="serve",
                          size=len(tickets), evacuating=evacuating,
                          replica=self.replica_id)
            if dsp is not None:
                dsp.add(interrupted=True)
                dsp.__exit__(None, None, None)
            if self._profiler is not None:
                self._profiler.batch_end()
            return
        with self._cond:
            self._active = []
        for t, res in zip(tickets, results):
            if t._recovered:
                res.recovered = True
            sid = t.request.session_id
            if self.session_store is not None and sid is not None:
                # The request completed; its recovery snapshots are spent.
                self.session_store.discard(sid)
            t._finish(result=res)
        self._release(tickets)
        if self._profiler is not None:
            self._profiler.batch_end()
        duration_s = time.monotonic() - t0
        if dsp is not None:
            dsp.add(rounds=info["rounds"], occupancy=info["occupancy"])
            dsp.__exit__(None, None, None)
            dispatch_ctx = (dsp.trace_id, dsp.span_id,
                            ORIGIN_SERVE_SERVER, t0, t0_wall)
            for t, res in zip(tickets, results):
                if t.trace_id is None:
                    continue
                # Reply span closes the request's trace, with a flow
                # arrow in from the shared dispatch span.  A certified
                # request's reply span carries the verdict, so the trace
                # reads decode -> admission -> dispatch -> certified
                # reply end to end.
                cert = getattr(res, "certificate", None)
                cert_attrs = {} if cert is None else {
                    "certified": bool(cert.certified),
                    "cert_lambda_min": float(cert.lambda_min)}
                obs_trace.emit_span(
                    run, "reply", t.t_done, time.time(), 0.0,
                    phase="serve", trace_id=t.trace_id,
                    parent_id=t.span_admission, tenant=t.request.tenant,
                    latency_s=t.latency_s, link=dispatch_ctx, **cert_attrs)
        with self._cond:
            self._n_batches += 1
            self._n_requests += len(tickets)
            self._last_batch = {"size": info["size"],
                                "batch": info["batch"],
                                "occupancy": info["occupancy"],
                                "rounds": info["rounds"],
                                "duration_s": duration_s}
        self._obs_batch(tickets, results, info, duration_s)

    def _session_cb(self, tickets):
        """The runner's snapshot hook for this batch: persist each
        session-tagged member's sliced state.  None when no store is
        configured or no member carries a session id (zero overhead on
        the common path)."""
        if self.session_store is None:
            return None
        tagged = [(i, t.request.session_id) for i, t in enumerate(tickets)
                  if t.request.session_id is not None]
        if not tagged:
            return None
        store = self.session_store

        def cb(iteration, states):
            for i, sid in tagged:
                t = tickets[i]
                # Snapshot sequence numbers are ABSOLUTE session
                # iterations: a resumed batch counts from zero, so its
                # resume base is added back — a later migration of the
                # same session budgets its remaining iterations right.
                # The bucket shape rides the meta so only a same-shape
                # server resumes the state (migration).
                store.save(sid, states[i],
                           iteration=int(iteration) + t._resumed_from,
                           meta={"tenant": t.request.tenant,
                                 "bucket": list(t._padded.shape)})
        return cb

    # -- telemetry (every site behind the zero-overhead fence) --------------

    def _slo_for(self, tenant: str) -> "ServeSLO | None":
        if self.slo is None:
            return None
        if isinstance(self.slo, ServeSLO):
            return self.slo
        return self.slo.get(tenant, self.slo.get("default"))

    def _slo_tracker(self, tenant: str) -> "_SloTracker | None":
        """The tenant's burn tracker (lazily created) — callers are
        already behind the telemetry fence."""
        slo = self._slo_for(tenant)
        if slo is None:
            return None
        with self._cond:
            trk = self._slo_state.get(tenant)
            if trk is None:
                trk = self._slo_state[tenant] = _SloTracker(slo)
        return trk

    def _slo_evaluate(self, run, tenant: str, trk: "_SloTracker") -> None:
        """Burn-rate gauges every evaluation; one ``slo_burn`` anomaly per
        level transition (through ``obs.health``'s callback/abort/dump
        machinery), one ``slo_recovered`` event on the way back down."""
        now = time.monotonic()
        # Trackers are touched by client threads (shed at admission) and
        # the worker (request completions): burn/level transitions happen
        # under the server lock so a transition is decided exactly once.
        # self._cond is reentrant (threading.Condition wraps an RLock) and
        # the registry/event locks nest strictly inside it — one order.
        with self._cond:
            burn = trk.burn(now)
            g = run.gauge("serve_slo_burn_rate",
                          "error-budget burn rate over the rolling SLO "
                          "window (1.0 = consuming exactly the budget)")
            for slo_kind, rate in (("latency", burn["latency_burn"]),
                                   ("shed", burn["shed_burn"])):
                g.set(rate, tenant=tenant, slo=slo_kind)
                level = trk.classify(rate)
                prev = trk.level[slo_kind]
                if level == prev:
                    continue
                trk.level[slo_kind] = level
                if level is not None:
                    obs.monitor_for(run).anomaly(
                        "slo_burn", severity=level, tenant=tenant,
                        slo=slo_kind, burn_rate=rate,
                        window_s=trk.slo.window_s,
                        requests=burn["requests"], slow=burn["slow"],
                        shed=burn["shed"])
                elif prev is not None:
                    run.event("slo_recovered", phase="serve", tenant=tenant,
                              slo=slo_kind, burn_rate=rate)

    def _obs_shed(self, tenant: str, reason: str, waited_s: float) -> None:
        run = obs.get_run()
        with self._cond:
            self._n_shed += 1
        if run is None:
            return
        run.counter("serve_shed_total",
                    "requests shed by admission control").inc(
            tenant=tenant, reason=reason)
        run.event("serve_shed", phase="serve", tenant=tenant, reason=reason,
                  waited_s=waited_s)
        trk = self._slo_tracker(tenant)
        if trk is not None:
            with self._cond:  # tracker windows are shared mutable state
                trk.observe_shed(time.monotonic())
            self._slo_evaluate(run, tenant, trk)

    def _obs_batch(self, tickets, results, info, duration_s: float) -> None:
        run = obs.get_run()
        if run is None:
            return
        bucket = str(tuple(tickets[0]._padded.shape))
        run.gauge("serve_batch_occupancy",
                  "fraction of the batched executable's slots carrying "
                  "real requests").set(info["occupancy"])
        run.event("serve_batch", phase="serve", bucket=bucket,
                  size=info["size"], batch=info["batch"],
                  occupancy=info["occupancy"], rounds=info["rounds"],
                  evals=info["evals"], duration_s=duration_s,
                  cache=self.cache.stats())
        c_req = run.counter("serve_requests_total", "requests served")
        h_wait = run.histogram("serve_queue_wait_seconds",
                               "submit -> dispatch wait", unit="s")
        h_lat = run.histogram("serve_solve_latency_seconds",
                              "submit -> result latency", unit="s")
        for t, res in zip(tickets, results):
            tenant = t.request.tenant
            c_req.inc(tenant=tenant)
            h_wait.observe(t.queue_wait_s or 0.0, tenant=tenant)
            h_lat.observe(t.latency_s or 0.0, tenant=tenant)
            run.event(
                "serve_request", phase="serve", tenant=tenant, bucket=bucket,
                queue_wait_s=t.queue_wait_s, latency_s=t.latency_s,
                iterations=res.iterations, terminated_by=res.terminated_by,
                cost=res.cost_history[-1] if res.cost_history else None,
                grad_norm=res.grad_norm_history[-1]
                if res.grad_norm_history else None)
            trk = self._slo_tracker(tenant)
            if trk is not None:
                with self._cond:  # tracker windows are shared mutable state
                    trk.observe_request(time.monotonic(),
                                        t.latency_s or 0.0)
                self._slo_evaluate(run, tenant, trk)

"""Replica lifecycle: spawn, health-monitor, respawn, autoscale (port of
``dpgo_tpu.serve.fleet.manager``).

``ReplicaManager`` owns the pool of ``Replica``\\ s the router hashes
over.  Each replica is one ``SolveServer`` (or an out-of-process
``procs.ProcServer``) built by the caller's ``make_server(replica_id)``
factory — the factory decides device placement (``SolveServer(device=
...)``; on one card every replica is ``cuda:0``, and in-process replicas
share its CUDA context and default stream), snapshot/session stores, and
the shared ``aot_cache_dir`` that lets a freshly spawned replica bind the
fleet's kernel library without running ``nvcc``.

A daemon monitor thread (joined on ``close``, so the leak-check plugin
stays green) probes each replica's ``status()["accepting"]`` every
``monitor_interval_s``:

* a replica found dead (crashed worker, external ``kill()``) is retired,
  its stranded tickets re-admitted through ``router.reroute_dead``, and a
  fresh replica spawned in its place while the pool is below
  ``min_replicas``;
* sustained queue-wait burn above ``scale_up_burn`` (measured by the same
  ``_SloTracker`` the admission shed uses — here as a functional input,
  not telemetry) spawns a replica up to ``max_replicas``; burn below
  ``scale_down_burn`` live-migrates the newest replica's sessions away
  (``router.migrate_from``) and retires it, down to ``min_replicas``.

The default ``max_replicas == min_replicas`` disables autoscaling, so
tests and fixed-size deployments get a deterministic pool.
"""

from __future__ import annotations

import threading
import time

from ... import obs
from ..server import OverCapacityError, ServeSLO, _SloTracker


class Replica:
    """One managed solve replica: an id, its server, and liveness."""

    def __init__(self, replica_id: str, server):
        self.replica_id = str(replica_id)
        self.server = server
        self.spawned_at = time.monotonic()
        #: Set by ``FleetRouter.migrate_from`` before the drain starts:
        #: the drainer owns this replica's tickets, so the health monitor
        #: must retire it WITHOUT racing a ``reroute_dead`` of its own.
        self.draining = False

    def alive(self) -> bool:
        """Liveness = the server says it is accepting work.  A crashed,
        killed, draining, or closed server all read as dead."""
        try:
            return bool(self.server.status().get("accepting"))
        except Exception:
            return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Replica({self.replica_id!r}, alive={self.alive()})"


class ReplicaManager:
    """Spawns/monitors/retires replicas; the router's source of truth."""

    def __init__(self, make_server, min_replicas: int = 1,
                 max_replicas: int | None = None,
                 monitor_interval_s: float = 0.2,
                 respawn: bool = True,
                 queue_wait_slo_s: float = 0.25,
                 scale_window_s: float = 5.0,
                 scale_up_burn: float = 1.0,
                 scale_down_burn: float = 0.05,
                 scale_cooldown_s: float = 2.0,
                 min_scale_observations: int = 8,
                 metrics_port: int | None = None):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        self.make_server = make_server
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas) if max_replicas is not None \
            else self.min_replicas
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self.monitor_interval_s = float(monitor_interval_s)
        self.respawn = bool(respawn)
        self.queue_wait_slo_s = float(queue_wait_slo_s)
        self.scale_up_burn = float(scale_up_burn)
        self.scale_down_burn = float(scale_down_burn)
        self.scale_cooldown_s = float(scale_cooldown_s)
        self.min_scale_observations = int(min_scale_observations)
        self.metrics_port = metrics_port
        #: Fleet-level ``/metrics`` + ``/statusz`` aggregator; constructed
        #: in ``start()`` behind the telemetry fence (None when off).
        self.sidecar = None

        self._lock = threading.Lock()
        self._replicas: list[Replica] = []  # guarded-by: _lock
        self._seq = 0                       # guarded-by: _lock
        self._router = None
        self._stop = threading.Event()
        self._monitor = None
        self._started = False               # guarded-by: _lock
        self._closed = False                # guarded-by: _lock
        # Functional reuse of the burn-rate machinery (not telemetry):
        # queue wait stands in for latency, the SLO is the wait target.
        self._tracker = _SloTracker(ServeSLO(
            latency_s=self.queue_wait_slo_s, latency_target=0.5,
            window_s=float(scale_window_s)))
        self._n_waits = 0                   # guarded-by: _lock
        self._last_scale = 0.0              # guarded-by: _lock
        self.spawned = 0                    # guarded-by: _lock
        self.retired = 0                    # guarded-by: _lock
        self.respawns = 0                   # guarded-by: _lock
        self.scale_ups = 0                  # guarded-by: _lock
        self.scale_downs = 0                # guarded-by: _lock

    # -- pool ---------------------------------------------------------------

    def attach_router(self, router) -> None:
        self._router = router

    def replicas(self) -> list[Replica]:
        with self._lock:
            return list(self._replicas)

    def get(self, replica_id: str) -> Replica | None:
        with self._lock:
            for r in self._replicas:
                if r.replica_id == replica_id:
                    return r
        return None

    def start(self) -> None:
        """Bring the pool to ``min_replicas`` and start the monitor.
        Idempotent."""
        with self._lock:
            if self._started:
                return
            self._started = True
        while len(self.replicas()) < self.min_replicas:
            self.spawn(reason="start")
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="dpgo-fleet-monitor", daemon=True)
        self._monitor.start()
        if self.metrics_port is not None:
            from ...obs import fleetobs
            self.sidecar = fleetobs.attach_fleet_sidecar(
                fleetobs.ReplicaFleetSource(self), port=self.metrics_port)

    def spawn(self, reason: str = "manual") -> Replica:
        with self._lock:
            if self._closed:
                raise RuntimeError("manager is closed")
            rid = f"r{self._seq}"
            self._seq += 1
        server = self.make_server(rid)
        if getattr(server, "replica_id", None) is None:
            server.replica_id = rid
        replica = Replica(rid, server)
        with self._lock:
            self._replicas.append(replica)
            self.spawned += 1
        run = obs.get_run()
        if run is not None:
            run.counter("fleet_replicas_spawned_total",
                        "replicas brought up by the manager").inc(
                reason=reason)
            run.event("replica_spawn", phase="fleet", replica=rid,
                      reason=reason, pool=len(self.replicas()))
        return replica

    def _retire(self, replica: Replica) -> None:
        with self._lock:
            try:
                self._replicas.remove(replica)
            except ValueError:
                return
            self.retired += 1

    def kill_replica(self, replica_id: str) -> bool:
        """Hard-kill one replica (chaos lever for soaks/tests): sheds its
        in-flight batch at the next boundary, retires it, re-admits the
        stranded tickets, and respawns if the pool dropped below
        ``min_replicas``."""
        replica = self.get(replica_id)
        if replica is None:
            return False
        self._retire(replica)
        replica.server.kill()
        if self._router is not None:
            self._router.reroute_dead(replica)
        with self._lock:
            need = self.respawn and not self._closed \
                and len(self._replicas) < self.min_replicas
        if need:
            with self._lock:
                self.respawns += 1
            self.spawn(reason="respawn")
        return True

    # -- autoscale input ----------------------------------------------------

    def observe_queue_wait(self, wait_s: float) -> None:
        """Router feedback: one completed request's queue wait.  Waits
        beyond ``queue_wait_slo_s`` burn the tracker's error budget."""
        with self._lock:
            self._tracker.observe_request(time.monotonic(), float(wait_s))
            self._n_waits += 1

    # -- monitor ------------------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.monitor_interval_s):
            try:
                self._check_health()
                self._check_scale()
            except Exception as e:  # monitor must survive anything
                run = obs.get_run()
                if run is not None:
                    run.event("fleet_monitor_error", phase="fleet",
                              error=f"{type(e).__name__}: {e}")

    def _check_health(self) -> None:
        for replica in self.replicas():
            if replica.alive():
                continue
            self._retire(replica)
            if not replica.draining:
                run = obs.get_run()
                if run is not None:
                    run.counter("fleet_replica_deaths_total",
                                "replicas found dead by the monitor").inc()
                    run.event("replica_death", phase="fleet",
                              replica=replica.replica_id,
                              pool=len(self.replicas()))
                if self._router is not None:
                    self._router.reroute_dead(replica)
            with self._lock:
                need = self.respawn and not self._closed \
                    and len(self._replicas) < self.min_replicas
            if need:
                with self._lock:
                    self.respawns += 1
                self.spawn(reason="respawn")

    def _check_scale(self) -> None:
        if self.max_replicas <= self.min_replicas:
            return  # autoscaling disabled (the deterministic default)
        with self._lock:
            if self._n_waits < self.min_scale_observations:
                return
            if time.monotonic() - self._last_scale < self.scale_cooldown_s:
                return
        with self._lock:
            burn = self._tracker.burn(time.monotonic())["latency_burn"]
        n = len(self.replicas())
        if burn >= self.scale_up_burn and n < self.max_replicas:
            self._mark_scaled()
            self.spawn(reason="scale_up")
            with self._lock:
                self.scale_ups += 1
            self._obs_scale("up", burn)
        elif burn <= self.scale_down_burn and n > self.min_replicas:
            self._mark_scaled()
            self.scale_down()
            self._obs_scale("down", burn)

    def _mark_scaled(self) -> None:
        with self._lock:
            self._last_scale = time.monotonic()
            self._n_waits = 0

    def _obs_scale(self, direction: str, burn: float) -> None:
        run = obs.get_run()
        if run is not None:
            run.counter("fleet_scale_events_total",
                        "autoscaler decisions").inc(direction=direction)
            run.event("fleet_scale", phase="fleet", direction=direction,
                      burn=burn, pool=len(self.replicas()))

    def scale_down(self, replica_id: str | None = None) -> bool:
        """Retire one replica gracefully: live-migrate its sessions via
        the router's drain path, then close it.  Victim defaults to the
        newest replica (rendezvous hashing keeps the remap set minimal
        either way)."""
        with self._lock:
            if len(self._replicas) <= self.min_replicas:
                return False
            pool = list(self._replicas)
        victim = None
        if replica_id is not None:
            victim = self.get(replica_id)
        else:
            victim = max(pool, key=lambda r: r.spawned_at)
        if victim is None:
            return False
        # Retire first so the router stops hashing new work onto it,
        # then evacuate what it already holds.
        self._retire(victim)
        with self._lock:
            self.scale_downs += 1
        if self._router is not None:
            self._router.migrate_from(victim)
        else:
            for t in victim.server.drain():
                if not t.done():
                    t._finish(exception=OverCapacityError(
                        "replica retired", reason="closed"))
        victim.server.close()
        return True

    # -- shutdown -----------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        if self.sidecar is not None:
            try:
                self.sidecar.close()
            except Exception:
                pass
            self.sidecar = None
        if self._monitor is not None:
            self._monitor.join(timeout=10.0)
        for replica in self.replicas():
            self._retire(replica)
            try:
                replica.server.close()
            except Exception:
                pass

    def __enter__(self) -> "ReplicaManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def status(self) -> dict:
        with self._lock:
            out = {"spawned": self.spawned, "retired": self.retired,
                   "respawns": self.respawns, "scale_ups": self.scale_ups,
                   "scale_downs": self.scale_downs,
                   "min_replicas": self.min_replicas,
                   "max_replicas": self.max_replicas,
                   "pool": [r.replica_id for r in self._replicas]}
            out["burn"] = self._tracker.burn(time.monotonic())
        return out

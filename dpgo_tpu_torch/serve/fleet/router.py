"""Session-affinity request router over a pool of solve replicas (port of
``dpgo_tpu.serve.fleet.router``).

``FleetRouter`` is the fleet's front door: it exposes the familiar
``submit``/``solve``/``status``/``close`` surface (so ``ServeFrontend``
can sit on it unchanged) and hashes each request onto one of the
manager's ``Replica``\\ s with rendezvous (highest-random-weight)
hashing — the scheme whose remap set under pool churn is exactly the
keys owned by the departed replica, so an autoscale event does not
reshuffle every session's affinity.

Two key classes, in priority order:

* session-tagged requests hash on ``session_id`` — a live session keeps
  landing on the replica that holds its warm state and snapshot cadence;
* untagged requests hash on a cheap *bucket proxy* (quantum-rounded pose
  and measurement counts, robots, rank, dtype — computable from the raw
  ``Measurements`` without building the problem), so same-shape traffic
  coalesces onto the same replica and batch occupancy survives the
  fan-out.

``RouterTicket`` is the client future.  Migration is transparent inside
it: when the ticket's replica is drained (live migration, scale-down,
rolling restart) or dies, the router re-admits the request on the next
replica in rendezvous order and the waiter keeps waiting — ``result()``
only raises once the request truly failed (admission refusal everywhere,
or the migration cap).  Session-tagged requests re-admit onto
``resume_sessions`` replicas, which pick the solve up from the drained
replica's final boundary snapshot instead of restarting it.

The keys are the JAX package's, character for character: a request's
dtype reads ``float64``/``float32``, and a request that leaves it to the
replica (``dtype=None``) keys on the dtype its replicas solve in
(``device.default_dtype`` of their device: float32 on the card).
"""

from __future__ import annotations

import hashlib
import threading
import time

import numpy as np
import torch

from ... import obs
from ...device import default_dtype
from ...obs.recorder import dtype_name
from ..server import OverCapacityError, SolveRequest

#: A request that keeps landing on dying/draining replicas is eventually
#: failed rather than bounced forever.
DEFAULT_MAX_MIGRATIONS = 8


class _Migrated(Exception):
    """Internal wake-up: the ticket's inner future was superseded by a
    re-admission on another replica.  Never escapes ``RouterTicket``."""


def _is_replica_death(e: BaseException) -> bool:
    """Failures that mean "this replica is gone", not "this request is
    bad" — the distinction between re-routing and failing the caller."""
    if isinstance(e, OverCapacityError):
        return e.reason == "closed"
    if isinstance(e, RuntimeError):
        msg = str(e)
        return "closed" in msg or "died mid-batch" in msg
    return False


def _hrw_weight(key: str, replica_id: str) -> bytes:
    return hashlib.blake2b(f"{key}|{replica_id}".encode("utf-8"),
                           digest_size=8).digest()


class RouterTicket:
    """Future for one routed request; survives replica churn.

    ``result()`` blocks through migrations: the inner per-replica ticket
    may be swapped any number of times (up to ``max_migrations``) before
    a reply lands.  ``migrations`` counts the swaps."""

    def __init__(self, router: "FleetRouter", request: SolveRequest):
        self.request = request
        self.t_submit = time.monotonic()
        self._router = router
        self._cv = threading.Condition()
        self._inner = None        # guarded-by: _cv
        self._replica = None      # guarded-by: _cv
        self._gen = 0             # guarded-by: _cv
        self._migrating = False   # guarded-by: _cv
        self._terminal = None     # guarded-by: _cv
        self.migrations = 0       # guarded-by: _cv

    def done(self) -> bool:
        with self._cv:
            if self._terminal is not None:
                return True
            if self._migrating or self._inner is None:
                return False
            inner = self._inner
        if not inner.done():
            return False
        try:
            inner.result(timeout=0)
        except BaseException as e:
            # A death/migration marker means "moving", not "done".
            return not (_is_replica_death(e) or isinstance(e, _Migrated))
        return True

    def result(self, timeout: float | None = None):
        """The ``RBCDResult`` (or raises): waits across migrations."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cv:
                while self._migrating and self._terminal is None:
                    rem = None if deadline is None \
                        else deadline - time.monotonic()
                    if rem is not None and rem <= 0:
                        raise TimeoutError(
                            "solve not finished within timeout")
                    self._cv.wait(timeout=1.0 if rem is None
                                  else min(rem, 1.0))
                if self._terminal is not None:
                    exc = self._terminal
                    self._router._done(self)
                    raise exc
                inner, gen = self._inner, self._gen
            rem = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            try:
                res = inner.result(timeout=rem)
            except _Migrated:
                continue  # inner superseded: loop picks up the new one
            except TimeoutError:
                with self._cv:
                    if gen != self._gen or self._migrating:
                        continue  # migrated right at the deadline: retry
                raise
            except (OverCapacityError, RuntimeError) as e:
                if not _is_replica_death(e):
                    self._router._done(self)
                    raise
                # The replica went away under us: re-admit and keep
                # waiting (the lazy half of failure detection — the
                # manager's monitor is the eager half; _reroute is
                # idempotent so both may fire).
                self._router._reroute(self, inner, kind="death")
                continue
            self._router._observe(inner)
            self._router._done(self)
            return res


class FleetRouter:
    """Rendezvous-hash router over a ``ReplicaManager``'s pool."""

    def __init__(self, manager, max_migrations: int = DEFAULT_MAX_MIGRATIONS,
                 quantum: int = 32):
        self.manager = manager
        self.max_migrations = int(max_migrations)
        self.quantum = max(int(quantum), 1)
        self._lock = threading.Lock()
        self._live: set = set()   # guarded-by: _lock
        self.migrations = 0       # guarded-by: _lock
        self._n_routed = 0        # guarded-by: _lock
        manager.attach_router(self)
        manager.start()

    # -- placement ----------------------------------------------------------

    def route_key(self, request: SolveRequest) -> str:
        """Affinity key: the session id when there is one, else the
        bucket proxy (cheap shape summary of the raw measurements —
        requests that would pad into the same bucket share it)."""
        if request.session_id is not None:
            return f"s|{request.session_id}"
        q = self.quantum
        n = max(int(request.meas.num_poses), 1)
        m = max(int(np.asarray(request.meas.kappa).shape[0]), 1)
        rank = request.params.r if request.params is not None else "-"
        return (f"b|{-(-n // q) * q}|{-(-m // q) * q}|"
                f"{int(request.num_robots)}|{rank}|"
                f"{self._dtype_key(request.dtype)}")

    def _dtype_key(self, dtype) -> str:
        """numpy's spelling of the dtype the request solves in: its own,
        or — for ``None`` — the default of the pool's device (a fleet's
        replicas are homogeneous; the card when the pool is empty)."""
        if dtype is None:
            dev = next((getattr(r.server, "device", None)
                        for r in self.manager.replicas()), None)
            dtype = default_dtype(torch.device(dev if dev is not None
                                               else "cuda"))
        if isinstance(dtype, torch.dtype):
            return dtype_name(dtype)
        return str(np.dtype(dtype))

    def _pick(self, request: SolveRequest, exclude):
        alive = [r for r in self.manager.replicas()
                 if r not in exclude and r.alive()]
        if not alive:
            return None
        key = self.route_key(request)
        return max(alive, key=lambda r: _hrw_weight(key, r.replica_id))

    def _submit_once(self, request: SolveRequest, exclude=frozenset()):
        """Admit on the rendezvous-first alive replica, falling through
        the rendezvous order past full/closing replicas.  Raises the
        structured admission error when nobody accepts."""
        tried = set(exclude)
        while True:
            replica = self._pick(request, tried)
            if replica is None:
                raise OverCapacityError(
                    "no alive replica accepted the request",
                    reason="closed")
            try:
                return replica, replica.server.submit(request)
            except OverCapacityError as e:
                if e.reason in ("queue", "closed"):
                    tried.add(replica)
                    continue
                raise  # tenant_quota/deadline: a real admission decision
            except RuntimeError:  # "server is closed" raced the pick
                tried.add(replica)
                continue

    # -- client API ---------------------------------------------------------

    def submit(self, request: SolveRequest) -> RouterTicket:
        rt = RouterTicket(self, request)
        replica, inner = self._submit_once(request)
        with rt._cv:
            rt._inner, rt._replica = inner, replica
        with self._lock:
            self._live.add(rt)
            self._n_routed += 1
        run = obs.get_run()
        if run is not None:
            run.counter("fleet_requests_total",
                        "requests routed through the fleet router").inc(
                replica=replica.replica_id)
        return rt

    def solve(self, request: SolveRequest, timeout: float | None = None):
        return self.submit(request).result(timeout)

    def status(self) -> dict:
        replicas = []
        any_alive = False
        for r in self.manager.replicas():
            alive = r.alive()
            any_alive = any_alive or alive
            try:
                st = r.server.status()
                row = {"replica_id": r.replica_id, "alive": alive,
                       "accepting": st.get("accepting"),
                       "queue_depth": st.get("queue_depth"),
                       "requests_served": st.get("requests_served"),
                       "worker_crashes": st.get("worker_crashes"),
                       "replica": st.get("replica")}
            except Exception as e:  # a dying replica must not kill status
                row = {"replica_id": r.replica_id, "alive": False,
                       "error": f"{type(e).__name__}: {e}"}
            replicas.append(row)
        with self._lock:
            migrations = self.migrations
            routed = self._n_routed
            live = len(self._live)
        return {
            "replicas": replicas,
            "n_replicas": len(replicas),
            "migrations": migrations,
            "requests_routed": routed,
            "requests_live": live,
            # ServeFrontend/healthz compatibility: the fleet as a whole
            # is "closed" only when nothing is alive.
            "closed": not any_alive,
            "draining": False,
            "accepting": any_alive,
            "queue_depth": sum(r.get("queue_depth") or 0 for r in replicas),
        }

    def close(self) -> None:
        self.manager.close()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- migration ----------------------------------------------------------

    def migrate_from(self, replica) -> int:
        """Live-migrate everything off one replica: ``drain()`` it (the
        in-flight batch stops at its next boundary snapshot) and re-admit
        every evacuated ticket on its rehashed replica.  The scale-down
        and rolling-restart path; returns the number migrated."""
        # Claim the replica before it starts reading as dead, so the
        # manager's health monitor retires it quietly instead of racing
        # this drain with its own reroute_dead.
        replica.draining = True
        evacuated = replica.server.drain()
        with self._lock:
            live = list(self._live)
        by_inner = {}
        for rt in live:
            with rt._cv:
                if rt._inner is not None:
                    by_inner[id(rt._inner)] = rt
        n = 0
        for t in evacuated:
            rt = by_inner.get(id(t))
            if rt is None:
                # Not ours (submitted straight to the replica): the
                # contract-holder is whoever submitted it; shed cleanly.
                if not t.done():
                    t._finish(exception=OverCapacityError(
                        "replica drained for migration", reason="closed"))
                continue
            self._reroute(rt, t, kind="drain")
            n += 1
        return n

    def reroute_dead(self, replica) -> int:
        """Eager failure path: re-admit every live ticket stranded on a
        dead replica (the manager's monitor calls this on detection; the
        waiters' lazy path covers the gap)."""
        with self._lock:
            live = list(self._live)
        n = 0
        for rt in live:
            with rt._cv:
                if rt._replica is not replica or rt._migrating \
                        or rt._terminal is not None:
                    continue
                inner = rt._inner
            if inner.done():
                try:
                    inner.result(timeout=0)
                    continue  # completed before the death: nothing to do
                except _Migrated:
                    continue
                except BaseException as e:
                    if not _is_replica_death(e):
                        continue
            self._reroute(rt, inner, kind="death")
            n += 1
        return n

    def _reroute(self, rt: RouterTicket, failed_inner, kind: str) -> None:
        """Swap ``rt``'s inner future for a fresh admission on another
        replica.  Idempotent under races (waiter thread and monitor may
        both observe the same death): exactly one caller wins the swap,
        the rest no-op."""
        with rt._cv:
            if rt._terminal is not None or rt._migrating \
                    or rt._inner is not failed_inner:
                return
            if rt.migrations >= self.max_migrations:
                rt._terminal = OverCapacityError(
                    f"request migrated {rt.migrations} times without "
                    "completing; giving up", reason="capacity")
                rt._cv.notify_all()
                if not failed_inner.done():
                    failed_inner._finish(exception=_Migrated())
                return
            rt._migrating = True
            rt.migrations += 1
            old = rt._replica
        with self._lock:
            self.migrations += 1
        try:
            replica, inner = self._submit_once(rt.request, exclude={old})
        except (OverCapacityError, RuntimeError) as e:
            with rt._cv:
                rt._terminal = e
                rt._migrating = False
                rt._cv.notify_all()
            if not failed_inner.done():
                failed_inner._finish(exception=_Migrated())
            self._obs_migration(rt, old, None, kind, ok=False)
            return
        with rt._cv:
            rt._inner, rt._replica = inner, replica
            rt._gen += 1
            rt._migrating = False
            rt._cv.notify_all()
        if not failed_inner.done():
            # Wake waiters parked on the superseded future (drain path:
            # the evacuated ticket was never finished).
            failed_inner._finish(exception=_Migrated())
        self._obs_migration(rt, old, replica, kind, ok=True)

    # -- bookkeeping --------------------------------------------------------

    def _done(self, rt: RouterTicket) -> None:
        with self._lock:
            self._live.discard(rt)

    def _observe(self, inner) -> None:
        """Feed a completed request's queue wait to the manager's
        autoscaler (functional, not telemetry — works with obs off)."""
        wait = inner.queue_wait_s
        if wait is not None:
            self.manager.observe_queue_wait(wait)

    def _obs_migration(self, rt, old, new, kind: str, ok: bool) -> None:
        run = obs.get_run()
        if run is None:
            return
        run.counter("fleet_migrations_total",
                    "tickets re-admitted on another replica").inc(kind=kind)
        run.event("session_migrated", phase="fleet", kind=kind, ok=ok,
                  session=rt.request.session_id,
                  tenant=rt.request.tenant,
                  migrations=rt.migrations,
                  from_replica=old.replica_id if old is not None else None,
                  to_replica=new.replica_id if new is not None else None)

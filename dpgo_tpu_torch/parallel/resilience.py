"""Resilience of the sharded solve plane — the port of
``dpgo_tpu.parallel.resilience``.

* **Mesh-elastic checkpoints** — at verdict boundaries (the existing
  one-int32-per-K-rounds readback, so checkpointing adds no new
  steady-state synchronization point) the ranks' blocks of the
  ``RBCDState`` are gathered into a layout that does not depend on the
  mesh: every persisted array keeps its per-agent ``[A, ...]`` leading
  axis, and the snapshot carries ``graph.global_index`` so a reader can
  verify the agent->pose layout before resuming.  Snapshots persist
  through ``serve.session.SessionStore`` (the JAX package's format, schema
  v2: either package reads the other's), so a solve checkpointed on 4
  ranks resumes on 2 — ``shard_problem`` re-blocks the same arrays.  The
  mesh's first rank writes; every rank reads.

* **A deterministic collective fault injector** —
  ``CollectiveFaultInjector`` wraps the exchange seam
  (``rbcd._exchange_for``, which ``sharded._gather_exchange`` builds on,
  through its ``_exchange_wrap`` hook) and the driver's
  ``rbcd._host_fetch`` reads to inject NaN/corrupt halo payloads,
  simulated device loss, and hung fetches — seeded per link like the
  deployment plane's ``comms.faults.FaultInjector``, so chaos runs
  replay exactly (and every rank of a mesh draws the same faults).

* **Anomaly-triggered rewind** — the verdict word's latched anomaly bits
  (non-finite / cost-spike / stall / grad-explosion) detect trouble on
  the device; the supervisor loop of ``solve_rbcd_sharded(resilience=
  ResilienceConfig(...))`` turns a latched anomaly or a
  ``MeshFaultError`` into a rewind to the last good checkpoint (after a
  device loss on a smaller mesh: every rank builds the subgroup of the
  first ranks, the others leave the solve).  ``Watchdog`` deadlines
  around every blocking fetch make a dead mesh raise a phase-naming
  ``MeshFaultError`` instead of hanging; a hung collective cannot be
  cancelled, so its worker thread is abandoned.

The checkpoint gather routes through this module's own ``_host_fetch``
seam — not ``rbcd._host_fetch`` — so the driver-loop sync-rate contract
(``host_syncs_per_100_rounds == 100/K``, counted by patching
``rbcd._host_fetch``) holds with resilience enabled: the gather rides a
boundary the word fetch just drained.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FetchTimeout

import numpy as np
import torch

from .. import obs
from ..models import rbcd
from ..serve.session import SessionStore

#: RBCDState fields a checkpoint persists (the recomputable factors are
#: dropped; ``rbcd.refresh_problem`` restores them bit-for-bit from the
#: stored weights — same contract as ``serve.session``).
_CHECKPOINT_FIELDS = ("X", "weights", "iteration", "seed", "rel_change",
                      "ready", "gamma", "alpha", "mu", "V", "X_init")

#: Anomaly names a ``ResilienceConfig.rewind_on`` entry may use (the
#: verdict word's latched anomaly vocabulary, ``rbcd._VERDICT_ANOMALY``).
REWINDABLE_ANOMALIES = frozenset(
    name for name in rbcd._VERDICT_ANOMALY.values() if name is not None)


def _host_fetch(x):
    """The resilience plane's device->host transfer seam.

    Deliberately separate from ``rbcd._host_fetch``: the checkpoint
    gather happens at a verdict boundary the word fetch has already
    drained, so it must not count against (or be hidden inside) the
    driver loop's sync-rate contract.  Tests count checkpoint transfers
    by patching THIS function.  A tensor comes back as a numpy array, a
    host scalar as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MeshFaultError(RuntimeError):
    """A structured mesh fault: which phase was blocked, what kind of
    fault, and (for device loss) which device — the sharded plane's
    analog of the serve plane's typed worker-death errors."""

    def __init__(self, message: str, *, phase: str, kind: str = "fault",
                 device: int | None = None):
        super().__init__(message)
        self.phase = str(phase)
        self.kind = str(kind)
        self.device = device


#: Fault kinds scoped to the WORLD, not the local mesh: a peer process
#: that died (``process_lost``, the multihost barrier timeout) or whose
#: lockstep verdict word diverged (``desync``).  ``CheckpointSupervisor
#: .recover`` re-raises these instead of rewinding — a dead or diverged
#: peer cannot be repaired in-process; the multihost launcher shrinks
#: the world and respawns the survivors, whose supervisor then resumes
#: from the same checkpoint store (``parallel.multihost``).
WORLD_FAULT_KINDS = frozenset({"process_lost", "desync"})


class DeviceLostError(MeshFaultError):
    """A device (simulated or real) dropped out of the mesh."""

    def __init__(self, message: str, *, phase: str, device: int | None = None):
        super().__init__(message, phase=phase, kind="device_loss",
                         device=device)


class AnomalyRewind(Exception):
    """Internal control-flow signal: a verdict boundary latched an
    anomaly the policy rewinds on.  Raised by the supervisor's boundary
    callback, caught by ``solve_rbcd_sharded``'s recovery loop — it
    never escapes to callers (a blown rewind budget surfaces as
    ``MeshFaultError(kind="rewind_budget")``)."""

    def __init__(self, anomaly: str, iteration: int, word: int):
        super().__init__(f"verdict anomaly {anomaly!r} latched at "
                         f"iteration {iteration}")
        self.anomaly = str(anomaly)
        self.iteration = int(iteration)
        self.word = int(word)


# ---------------------------------------------------------------------------
# Watchdog: deadline-guarded blocking fetches
# ---------------------------------------------------------------------------

class Watchdog:
    """Deadline guard for blocking device->host reads.

    Each guarded fetch runs on a worker thread; if it does not complete
    within ``deadline_s`` the caller gets a phase-naming
    ``MeshFaultError`` (mirroring ``RoundTimer.stop``'s open-phase
    guard message style) while the stuck transfer is abandoned to a
    fresh worker.  ``close()`` joins every worker — callers must
    release whatever is blocking them first (the injector's
    ``release_hangs``; on real hardware, process teardown)."""

    def __init__(self, deadline_s: float):
        if not deadline_s or deadline_s <= 0:
            raise ValueError(f"watchdog deadline must be > 0, "
                             f"got {deadline_s!r}")
        self.deadline_s = float(deadline_s)
        self._pool: ThreadPoolExecutor | None = None
        self._abandoned: list[ThreadPoolExecutor] = []

    def fetch(self, fn, x, phase: str):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dpgo-mesh-watchdog")
        fut = self._pool.submit(fn, x)
        try:
            return fut.result(timeout=self.deadline_s)
        except _FetchTimeout:
            # The worker is stuck inside the transfer; abandon it (a
            # later close() joins it) so a post-rewind fetch does not
            # queue behind the hung one.
            self._abandoned.append(self._pool)
            self._pool.shutdown(wait=False)
            self._pool = None
            raise MeshFaultError(
                f"host fetch in phase {phase!r} exceeded the "
                f"{self.deadline_s:g}s watchdog deadline (dead mesh or "
                f"hung collective — no data arrived)",
                phase=phase, kind="fetch_timeout") from None

    def close(self):
        """Join every worker thread (leak-free teardown)."""
        for pool in [*self._abandoned,
                     *([self._pool] if self._pool is not None else [])]:
            pool.shutdown(wait=True)
        self._abandoned = []
        self._pool = None


@contextlib.contextmanager
def fetch_guard(watchdog: Watchdog | None,
                injector: "CollectiveFaultInjector | None",
                phase: list, *, close: bool = False):
    """Scope that routes every ``rbcd._host_fetch`` through the watchdog
    deadline and the injector's fetch-side faults.

    ``phase`` is a one-element list the caller mutates as the solve
    moves between phases (``["sharded_verdict"]`` -> ``"gn_tail"``), so
    a timeout names what was actually blocked.  The guard wraps
    whatever ``rbcd._host_fetch`` currently is — a test's counting shim
    installed first keeps counting — and restores it on exit.  The
    injector's hang/device-loss faults execute INSIDE the guarded
    worker so the watchdog can time them out like a real dead mesh."""
    orig = rbcd._host_fetch

    def fetch_with_faults(x):
        if injector is not None:
            injector.on_fetch(phase[0])
        return orig(x)

    def guarded(x):
        if watchdog is not None:
            return watchdog.fetch(fetch_with_faults, x, phase[0])
        return fetch_with_faults(x)

    rbcd._host_fetch = guarded
    try:
        yield
    finally:
        rbcd._host_fetch = orig
        if close and watchdog is not None:
            watchdog.close()


# ---------------------------------------------------------------------------
# Deterministic collective fault injection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshFaultSpec:
    """What to break, and when (in DISPATCHED solver rounds — the host
    schedule is deterministic, so a chaos run replays exactly).

    Each entry in a ``*_rounds`` tuple fires once, the first time the
    dispatch counter crosses it.  Halo faults poison a seeded public
    pose at dispatch time (an async device op — no host sync); device
    loss and hangs fire at the next guarded fetch, where the driver
    would actually observe a dead mesh."""

    #: Dispatch rounds at which a NaN halo payload is injected.
    nan_halo_rounds: tuple = ()
    #: Dispatch rounds at which a finite-garbage halo payload is injected.
    corrupt_halo_rounds: tuple = ()
    #: Dispatch rounds after which the next fetch raises DeviceLostError.
    device_loss_rounds: tuple = ()
    #: Which device "dies" (bookkeeping only on the virtual mesh).
    lost_device: int = 0
    #: Dispatch rounds after which the next fetch blocks for ``hang_s``.
    hang_rounds: tuple = ()
    hang_s: float = 3600.0
    #: (src_agent, dst_agent) link to corrupt; None = seeded choice.
    link: tuple | None = None


class CollectiveFaultInjector:
    """Deterministic fault injection on the mesh's collective seams.

    Seeded per-link exactly like the deployment plane's
    ``comms.faults.FaultInjector`` (``default_rng((seed << 32) ^
    crc32(repr(link)))``), so which pose gets poisoned and which slot a
    wrapped exchange corrupts replay across runs.  Two injection levels:

    * **dispatch-time** (``before_dispatch``): the supervisor wraps the
      segment dispatch; when a configured round is crossed, one seeded
      public pose of one seeded agent is set to NaN/garbage so the NEXT
      exchange carries the corrupt halo to every neighbor — the
      mid-solve transient that must trip the verdict anomaly latch.
    * **trace-time** (``installed()`` / ``wrap_exchange``): the
      ``rbcd._exchange_wrap`` hook passes every exchange closure built
      while installed (the solver round's and the GN tail's and
      certificate's ``sharded._gather_exchange``) through
      ``wrap_exchange``, which corrupts a seeded neighbor-buffer slot in
      the traced program itself — persistent corruption for seam-level
      tests.  (Only programs COMPILED while installed are affected;
      jit caches keep earlier traces.)

    Fetch-side faults (``on_fetch``) run inside the ``fetch_guard``
    worker: device loss raises ``DeviceLostError``; a hang blocks until
    ``release_hangs()`` or ``hang_s`` — which the watchdog times out,
    exactly like a real dead mesh."""

    def __init__(self, spec: MeshFaultSpec | None = None, seed: int = 0,
                 enabled: bool = True):
        self.spec = spec or MeshFaultSpec()
        self.seed = int(seed)
        self.enabled = bool(enabled)
        self.stats = {"rounds_dispatched": 0, "halo_nan": 0,
                      "halo_corrupt": 0, "device_loss": 0,
                      "hung_fetches": 0, "links_wrapped": 0}
        self._fired: set = set()
        self._lock = threading.Lock()
        self._hang_release = threading.Event()
        self._pub = None  # host public-slot table, captured by arm()

    def _rng(self, link):
        return np.random.default_rng(
            (self.seed << 32) ^ zlib.crc32(repr(link).encode()))

    def arm(self, graph) -> None:
        """Capture the host-side public-slot table ONCE, before the solve
        loop, so mid-solve poisoning needs no extra device reads."""
        self._pub = graph.pub_idx.cpu().numpy()

    # -- dispatch-time halo poisoning ---------------------------------------

    def _due(self, kind: str, rounds: tuple, r0: int):
        for i, r in enumerate(rounds):
            key = (kind, i)
            if r0 >= int(r) and key not in self._fired:
                self._fired.add(key)
                return key
        return None

    def before_dispatch(self, state, k: int, offset: int = 0,
                        num_robots: int | None = None):
        """Called by the supervisor's segment wrapper with the state about
        to be dispatched for ``k`` rounds; returns the (possibly
        poisoned) state.  Pure host bookkeeping plus at most one async
        indexed write — never a device sync.  On a mesh, ``state`` is the
        rank's block of agents ``offset ..`` of ``num_robots``: the seeded
        agent is drawn over all of them and poisoned on its owner rank."""
        with self._lock:
            r0 = self.stats["rounds_dispatched"]
            self.stats["rounds_dispatched"] = r0 + int(k)
            if not self.enabled:
                return state
            nan_due = self._due("nan", self.spec.nan_halo_rounds, r0)
            bad_due = self._due("corrupt", self.spec.corrupt_halo_rounds, r0)
        if nan_due is not None:
            state = self._poison(state, nan_due, float("nan"), "halo_nan",
                                 offset, num_robots)
        if bad_due is not None:
            state = self._poison(state, bad_due, 1e30, "halo_corrupt",
                                 offset, num_robots)
        return state

    def _poison(self, state, token, payload, stat: str, offset: int = 0,
                num_robots: int | None = None):
        A_loc = int(state.X.shape[0])
        A = int(num_robots) if num_robots is not None else A_loc
        rng = self._rng(self.spec.link if self.spec.link is not None
                        else token)
        a = int(self.spec.link[0]) % A if self.spec.link is not None \
            else int(rng.integers(A))
        # A PUBLIC pose of agent a, so the next exchange carries the
        # poison to every neighbor as a corrupt halo payload (pose 0
        # when arm() was skipped — still poisons the central metrics).
        p = int(self._pub[a, int(rng.integers(self._pub.shape[1]))]) \
            if self._pub is not None else 0
        with self._lock:
            self.stats[stat] += 1
        if not 0 <= a - offset < A_loc:
            return state  # another rank owns agent a
        X = state.X.clone()
        X[a - offset, p] = payload
        return state._replace(X=X)

    # -- trace-time exchange corruption -------------------------------------

    def wrap_exchange(self, exchange):
        """Wrap an exchange closure (an ``rbcd._exchange_for`` product)
        so the resolved neighbor buffer carries one seeded corrupted slot
        — trace-level, so every round of a program compiled through the
        wrap is affected."""
        link = self.spec.link if self.spec.link is not None else (0, 1)
        rng = self._rng(link)
        payload = float("nan") if self.spec.nan_halo_rounds else 1e30
        dst = int(link[1])
        with self._lock:
            self.stats["links_wrapped"] += 1

        def wrapped(Xl):
            Z = exchange(Xl)
            if not self.enabled:
                return Z
            slot = int(rng.integers(max(int(Z.shape[1]), 1)))
            Z = Z.clone()
            Z[dst % int(Z.shape[0]), slot] = payload
            return Z

        return wrapped

    @contextlib.contextmanager
    def installed(self):
        """Install the wrap on the exchange seam for the scope's
        duration: every exchange built meanwhile is corrupted."""
        prev = rbcd._exchange_wrap
        rbcd._exchange_wrap = self.wrap_exchange
        try:
            yield self
        finally:
            rbcd._exchange_wrap = prev

    # -- fetch-side faults ---------------------------------------------------

    def on_fetch(self, phase: str) -> None:
        """Runs inside the guarded fetch worker (see ``fetch_guard``)."""
        if not self.enabled:
            return
        with self._lock:
            r0 = self.stats["rounds_dispatched"]
            hang = self._due("hang", self.spec.hang_rounds, r0)
            loss = self._due("loss", self.spec.device_loss_rounds, r0)
            if hang is not None:
                self.stats["hung_fetches"] += 1
            if loss is not None:
                self.stats["device_loss"] += 1
        if hang is not None:
            self._hang_release.wait(self.spec.hang_s)
        if loss is not None:
            raise DeviceLostError(
                f"simulated loss of device {self.spec.lost_device} after "
                f"{r0} dispatched rounds (CollectiveFaultInjector)",
                phase=phase, device=self.spec.lost_device)

    def release_hangs(self) -> None:
        """Unblock any in-flight simulated hang (the supervisor calls this
        on fault recovery so abandoned watchdog workers can exit)."""
        self._hang_release.set()


# ---------------------------------------------------------------------------
# Mesh-elastic checkpoints + the rewind supervisor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Policy knobs for ``solve_rbcd_sharded(resilience=...)``."""

    #: SessionStore root for checkpoints (or pass a prebuilt ``store``).
    checkpoint_dir: str | None = None
    store: SessionStore | None = None
    session_id: str = "sharded-solve"
    #: Checkpoint every Nth clean verdict boundary (1 = every boundary,
    #: i.e. every K rounds — the at-most-K-rounds-lost guarantee).
    checkpoint_every: int = 1
    #: Snapshots retained per session (SessionStore pruning).
    keep: int = 3
    #: Rewind budget; exhausted -> MeshFaultError(kind="rewind_budget").
    max_rewinds: int = 3
    #: Latched verdict anomalies that trigger a rewind (names from
    #: ``REWINDABLE_ANOMALIES``).  Cost spikes and stalls are normal in
    #: GNC schedules, so only divergence anomalies rewind by default.
    rewind_on: tuple = ("non_finite", "grad_explosion")
    #: Watchdog deadline for every blocking fetch; None = no watchdog.
    fetch_deadline_s: float | None = None
    #: On device loss / fetch timeout, resume on the next smaller mesh
    #: that still divides the agent count.
    reshard_on_fault: bool = True
    min_mesh_size: int = 1
    #: Off-thread checkpoint writes (default on): the boundary npz
    #: compression + fsync runs on the store's writer thread,
    #: double-buffered last-writer-wins, so checkpoint overhead hides
    #: under the next K-round device segment.  The device->host gather
    #: stays synchronous at the boundary either way (the snapshot must
    #: capture THIS boundary's state), so the solve's
    #: host_syncs_per_100_rounds is unchanged.  ``recover`` flushes the
    #: writer before reading snapshots back.
    async_checkpoint: bool = True
    #: Deterministic chaos source (tests / chaos arms); None in prod.
    injector: CollectiveFaultInjector | None = None
    #: Whether THIS process persists boundary checkpoints.  Multihost
    #: runs replicate the solve across ranks over one shared store: only
    #: the controller (rank 0) writes — concurrent ranks saving the same
    #: iteration would race the atomic tmp+rename — while every rank
    #: still reads the store on resume/recovery.  Anomaly detection and
    #: rewind bookkeeping are unaffected by this flag.
    checkpoint_writer: bool = True

    def __post_init__(self):
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1, got "
                             f"{self.checkpoint_every}")
        if self.max_rewinds < 0:
            raise ValueError(f"max_rewinds must be >= 0, got "
                             f"{self.max_rewinds}")
        bad = set(self.rewind_on) - REWINDABLE_ANOMALIES
        if bad:
            raise ValueError(
                f"unknown anomaly names in rewind_on: {sorted(bad)} "
                f"(valid: {sorted(REWINDABLE_ANOMALIES)})")
        if self.store is None and self.checkpoint_dir is None:
            raise ValueError("ResilienceConfig needs a checkpoint_dir "
                             "or a prebuilt SessionStore")
        if self.fetch_deadline_s is not None and self.fetch_deadline_s <= 0:
            raise ValueError(f"fetch_deadline_s must be > 0, got "
                             f"{self.fetch_deadline_s}")
        if self.min_mesh_size < 1:
            raise ValueError(f"min_mesh_size must be >= 1, got "
                             f"{self.min_mesh_size}")

    def resolve_store(self, device="cuda") -> SessionStore:
        """The prebuilt ``store``, or one at ``checkpoint_dir`` that loads
        snapshots onto ``device``."""
        if self.store is not None:
            return self.store
        return SessionStore(self.checkpoint_dir, keep=self.keep,
                            async_write=self.async_checkpoint,
                            device=device)


def shrink_mesh_size(cur: int, num_robots: int, min_size: int = 1) -> int:
    """The largest mesh size strictly below ``cur`` that still divides the
    agent count (``shard_problem``'s layout contract); ``cur`` when none
    exists — the supervisor then retries on the same mesh."""
    for s in range(int(cur) - 1, max(int(min_size), 1) - 1, -1):
        if num_robots % s == 0:
            return s
    return int(cur)


def checkpoint_arrays(state) -> dict:
    """Gather a (possibly mesh-sharded) ``RBCDState`` into the
    mesh-shape-independent host layout: every field keeps its per-agent
    ``[A, ...]`` leading axis, which the mesh only ever shards in equal
    contiguous blocks — so the SAME arrays re-shard onto any mesh whose
    size divides A.  The gather is the resilience plane's one sanctioned
    transfer and rides a verdict boundary the word fetch just drained."""
    host = {}
    for f in _CHECKPOINT_FIELDS:
        v = getattr(state, f)
        if v is None:
            continue
        # dpgolint: disable=DPG003 -- sanctioned mesh checkpoint gather
        host[f] = _host_fetch(v)
    return host


def _host_state(host: dict) -> "rbcd.RBCDState":
    """A host-tensor ``RBCDState`` for ``SessionStore.save``; factors
    recompute on restore via ``rbcd.refresh_problem``."""
    def t(name):
        v = host.get(name)
        return torch.as_tensor(v) if v is not None else None

    return rbcd.RBCDState(
        X=t("X"), weights=t("weights"),
        iteration=int(host["iteration"]), seed=int(host["seed"]),
        rel_change=t("rel_change"), ready=t("ready"),
        V=t("V"), gamma=t("gamma"), alpha=t("alpha"),
        mu=t("mu"), X_init=t("X_init"), chol=None, Qbuf=None)


class CheckpointSupervisor:
    """Verdict-boundary checkpointing + rewind bookkeeping for one solve.

    ``boundary_cb`` is handed to ``rbcd.run_rbcd``: at every verdict
    boundary it either checkpoints a clean state or raises
    ``AnomalyRewind`` when the word latched an anomaly the policy
    rewinds on.  ``recover`` maps a caught fault to (new mesh size,
    restored host state, resume iteration, resume weight-update count);
    the caller rebuilds the mesh programs and re-enters the driver.  A
    snapshot whose ``global_index`` does not match the live graph is
    unusable (different problem layout) and recovery degrades to a cold
    restart — fail-open, like ``SessionStore.load_newest`` itself.

    On a mesh the solve sets ``gather`` (the ranks' blocks -> the whole
    state, a collective every rank joins at a checkpointed boundary),
    ``writer`` (only the mesh's first rank saves) and ``barrier`` (taken
    in ``recover`` after the writer drained, so every rank reads the
    snapshot the writer promised)."""

    def __init__(self, cfg: ResilienceConfig, store: SessionStore,
                 graph_host, session_id: str | None = None):
        self.cfg = cfg
        self.store = store
        self.session_id = session_id or cfg.session_id
        gidx = graph_host.global_index
        self._gidx = gidx.cpu().numpy() if isinstance(gidx, torch.Tensor) \
            else np.asarray(gidx)
        self.recoveries = 0
        self.checkpoints = 0
        self.cold_restarts = 0
        self.recovery_overhead_s = 0.0
        self.mesh_sizes: list[int] = []
        self.fault_kinds: list[str] = []
        self._boundaries = 0
        self._last_saved_it = -1
        self.gather = None
        self.writer = True
        self.barrier = None

    def attach_mesh(self, mesh_size: int) -> None:
        self.mesh_sizes.append(int(mesh_size))

    # -- boundary hook (called from inside the driver loop) ------------------

    def boundary_cb(self, it, nwu, state, word, terminal) -> None:
        anomaly = rbcd.unpack_verdict(word)["anomaly"]
        if anomaly is not None and anomaly in self.cfg.rewind_on:
            # Anomalous terminal words rewind too: a solve that latched
            # non_finite and then "converged" converged on garbage.
            raise AnomalyRewind(anomaly, it, word)
        if terminal:
            return
        self._boundaries += 1
        if (self._boundaries - 1) % self.cfg.checkpoint_every:
            return
        if anomaly is not None or it == self._last_saved_it:
            return  # never checkpoint an anomalous state
        if not self.cfg.checkpoint_writer:
            return  # reader rank: the controller persists for the world
        self.save(state, it, nwu)

    def save(self, state, it: int, nwu: int) -> str | None:
        """Checkpoint this boundary: gather the ranks' blocks (every rank
        joins), persist on the writer rank; every rank counts it, so the
        summary is the same on all of them.  Returns the path written."""
        if self.gather is not None:
            state = self.gather(state)
        mesh_shape = (self.mesh_sizes[-1],) if self.mesh_sizes else None
        path = None
        if self.writer:
            host = checkpoint_arrays(state)
            # The gather is synchronous (the snapshot pins THIS boundary's
            # state); the npz write lands off-thread when the store was
            # built with async_write, under the next K-round segment.
            save = getattr(self.store, "save_async", self.store.save)
            path = save(
                self.session_id, _host_state(host), iteration=int(it),
                num_weight_updates=int(nwu), mesh_shape=mesh_shape,
                global_index=self._gidx)
        self.checkpoints += 1
        self._last_saved_it = int(it)
        run = obs.get_run()
        if run is not None:
            run.counter("mesh_checkpoints_total",
                        "mesh-elastic verdict-boundary checkpoints").inc()
            run.event("mesh_checkpoint", phase="resilience",
                      session=self.session_id, iteration=int(it),
                      mesh_size=mesh_shape[0] if mesh_shape else None)
        return path

    # -- fault recovery ------------------------------------------------------

    def recover(self, exc, mesh_size: int, num_robots: int):
        """Map a caught fault to ``(new_mesh_size, host_state | None,
        start_iteration, start_num_weight_updates)``; ``None`` state
        means cold restart from the initial guess."""
        if isinstance(exc, MeshFaultError) and exc.kind in WORLD_FAULT_KINDS:
            # A dead or diverged PEER PROCESS is not fixable by an
            # in-process rewind: the world itself must shrink.  Propagate
            # to the multihost launcher, which respawns the surviving
            # ranks as a new generation; that generation's supervisor
            # resumes from this same store (solve_rbcd_sharded(resume=)).
            raise exc
        self.recoveries += 1
        kind = exc.kind if isinstance(exc, MeshFaultError) \
            else f"anomaly:{exc.anomaly}"
        self.fault_kinds.append(kind)
        if self.recoveries > self.cfg.max_rewinds:
            raise MeshFaultError(
                f"rewind budget exhausted after {self.cfg.max_rewinds} "
                f"recoveries (last fault: {kind})",
                phase="resilience", kind="rewind_budget") from exc
        new_size = int(mesh_size)
        if isinstance(exc, MeshFaultError) and self.cfg.reshard_on_fault:
            new_size = shrink_mesh_size(mesh_size, num_robots,
                                        self.cfg.min_mesh_size)
        flush = getattr(self.store, "flush", None)
        if flush is not None:
            # Drain the async writer before reading back: the freshest
            # boundary snapshot may still be in the pending slot.
            flush()
        if self.barrier is not None:
            self.barrier()
        snap = self.store.load_newest(self.session_id)
        usable = snap is not None and (
            snap.global_index is None
            or np.array_equal(np.asarray(snap.global_index), self._gidx))
        run = obs.get_run()
        if run is not None:
            run.counter("mesh_rewinds_total",
                        "supervisor rewinds after mesh faults").inc()
            run.event("mesh_fault", phase="resilience", kind=kind,
                      fault_phase=getattr(exc, "phase", None),
                      device=getattr(exc, "device", None))
            run.event("mesh_rewind", phase="resilience", kind=kind,
                      mesh_from=int(mesh_size), mesh_to=new_size,
                      resume_iteration=int(snap.iteration) if usable else 0,
                      cold=not usable)
        if not usable:
            self.cold_restarts += 1
            return new_size, None, 0, 0
        return (new_size, snap.state, int(snap.iteration),
                int(snap.num_weight_updates))

    def note_overhead(self, seconds: float) -> None:
        self.recovery_overhead_s += float(seconds)

    def finish(self, injector: CollectiveFaultInjector | None) -> dict:
        """The ``RBCDResult.resilience`` summary; also emits the gated
        recovery-overhead metric when telemetry is on."""
        run = obs.get_run()
        if run is not None and self.recoveries:
            run.metric("mesh_recovery_overhead_s", self.recovery_overhead_s,
                       phase="resilience", recoveries=self.recoveries)
        return {
            "recoveries": self.recoveries,
            "checkpoints": self.checkpoints,
            "cold_restarts": self.cold_restarts,
            "recovery_overhead_s": round(self.recovery_overhead_s, 6),
            "mesh_sizes": list(self.mesh_sizes),
            "fault_kinds": list(self.fault_kinds),
            "injector": dict(injector.stats) if injector is not None
            else None,
        }

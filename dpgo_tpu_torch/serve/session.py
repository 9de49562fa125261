"""Crash-recovery session store: durable solver-state snapshots (port of
``dpgo_tpu.serve.session``; the snapshot format is the JAX package's, so
a store written by either package loads in the other).

The flight recorder (``obs.recorder``) snapshots exact ``RBCDState``\\ s
for *replay* — a black box read after the fact.  This module promotes the
same snapshot payload to a *session store*: a directory of
schema-versioned ``.npz`` state files a live server writes on solve
boundaries and reads back to re-admit work that died mid-batch.  It is a
durability feature, not telemetry — it works with the obs stack entirely
off (events/counters about it are separately fenced by the callers).

Layout (one subdirectory per session id)::

    <root>/<session id>/snap-00000040.npz     # newest wins
    <root>/<session id>/snap-00000020.npz
    <root>/<session id>/snap-00000020.npz.quarantined  # failed validation

Every snapshot carries ``__schema__`` (``SESSION_SCHEMA_VERSION``) and the
full ``RBCDState`` array set (``models.incremental.state_to_arrays``); the
factors (``chol``/``Qbuf``) are never persisted — ``refresh_problem``
recomputes them bit-for-bit from the stored weights.  Writes are atomic
(temp file + rename), so a crash mid-write leaves at worst one torn temp
file, never a torn snapshot.

``load_newest`` is the recovery contract the server worker relies on:
newest-first, any snapshot that fails to parse (truncated zip, bit-flipped
member, wrong schema version, missing state field) is QUARANTINED — renamed
aside so it is never retried — and the previous snapshot is tried instead.
A corrupt store therefore degrades to an older resume point or a clean
``None`` (cold re-solve); it never raises into the worker loop.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading

import numpy as np

from .. import obs
from ..device import resolve_device
from ..models.incremental import state_from_arrays, state_to_arrays
from ..models.rbcd import RBCDState

#: Bump on any incompatible change to the snapshot array set.  A loader
#: finding an unknown version quarantines the file — resuming a solver
#: from arrays with silently different semantics is worse than a cold
#: re-solve.  v2 (the pod-scale resilience round) adds the OPTIONAL
#: mesh tags ``__mesh_shape__`` / ``__global_index__``: the mesh the
#: snapshot was taken on and the agent->global-pose layout it assumes,
#: so a mesh-elastic restore can verify the layout before resuming.
SESSION_SCHEMA_VERSION = 2

#: Schema versions this reader accepts.  v1 snapshots are a strict
#: subset of v2 (no mesh tags), so old single-device snapshots keep
#: loading; v1-era readers see ``2 != 1`` and quarantine mesh-tagged
#: snapshots (fail-open: recovery degrades to an older snapshot or a
#: cold re-solve, never a mis-resumed one).
_COMPAT_SCHEMAS = (1, 2)

_SNAP_RE = re.compile(r"^snap-(\d{8})\.npz$")
#: RBCDState fields every valid snapshot must carry (the optional
#: ``V``/``X_init`` are schema-legal absences).
_REQUIRED = ("X", "weights", "key", "rel_change", "ready", "gamma",
             "alpha", "mu")


@dataclasses.dataclass
class SessionSnapshot:
    """One recovered snapshot: the rebuilt state plus its bookkeeping."""

    session_id: str
    path: str
    iteration: int
    num_weight_updates: int
    state: RBCDState
    meta: dict
    #: Mesh tags (schema v2, ``parallel.resilience``); None on v1
    #: snapshots and single-device saves.
    mesh_shape: tuple | None = None
    global_index: "np.ndarray | None" = None


def _sanitize(session_id: str) -> str:
    """Session ids become directory names; keep them path-safe."""
    out = re.sub(r"[^A-Za-z0-9._-]", "_", str(session_id))
    if not out or out in (".", ".."):
        raise ValueError(f"invalid session id {session_id!r}")
    return out


class SessionStore:
    """Directory-backed store of per-session solver snapshots.

    Thread-safe: the server worker saves while client threads may list or
    discard; one lock serializes directory mutations per store.  Loaded
    states are rebuilt on ``device`` (the card unless ``"cpu"`` is asked
    for)."""

    def __init__(self, root: str, keep: int = 2,
                 async_write: bool = False, device="cuda"):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.root = str(root)
        self.keep = int(keep)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        #: Off-thread write mode (``save_async``): one daemon writer and
        #: a ONE-SLOT pending buffer — last writer wins, so a slow disk
        #: never queues a backlog of stale snapshots; the freshest state
        #: is always the one that lands.  ``flush()`` drains it.
        self.async_write = bool(async_write)
        self._wcond = threading.Condition()
        self._wpending: dict | None = None
        self._winflight = False
        self._wthread: threading.Thread | None = None
        self.last_write_error: Exception | None = None
        os.makedirs(self.root, exist_ok=True)

    # -- paths ---------------------------------------------------------------

    def _dir(self, session_id: str) -> str:
        return os.path.join(self.root, _sanitize(session_id))

    def _snaps(self, sdir: str) -> list[tuple[int, str]]:
        """(sequence, filename) of intact-looking snapshots, oldest first."""
        try:
            names = os.listdir(sdir)
        except OSError:
            return []
        out = []
        for name in names:
            m = _SNAP_RE.match(name)
            if m:
                out.append((int(m.group(1)), name))
        return sorted(out)

    # -- writing -------------------------------------------------------------

    def save(self, session_id: str, state: RBCDState, iteration: int,
             num_weight_updates: int = 0, meta: dict | None = None,
             mesh_shape: tuple | None = None,
             global_index=None) -> str:
        """Persist one snapshot atomically; prune to the ``keep`` newest.
        ``iteration`` doubles as the snapshot sequence number, so saves on
        the solver's K-boundaries land in replayable order.
        ``mesh_shape`` / ``global_index`` are the v2 mesh tags
        (``parallel.resilience``): the mesh the state was gathered from
        and the agent->global-pose layout the arrays assume."""
        arrays = self._snapshot_arrays(state, iteration, num_weight_updates,
                                       meta, mesh_shape, global_index)
        return self._write(session_id, arrays, int(iteration))

    def _snapshot_arrays(self, state, iteration, num_weight_updates, meta,
                         mesh_shape, global_index) -> dict:
        """Materialize the snapshot payload on the CALLER'S thread — any
        device tensors in the state transfer here, so the async writer
        only ever touches host memory and the filesystem."""
        arrays = {k: np.asarray(v)
                  for k, v in state_to_arrays(state).items()}
        arrays["__schema__"] = np.asarray(SESSION_SCHEMA_VERSION, np.int64)
        arrays["__iteration__"] = np.asarray(int(iteration), np.int64)
        arrays["__nwu__"] = np.asarray(int(num_weight_updates), np.int64)
        if mesh_shape is not None:
            arrays["__mesh_shape__"] = np.asarray(mesh_shape, np.int64)
        if global_index is not None:
            arrays["__global_index__"] = np.asarray(global_index)
        if meta:
            arrays["__meta__"] = np.frombuffer(
                json.dumps(meta, sort_keys=True).encode("utf-8"), np.uint8)
        return arrays

    def _write(self, session_id: str, arrays: dict, iteration: int) -> str:
        sdir = self._dir(session_id)
        with self._lock:
            os.makedirs(sdir, exist_ok=True)
            path = os.path.join(sdir, f"snap-{int(iteration):08d}.npz")
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                np.savez_compressed(fh, **arrays)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            for _, name in self._snaps(sdir)[:-self.keep]:
                try:
                    os.remove(os.path.join(sdir, name))
                except OSError:
                    pass
        run = obs.get_run()
        if run is not None:
            run.counter("session_saves_total",
                        "session snapshots persisted").inc()
            run.event("session_saved", phase="session",
                      session=str(session_id), iteration=int(iteration),
                      path=path)
        return path

    # -- off-thread writes ---------------------------------------------------

    def save_async(self, session_id: str, state: RBCDState, iteration: int,
                   num_weight_updates: int = 0, meta: dict | None = None,
                   mesh_shape: tuple | None = None,
                   global_index=None) -> str:
        """``save`` with the npz compression + fsync moved to the store's
        writer thread (``async_write=True``; otherwise falls back to the
        synchronous ``save``).  The state materializes on the caller's
        thread, so the enqueued payload is immutable host memory; the
        pending slot is last-writer-wins — a newer boundary snapshot
        replaces an unwritten older one rather than queueing behind it.
        Returns the path the snapshot WILL land at; call ``flush()``
        before reading it back."""
        if not self.async_write:
            return self.save(session_id, state, iteration,
                             num_weight_updates, meta, mesh_shape,
                             global_index)
        arrays = self._snapshot_arrays(state, iteration, num_weight_updates,
                                       meta, mesh_shape, global_index)
        path = os.path.join(self._dir(session_id),
                            f"snap-{int(iteration):08d}.npz")
        with self._wcond:
            self._wpending = {"session_id": session_id, "arrays": arrays,
                              "iteration": int(iteration)}
            if self._wthread is None or not self._wthread.is_alive():
                self._wthread = threading.Thread(
                    target=self._writer_loop, daemon=True,
                    name="dpgo-session-writer")
                self._wthread.start()
            self._wcond.notify_all()
        return path

    def _writer_loop(self) -> None:
        while True:
            with self._wcond:
                while self._wpending is None:
                    self._wcond.wait()
                job, self._wpending = self._wpending, None
                self._winflight = True
            try:
                self._write(job["session_id"], job["arrays"],
                            job["iteration"])
                err = None
            except Exception as e:  # fail-open: recovery degrades to an
                err = e             # older snapshot, never a crash here
            with self._wcond:
                self._winflight = False
                if err is not None:
                    self.last_write_error = err
                self._wcond.notify_all()

    def flush(self, timeout: float | None = None) -> bool:
        """Block until the async writer has drained (no pending slot, no
        write in flight).  Call before ``load_newest`` on a store that
        saves asynchronously, so recovery sees the freshest snapshot.
        Returns False on timeout; a writer error is surfaced on
        ``last_write_error`` (the store itself stays fail-open)."""
        with self._wcond:
            return self._wcond.wait_for(
                lambda: self._wpending is None and not self._winflight,
                timeout=timeout)

    # -- reading / recovery --------------------------------------------------

    def _load_one(self, path: str) -> tuple[dict, dict]:
        """Parse + validate one snapshot file; raises on any defect."""
        arrays = dict(np.load(path, allow_pickle=False))
        schema = int(np.asarray(arrays.pop("__schema__")))
        if schema not in _COMPAT_SCHEMAS:
            raise ValueError(f"schema version {schema} not in "
                             f"{_COMPAT_SCHEMAS}")
        for f in _REQUIRED:
            if f not in arrays:
                raise ValueError(f"missing state field {f!r}")
            # Decompress every member now: a bit-flip deep in the zip
            # stream must fail HERE, in the quarantine path, not later
            # inside the solver.
            np.asarray(arrays[f])
        book = {
            "iteration": int(np.asarray(arrays.pop("__iteration__", 0))),
            "num_weight_updates": int(np.asarray(arrays.pop("__nwu__", 0))),
        }
        mesh_shape = arrays.pop("__mesh_shape__", None)
        book["mesh_shape"] = tuple(int(v) for v in np.asarray(mesh_shape)) \
            if mesh_shape is not None else None
        gidx = arrays.pop("__global_index__", None)
        book["global_index"] = np.asarray(gidx) if gidx is not None else None
        raw_meta = arrays.pop("__meta__", None)
        book["meta"] = json.loads(bytes(np.asarray(raw_meta, np.uint8))
                                  .decode("utf-8")) \
            if raw_meta is not None else {}
        return arrays, book

    def _quarantine(self, path: str, error: Exception) -> None:
        try:
            os.replace(path, path + ".quarantined")
        except OSError:
            pass
        run = obs.get_run()
        if run is not None:
            run.counter("session_quarantined_total",
                        "corrupt session snapshots set aside").inc()
            run.event("session_quarantined", phase="session", path=path,
                      error=f"{type(error).__name__}: {error}")

    def load_newest(self, session_id: str) -> SessionSnapshot | None:
        """The newest VALID snapshot, quarantining corrupt ones on the way
        down; None when no valid snapshot remains.  Never raises on bad
        data — the recovery path must not kill the worker a second time.
        Drains the async writer first, so a read-after-save always sees
        the snapshot the save promised."""
        self.flush()
        sdir = self._dir(session_id)
        with self._lock:
            candidates = [os.path.join(sdir, name)
                          for _, name in reversed(self._snaps(sdir))]
        for path in candidates:
            try:
                arrays, book = self._load_one(path)
            except Exception as e:  # any defect: quarantine, fall back
                self._quarantine(path, e)
                continue
            return SessionSnapshot(
                session_id=str(session_id), path=path,
                iteration=book["iteration"],
                num_weight_updates=book["num_weight_updates"],
                state=state_from_arrays(arrays, self.device),
                meta=book["meta"],
                mesh_shape=book["mesh_shape"],
                global_index=book["global_index"])
        return None

    # -- maintenance ---------------------------------------------------------

    def sessions(self) -> list[str]:
        try:
            return sorted(d for d in os.listdir(self.root)
                          if os.path.isdir(os.path.join(self.root, d)))
        except OSError:
            return []

    def discard(self, session_id: str) -> None:
        """Drop a finished session's snapshots (kept quarantined files are
        dropped too — the session is over)."""
        sdir = self._dir(session_id)
        with self._lock:
            try:
                names = os.listdir(sdir)
            except OSError:
                return
            for name in names:
                try:
                    os.remove(os.path.join(sdir, name))
                except OSError:
                    pass
            try:
                os.rmdir(sdir)
            except OSError:
                pass

"""The bucket-program cache, keyed by config fingerprint (port of
``dpgo_tpu.serve.cache``).

In the JAX package an entry is an XLA executable (a compiled, vmapped
fused RBCD segment); the port compiles nothing per program — its one
build is the kernel library (``ops.rtr_kernel.build``) — so an entry is
the bucket's prepared callable: the batched segment, metrics, verdict or
epilogue program with its meta and params bound (``runner``).  With a
telemetry run live the entry is wrapped in
``obs.profile.ProfiledExecutable``, which records its first call.

The cache key is the canonical config fingerprint — deliberately the
same shape/dtype/schedule field set
``run_rbcd`` registers via ``TelemetryRun.set_fingerprint`` for the
regression gate (``obs/run.py``), because that canonicalization was
designed to capture exactly what makes two solves the "same program":
pose/edge/slot counts, rank, d, dtype, schedule, robust cost, selection
mode.  Two requests whose fingerprints agree reuse one entry; a
differing rank, dtype, or schedule misses and builds its own.
"""

from __future__ import annotations

import json
import threading

from ..models.rbcd import GraphMeta
from ..models.rbcd import _sel_mode as resolved_sel_mode
from ..obs.events import _jsonable
from ..obs.recorder import dtype_name


def problem_fingerprint(meta: GraphMeta, params, dtype, shape=None,
                        batch: int | None = None,
                        kind: str | None = None) -> dict:
    """Canonical (JSON-able) fingerprint of a batched solve program.

    Field names follow ``run_rbcd``'s ``set_fingerprint`` record where the
    concepts coincide (num_robots/rank/d/dtype/schedule/robust_cost/
    sel_mode), extended with the padded bucket shape, the remaining solver
    configuration (``params`` is a frozen dataclass — its repr is a stable
    canonical form), the batch width, and the program kind
    (segment/metrics/finalize)."""
    fp = {
        "solver": "serve_batch",
        "num_robots": meta.num_robots,
        "rank": meta.rank,
        "d": meta.d,
        "n_max": meta.n_max,
        "e_max": meta.e_max,
        "s_max": meta.s_max,
        "p_max": meta.p_max,
        "num_colors": meta.num_colors,
        "dtype": dtype_name(dtype),
        "schedule": params.schedule.value,
        "robust_cost": params.robust.cost_type.value,
        "sel_mode": resolved_sel_mode(params),
        "params": repr(params),
    }
    if shape is not None:
        fp["bucket_shape"] = tuple(shape)
    if batch is not None:
        fp["batch"] = int(batch)
    if kind is not None:
        fp["kind"] = str(kind)
    return {k: _jsonable(v) for k, v in fp.items()}


def fingerprint_key(fp: dict) -> str:
    """Stable hashable form of a fingerprint dict."""
    return json.dumps(fp, sort_keys=True)


class ExecutableCache:
    """Fingerprint-keyed store of built executables with hit/compile
    accounting.

    ``get`` returns the cached executable for ``fp`` or invokes
    ``builder()`` exactly once and caches its result.  ``compiles`` counts
    builder invocations — the observable the bucketing tests pin: a stream
    of identical-fingerprint requests must leave it flat.

    Single-flight: concurrent ``get``\\ s on the same key run ONE builder;
    the rest wait on its completion and count as hits.  Builds still run
    outside the cache lock (two different keys must build concurrently);
    per-key in-flight events
    provide the exclusion.  A builder that raises clears its in-flight
    marker so waiters (and retries) attempt the build themselves.

    ``disk`` is the optional artifact tier
    (``serve.fleet.aotcache.AOTDiskCache``), which ``SolveServer`` resolves
    the kernel library through before its first batch on the card; the
    cache only carries the handle and surfaces the tier's stats.
    """

    def __init__(self, disk=None):
        self.disk = disk
        self._lock = threading.Lock()
        self._entries: dict[str, object] = {}           # guarded-by: _lock
        self._building: dict[str, threading.Event] = {}  # guarded-by: _lock
        self.compiles = 0                               # guarded-by: _lock
        self.hits = 0                                   # guarded-by: _lock

    def get(self, fp: dict, builder):
        key = fingerprint_key(fp)
        while True:
            with self._lock:
                if key in self._entries:
                    self.hits += 1
                    entry = self._entries[key]
                    break
                pending = self._building.get(key)
                if pending is None:
                    pending = self._building[key] = threading.Event()
                    entry = None
                    break
            # Another thread is building this key: wait for it, then
            # re-check (it may have failed, in which case we build).
            pending.wait()
        if entry is not None:
            self._obs("hit")
            return entry
        try:
            built = builder()
        except BaseException:
            with self._lock:
                self._building.pop(key, None)
            pending.set()
            raise
        with self._lock:
            self._entries[key] = built
            self.compiles += 1
            self._building.pop(key, None)
        pending.set()
        self._obs("compile")
        return built

    def _obs(self, outcome: str) -> None:
        """Mirror hit/compile tallies as Prometheus counters so the live
        ``/metrics`` endpoint carries them (zero-overhead fence: resolved
        per call, nothing constructed with telemetry off)."""
        from .. import obs

        run = obs.get_run()
        if run is None:
            return
        run.counter("serve_cache_requests_total",
                    "executable-cache lookups by outcome").inc(
            outcome=outcome)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            out = {"entries": len(self._entries), "compiles": self.compiles,
                   "hits": self.hits}
        if self.disk is not None:
            out["disk"] = self.disk.stats()
        return out

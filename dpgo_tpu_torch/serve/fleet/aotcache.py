"""The artifact tier: a persistent copy of the kernel library under
``ExecutableCache`` (port of ``dpgo_tpu.serve.fleet.aotcache``).

The JAX package serializes one XLA executable per bucket fingerprint, so a
restarted replica loads its programs instead of compiling them.  The port
compiles exactly one artifact: the kernel library that
``ops.rtr_kernel.build`` makes with ``nvcc`` from ``csrc/`` and binds
through ``ctypes``; a bucket's programs are Python callables with nothing
to serialize.  So this tier persists that library, shared by every replica
and restart of a fleet, keyed by everything that could make a built
library wrong to load: the sources, headers and nvcc flags
(``rtr_kernel.source_digest``), ``nvcc --version``, torch and its CUDA
version, the device's compute capability and the entry schema version.

Durability discipline mirrors the JAX tier and ``serve.session``:

* writes are atomic (temp file + fsync + rename), so a crash mid-write
  leaves a torn temp file, never a torn entry;
* every entry embeds its full identity and a digest of its bytes, and
  ``load`` re-validates both against the requested identity before the
  library is ever opened — a stale, colliding or corrupted entry is
  refused, not loaded;
* ANY load defect (a torn or mismatched file, a library that fails
  ``dlopen`` or lacks a ``dpgo_*`` entry point) QUARANTINES the entry —
  renamed aside so it is never retried — and the caller rebuilds from
  ``csrc/``.  The tier is strictly fail-open: no admission path ever sees
  a disk-tier exception.  A failed rebuild raises: nothing here falls
  back to a plain version.

An entry is the library itself with a trailer appended (the identity as
JSON, its length, a blake2b digest of library and identity, a magic
word): the dynamic loader maps an ELF object by its program headers and
ignores bytes past them, so the validated file is opened in place.

``resolve_kernel_library`` binds the library through the tiers: already
bound in the process; else the disk tier (a ``compile_profile`` event with
``disk_hit=True`` and the load seconds); else ``rtr_kernel.build()`` and a
store.  A ``SolveServer`` with ``aot_cache_dir`` calls it once, before its
first batch on the card; ``serve_compile_seconds_total`` grows only by
builds that ran ``nvcc``.  CPU servers never touch the tier (their
programs run the plain versions).  It constructs no obs objects and emits
nothing unless a run is live.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import struct
import threading
import time

import torch

from ... import obs

#: Bump on any incompatible change to the entry layout.  A loader finding a
#: different version finds another path (the version keys the identity).
AOT_CACHE_SCHEMA_VERSION = 1

#: The entry trailer's last bytes.
_MAGIC = b"DPGOAOT1"
_DIGEST_BYTES = 32


def entry_identity(capability=None) -> dict:
    """The full identity of the kernel library's disk entry: everything
    that could make a built library wrong to load.  ``capability`` is the
    device's compute capability (default: the current CUDA device's)."""
    from ...ops import rtr_kernel

    if capability is None:
        capability = torch.cuda.get_device_capability()
    return {
        "schema": AOT_CACHE_SCHEMA_VERSION,
        "artifact": "kernel_library",
        "sources": rtr_kernel.source_digest(),
        **rtr_kernel.toolchain(),
        "capability": [int(c) for c in capability],
    }


def _ident_digest(ident: dict) -> str:
    blob = json.dumps(ident, sort_keys=True).encode("utf-8")
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def _entry_digest(payload: bytes, ident_blob: bytes) -> bytes:
    return hashlib.blake2b(payload + ident_blob,
                           digest_size=_DIGEST_BYTES).digest()


def _read_entry(path: str) -> dict:
    """The identity an entry embeds, after checking its trailer and its
    digest; raises ``ValueError`` on any defect."""
    with open(path, "rb") as fh:
        blob = fh.read()
    tail = len(_MAGIC) + _DIGEST_BYTES + 8
    if len(blob) < tail or blob[-len(_MAGIC):] != _MAGIC:
        raise ValueError("entry has no trailer (torn or foreign file)")
    n_ident = struct.unpack("<Q", blob[-tail:-tail + 8])[0]
    end = len(blob) - tail
    if n_ident > end:
        raise ValueError("entry trailer is corrupt")
    ident_blob = blob[end - n_ident:end]
    digest = blob[end + 8:end + 8 + _DIGEST_BYTES]
    if _entry_digest(blob[:end - n_ident], ident_blob) != digest:
        raise ValueError("entry bytes do not match their digest")
    return json.loads(ident_blob.decode("utf-8"))


class AOTDiskCache:
    """Directory-backed store of the kernel library, one entry per
    identity.

    Thread-safe and multi-process-safe by construction: entries are
    immutable once renamed into place, writes are atomic, and identity
    validation makes concurrent writers idempotent (same identity -> same
    library).  Replicas of one fleet share a root."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.disk_hits = 0      # guarded-by: _lock
        self.disk_misses = 0    # guarded-by: _lock
        self.stores = 0         # guarded-by: _lock
        self.quarantined = 0    # guarded-by: _lock
        self.store_errors = 0   # guarded-by: _lock

    def _path(self, ident: dict) -> str:
        return os.path.join(self.root, f"lib-{_ident_digest(ident)}.so")

    # -- reading -------------------------------------------------------------

    def load(self, ident: dict, symbols=None) -> str | None:
        """The path of the validated library for ``ident``, opened once
        with ``ctypes`` and found to export every name in ``symbols``
        (default: the kernel library's, ``rtr_kernel.SYMBOLS``); or None.

        None covers both a plain miss and every defect path (quarantined
        entry, identity or digest mismatch, ``dlopen`` failure, a missing
        entry point) — the caller always falls back to building.  Never
        raises."""
        if symbols is None:
            from ...ops.rtr_kernel import SYMBOLS as symbols
        path = self._path(ident)
        if not os.path.exists(path):
            with self._lock:
                self.disk_misses += 1
            self._obs("disk_miss")
            return None
        try:
            found = _read_entry(path)
            if found != ident:
                # A digest collision or a stale/foreign entry: the library
                # was built for other sources or another toolchain.
                raise ValueError(f"entry identity mismatch: {found!r}")
            lib = ctypes.CDLL(path)
            for name in symbols:
                getattr(lib, name)  # AttributeError: not this library
        except Exception as e:  # any defect: quarantine, fall back
            self._quarantine(path, e)
            return None
        with self._lock:
            self.disk_hits += 1
        self._obs("disk_hit")
        return path

    def _quarantine(self, path: str, error: Exception) -> None:
        try:
            os.replace(path, path + ".quarantined")
        except OSError:
            pass
        with self._lock:
            self.quarantined += 1
        run = obs.get_run()
        if run is not None:
            run.counter("serve_aot_quarantined_total",
                        "corrupt/stale persisted executables set aside").inc()
            run.event("aot_entry_quarantined", phase="serve", path=path,
                      error=f"{type(error).__name__}: {error}")

    # -- writing -------------------------------------------------------------

    def store(self, ident: dict, lib_path) -> bool:
        """Atomically persist the library at ``lib_path`` as ``ident``'s
        entry.  Write failures are swallowed (the disk tier must never take
        a solve down); returns whether the entry landed."""
        tmp = None
        try:
            with open(lib_path, "rb") as fh:
                payload = fh.read()
            ident_blob = json.dumps(ident, sort_keys=True).encode("utf-8")
            path = self._path(ident)
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "wb") as fh:
                fh.write(payload)
                fh.write(ident_blob)
                fh.write(struct.pack("<Q", len(ident_blob)))
                fh.write(_entry_digest(payload, ident_blob))
                fh.write(_MAGIC)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except Exception as e:
            if tmp is not None and os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            with self._lock:
                self.store_errors += 1
            run = obs.get_run()
            if run is not None:
                run.event("aot_store_failed", phase="serve",
                          error=f"{type(e).__name__}: {e}")
            return False
        with self._lock:
            self.stores += 1
        run = obs.get_run()
        if run is not None:
            run.counter("serve_aot_stores_total",
                        "compiled executables persisted to the disk "
                        "tier").inc()
        return True

    def _obs(self, outcome: str) -> None:
        run = obs.get_run()
        if run is None:
            return
        run.counter("serve_cache_requests_total",
                    "executable-cache lookups by outcome").inc(
            outcome=outcome)

    def stats(self) -> dict:
        with self._lock:
            return {"root": self.root, "disk_hits": self.disk_hits,
                    "disk_misses": self.disk_misses, "stores": self.stores,
                    "quarantined": self.quarantined,
                    "store_errors": self.store_errors}


def resolve_kernel_library(disk: AOTDiskCache,
                           label: str = "kernel_library") -> str:
    """Bind the kernel library through the tiers and say which one served:
    ``"bound"`` (this process had it), ``"disk"`` (``disk``'s validated
    entry), or ``"build"`` (``rtr_kernel.build()``, then stored; it
    returns only a library this toolchain built, ``rtr_kernel.
    library_path``, so no entry claims another nvcc's library).  Holds
    ``rtr_kernel``'s one build lock throughout, so concurrent replicas of
    one process resolve once.  A failed build or bind raises."""
    from ...ops import rtr_kernel

    with rtr_kernel._BUILD_LOCK:
        if rtr_kernel.bound():
            return "bound"
        rtr_kernel._need_cuda()
        ident = entry_identity()
        run = obs.get_run()
        t0 = time.monotonic()
        path = disk.load(ident)
        if path is not None:
            rtr_kernel.bind(path)
            if run is not None:
                # The cold-start proof: a disk hit reports its load time
                # under the compile event family but adds nothing to
                # serve_compile_seconds_total.
                run.event("compile_profile", phase="serve", label=label,
                          disk_hit=True, load_s=time.monotonic() - t0)
            return "disk"
        runs0 = rtr_kernel.NVCC_RUNS
        lib = rtr_kernel.build()
        build_s = time.monotonic() - t0
        rtr_kernel.bind(lib)
        nvcc = rtr_kernel.NVCC_RUNS > runs0
        if run is not None:
            run.event("compile_profile", phase="serve", label=label,
                      disk_hit=False, nvcc=nvcc, build_s=build_s)
            if nvcc:
                run.counter("serve_compile_seconds_total",
                            "host wall of the kernel library's nvcc "
                            "builds", unit="s").inc(build_s, label=label)
        disk.store(ident, lib)
        return "build"

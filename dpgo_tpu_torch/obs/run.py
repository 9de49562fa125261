"""Run scoping: one ``TelemetryRun`` = one registry + one event stream
bound to a run directory, installable as the process-ambient run (the
PyTorch port's copy of ``dpgo_tpu.obs.run``; ``materialize`` reads torch
tensors).

Instrumented hot paths resolve the ambient run with ``get_run()`` and take
a no-telemetry early exit when it is ``None`` — that early exit IS the
zero-overhead path the acceptance criteria require: no events, no registry
calls, and no added device->host transfers, because every device readback
the instrumentation performs goes through ``materialize`` below, which is
only reachable behind the ``get_run() is not None`` guard
(``tests/test_obs.py`` patches ``materialize`` to count and asserts zero
with telemetry off).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid

import numpy as np

from .events import EventStream
from .exporters import to_prometheus_text
from .metrics import MetricsRegistry

EVENTS_FILE = "events.jsonl"
METRICS_FILE = "metrics.json"
PROMETHEUS_FILE = "metrics.prom"
META_FILE = "run.json"


def materialize(x) -> np.ndarray:
    """The obs-owned device->host fence: every readback the telemetry layer
    performs funnels through here, so 'telemetry off adds no transfers' is
    a testable property instead of a code-review promise.  A torch tensor
    (on any device) is copied to the host and returned as numpy; anything
    else goes through ``np.asarray``."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TelemetryRun:
    """Metrics + events for one run, persisted under ``run_dir``.

    ``close()`` (or the ``run_scope`` context) writes the metrics snapshot
    (``metrics.json``), the Prometheus exposition (``metrics.prom``), and
    closes the event stream; the report CLI reads those artifacts.
    """

    def __init__(self, run_dir: str, run_id: str | None = None):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.registry = MetricsRegistry()
        self.events = EventStream(
            os.path.join(self.run_dir, EVENTS_FILE), self.run_id)
        #: Config fingerprint (dataset, ranks, wire format, ... — whatever
        #: the instrumented layers register via ``set_fingerprint``); the
        #: regression gate (``obs.regress``) refuses apples-to-oranges
        #: comparisons on it.
        self.fingerprint: dict = {}
        #: Optional attached ``obs.recorder.FlightRecorder``.
        self.recorder = None
        self._closed = False
        self._t0_wall = time.time()
        self._t0_mono = time.monotonic()
        with open(os.path.join(self.run_dir, META_FILE), "w") as fh:
            json.dump({"run": self.run_id, "t_start_wall": self._t0_wall,
                       "t_start_mono": self._t0_mono}, fh)
        self.events.emit("run_start")

    # -- convenience forwarding --------------------------------------------

    def event(self, event: str, phase: str | None = None, **fields) -> dict:
        return self.events.emit(event, phase=phase, **fields)

    def metric(self, metric: str, value, unit: str | None = None,
               phase: str | None = None, **extra) -> dict:
        return self.events.metric(metric, value, unit, phase=phase, **extra)

    def counter(self, name, help="", unit=""):
        return self.registry.counter(name, help, unit)

    def gauge(self, name, help="", unit=""):
        return self.registry.gauge(name, help, unit)

    def histogram(self, name, help="", unit="", **kw):
        return self.registry.histogram(name, help, unit, **kw)

    def set_fingerprint(self, **fields) -> dict:
        """Merge config-identity fields (dataset, num_robots, rank,
        sel_mode, wire format, package version, ...) into the run's
        fingerprint and emit it as a ``run_summary`` event with
        ``channel="config"`` — the record ``report --compare`` keys its
        apples-to-oranges refusal on.  The merged fingerprint also lands
        in ``run.json`` at close.  Fields set to None are dropped; later
        calls override earlier keys (the most specific caller wins)."""
        from .events import _jsonable

        for k, v in fields.items():
            if v is not None:
                self.fingerprint[k] = _jsonable(v)
        self.events.emit("run_summary", phase="config", channel="config",
                         fingerprint=dict(self.fingerprint))
        return dict(self.fingerprint)

    # -- persistence --------------------------------------------------------

    def write_snapshot(self) -> str:
        path = os.path.join(self.run_dir, METRICS_FILE)
        snap = {"run": self.run_id, "t_wall": time.time(),
                "t_mono": time.monotonic(),
                "metrics": self.registry.snapshot()}
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(snap, fh, indent=1)
        os.replace(tmp, path)
        prom = os.path.join(self.run_dir, PROMETHEUS_FILE)
        with open(prom + ".tmp", "w") as fh:
            fh.write(to_prometheus_text(self.registry))
        os.replace(prom + ".tmp", prom)
        return path

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.events.emit("run_end",
                         duration_s=time.monotonic() - self._t0_mono)
        self.write_snapshot()
        self.events.close()
        if self.fingerprint:
            # Persist the final fingerprint into run.json so comparisons
            # need not scan the event stream.
            meta_path = os.path.join(self.run_dir, META_FILE)
            try:
                with open(meta_path) as fh:
                    meta = json.load(fh)
            except (OSError, ValueError):
                meta = {"run": self.run_id}
            meta["fingerprint"] = self.fingerprint
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(meta, fh)
            os.replace(tmp, meta_path)

    @property
    def closed(self) -> bool:
        return self._closed


# -- ambient run -------------------------------------------------------------

_lock = threading.Lock()
_current: TelemetryRun | None = None


def get_run() -> TelemetryRun | None:
    """The ambient run, or None (the zero-overhead telemetry-off path).

    Deliberately lock-free: a plain global read, so the hot-path guard
    ``if obs.get_run() is not None`` costs one attribute lookup.  Python's
    GIL makes the read atomic; installation/removal takes the lock."""
    return _current


def start_run(run_dir: str, run_id: str | None = None) -> TelemetryRun:
    """Create a run under ``run_dir`` and install it as the ambient run.

    Refuses to silently replace a live ambient run — two overlapping runs
    would interleave their instrumentation; scope with ``run_scope`` or
    ``end_run()`` first."""
    global _current
    run = TelemetryRun(run_dir, run_id)
    with _lock:
        if _current is not None and not _current.closed:
            run.events.close()
            raise RuntimeError(
                f"a telemetry run is already active ({_current.run_id}); "
                "end it before starting another")
        _current = run
    return run


def end_run() -> None:
    """Close and uninstall the ambient run (no-op when none is active)."""
    global _current
    with _lock:
        run, _current = _current, None
    if run is not None:
        run.close()


@contextlib.contextmanager
def run_scope(run_dir: str, run_id: str | None = None):
    """``with obs.run_scope(dir) as run: solve(...)`` — telemetry on inside,
    artifacts written and the ambient run cleared on exit (exceptions
    included)."""
    run = start_run(run_dir, run_id)
    try:
        yield run
    finally:
        global _current
        with _lock:
            if _current is run:
                _current = None
        run.close()

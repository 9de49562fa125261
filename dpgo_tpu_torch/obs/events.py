"""Structured JSONL event stream.

One event per line.  Every line carries the correlation fields up front —
``run`` (run id), ``seq`` (per-stream sequence number), ``t_wall`` (Unix
epoch seconds), ``t_mono`` (monotonic seconds, for intra-run latency math
immune to clock steps), ``event`` (kind), and ``phase`` (solver phase the
event belongs to: ``exchange`` / ``solve`` / ``eval`` / ``certify`` / ...)
— followed by the event's own payload fields.

``metric_record`` is the shared scalar-metric schema: the same
``metric`` / ``value`` / ``unit`` leading keys as the repo's
``BENCH_r0*.json`` records, so ``bench.py``'s final line and in-stream
``metric`` events parse with one reader.

The PyTorch port's copy of ``dpgo_tpu.obs.events``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import json
import math
import threading
import time
import warnings


#: The one non-finite float convention of the whole obs stack: JSON has no
#: literal for them, so they serialize as the Prometheus text-exposition
#: strings and ``read_events`` restores them to floats on load — the
#: snapshot (``metrics.py``), the exporters, and the event stream all
#: round-trip through this single table.
NONFINITE_STR = {"NaN": float("nan"), "+Inf": float("inf"),
                 "-Inf": float("-inf")}
#: Legacy spellings from pre-unification streams, restored on read only.
_NONFINITE_LEGACY = {"nan": float("nan"), "inf": float("inf"),
                     "-inf": float("-inf")}


def nonfinite_str(v: float) -> str:
    """Canonical string for a non-finite float (Prometheus convention)."""
    if math.isnan(v):
        return "NaN"
    return "+Inf" if v > 0 else "-Inf"


def restore_nonfinite(v):
    """Inverse of the serialization convention: recursively convert the
    canonical (and legacy) non-finite strings back to floats.  Applied by
    ``read_events`` so a round-tripped stream yields real float NaN/Inf —
    string payloads that happen to spell exactly ``"NaN"``/``"+Inf"``/
    ``"-Inf"`` are, by convention, numbers."""
    if isinstance(v, str):
        if v in NONFINITE_STR:
            return NONFINITE_STR[v]
        if v in _NONFINITE_LEGACY:
            return _NONFINITE_LEGACY[v]
        return v
    if isinstance(v, dict):
        return {k: restore_nonfinite(x) for k, x in v.items()}
    if isinstance(v, list):
        return [restore_nonfinite(x) for x in v]
    return v


def _jsonable(v):
    """Coerce payload values to JSON-safe types (numpy scalars/arrays from
    phase-boundary readbacks arrive here routinely; non-finite floats have
    no JSON literal, so they become the canonical strings rather than
    invalid output)."""
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else nonfinite_str(v)
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return _jsonable(v.item())
    if hasattr(v, "tolist"):
        return _jsonable(v.tolist())
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


def metric_record(metric: str, value, unit: str | None = None,
                  **extra) -> dict:
    """The canonical scalar-metric record: ``metric``/``value``/``unit``
    first (the ``BENCH_r0*.json`` key set), extras after."""
    rec = {"metric": str(metric), "value": _jsonable(value)}
    if unit is not None:
        rec["unit"] = str(unit)
    for k, v in extra.items():
        rec[k] = _jsonable(v)
    return rec


class EventStream:
    """Append-only JSONL writer for one run.

    Thread-safe: one lock serializes sequence assignment and the write, so
    lines from the agent's optimization thread and a transport thread
    interleave whole, never torn.  Lines are flushed per event — an event
    stream that loses its tail on a crash is the one that mattered.
    """

    def __init__(self, path: str, run_id: str):
        self.path = path
        self.run_id = run_id
        self._lock = threading.Lock()
        self._seq = 0
        self._fh = open(path, "a", encoding="utf-8")
        self._closed = False

    def emit(self, event: str, phase: str | None = None, **fields) -> dict:
        rec = {"run": self.run_id, "seq": 0,
               "t_wall": time.time(), "t_mono": time.monotonic(),
               "event": str(event)}
        if phase is not None:
            rec["phase"] = str(phase)
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        line = None
        with self._lock:
            if self._closed:
                return rec
            rec["seq"] = self._seq
            self._seq += 1
            line = json.dumps(rec)
            self._fh.write(line + "\n")
            self._fh.flush()
        return rec

    def metric(self, metric: str, value, unit: str | None = None,
               phase: str | None = None, **extra) -> dict:
        """Emit one scalar-metric event in the shared schema."""
        return self.emit("metric", phase=phase,
                         **metric_record(metric, value, unit, **extra))

    @property
    def num_emitted(self) -> int:
        with self._lock:
            return self._seq

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._fh.close()


def read_events(path: str) -> list[dict]:
    """Load a JSONL event file; skips blank lines.

    A corrupt line in the MIDDLE of the file raises ``ValueError`` (the
    stream is damaged, not merely cut short).  An unparseable FINAL line
    is tolerated with a ``RuntimeWarning`` — a robot killed mid-write
    (exactly the ``tests/test_chaos.py`` scenarios) truncates its last
    line, and the events before it are intact and wanted.  Use
    ``read_events_meta`` to get the truncation flag programmatically.

    Non-finite floats round-trip: values the writer serialized as the
    canonical ``"NaN"``/``"+Inf"``/``"-Inf"`` strings (``_jsonable``) come
    back as real floats (``restore_nonfinite``)."""
    events, _truncated = read_events_meta(path)
    return events


def read_events_meta(path: str) -> tuple[list[dict], bool]:
    """``(events, truncated)``: like ``read_events`` but returns whether
    the file ended in a truncated (unparseable) final line."""
    out = []
    with open(path, encoding="utf-8") as fh:
        lines = fh.readlines()
    last = max((i for i, ln in enumerate(lines) if ln.strip()), default=-1)
    for ln, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(restore_nonfinite(json.loads(line)))
        except json.JSONDecodeError as e:
            if ln == last:
                warnings.warn(
                    f"{path}:{ln + 1}: truncated final event line "
                    "(writer killed mid-write?) — dropped",
                    RuntimeWarning, stacklevel=2)
                return out, True
            raise ValueError(f"{path}:{ln + 1}: corrupt event line") from e
    return out, False

"""Thread-safe metrics primitives: counters, gauges, histograms with labels.

The shapes follow the Prometheus data model (a *family* per name, one time
series per label set) because that is what the text exposition exports, but
the implementation is a host-side dict under one lock — metric calls happen
at phase boundaries (per round / per eval / per message), thousands per
second at most, so a single ``threading.Lock`` per registry is simpler and
plenty.  Safe from the agent's background optimization thread
(``agent.start_optimization_loop``) concurrently with a transport thread.

Values are plain floats; histograms keep cumulative bucket counts plus
sum/count (Prometheus ``_bucket``/``_sum``/``_count`` semantics).

The PyTorch port's copy of ``dpgo_tpu.obs.metrics``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import math
import threading

from .events import nonfinite_str

# Default histogram buckets: geometric, spanning 100 us .. ~100 s — sized
# for round/iterate latencies, the dominant histogram use.
DEFAULT_BUCKETS = tuple(1e-4 * (10 ** (k / 3.0)) for k in range(19))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Family:
    """Base: one named metric family holding per-label-set series."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str = "",
                 unit: str = ""):
        self._registry = registry
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.unit = unit
        self._series: dict[tuple, object] = {}  # guarded-by: _lock

    def _zero(self):
        return 0.0

    def _get(self, labels: dict):  # holds: _lock
        key = _label_key(labels)
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = self._zero()
        return key, series

    def series(self) -> dict[tuple, object]:
        with self._lock:
            return dict(self._series)


class Counter(_Family):
    """Monotonically increasing value (``inc`` only)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        with self._lock:
            key, cur = self._get(labels)
            self._series[key] = cur + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Family):
    """Point-in-time value (``set``/``inc``)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            key, _ = self._get(labels)
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            key, cur = self._get(labels)
            self._series[key] = cur + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Histogram(_Family):
    """Cumulative-bucket histogram (Prometheus semantics).

    ``observe_many`` takes any value iterable (a numpy array included) and
    bins it in one pass — the GNC weight vector is observed per update
    round, and a Python-level per-element loop there would cost more than
    the weight computation itself.
    """

    kind = "histogram"

    def __init__(self, registry, name, help="", unit="",
                 buckets=DEFAULT_BUCKETS):
        super().__init__(registry, name, help, unit)
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = tuple(b)

    def _zero(self):
        return {"counts": [0] * (len(self.buckets) + 1),  # +inf tail
                "sum": 0.0, "count": 0}

    def observe(self, value: float, **labels) -> None:
        self.observe_many((value,), **labels)

    def observe_many(self, values, **labels) -> None:
        vals = [float(v) for v in values]
        if not vals:
            return
        binned = [0] * (len(self.buckets) + 1)
        total = 0.0
        for v in vals:
            total += v
            for bi, bound in enumerate(self.buckets):
                if v <= bound:
                    binned[bi] += 1
                    break
            else:
                binned[-1] += 1
        with self._lock:
            key, series = self._get(labels)
            for bi, n in enumerate(binned):
                series["counts"][bi] += n
            series["sum"] += total
            series["count"] += len(vals)

    def snapshot_series(self, **labels) -> dict | None:
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None:
                return None
            return {"counts": list(s["counts"]), "sum": s["sum"],
                    "count": s["count"]}


class MetricsRegistry:
    """A run's metric families, keyed by name.

    Re-requesting a name returns the existing family (so call-site helpers
    need no caching), but re-requesting with a different kind raises — a
    silent kind change would corrupt the exposition.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}  # guarded-by: _lock

    def _family(self, cls, name: str, help: str, unit: str, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
        if fam is None:
            new = cls(self, name, help, unit, **kw)
            with self._lock:
                fam = self._families.setdefault(name, new)
        if type(fam) is not cls:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}")
        return fam

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._family(Counter, name, help, unit)

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        return self._family(Gauge, name, help, unit)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._family(Histogram, name, help, unit, buckets=buckets)

    def families(self) -> list[_Family]:
        with self._lock:
            return list(self._families.values())

    def snapshot(self) -> dict:
        """JSON-serializable view of every series of every family."""
        out = {}
        for fam in self.families():
            series = []
            for key, val in sorted(fam.series().items()):
                entry = {"labels": dict(key)}
                if isinstance(val, dict):
                    entry.update(val)
                else:
                    # One non-finite convention across the stack: the same
                    # canonical strings the Prometheus exposition and the
                    # event stream use (events.nonfinite_str), restored to
                    # floats by read_events.
                    entry["value"] = val if math.isfinite(val) \
                        else nonfinite_str(val)
                series.append(entry)
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "unit": fam.unit, "series": series}
            if fam.kind == "histogram":
                out[fam.name]["buckets"] = list(fam.buckets)
        return out

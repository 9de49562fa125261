"""Device-time attribution from ``torch.profiler`` traces (port of
``dpgo_tpu.obs.devprof``).

* ``DeviceTraceWindow`` — a fence-constructed ``torch.profiler`` window
  over a short calibration segment (a few fused rounds).  Stopping the
  window synchronizes the device, writes the Chrome-format trace and
  parses it.
* ``attribute_trace`` / ``attribute_profile_dir`` — pure parsers that
  split per-lane device time into **collective** vs **compute** vs
  **idle**, normalized per round, plus the measured overlap efficiency:
  the fraction of collective time during which another lane was
  computing.
* ``decide_overlap`` — the overlap gate's arbiter over timed lockstep and
  overlapped arms.
* ``profiled_program`` — the solver planes' first-call accounting
  (``profile.ProfiledExecutable`` under the plane's phase and metric
  prefix).
* ``time_arm`` — the plain wall timer of the overlap gate's A/B arms.

Device events are recognized by their Chrome-trace category, where the
JAX package keys on XLA's ``args.hlo_op`` marker: ``torch.profiler``
(CUPTI) writes CUDA kernels as ``cat: "kernel"`` and device copies and
fills as ``gpu_memcpy`` / ``gpu_memset``, one lane per (device, stream);
host spans (``cpu_op``, ``cuda_runtime``, ``user_annotation``) are not
device time.  A kernel whose name starts with ``nccl`` is a collective.
Everything here is constructed and invoked behind the zero-overhead
telemetry fence; the parsers are pure functions usable offline.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import threading
import time

from .run import get_run

__all__ = [
    "COLLECTIVE_OP_PREFIXES",
    "DEVICE_CATEGORIES",
    "DeviceTraceWindow",
    "attribute_profile_dir",
    "attribute_trace",
    "classify_op",
    "decide_overlap",
    "device_events",
    "find_trace_files",
    "load_trace_events",
    "op_device_seconds",
    "profiled_program",
    "time_arm",
]

#: Kernel-name prefixes that mark a device op as a cross-device
#: collective (NCCL's kernels: ``ncclDevKernel_AllReduce_...``,
#: ``ncclKernel_...``).
COLLECTIVE_OP_PREFIXES = ("nccl",)

#: Chrome-trace categories of device work in a ``torch.profiler`` trace.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: Keep at most this many slices in a ``device_attribution`` event (the
#: longest ones) — enough for the timeline device track without letting
#: a long window bloat events.jsonl.
MAX_SLICES = 200

#: And at most this many distinct ops in the ``top_ops`` table.
MAX_TOP_OPS = 12


def classify_op(op_name: str) -> str:
    """``"collective"`` or ``"compute"`` for one device op name."""
    name = op_name.lower()
    for prefix in COLLECTIVE_OP_PREFIXES:
        if name.startswith(prefix):
            return "collective"
    return "compute"


def find_trace_files(profile_dir: str) -> list:
    """Chrome-format trace files under a profiler output dir
    (``utils.profiling.trace`` writes ``<dir>/<host>.<pid>.<ms>.trace.json``;
    gzipped files and any ``*.trace.json[.gz]`` below are accepted too)."""
    pats = [
        os.path.join(profile_dir, "*.trace.json"),
        os.path.join(profile_dir, "*.trace.json.gz"),
        os.path.join(profile_dir, "**", "*.trace.json.gz"),
        os.path.join(profile_dir, "**", "*.trace.json"),
    ]
    for pat in pats:
        found = sorted(glob.glob(pat, recursive=True))
        if found:
            return found
    return []


def load_trace_events(path: str) -> list:
    """The ``traceEvents`` list of one Chrome-format trace file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return [e for e in events if isinstance(e, dict)]


def device_events(events: list):
    """``(t0_us, t1_us, name, lane)`` for every device slice of a trace:
    ``ph == "X"`` events whose ``cat`` is one of ``DEVICE_CATEGORIES``."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        try:
            t0 = float(e["ts"])
            dur = float(e.get("dur", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        out.append((t0, t0 + max(dur, 0.0), str(e.get("name", "")),
                    (e.get("pid", 0), e.get("tid", 0))))
    return out


def op_device_seconds(events: list, pattern: str) -> tuple[float, int]:
    """``(seconds, count)`` of the device slices whose name contains
    ``pattern`` — one kernel's device time within a window."""
    sel = [t1 - t0 for t0, t1, name, _lane in device_events(events)
           if pattern in name]
    return sum(sel) * 1e-6, len(sel)


def _merge(intervals: list) -> list:
    """Union of [t0, t1) intervals, sorted and coalesced."""
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def _subtract(merged_a: list, merged_b: list) -> list:
    """Parts of merged union ``a`` not covered by merged union ``b``."""
    out = []
    j = 0
    for t0, t1 in merged_a:
        cur = t0
        while j < len(merged_b) and merged_b[j][1] <= cur:
            j += 1
        k = j
        while k < len(merged_b) and merged_b[k][0] < t1:
            if merged_b[k][0] > cur:
                out.append((cur, merged_b[k][0]))
            cur = max(cur, merged_b[k][1])
            k += 1
        if cur < t1:
            out.append((cur, t1))
    return out


def _leaf_flags(ops: list) -> list:
    """``True`` per op that contains no other op on the same lane.

    XLA traces nest: the fused-rounds ``while`` slice encloses every op
    of its body, so summing raw durations double-counts and the container
    drowns the real op mix.  Ops here are ``(t0, t1, op)`` tuples;
    ordering by (start, -duration) makes any enclosing op precede its
    children, so one stack pass marks the parents."""
    order = sorted(range(len(ops)),
                   key=lambda i: (ops[i][0], ops[i][0] - ops[i][1]))
    leaf = [True] * len(ops)
    stack: list = []
    for i in order:
        t0, t1 = ops[i][0], ops[i][1]
        while stack and ops[stack[-1]][1] <= t0:
            stack.pop()
        if stack:
            leaf[stack[-1]] = False
        stack.append(i)
    return leaf

def _overlap_len(intervals: list, merged: list) -> float:
    """Total length of ``intervals`` covered by the merged union."""
    total = 0.0
    j = 0
    for t0, t1 in sorted(intervals):
        while j > 0 and merged[j - 1][1] > t0:
            j -= 1
        k = j
        while k < len(merged) and merged[k][0] < t1:
            total += max(0.0, min(t1, merged[k][1]) - max(t0, merged[k][0]))
            k += 1
        j = max(k - 1, 0)
    return total


def attribute_trace(events: list, num_rounds: int = 1,
                    module_filter: str | None = None) -> dict:
    """Per-round device-time attribution of one trace's device events.

    Device ops are the slices ``device_events`` selects, one lane per
    (pid, tid) pair — a device's stream.  ``module_filter`` keeps only the
    ops whose name contains it.  Per lane, collective time is the merged
    union of its collective-op intervals and compute time is the lane's
    busy union minus that — interval algebra, not duration sums, so
    nested slices never double-count.  Idle is the rest of the window.
    Returns the split (totals and per-round), the measured overlap
    efficiency (fraction of collective time concurrent with compute on
    another lane), a leaf-op ``top_ops`` table, and the longest leaf
    ``slices`` (window-relative seconds) for the timeline device track.
    """
    num_rounds = max(1, int(num_rounds))
    lanes: dict = {}
    for t0, t1, op, lane in device_events(events):
        if module_filter and module_filter not in op:
            continue
        lanes.setdefault(lane, []).append((t0, t1, op))

    if not lanes:
        return {"lanes": 0, "num_rounds": num_rounds, "window_s": 0.0,
                "compute_s": 0.0, "collective_s": 0.0, "idle_s": 0.0,
                "per_round": {"compute_s": 0.0, "collective_s": 0.0,
                              "idle_s": 0.0},
                "collective_hidden_s": 0.0,
                "overlap_efficiency_measured": 0.0,
                "top_ops": [], "slices": []}

    t_min = min(t0 for ops in lanes.values() for t0, _t1, _op in ops)
    t_max = max(t1 for ops in lanes.values() for _t0, t1, _op in ops)
    window_us = max(t_max - t_min, 0.0)

    lane_ids = {lane: i for i, lane in enumerate(sorted(lanes))}
    compute_us = collective_us = busy_us = 0.0
    per_lane_compute: dict = {}
    per_lane_collective: dict = {}
    op_totals: dict = {}
    all_slices = []
    for lane, ops in lanes.items():
        leaf = _leaf_flags(ops)
        coll_raw = []
        for is_leaf, (t0, t1, op) in zip(leaf, ops):
            kind = classify_op(op)
            if kind == "collective":
                coll_raw.append((t0, t1))
            if is_leaf:
                base = op
                tot = op_totals.setdefault(base, [kind, 0.0, 0])
                tot[1] += t1 - t0
                tot[2] += 1
                all_slices.append((t1 - t0, lane_ids[lane], op, kind, t0))
        coll = _merge(coll_raw)
        busy = _merge([(t0, t1) for t0, t1, _op in ops])
        comp = _subtract(busy, coll)
        compute_us += sum(t1 - t0 for t0, t1 in comp)
        collective_us += sum(t1 - t0 for t0, t1 in coll)
        busy_us += sum(t1 - t0 for t0, t1 in busy)
        per_lane_compute[lane] = comp
        per_lane_collective[lane] = coll

    # Hidden collective time: per lane, its collective intervals that are
    # concurrent with compute on ANY OTHER lane (same-lane overlap cannot
    # happen on a serialized executor; on async-collective backends the
    # same-device compute stream shows up as its own lane/tid anyway).
    hidden_us = 0.0
    for lane, coll in per_lane_collective.items():
        if not coll:
            continue
        others = _merge([iv for other, comp in per_lane_compute.items()
                         if other != lane for iv in comp])
        if others:
            hidden_us += _overlap_len(coll, others)

    n_lanes = len(lanes)
    idle_us = max(n_lanes * window_us - busy_us, 0.0)
    to_s = 1e-6
    top = sorted(op_totals.items(), key=lambda kv: -kv[1][1])[:MAX_TOP_OPS]
    all_slices.sort(reverse=True)
    slices = [{"lane": lane_i, "op": op, "kind": kind,
               "t0_s": round((t0 - t_min) * to_s, 9),
               "dur_s": round(dur * to_s, 9)}
              for dur, lane_i, op, kind, t0 in all_slices[:MAX_SLICES]]
    slices.sort(key=lambda s: (s["lane"], s["t0_s"]))
    return {
        "lanes": n_lanes,
        "num_rounds": num_rounds,
        "window_s": window_us * to_s,
        "compute_s": compute_us * to_s,
        "collective_s": collective_us * to_s,
        "idle_s": idle_us * to_s,
        "per_round": {
            "compute_s": compute_us * to_s / num_rounds,
            "collective_s": collective_us * to_s / num_rounds,
            "idle_s": idle_us * to_s / num_rounds,
        },
        "collective_hidden_s": hidden_us * to_s,
        "overlap_efficiency_measured":
            (hidden_us / collective_us) if collective_us > 0 else 0.0,
        "top_ops": [{"op": op, "kind": kind, "total_s": tot * to_s,
                     "count": count}
                    for op, (kind, tot, count) in top],
        "slices": slices,
    }


def attribute_profile_dir(profile_dir: str, num_rounds: int = 1,
                          module_filter: str | None = None) -> dict | None:
    """Attribution over every trace file a profiler window emitted
    (normally one per host); ``None`` when no trace was found."""
    files = find_trace_files(profile_dir)
    if not files:
        return None
    events = []
    for path in files:
        try:
            events.extend(load_trace_events(path))
        except (OSError, ValueError):
            continue
    out = attribute_trace(events, num_rounds=num_rounds,
                          module_filter=module_filter)
    out["trace_files"] = len(files)
    return out


class DeviceTraceWindow:
    """One fence-constructed profiler capture + attribution window.

    ``start()`` opens a ``torch.profiler`` window (``utils.profiling.
    trace``) writing into ``profile_dir``; ``stop(num_rounds=K)``
    synchronizes the device (so every enqueued kernel lands in the
    window), closes it, attributes the emitted trace, and (when a run is
    still live) emits one ``device_attribution`` event carrying the split,
    the measured overlap efficiency, the top-ops table, and the timeline
    slices.  Every failure path degrades to "no attribution" plus a
    ``profiler_error`` event — profiling must never take a solve down,
    and a window is only ever constructed behind ``get_run() is not
    None``."""

    def __init__(self, profile_dir: str, plane: str = "sharded"):
        self.profile_dir = str(profile_dir)
        self.plane = str(plane)
        self._trace = None
        self._dead = False
        self._lock = threading.Lock()

    def _error(self, e) -> None:
        run = get_run()
        if run is not None:
            run.event("profiler_error", phase=self.plane, error=repr(e))

    def start(self) -> "DeviceTraceWindow":
        with self._lock:
            if self._dead or self._trace is not None:
                return self
            try:
                from ..utils import profiling

                cm = profiling.trace(self.profile_dir)
                cm.__enter__()
                self._trace = cm
            except Exception as e:
                self._dead = True
                self._error(e)
        return self

    def stop(self, num_rounds: int = 1, label: str = "calibration",
             module_filter: str | None = None, **extra) -> dict | None:
        with self._lock:
            if self._trace is None:
                return None
            cm, self._trace = self._trace, None
            try:
                import torch

                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                cm.__exit__(None, None, None)
            except Exception as e:
                self._dead = True
                self._error(e)
                return None
        try:
            attribution = attribute_profile_dir(
                self.profile_dir, num_rounds=num_rounds,
                module_filter=module_filter)
        except Exception as e:
            attribution = None
            self._error(e)
        run = get_run()
        if run is not None and attribution is not None:
            run.event("device_attribution", phase=self.plane, label=label,
                      profile_dir=self.profile_dir, **attribution, **extra)
            run.gauge(
                "device_overlap_efficiency_measured",
                "measured fraction of collective device time hidden "
                "behind compute (profiler attribution)").set(
                    attribution["overlap_efficiency_measured"], label=label)
        return attribution

    def close(self) -> None:
        """Abandon a still-open window without attribution."""
        with self._lock:
            cm, self._trace = self._trace, None
            if cm is not None:
                try:
                    cm.__exit__(None, None, None)
                except Exception:
                    pass


def decide_overlap(arms: dict, threshold: float = 0.0) -> dict:
    """The adaptive gate's arbiter: pick overlapped vs lockstep.

    ``arms`` maps ``"lockstep"``/``"overlapped"`` to dicts with at least
    ``seconds`` and ``rounds`` (plus optional ``attribution``).  The A/B
    efficiency is ``1 - t_overlapped / t_lockstep`` (positive = overlap
    pays); overlap wins when it clears ``threshold``.  Returns the
    decision record that becomes the ``overlap_decision`` event body."""
    lock = arms["lockstep"]
    over = arms["overlapped"]
    t_lock = max(float(lock["seconds"]), 1e-12)
    t_over = max(float(over["seconds"]), 1e-12)
    efficiency = 1.0 - t_over / t_lock
    chosen = efficiency > float(threshold)
    record = {
        "overlap": chosen,
        "efficiency": efficiency,
        "threshold": float(threshold),
        "lockstep_seconds": float(lock["seconds"]),
        "overlapped_seconds": float(over["seconds"]),
        "lockstep_rounds_per_s": float(lock["rounds"]) / t_lock,
        "overlapped_rounds_per_s": float(over["rounds"]) / t_over,
        "calib_rounds": int(lock["rounds"]),
    }
    for name, arm in (("lockstep", lock), ("overlapped", over)):
        attribution = arm.get("attribution")
        if attribution:
            record[f"{name}_overlap_efficiency_measured"] = \
                attribution["overlap_efficiency_measured"]
            record[f"{name}_collective_s_per_round"] = \
                attribution["per_round"]["collective_s"]
            record[f"{name}_compute_s_per_round"] = \
                attribution["per_round"]["compute_s"]
    return record


def profiled_program(run, fn, key: str, label: str, plane: str,
                     static_names: tuple = (), **extra):
    """Solver-plane first-call accounting: ``fn`` wrapped in a
    ``profile.ProfiledExecutable`` whose ``compile_profile`` records carry
    ``phase=plane`` and ``{plane}_*`` metric names.  The wrapper calls
    ``fn`` exactly as the plain path does (no extra launch, no host sync);
    ``flush()`` publishes the records whose device work has finished.
    ``run`` is the caller's already-resolved fence."""
    from . import profile as profile_mod

    del run  # resolved again per call: a run that ended means a plain call
    return profile_mod.ProfiledExecutable(
        fn, key, label, static_names, phase=plane, metric_prefix=plane,
        **extra)



def _first_tensor(tree):
    """The first tensor of a tensor / tuple / list / dict / NamedTuple
    tree, or None."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (tuple, list)) else ()
    for t in items:
        found = _first_tensor(t)
        if found is not None:
            return found
    return None


def time_arm(fn, *args) -> float:
    """Wall seconds for one fully finished call of ``fn`` — the plain A/B
    timer the overlap gate uses with telemetry off (no obs machinery).
    On the card the fence is ``torch.cuda.synchronize`` of the output's
    device; CPU work has finished when the call returns."""
    import torch

    t0 = time.monotonic()
    out = fn(*args)
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return time.monotonic() - t0
